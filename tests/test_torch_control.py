"""The port's serving control plane (A12) against the JAX reference's, on
the CPU: the telemetry ring and the straggler detector, the controller,
the scheduler's threshold flush, the cost model and the autotuned server.

Every reference server is built once, in one module fixture, and each of
its products is computed the first time a test asks for it.

Tolerances, and why:

- the telemetry ring, ``StragglerDetector``, the controller (fits, knobs,
  ``median_rel_error``, counters, ``report()``), ``flush_filled`` /
  ``queue_stats``: exact. The port's copies are pure Python doing the
  reference's float operations in the reference's order on equal inputs.
- the cost model's FLOPs against the reference's optimized-HLO count at
  the reference's smoke config (``_smoke_cfg("bf16")``, micro-batch 2,
  chunk 4): exact, per ladder bucket, gathered and one-shape (the HLO
  counts dots only: 2 x M x K x N each, as the port's analytic count).
  Under ``photonic_sim`` the totals are equal too, but the int8 shares
  differ by design: the reference's oracle widens the codes to int32
  before its chunk dots (``src/repro/core/backend.py:536-537``), so its
  HLO holds no s8 dot and its int8 share is 0; the port's chunk walk
  multiplies int8 codes (``torch._int_mm`` on the card), so every linear
  is int8 there. The test states that relation.
- ``energy_uj`` / ``photonic_us``: 1e-12 relative (float arithmetic over
  the same integer shapes; the accounting's own class).
- predictions: within the port an autotuned server's equal a static
  server's exactly where every queue fills (``force_bucket=0.5``, as the
  reference's own test pins it: per-tensor activation scales make a knob
  that regroups rows able to move a prediction); against the reference
  at least 90% agreement, the serving tests' class (PyTorch's and XLA's
  float ops differ by ulps; a requantization can flip a code).
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_fallback import given, settings, st

import jax
import jax.numpy as jnp

from repro.core.backend import ExecPolicy as JPolicy
from repro.data.pipeline import video_fleet as jfleet
from repro.distributed.fault_tolerance import \
    StragglerDetector as JStraggler
from repro.models.vit import forward_vit_tokens as jforward_tokens
from repro.roofline.hlo_analysis import compile_and_cost
from repro.serving import server as jserver
from repro.serving.control import Controller as JController
from repro.serving.control import ControllerConfig as JControllerConfig
from repro.serving.control import EncodeCostModel as JCostModel
from repro.serving.control import FlushTelemetry as JTelemetry
from repro.serving.control import TunedKnobs as JKnobs
from repro.serving.engine import _smoke_cfg
from repro.serving.scheduler import MicroBatcher as JBatcher
from repro.serving.session import ServingConfig as JServingConfig
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core.backend import ExecPolicy
from repro_torch.data.pipeline import video_fleet
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.models.vit import vit_matmul_shapes
from repro_torch.roofline.cost import encode_cost
from repro_torch.roofline.report import HW
from repro_torch.serving import server as tserver
from repro_torch.serving.control import (Controller, ControllerConfig,
                                         EncodeCostModel, FlushTelemetry,
                                         TunedKnobs)
from repro_torch.serving.scheduler import MicroBatcher
from repro_torch.serving.session import ServingConfig

LADDER = (4, 8, 12, 16)
MB, CHUNK = 2, 4
E2E_FRAMES, E2E_STREAMS = 12, 2


def _tcfg(backend: str):
    """The port's counterpart of the reference's ``_smoke_cfg(backend)``:
    the smoke ViT with the composed attention and FFN."""
    return tserver.smoke_cfg().with_(matmul_backend=backend,
                                     attn_backend="", ffn_backend="")


@pytest.fixture(scope="module")
def ref():
    """The reference's cost tables at micro-batch 2 under bf16 (all four
    buckets, gathered and one-shape), its optimized-HLO count of the
    photonic_sim encode at the cap, and its autotuned serve at
    ``force_bucket=0.5`` (``tests/test_control.py``'s parity case). Every
    server of both packages serves one param tree, drawn once with the
    port's ``bridge.init_vit`` (the reference's shapes and scales), so no
    server pays the reference's per-leaf random init."""
    raw = init_vit(0, _tcfg("bf16"), 10)
    jraw = jax.tree.map(jnp.asarray, raw)

    def server(backend="bf16", one_shape=False, impl="standard"):
        return jserver.StreamServer(
            _smoke_cfg(backend).with_(attn_impl=impl),
            jserver.ServerConfig.from_serving(
                JServingConfig(microbatch=MB, chunk=CHUNK,
                               one_shape=one_shape),
                warm_start=False, autotune=True, mesh="off"),
            params=jraw, n_classes=10)

    @functools.lru_cache(maxsize=None)
    def costs(one_shape=False, impl="standard"):
        return JCostModel.from_server(server("bf16", one_shape,
                                             impl)).table()

    @functools.lru_cache(maxsize=None)
    def sim_hlo(impl="standard"):
        """The reference's photonic_sim encode at the cap over the raw
        weights (its linear quantizes an uncached weight inside the
        encode: more elementwise ops, the same dots as over the cache)."""
        cfg = _smoke_cfg("photonic_sim").with_(attn_impl=impl)
        pol = JPolicy.from_cfg(cfg, training=False)
        fn = jax.jit(lambda p, t: jforward_tokens(p, t, cfg, pol)[0])
        return compile_and_cost(fn, jraw, jax.ShapeDtypeStruct(
            (MB, LADDER[-1], cfg.d_model), jnp.float32))[0]

    @functools.lru_cache(maxsize=None)
    def autotuned_serve():
        srv = jserver.StreamServer(
            _smoke_cfg("bf16"), jserver.ServerConfig.from_serving(
                JServingConfig(microbatch=MB, chunk=CHUNK, force_bucket=0.5),
                warm_start=False, autotune=True, retune_every=4,
                mesh="off"), params=jraw, n_classes=10)
        sessions = [srv.add_session(st, n_frames=E2E_FRAMES, start=16 * i)
                    for i, st in enumerate(jfleet(
                        E2E_STREAMS, img_size=32, patch=8, cut_every=32))]
        srv.autotune_prepare()
        res = srv.serve()
        return [res[s.sid] for s in sessions], srv

    return {"costs": costs, "sim_hlo": sim_hlo,
            "params": from_jax_params(raw, "cpu"),
            "autotuned_serve": autotuned_serve}


def _tserver(backend="bf16", one_shape=False, impl="standard"):
    """The port's autotuned CPU server at the reference's smoke config,
    nothing warmed yet."""
    return tserver.StreamServer(
        _tcfg(backend).with_(attn_impl=impl),
        tserver.ServerConfig.from_serving(
            ServingConfig(microbatch=MB, chunk=CHUNK, one_shape=one_shape),
            warm_start=False, autotune=True),
        device="cpu")


# --------------------------------------------------------------------------
# telemetry ring + straggler detector
# --------------------------------------------------------------------------

def _obs_fields(o):
    return dataclasses.astuple(o)


@pytest.mark.parametrize("window", [4, 16, 64])
def test_telemetry_and_straggler_views_equal_reference(window):
    """Equal records (three buckets, fills, stream counts, walls with two
    planted stalls) into both packages' rings, each carrying its own
    package's ``StragglerDetector``, give equal views at every step."""
    rng = np.random.default_rng(window)
    tel = FlushTelemetry(window, straggler=StragglerDetector())
    jtel = JTelemetry(window, straggler=JStraggler())
    for i in range(40):
        k = int(rng.choice(LADDER[:3]))
        wall = float(1e-3 * k * (1 + 0.1 * rng.standard_normal()))
        if i in (17, 31):
            wall += 0.05
        args = (k, int(rng.integers(1, 5)), 4, int(rng.integers(1, 4)),
                wall, i // 3)
        assert _obs_fields(tel.record(*args)) == _obs_fields(
            jtel.record(*args))
        assert len(tel) == len(jtel) and tel.seq == jtel.seq
        assert tel.total_recorded == jtel.total_recorded
        assert [_obs_fields(o) for o in tel] == [_obs_fields(o)
                                                 for o in jtel]
        assert ({b: [_obs_fields(o) for o in v]
                 for b, v in tel.by_bucket().items()}
                == {b: [_obs_fields(o) for o in v]
                    for b, v in jtel.by_bucket().items()})
        for b in LADDER:
            for ms in (0, i // 2):
                assert tel.latencies(b, ms) == jtel.latencies(b, ms)
                assert tel.median_latency(b, ms) == jtel.median_latency(b,
                                                                        ms)
                assert tel.mean_latency(b, ms) == jtel.mean_latency(b, ms)
            assert tel.occupancy(b) == jtel.occupancy(b)
        assert tel.occupancy() == jtel.occupancy()
        assert tel.mean_streams() == jtel.mean_streams()
        assert ([_obs_fields(o) for o in tel.straggler_flags]
                == [_obs_fields(o) for o in jtel.straggler_flags])
        assert tel.straggler.flags == jtel.straggler.flags
    assert {o.seq for o in tel.straggler_flags} >= {17, 31}
    with pytest.raises(ValueError):
        FlushTelemetry(window=0)


def test_straggler_detector_and_timer_equal_reference():
    det, jdet = StragglerDetector(k=3.0, window=12), JStraggler(k=3.0,
                                                                 window=12)
    for i, d in enumerate([0.01] * 11 + [0.2, 0.011, 0.009] * 5 + [0.5]):
        assert det.record(i, d) == jdet.record(i, d)
        assert det._durations == jdet._durations
    assert det.flags == jdet.flags and det.flags[-1][0] == 26
    with StragglerDetector.timer(det, 99):
        pass
    assert len(det._durations) == 12 and det._durations[-1] >= 0.0


# --------------------------------------------------------------------------
# the controller, through a stub cost model (known raw predictions)
# --------------------------------------------------------------------------

class _StubCostModel:
    """Known raw predictions, no compiles or captures (the reference's
    ``tests/test_control.py::_StubCostModel``)."""

    def __init__(self, preds: dict, microbatch: int = 4):
        self.microbatch = microbatch
        self.costs = dict(preds)
        self._builders = {}
        self._preds = preds

    def predicted_flush_s(self, bucket: int) -> float:
        return self._preds[bucket]


def _pair(preds=None, cc: dict | None = None, window=64, mb=4,
          defaults: dict | None = None):
    """The port's and the reference's controllers on equal stubs."""
    preds = preds or {4: 1e-5, 8: 2e-5, 16: 4e-5}
    cc, defaults = cc or {}, defaults or {}
    return (Controller(_StubCostModel(preds, mb), FlushTelemetry(window),
                       TunedKnobs(**defaults), ControllerConfig(**cc)),
            JController(_StubCostModel(preds, mb), JTelemetry(window),
                        JKnobs(**defaults), JControllerConfig(**cc)))


def _state(c):
    return (c.knobs.key(), c._fit, c._fit_seq, c._bucket_scale,
            c.clamp_violations, c.clamp_engaged, c.applied_retunes,
            c.frozen, c.calibrated, c.converged, c._baseline_fps,
            c._backlog_ema, c._pending_key, c._pending_count,
            c._stable_steps, c.median_rel_error(),
            c.median_rel_error(holdout=False), c.report(),
            tuple(c.predict_flush_s(k) for k in sorted(c.cost_model.costs)))


def _both(pair, name, *args):
    a, b = (getattr(c, name)(*args) for c in pair)
    assert a == b, name
    return a


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 4), st.integers(1, 3),
       st.integers(0, 2), st.integers(1, 6), st.integers(4, 64))
def test_controller_matches_reference(seed, n_buckets, hysteresis, burn_in,
                                      min_samples, window):
    """The same predictions, observations, queue stats and step times into
    both packages' ``Controller``: after every call the fit, knobs,
    counters, held-out and in-window errors, calibrated predictions and
    ``report()`` are equal (bitwise floats, equal strings)."""
    rng = np.random.default_rng(seed)
    buckets = LADDER[:n_buckets]
    preds = {k: float(rng.uniform(1e-6, 1e-3)) for k in buckets}
    mb = int(rng.integers(1, 9))
    pair = _pair(preds, dict(hysteresis=hysteresis, burn_in=burn_in,
                             min_samples=min_samples,
                             retune_every=int(rng.integers(1, 64))),
                 window=window, mb=mb,
                 defaults=dict(max_wait_chunks=int(rng.integers(0, 3)),
                               interleave_depth=int(rng.integers(1, 3))))
    a, b = float(rng.uniform(0.5, 5.0)), float(rng.uniform(0.0, 1e-2))
    frames, t = 0, 0.0
    for _ in range(80):
        if rng.random() < 0.75:
            k = int(rng.choice(buckets))
            wall = max(a * preds[k] + b
                       + float(rng.normal(0.0, 1e-3)), 1e-7)
            if rng.random() < 0.05:
                wall = 0.0                    # skipped by the error score
            _both(pair, "record_flush", k, int(rng.integers(1, mb + 1)),
                  int(rng.integers(1, 4)), wall, int(rng.integers(0, 50)))
        else:
            frames += int(rng.integers(0, 40))
            t += float(rng.choice([0.01, 0.5, 2.0]))
            qs = {(int(rng.choice(LADDER)), s): (int(rng.integers(0, 3 * mb)),
                                                 int(rng.integers(0, 9)))
                  for s in range(int(rng.integers(0, 4)))}
            _both(pair, "step", qs, frames, t)
        assert _state(pair[0]) == _state(pair[1])
    _both(pair, "calibrate")
    assert _state(pair[0]) == _state(pair[1])
    wild = TunedKnobs(int(rng.integers(-3, 20)), int(rng.integers(-2, 8)),
                      {k: int(rng.integers(-2, 2 * mb)) for k in buckets})
    jwild = JKnobs(wild.max_wait_chunks, wild.interleave_depth,
                   dict(wild.flush_threshold))
    assert pair[0]._clamp(wild).key() == pair[1]._clamp(jwild).key()
    assert pair[0]._in_bounds(wild) == pair[1]._in_bounds(jwild)
    assert _state(pair[0]) == _state(pair[1])


def test_calibration_recovers_linear_map():
    """obs = 3 * pred + 0.01 exactly: both recover (a, b), equally."""
    pair = _pair()
    for k, p in pair[0].cost_model._preds.items():
        for _ in range(6):
            _both(pair, "record_flush", k, 4, 2, 3.0 * p + 0.01)
    assert _both(pair, "calibrate")
    a, b = pair[0]._fit
    assert a == pytest.approx(3.0, rel=1e-6)
    assert b == pytest.approx(0.01, rel=1e-6)
    for k, p in pair[0].cost_model._preds.items():
        assert pair[0].predict_flush_s(k) == pytest.approx(3.0 * p + 0.01,
                                                           rel=0.01)
    assert pair[0].median_rel_error(holdout=False) == pytest.approx(
        0.0, abs=1e-6)
    assert _state(pair[0]) == _state(pair[1])


def test_calibration_single_bucket_fits_through_origin():
    pair = _pair(preds={8: 2e-5})
    for _ in range(4):
        _both(pair, "record_flush", 8, 4, 1, 6e-5)
    assert _both(pair, "calibrate")
    assert pair[0]._fit[1] == 0.0
    assert pair[0].predict_flush_s(8) == pytest.approx(6e-5)
    assert _state(pair[0]) == _state(pair[1])


def test_holdout_split_scores_only_post_fit_observations():
    pair = _pair(preds={8: 2e-5})
    for _ in range(4):
        _both(pair, "record_flush", 8, 4, 1, 6e-5)
    _both(pair, "calibrate")
    assert pair[0].median_rel_error() is None
    _both(pair, "record_flush", 8, 4, 1, 12e-5)   # the workload shifted 2x
    assert pair[0].median_rel_error() == pytest.approx(0.5)
    assert _state(pair[0]) == _state(pair[1])


def test_hysteresis_defers_then_applies():
    pair = _pair(cc=dict(hysteresis=2))
    for k in pair[0].cost_model._preds:
        for _ in range(6):
            _both(pair, "record_flush", k, 2, 2, 1e-4)        # 50% fill
    assert _both(pair, "step", {}, 16, 1.0) is False
    assert pair[0].knobs.key() == pair[0].defaults.key()
    assert _both(pair, "step", {}, 32, 2.0) is True
    assert pair[0].applied_retunes == 1 and pair[0].converged
    assert pair[0].knobs.max_wait_chunks > 0 and pair[0].knobs.flush_threshold
    assert pair[0].clamp_violations == 0
    assert _state(pair[0]) == _state(pair[1])


def test_clamp_forces_box_and_counts():
    pair = _pair()
    wild = dict(max_wait_chunks=99, interleave_depth=0,
                flush_threshold={8: 999, 16: 0})
    out, jout = pair[0]._clamp(TunedKnobs(**wild)), pair[1]._clamp(
        JKnobs(**wild))
    assert out.key() == jout.key()
    assert pair[0]._in_bounds(out) and not pair[0]._in_bounds(
        TunedKnobs(**wild))
    assert out.interleave_depth == 1 and out.flush_threshold == {8: 4, 16: 2}
    assert pair[0].clamp_engaged == pair[1].clamp_engaged == 1
    assert _state(pair[0]) == _state(pair[1])


def test_watchdog_reverts_and_freezes():
    pair = _pair()
    assert _both(pair, "step", {}, 100, 1.0) is False    # baseline 100 fps
    for c, kn in zip(pair, (TunedKnobs, JKnobs)):
        c.knobs.set_to(kn(max_wait_chunks=2))            # tuned knobs live
    assert _both(pair, "step", {}, 110, 2.0) is True     # 10 fps << 75
    assert pair[0].frozen and not pair[0].converged
    assert pair[0].knobs.key() == pair[0].defaults.key()
    assert _both(pair, "step", {}, 120, 3.0) is False
    assert _state(pair[0]) == _state(pair[1])


# --------------------------------------------------------------------------
# the scheduler's threshold flush and queue view
# --------------------------------------------------------------------------

def test_flush_filled_and_queue_stats_equal_reference():
    tb, jb = MicroBatcher(microbatch=4), JBatcher(microbatch=4)
    pushes = [((8, 0), 3, 5), ((16, 1), 1, 6), ((8, 1), 2, 6),
              ((12, 0), 4, 7), ((16, 1), 2, 8)]
    for i, (key, m, now) in enumerate(pushes):
        x = np.arange(m * key[0] * 2, dtype=np.float32).reshape(
            m, key[0], 2) + i
        idx = [(key[1], 10 * i + r) for r in range(m)]
        got = tb.push_many(key, torch.from_numpy(x), idx, now=now)
        want = jb.push_many(key, jnp.asarray(x), idx, now=now)
        assert [(f.bucket, f.frame_idx, f.n_real) for f in got] == [
            (f.bucket, f.frame_idx, f.n_real) for f in want]
    assert tb.queue_stats() == jb.queue_stats()
    for thr in ({8: 2}, {16: 3, 8: 3}, {}):
        def of(key, thr=thr):
            return thr.get(key[0], 4)
        got, want = tb.flush_filled(of), jb.flush_filled(of)
        assert [(f.bucket, f.frame_idx, f.n_real) for f in got] == [
            (f.bucket, f.frame_idx, f.n_real) for f in want]
        for f, g in zip(got, want):
            assert f.tokens.shape[0] == 4
            np.testing.assert_array_equal(f.tokens.numpy(),
                                          np.asarray(g.tokens))
        assert tb.queue_stats() == jb.queue_stats()
    assert tb.flush_filled(lambda k: 4) == []


# --------------------------------------------------------------------------
# the cost model at the reference's smoke config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("one_shape,impl", [
    (False, "standard"), (True, "standard"), (False, "decomposed")],
    ids=["gathered", "one-shape", "eq2"])
def test_cost_model_flops_equal_reference_hlo(ref, one_shape, impl):
    """Per ladder bucket the port's analytic FLOPs are the reference's
    optimized-HLO count exactly (also under Eq. 2's decomposed
    attention); the modeled accelerator's energy and latency equal to
    1e-12; every bucket warmed by its price (on the CPU: one eager encode
    each, no graph)."""
    want = ref["costs"](one_shape, impl)
    srv = _tserver("bf16", one_shape, impl=impl)
    assert not srv.warmed and srv.cost_model is None
    cm = EncodeCostModel.from_server(srv)
    assert srv.warmed == set(LADDER) and srv.graphs == {}
    got = cm.table()
    assert sorted(got) == sorted(want) == list(LADDER)
    for k in LADDER:
        g, w = got[k], want[k]
        assert (g.bucket, g.microbatch, g.kv_len) == (w.bucket, w.microbatch,
                                                      w.kv_len)
        assert g.flops == w.flops, (k, g.flops, w.flops)
        assert g.int8_flops == w.int8_flops == 0.0
        assert g.energy_uj == pytest.approx(w.energy_uj, rel=1e-12)
        assert g.photonic_us == pytest.approx(w.photonic_us, rel=1e-12)
        assert g.bits_sig == w.bits_sig is None
        assert g.device_s > 0 and g.hbm_bytes > 0
    assert "pred us" in cm.render()


@pytest.mark.parametrize("impl", ["standard", "decomposed"])
def test_cost_model_int8_share_under_photonic_sim(ref, impl):
    """photonic_sim at the cap: equal totals (under Eq. 2 both count the
    per-head K = d_head products zero-padded to a 32-wide chunk); the port
    counts every linear as int8 (its chunk walk multiplies int8 codes),
    the reference's HLO none (its oracle widens the codes to int32 before
    each dot)."""
    want = ref["sim_hlo"](impl)
    k = LADDER[-1]
    got = EncodeCostModel.from_server(_tserver("photonic_sim", impl=impl),
                                      buckets=(k,)).costs[k]
    assert got.flops == want.flops
    assert want.int8_flops == 0.0
    cfg = _tcfg("photonic_sim")
    d, heads = cfg.d_model, cfg.n_heads
    width = d if impl == "decomposed" else d // heads     # a head's keys
    core = cfg.n_layers * MB * 2 * heads * (k + 1) ** 2 * (width + d // heads)
    assert got.int8_flops == got.flops - core > 0


def test_cost_model_rises_with_bucket_and_rejects_off_ladder():
    srv = _tserver("photonic_pallas")
    cm = EncodeCostModel.from_server(srv, buckets=())
    assert cm.costs == {} and not srv.warmed       # lazy until ensured
    rows = [cm.ensure(k) for k in LADDER]
    assert srv.warmed == set(LADDER)
    for attr in ("flops", "hbm_bytes", "energy_uj", "photonic_us",
                 "device_s"):
        vals = [getattr(r, attr) for r in rows]
        assert vals == sorted(vals) and len(set(vals)) == len(vals), attr
    with pytest.raises(KeyError):
        cm.ensure(max(LADDER) + 1)
    assert cm.predicted_flush_s(8) == cm.costs[8].device_s


@pytest.mark.parametrize("variant", ["smoke", "base"])
def test_encode_cost_follows_the_kernels(variant):
    """The fused serving point: every linear and the FFN on int8, the
    attention core on the flash kernel's entry for its head dims (the SIMT
    one at the smoke config's 16, the 3xTF32 tensor-core one at base's
    64); the gathered count is vit_matmul_shapes' (less the patch embed)
    plus the head; one-shape packing drops the dead keys and FFN rows
    there but not on the materialized attention and composed FFN; the
    roofline takes each dtype class's operations over its own peak."""
    cfg = (tserver.smoke_cfg() if variant == "smoke"
           else tserver.serving_cfg("base", 224))
    mb, c, cap = 4, 10, cfg.img_size ** 2 // cfg.patch ** 2
    d, small = cfg.d_model, cap // 4
    pol = ExecPolicy.from_cfg(cfg)
    full = encode_cost(cfg, pol, mb, cap, n_classes=c)
    shapes = vit_matmul_shapes(cfg, kept_patches=cap)[1:]
    want = mb * sum(2 * m * k * n for m, k, n in shapes) + 2 * mb * d * c
    assert full.flops == want
    attn = mb * cfg.n_layers * 2 * 2 * (cap + 1) ** 2 * d
    core = "f32" if variant == "smoke" else "tf32x3"
    assert full.by_type == {"int8": want - attn, core: attn}
    assert full.int8_flops == want - attn
    packed = encode_cost(cfg, pol, mb, small, cap, n_classes=c)
    gathered = encode_cost(cfg, pol, mb, small, n_classes=c)
    assert gathered.flops < packed.flops < full.flops
    assert gathered.bytes < packed.bytes < full.bytes
    xla = ExecPolicy.from_cfg(cfg.with_(attn_backend="xla",
                                        ffn_backend="xla"))
    assert (encode_cost(cfg, xla, mb, small, cap, n_classes=c).flops
            == encode_cost(cfg, xla, mb, cap, n_classes=c).flops
            == full.flops)
    hw = HW()
    t_c = sum(f / hw.peak(kind) for kind, f in full.by_type.items())
    core_s = attn / 67e12 if core == "f32" else 3 * attn / 495e12
    assert math.isclose(t_c, (want - attn) / 1979e12 + core_s,
                        rel_tol=1e-12)
    with pytest.raises(ValueError):
        encode_cost(cfg, pol, mb, cap + 1, cap, n_classes=c)


def test_calibrate_bits_reprices_the_cost_model():
    """A bit plan installed after ``autotune_prepare`` re-prices every
    priced bucket at the new widths, and the controller reads the new
    table."""
    srv = tserver.StreamServer(
        tserver.smoke_cfg(), tserver.ServerConfig(
            microbatch=MB, chunk=CHUNK, autotune=True, warm_start=False),
        device="cpu")
    srv.add_session(video_fleet(1, img_size=32, patch=8)[0], n_frames=8)
    ctl = srv.autotune_prepare()
    before = srv.cost_model.table()
    plan = srv.calibrate_bits(6.0)
    assert srv.cost_model is ctl.cost_model and sorted(
        srv.cost_model.costs) == sorted(before)
    for k, c in srv.cost_model.table().items():
        assert c.bits_sig == plan and before[k].bits_sig is None
        assert c.energy_uj < before[k].energy_uj
        assert c.flops == before[k].flops


# --------------------------------------------------------------------------
# the autotuned server
# --------------------------------------------------------------------------

def _tserve(params, autotune: bool):
    srv = tserver.StreamServer(
        _tcfg("bf16"), tserver.ServerConfig.from_serving(
            ServingConfig(microbatch=MB, chunk=CHUNK, force_bucket=0.5),
            warm_start=False, autotune=autotune, retune_every=4),
        params=params, device="cpu")
    sessions = [srv.add_session(st, n_frames=E2E_FRAMES, start=16 * i)
                for i, st in enumerate(video_fleet(
                    E2E_STREAMS, img_size=32, patch=8, cut_every=32))]
    if autotune:
        srv.autotune_prepare()
    else:
        srv.warm_start()
    res = srv.serve()
    return srv, [res[s.sid] for s in sessions]


def test_autotune_prediction_parity_with_static_server(ref):
    """The reference's ``test_autotune_prediction_parity_with_static_server``
    on the port: autotuning never changes predictions where every queue
    fills; only the timed server reports measured flush times; the
    controller calibrated inside its clamp; and the predictions agree with
    the reference's autotuned server at the serving tests' class."""
    srv_a, auto = _tserve(ref["params"], True)
    srv_s, static = _tserve(ref["params"], False)
    jres, jsrv = ref["autotuned_serve"]()
    assert srv_a.ladder.sizes == jsrv.ladder.sizes
    assert sorted(srv_a.cost_model.costs) == sorted(jsrv.cost_model.costs)
    for ra, rs, rj in zip(auto, static, jres):
        assert ra.predictions == rs.predictions
        assert ra.flush_wall_ms and not rs.flush_wall_ms
        assert set(ra.flush_wall_ms) == set(rj.flush_wall_ms) == {8}
        assert all(v > 0 for v in ra.flush_wall_ms.values())
        assert ra.bucket_hits == rj.bucket_hits
        assert set(ra.predictions) == set(rj.predictions)
        agree = np.mean([ra.predictions[i] == rj.predictions[i]
                         for i in ra.predictions])
        assert agree >= 0.9, agree
    ctl = srv_a.controller
    assert ctl.clamp_violations == 0 and ctl.calibrated
    assert len(srv_a.telemetry) == len(srv_a.flush_log) == len(
        jsrv.flush_log)
    assert srv_s.telemetry is None and srv_s.controller is None
    assert srv_a.straggler_flags == []


def test_watchdog_server_times_every_flush(ref):
    """``watchdog=True`` without the controller: every flush lands in the
    telemetry ring with a detector attached; predictions unchanged."""
    srv = tserver.StreamServer(
        _tcfg("bf16"), tserver.ServerConfig(
            microbatch=MB, chunk=CHUNK, force_bucket=0.5, watchdog=True),
        params=ref["params"], device="cpu")
    sessions = [srv.add_session(st, n_frames=E2E_FRAMES, start=16 * i)
                for i, st in enumerate(video_fleet(
                    E2E_STREAMS, img_size=32, patch=8, cut_every=32))]
    res = srv.serve()
    assert srv.controller is None and srv.telemetry.straggler is not None
    assert len(srv.telemetry) == len(srv.flush_log)
    assert [(o.bucket, o.n_real) for o in srv.telemetry] == [
        (k, n) for _, k, n in srv.flush_log]
    _, static = _tserve(ref["params"], False)
    for s, rs in zip(sessions, static):
        assert res[s.sid].predictions == rs.predictions
        assert res[s.sid].flush_wall_ms


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _parsed(monkeypatch, mod, argv):
    """The ServerConfig a CLI's ``main`` builds from ``argv``: its
    StreamServer is replaced by a stub that records it and stops."""
    got = {}

    def stub(cfg, sc, *a, **k):
        got["sc"] = sc
        raise _Stop

    monkeypatch.setattr(mod, "StreamServer", stub)
    with pytest.raises(_Stop):
        mod.main(argv)
    return got["sc"]


def test_control_flags_parse_as_the_reference(monkeypatch):
    """The same argv, the four control-plane flags among them, through
    both packages' ``main``s: equal control-plane config fields."""
    argv = ["--smoke", "--autotune", "--retune-every", "4",
            "--assert-converged", "--watchdog"]
    jsc = _parsed(monkeypatch, jserver, argv + ["--mesh", "off"])
    tsc = _parsed(monkeypatch, tserver, argv)
    for f in ("autotune", "retune_every", "watchdog", "telemetry_window",
              "interleave_depth"):
        assert getattr(tsc, f) == getattr(jsc, f), f
    assert (tsc.autotune, tsc.retune_every, tsc.watchdog) == (True, 4, True)
    args = tserver.build_parser().parse_args(argv)
    assert args.assert_converged
    assert not tserver.build_parser().parse_args([]).autotune


def test_autotune_cli_serves_on_cpu(capsys):
    res = tserver.main(["--smoke", "--device", "cpu", "--autotune",
                        "--retune-every", "4", "--assert-converged",
                        "--frames", "16"])
    assert res and all(r.frames == 16 and r.flush_wall_ms
                       for r in res.values())
    out = capsys.readouterr().out
    assert "pred us" in out and "[server] controller: obs = " in out
    assert "0 violations" in out and "[converged]" in out
