"""The port's calibrated device noise against the JAX reference, on the CPU.

The port draws with JAX's own generator (threefry2x32, partitionable
layout: core/threefry.py), so at the same key, and the same
``DriftState``, it draws the reference's noise, not merely noise of the
same distribution. On the CPU the noise-draw kernel's plain versions
(kernels/ref.py) run. Tolerances, and why:

- threefry ``fold_in`` and ``random_bits``: bitwise (integer arithmetic);
  ``uniform``: within 1e-8 (it is bitwise: one fused multiply-add, as XLA
  evaluates it); ``normal``: within 1e-5 (XLA's erf_inv polynomial,
  reproduced; only ``log1p`` differs, ~5e-7 at |n| ~ 4).
- the MR model (crosstalk, noise power, the drifted floor, the detune
  gain, ``transmission_error``): within 1e-6 absolute (f32 products and
  quotients; XLA's vectorised division differs from PyTorch's by an ulp).
- key data of ``next_call_keys``: bitwise.
- matmuls under noise (``photonic_matmul_sim``, the noisy prequant matmul,
  ``_noisy_matmul``): within 1e-5 relative to the output's largest value
  (the analog walk's f32 chunk sums in another order); clean: bitwise.
- noisy encodes (``forward_vit`` and the server's encode, uniform and
  under a two-segment bit plan, at one ``DriftState``): corr > 0.999 with
  the reference's, and the port's distance to it under a quarter of the
  reference's own distance between frame f and f + 1. A wrong call-counter
  or salt rule draws unrelated noise and lands at the frame-to-frame
  distance, so this fails it.
- ``retune_report``: within 1e-12 relative (the same float sums).

The mechanics the reference's tests/test_robustness.py holds run on the
port's server (scope required, pinned state, gate clean by default, the
fingerprint, routing, recalibration and its bill, ``inject_drift``).
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import noise as jnoise
from repro.core import photonic as jphotonic
from repro.kernels import ops as jops
from repro.models import vit as jvit
from repro.serving import accounting as jacct
from repro.serving import server as jserver
from repro.serving.engine import _smoke_cfg
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core import backend as tbackend
from repro_torch.core import noise as tnoise
from repro_torch.core import photonic as tphotonic
from repro_torch.core import threefry
from repro_torch.data.pipeline import VideoStream
from repro_torch.kernels import ops as tops
from repro_torch.models import vit as tvit
from repro_torch.serving import accounting as tacct
from repro_torch.serving import engine as tengine
from repro_torch.serving import server as tserver

N_CLASSES = 10
PLAN = (8, 8, 6, 6)                       # two equal-width runs of 2 layers
SPEC = dict(drift_rate_nm=0.01, wander_sigma_nm=0.01)


def _jkey(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _tkey(seed):
    return threefry.prng_key(seed)


def _jcache(tree):
    if isinstance(tree, dict):
        return {k: _jcache(v) for k, v in tree.items()}
    if isinstance(tree, tbackend.QuantizedWeight):
        return jbackend.QuantizedWeight(jnp.asarray(tree.wq.numpy()),
                                        jnp.asarray(tree.scale.numpy()),
                                        tree.bits)
    return jnp.asarray(tree.numpy())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _states(frame, drift=0.02):
    return (jnoise.DriftState(jax.random.PRNGKey(0), jnp.int32(frame),
                              jnp.float32(drift)),
            tnoise.DriftState(_tkey(0), frame, drift))


@pytest.fixture(scope="module")
def weights():
    """One numpy draw of the smoke params: raw (the port's), and the
    uniform and two-run planned caches in both packages."""
    raw = from_jax_params(init_vit(0, tserver.smoke_cfg(), N_CLASSES), "cpu")
    out = {"traw": raw}
    for tag, plan in (("uniform", None), ("plan", PLAN)):
        t = tbackend.prepare_params(raw, bits=8, bit_plan=plan, n_layers=4)
        out[tag] = (t, _jcache(t))
    return out


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (33, 65)])
def test_threefry_matches_jax_random(shape):
    for seed in (0, 123456789):
        jk, tk = jax.random.PRNGKey(seed), _tkey(seed)
        assert _jkey(jk) == tk
        for d in (0, 5, 0x46505601, 2 ** 32 - 1):
            assert _jkey(jax.random.fold_in(jk, d)) == threefry.fold_in(tk, d)
        bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(
            bits.astype(np.int64), threefry.random_bits(tk, shape).numpy())
        for lo, hi in ((0.0, 1.0), (-0.003, 0.003)):
            u = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                              maxval=hi))
            assert np.abs(u - threefry.uniform(tk, shape, lo, hi).numpy()
                          ).max() <= 1e-8
        n = np.asarray(jax.random.normal(jk, shape))
        assert np.abs(n - threefry.normal(tk, shape).numpy()).max() <= 1e-5


# -- the MR model ---------------------------------------------------------------

def test_mr_model_matches_reference():
    jc, tc = jnoise.MRConfig(), tnoise.MRConfig()
    np.testing.assert_allclose(tnoise.crosstalk_matrix(tc).numpy(),
                               np.asarray(jnoise.crosstalk_matrix(jc)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnoise.noise_power(tc).numpy(),
                               np.asarray(jnoise.noise_power(jc)),
                               rtol=0, atol=1e-6)
    assert tnoise.resolution_bits(tc) == jnoise.resolution_bits(jc)
    q = tnoise.required_q_factor()
    assert q == jnoise.required_q_factor() and q <= 5000.0
    for d in (0.0, 0.05, -0.12):
        for fn in ("drifted_noise_floor", "mr_detune_gain"):
            assert abs(float(getattr(tnoise, fn)(tc, d))
                       - float(getattr(jnoise, fn)(jc, d))) <= 1e-6


@pytest.mark.parametrize("kw", [{}, {"drift_nm": 0.03},
                                {"drift_nm": -0.05, "wander_sigma_nm": 0.02}],
                         ids=["static", "drift", "drift-wander"])
@pytest.mark.parametrize("fpv", [0.0, 0.01])
def test_transmission_error_matches_reference(kw, fpv):
    shape = (96, 70)
    jc, tc = jnoise.MRConfig(), tnoise.MRConfig()
    for fk in (False, True):
        j = np.asarray(jnoise.transmission_error(
            jax.random.PRNGKey(11), shape, jc, fpv,
            fpv_key=jax.random.PRNGKey(3) if fk else None, **kw))
        t = tnoise.transmission_error(
            _tkey(11), shape, tc, fpv, fpv_key=_tkey(3) if fk else None,
            **kw).numpy()
        assert np.abs(j - t).max() <= 1e-6, (kw, fpv, fk)


# -- scopes and keys ---------------------------------------------------------------

def test_next_call_keys_bitwise_under_nested_salts():
    spec_j, spec_t = jnoise.NoiseSpec(seed=5), tnoise.NoiseSpec(seed=5)
    with pytest.raises(RuntimeError, match="no noise scope"):
        tnoise.next_call_keys(spec_t)
    js, ts = _states(7)
    got_j, got_t = [], []
    with jnoise.noise_scope(js), tnoise.noise_scope(ts):
        for salts in ((), (3,), (3, 11), (2, 0, 9)):
            with contextlib.ExitStack() as stack:
                for s in salts:
                    stack.enter_context(jnoise.scope_salt(s))
                    stack.enter_context(tnoise.scope_salt(s))
                for _ in range(2):
                    kc, kf, drift = jnoise.next_call_keys(spec_j)
                    call = tnoise.next_call_keys(spec_t)
                    got_j.append((_jkey(kc), _jkey(kf), float(drift)))
                    got_t.append((call.draw_key(), call.fpv_key,
                                  float(call.drift_nm)))
                    # the kernels' derivation from the state tensor
                    dk = tnoise.state_draw_key(call.state_tensor("cpu"),
                                               call.salts, call.counter)
                    assert tuple(int(v) for v in dk) == call.draw_key()
    assert got_t == got_j
    assert tnoise.current_scope() is None


def test_drift_state_advances_in_f32_and_round_trips_the_tensor():
    spec_j, spec_t = jnoise.NoiseSpec(drift_rate_nm=0.013), \
        tnoise.NoiseSpec(drift_rate_nm=0.013)
    js, ts = jnoise.DriftState.init(4), tnoise.DriftState.init(4)
    for frames in (4, 3, 1, 8):
        js, ts = js.advance(spec_j, frames), ts.advance(spec_t, frames)
        assert np.float32(js.drift_nm) == ts.drift_nm
        assert int(js.frame) == int(ts.frame)
    assert tuple(int(v) for v in ts.key) == _jkey(js.key)
    t = ts.to_tensor("cpu")
    assert float(tnoise.state_drift(t)) == float(ts.drift_nm)
    assert ts.reset_drift().drift_nm == 0 and ts.reset_drift().frame == 16


@pytest.mark.parametrize("adc", [False, True])
def test_readout_noise_matches_reference(adc):
    y = np.random.default_rng(2).standard_normal((9, 13)).astype(np.float32)
    spec_j = jnoise.NoiseSpec(adc_quantize_output=adc)
    spec_t = tnoise.NoiseSpec(adc_quantize_output=adc)
    js, ts = _states(3)
    with jnoise.noise_scope(js), tnoise.noise_scope(ts):
        kc, _, _ = jnoise.next_call_keys(spec_j)
        call = tnoise.next_call_keys(spec_t)
        j = np.asarray(jnoise.readout_noise(jnp.asarray(y), spec_j, kc))
        t = tnoise.readout_noise(torch.from_numpy(y), spec_t, call).numpy()
    assert _rel(j, t) <= 1e-5


# -- matmuls ----------------------------------------------------------------------

def test_photonic_matmul_exact_and_sim_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 80)).astype(np.float32)
    w = rng.standard_normal((80, 40)).astype(np.float32)
    jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x),
                      torch.from_numpy(w))
    np.testing.assert_array_equal(
        tphotonic.photonic_matmul_exact(tx, tw).numpy(),
        np.asarray(jphotonic.photonic_matmul_exact(jx, jw)))
    np.testing.assert_array_equal(
        tphotonic.photonic_matmul_sim(tx, tw).numpy(),
        np.asarray(jphotonic.photonic_matmul_sim(jx, jw)))
    jc = jphotonic.OpticalCoreConfig(apply_noise=True, fpv_sigma=0.01)
    tc = tphotonic.OpticalCoreConfig(apply_noise=True, fpv_sigma=0.01)
    with pytest.raises(ValueError, match="noise_key"):
        tphotonic.photonic_matmul_sim(tx, tw, tc)
    for kw in ({}, {"drift_nm": 0.04, "wander_sigma_nm": 0.01}):
        j = jphotonic.photonic_matmul_sim(jx, jw, jc,
                                          noise_key=jax.random.PRNGKey(8),
                                          **kw)
        t = tphotonic.photonic_matmul_sim(tx, tw, tc, noise_key=_tkey(8),
                                          **kw)
        assert _rel(j, t.numpy()) <= 1e-5


def test_prequant_noisy_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    qw = tbackend.quantize_weight(
        torch.from_numpy(rng.standard_normal((96, 48)).astype(np.float32)))
    spec_j = jnoise.NoiseSpec(wander_sigma_nm=0.01, adc_quantize_output=True)
    spec_t = tnoise.NoiseSpec(wander_sigma_nm=0.01, adc_quantize_output=True)
    js, ts = _states(2, 0.05)
    with jnoise.noise_scope(js), tnoise.noise_scope(ts):
        kc, kf, drift = jnoise.next_call_keys(spec_j)
        mult = jnoise.transmission_error(
            kc, qw.wq.shape, spec_j.mr(), spec_j.fpv_sigma, fpv_key=kf,
            drift_nm=drift, wander_sigma_nm=spec_j.wander_sigma_nm)
        j = jops.photonic_matmul_prequant_noisy(
            jnp.asarray(x), jnp.asarray(qw.wq.numpy()),
            jnp.asarray(qw.scale.numpy().reshape(-1)), mult,
            jnoise.shot_key(kc), shot_sigma=spec_j.shot_sigma, adc_bits=8)
        t = tops.photonic_matmul_prequant_noisy(
            torch.from_numpy(x), qw.wq, qw.scale.reshape(-1),
            tnoise.next_call_keys(spec_t), spec_t)
    assert t.shape == (2, 5, 48)
    assert _rel(j, t.numpy()) <= 1e-5


@pytest.mark.parametrize("backend", ["bf16", "qat", "photonic_sim",
                                     "photonic_pallas"])
@pytest.mark.parametrize("cached", [False, True])
def test_noisy_matmul_matches_reference(backend, cached):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    tw = torch.from_numpy(w)
    tw = tbackend.quantize_weight(tw) if cached else tw
    jw = (jbackend.quantize_weight(jnp.asarray(w)) if cached
          else jnp.asarray(w))
    jp = jbackend.ExecPolicy(quant_bits=8, backend=backend, training=False,
                             noise=jnoise.NoiseSpec(**SPEC))
    tp = tbackend.ExecPolicy(quant_bits=8, backend=backend,
                             noise=tnoise.NoiseSpec(**SPEC))
    js, ts = _states(1, 0.03)
    with jnoise.noise_scope(js), tnoise.noise_scope(ts):
        j = np.asarray(jbackend.matmul(jnp.asarray(x), jw, jp))
        t = tbackend.matmul(torch.from_numpy(x), tw, tp)
    assert _rel(j, t.numpy()) <= 1e-5
    clean = tbackend.matmul(torch.from_numpy(x), tw, tp.without_noise())
    assert not torch.equal(clean, t)


# -- the encodes --------------------------------------------------------------------

def _cfgs(backend="photonic_sim", attn="flash"):
    jcfg = _smoke_cfg(backend, attn, "xla").with_(
        noise=jnoise.NoiseSpec(**SPEC))
    tcfg = tserver.smoke_cfg().with_(matmul_backend=backend,
                                     attn_backend=attn, ffn_backend="xla",
                                     noise=tnoise.NoiseSpec(**SPEC))
    return jcfg, tcfg


def _jpolicy(jcfg, plan):
    p = jbackend.ExecPolicy.from_cfg(jcfg, training=False)
    p.bit_plan = plan
    return p


def _discriminates(ref_f, ref_next, port):
    corr = np.corrcoef(np.ravel(ref_f), np.ravel(port))[0, 1]
    same = np.abs(np.asarray(ref_f) - port).max()
    step = np.abs(np.asarray(ref_f) - np.asarray(ref_next)).max()
    assert corr > 0.999, corr
    assert same < step / 4, (same, step)


@pytest.mark.parametrize("which", ["uniform", "plan"])
def test_noisy_forward_vit_matches_reference_at_one_state(weights, which):
    """forward_vit under one scope (embed, the clean gate, the encoder's
    runs, the head) draws the reference's noise at the same state, on the
    reference tests' noisy combination (photonic_pallas + xla + xla)."""
    plan = PLAN if which == "plan" else None
    tp, jp = weights[which]
    jcfg, tcfg = _cfgs("photonic_pallas", "xla")
    jpol = _jpolicy(jcfg, plan)
    tpol = tbackend.ExecPolicy.from_cfg(tcfg)
    tpol.bit_plan = plan
    frames = VideoStream(img_size=32, patch=8, cut_every=8).frames_at(
        0, 4)["frames"]
    fwd = jax.jit(lambda p, im, ns: jnoise.scoped(
        ns, lambda: jvit.forward_vit(p, im, jcfg, jpol)[0]))
    (j3, t3), (j4, _) = _states(3), _states(4)
    ref_f = fwd(jp, jnp.asarray(frames), j3)
    ref_next = fwd(jp, jnp.asarray(frames), j4)
    with tnoise.noise_scope(t3):
        port = tvit.forward_vit(tp, torch.from_numpy(frames), tcfg, tpol,
                                device="cpu")[0].numpy()
    _discriminates(ref_f, ref_next, port)


@pytest.mark.parametrize("which", ["uniform", "plan"])
def test_noisy_server_encode_matches_reference_at_one_state(weights, which):
    """The port server's encode at its DriftState (written into its state
    tensor, a fresh scope) against the reference server's encode entry
    (its noisy jit of forward_vit_tokens under ``scoped``)."""
    plan = PLAN if which == "plan" else None
    _, jp = weights[which]
    jcfg, tcfg = _cfgs()
    srv = tserver.StreamServer(
        tcfg, tserver.ServerConfig(warm_start=False, bit_plan=plan or ()),
        params=weights["traw"], device="cpu")
    jpol = _jpolicy(jcfg, srv.policy.bit_plan)
    enc = jax.jit(lambda p, t, ns: jnoise.scoped(
        ns, lambda: jvit.forward_vit_tokens(p, t, jcfg, jpol)[0]))
    tokens = np.random.default_rng(9).standard_normal((4, 8, 64)).astype(
        np.float32)
    (j3, t3), (j4, t4) = _states(3), _states(4)
    ref_f = enc(jp, jnp.asarray(tokens), j3)
    ref_next = enc(jp, jnp.asarray(tokens), j4)
    srv.drift = t3
    port = srv._encode(8, torch.from_numpy(tokens)).clone()
    _discriminates(ref_f, ref_next, port.numpy())
    # a pinned state reproduces bitwise; the next frame draws anew
    assert torch.equal(srv._encode(8, torch.from_numpy(tokens)), port)
    srv.drift = t4
    assert not torch.equal(srv._encode(8, torch.from_numpy(tokens)), port)


# -- the mechanics of tests/test_robustness.py, on the port ---------------------------

def _tserve(weights, noise=None, n_frames=16, backend="photonic_sim",
            attn="flash"):
    cfg = tserver.smoke_cfg().with_(matmul_backend=backend, attn_backend=attn,
                                    ffn_backend="xla", noise=noise)
    srv = tserver.StreamServer(
        cfg, tserver.ServerConfig(warm_start=False, chunk=4, microbatch=2),
        params=weights["traw"], device="cpu")
    st = VideoStream(img_size=32, patch=8, seed=3, cut_every=8)
    s = srv.add_session(st, n_frames=n_frames)
    res = srv.serve()[s.sid]
    return [res.predictions[i] for i in range(n_frames)], srv, res


def test_noisy_forward_requires_scope_and_differs_from_clean(weights):
    tp, _ = weights["uniform"]
    _, tcfg = _cfgs()
    frames = torch.from_numpy(VideoStream(img_size=32, patch=8).frames_at(
        0, 2)["frames"])
    with pytest.raises(RuntimeError, match="no noise scope"):
        tvit.forward_vit(tp, frames, tcfg, device="cpu")
    noisy = tnoise.scoped(tnoise.DriftState.init(0), lambda: tvit.forward_vit(
        tp, frames, tcfg, device="cpu")[0])
    clean = tvit.forward_vit(tp, frames, tcfg.with_(noise=None),
                             device="cpu")[0]
    assert not torch.equal(noisy, clean)
    assert np.corrcoef(noisy.ravel(), clean.ravel())[0, 1] > 0.9


def test_policy_gate_fingerprint_and_fused_refusals(weights):
    spec = tnoise.NoiseSpec()
    p = tbackend.ExecPolicy(backend="photonic_pallas", noise=spec)
    assert p.gate_policy().noise is None
    pg = tbackend.ExecPolicy(backend="photonic_pallas",
                             noise=tnoise.NoiseSpec(noisy_gate=True))
    assert pg.gate_policy() is pg
    clean = tbackend.ExecPolicy(backend="photonic_pallas")
    assert clean.without_noise() is clean
    assert clean.fingerprint() != p.fingerprint()
    assert p.without_noise().fingerprint() == clean.fingerprint()
    assert "noise=on" in repr(p)
    # the fused entries refuse noise, the noise reason first (the
    # reference warns and composes)
    tp, _ = weights["uniform"]
    x = torch.zeros(1, 3, 64)
    pol = tbackend.ExecPolicy(8, "photonic_pallas", "flash", "fused",
                              noise=spec)
    blk = tvit.layer_view(tp["blocks"], 0)
    with tnoise.noise_scope(tnoise.DriftState.init(0)):
        with pytest.raises(ValueError, match="noise"):
            tbackend.ffn(x, blk["ffn"]["w1"], blk["ffn"]["b1"],
                         blk["ffn"]["w2"], blk["ffn"]["b2"], pol)
        from repro_torch.core.decomposed_attention import mhsa_standard
        with pytest.raises(ValueError, match="noise"):
            mhsa_standard(x, blk["attn"], 4, pol)
    assert "noise" in tvit._fused_encoder_ineligible_reason(
        tp, tserver.smoke_cfg(), pol)


@pytest.fixture(scope="module")
def nodrift(weights):
    """One 16-frame serve under the default NoiseSpec (no drift), read by
    the routing and the recalibration tests."""
    return _tserve(weights, noise=tnoise.NoiseSpec())


def test_noisy_serving_routes_like_clean_and_gate_stays_clean(weights,
                                                              nodrift):
    preds_c, _, res_c = _tserve(weights)
    preds_n, srv, res_n = nodrift
    assert srv.noise is not None and srv.drift.frame == 16
    assert res_n.bucket_hits == res_c.bucket_hits
    assert res_n.scored_frames == res_c.scored_frames
    assert len(preds_n) == len(preds_c) == 16
    assert np.mean(np.equal(preds_n, preds_c)) >= 0.5


def test_drift_triggered_recalibration_bills_and_keeps_the_cache(weights,
                                                                nodrift):
    spec = tnoise.NoiseSpec(drift_rate_nm=0.01, recal_bound_nm=0.08)
    _, srv, res = _tserve(weights, noise=spec)
    assert srv.recalibrations >= 1
    assert res.recalibrations == srv.recalibrations
    assert srv._host_drift_nm < spec.recal_bound_nm
    assert float(srv.drift.drift_nm) < spec.recal_bound_nm
    _, _, res_nodrift = nodrift
    assert res.frames == res_nodrift.frames and res_nodrift.recalibrations == 0
    assert res.mean_frame_uj > res_nodrift.mean_frame_uj
    # the live cache already is the re-tuning's re-derivation from the raw
    # weights, and stays: same tensors (a CUDA graph reads them), same values
    wq = srv.params["blocks"]["attn"]["wq"]
    ptr, before = wq.wq.data_ptr(), wq.wq.clone()
    assert torch.equal(srv._prepare(None)["blocks"]["attn"]["wq"].wq, before)
    srv.recalibrate()
    assert srv.params["blocks"]["attn"]["wq"].wq.data_ptr() == ptr
    assert torch.equal(srv.params["blocks"]["attn"]["wq"].wq, before)


def test_inject_drift_requires_noise_and_recalibration_resets(weights):
    _, srv, _ = _tserve(weights, n_frames=4)
    with pytest.raises(ValueError, match="noise"):
        srv.inject_drift(0.5)
    cfg = tserver.smoke_cfg().with_(
        matmul_backend="photonic_sim", ffn_backend="xla",
        noise=tnoise.NoiseSpec(recal_bound_nm=0.2))
    srv = tserver.StreamServer(cfg, tserver.ServerConfig(warm_start=False),
                               params=weights["traw"], device="cpu")
    srv.inject_drift(0.5)
    assert srv._host_drift_nm == pytest.approx(0.5)
    srv._advance_drift(1)
    assert srv.recalibrations == 1 and srv._host_drift_nm == 0.0
    assert float(srv.drift.drift_nm) == 0.0


def test_retune_report_matches_reference():
    jcfg = _smoke_cfg("photonic_pallas")
    tcfg = tserver.smoke_cfg()
    for lb in (None, (4,) * 4, PLAN):
        j, t = jacct.retune_report(jcfg, lb), tacct.retune_report(tcfg, lb)
        for f in dataclasses.fields(j):
            a, b = getattr(j, f.name), getattr(t, f.name)
            assert abs(a - b) <= 1e-12 * max(abs(a), 1.0), (lb, f.name)
    assert 0 < tacct.retune_report(tcfg, (4,) * 4).total_uj \
        < tacct.retune_report(tcfg).total_uj


# -- the CLIs ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _parsed(monkeypatch, mod, argv):
    """The (config, ServerConfig) a CLI's ``main`` builds from ``argv``:
    its StreamServer is replaced by a stub that records them and stops."""
    got = {}

    def stub(cfg, sc, *a, **k):
        got["cfg"], got["sc"] = cfg, sc
        raise _Stop

    monkeypatch.setattr(mod, "StreamServer", stub)
    with pytest.raises(_Stop):
        mod.main(argv)
    return got["cfg"], got["sc"]


CLI_ARGV = [
    ["--variant", "tiny", "--img-size", "96", "--backend", "photonic_sim",
     "--attn-backend", "flash", "--ffn-backend", "xla", "--buckets",
     "0.5,1.0", "--mask-refresh", "4", "--delta-threshold", "0.3",
     "--chunk", "4", "--microbatch", "2", "--one-shape", "--max-wait", "2",
     "--noise", "--fpv-sigma", "0.02", "--shot-sigma", "0.001",
     "--q-factor", "4000", "--drift-rate-nm", "0.01", "--wander-sigma-nm",
     "0.005", "--recal-bound-nm", "0.1", "--adc-quant", "--noise-seed", "3"],
    ["--variant", "small", "--img-size", "64", "--backend",
     "photonic_pallas", "--attn-backend", "xla", "--ffn-backend", "xla",
     "--mix-streams", "--bit-plan", "8,6", "--noise"],
]
CFG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "d_ff", "img_size",
              "patch", "mgnet", "mgnet_embed", "mgnet_heads", "quant_bits",
              "matmul_backend", "attn_backend", "ffn_backend")


@pytest.mark.parametrize("argv", CLI_ARGV, ids=["noise-flags", "plan"])
def test_server_cli_parses_as_the_reference(monkeypatch, argv):
    jcfg, jsc = _parsed(monkeypatch, jserver, argv + ["--mesh", "off"])
    tcfg, tsc = _parsed(monkeypatch, tserver, argv)
    for f in CFG_FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(tcfg.noise) == dataclasses.asdict(jcfg.noise)
    for f in dataclasses.fields(tsc):
        if hasattr(jsc, f.name):
            assert getattr(tsc, f.name) == getattr(jsc, f.name), f.name
    args = tserver.build_parser().parse_args(["--cut-every", "12"])
    assert args.cut_every == 12 and (args.variant, args.img_size) == (
        "base", 224)


def test_engine_cli_takes_the_model(monkeypatch):
    got = {}

    class Stub:
        def __init__(self, cfg, *a, **k):
            got["cfg"] = cfg
            raise _Stop

    monkeypatch.setattr(tengine, "ServingEngine", Stub)
    with pytest.raises(_Stop):
        tengine.main(["--variant", "tiny", "--img-size", "96"])
    assert (got["cfg"].d_model, got["cfg"].img_size) == (192, 96)


@pytest.mark.parametrize("argv", [
    ["--smoke", "--backend", "photonic_sim", "--ffn-backend", "xla",
     "--noise", "--drift-rate-nm", "0.02", "--recal-bound-nm", "0.1"],
    ["--variant", "tiny", "--img-size", "96", "--streams", "1"],
], ids=["smoke-noise", "tiny-96"])
def test_server_cli_serves_on_cpu(argv, capsys):
    res = tserver.main(argv + ["--device", "cpu", "--frames", "8",
                               "--json", "--no-warm-start"])
    assert res and all(r.frames == 8 for r in res.values())
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    if "--noise" in argv:
        # 2 streams x 8 frames at 0.02 nm a frame cross 0.1 nm twice
        assert summary["noise"]["recalibrations"] == 2
        assert summary["recalibrations"] == [2, 2]
    else:
        assert summary["noise"] is None
