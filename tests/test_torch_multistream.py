"""The port's multi-stream serving against the JAX reference's, on the CPU.

Each comparison serves the same ``VideoStream``s on the same params: the
reference's own, drawn by its ``StreamServer`` (seed 0) on the smoke
config of the fused serving point and bridged into the port with
``from_jax_params``. One reference server serves every reference run of
the file, reconfigured between serves (its loop reads ``serve_cfg`` at
every serve and session), so its jitted stages compile once.

Tolerances, and why:

- within the port (interleaved vs sequential, warm vs cold): bitwise.
  Session-pure micro-batches give every launch the frames a solo run
  co-batches, so each per-launch absmax scope and every float op repeat.
- routing, scheduling and accounting against the reference (bucket hits,
  launches, scored frames, ``flush_log``, ``interleave_rounds``,
  ``flush_stale``, ``BucketLadder.trim``, ``calibrate_trim``): exact. They
  are host-side integer decisions on the same scores.
- the accelerator model (``bucket_report``, ``mgnet_report``,
  ``StreamAccounting``, a served ``StreamResult``'s KFPS/W and energy):
  1e-12 relative. It is float arithmetic over the same integer shapes in
  the same order; 1e-12 only allows for a summation order.
- predictions against the reference: at least 90% agreement, the
  reference's own quantized-vs-float class. PyTorch's and XLA's GELU,
  LayerNorm and softmax differ by ulps, and a requantization can flip a
  code at a rounding boundary (ROADMAP.md, "How parity is held").
- one-shape against gathered within the port: at least 90% as well (the
  cap-size tensor carries dead rows into every per-launch absmax).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.configs.opto_vit import get_config as jget_config
from repro.core import backend as jbackend
from repro.data.pipeline import video_fleet as jfleet
from repro.serving import accounting as jacct
from repro.serving.buckets import BucketLadder as JLadder
from repro.serving.engine import _smoke_cfg
from repro.serving.scheduler import MicroBatcher as JBatcher
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import StreamServer as JServer
from repro.serving.server import interleave_rounds as jinterleave
from repro_torch.bridge import from_jax_params
from repro_torch.data.pipeline import prefetch_to_device, video_fleet
from repro_torch.kernels import _build
from repro_torch.serving import accounting as tacct
from repro_torch.serving import server as tserver
from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import MicroBatcher
from repro_torch.serving.session import ServingConfig, StreamSession

N_FRAMES, PHASE = 32, 4
REPORT_FIELDS = ("tuning_uj", "vcsel_uj", "bpd_uj", "adc_uj", "dac_uj",
                 "memory_uj", "epu_uj", "optical_us", "epu_us", "memory_us")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def _fleet(n=2):
    return video_fleet(n, img_size=32, patch=8, seed=0, cut_every=16)


def _log(flush_log, sid0):
    """A flush log with owners counted from the first session's sid."""
    return [(tuple(o - sid0 for o in owners), k, n)
            for owners, k, n in flush_log]


@pytest.fixture(scope="module")
def ref():
    """The reference's server (one-shape encoders built, so the same
    server also serves one-shape runs), its params bridged into the port,
    and a memo of its serves by knobs."""
    jsrv = JServer(_smoke_cfg("photonic_pallas", "flash", "fused"),
                   JServerConfig(microbatch=4, chunk=8, mesh="off",
                                 warm_start=False, one_shape=True),
                   n_classes=10, seed=0)
    base = dataclasses.replace(jsrv.serve_cfg, one_shape=False)

    @functools.lru_cache(maxsize=None)
    def serve(**knobs):
        jsrv.serve_cfg = dataclasses.replace(base, **knobs)
        fleet = jfleet(2, img_size=32, patch=8, seed=0, cut_every=16)
        sessions = [jsrv.add_session(st, n_frames=N_FRAMES, start=PHASE * i)
                    for i, st in enumerate(fleet)]
        res = jsrv.serve()
        return ([res[s.sid] for s in sessions],
                _log(jsrv.flush_log, sessions[0].sid))

    return {"serve": serve,
            "params": from_jax_params(_np_tree(jsrv._raw_params), "cpu")}


def _tserve(params, n=2, **knobs):
    """The port's server on the CPU: ``n`` streams of the fleet, phase 4;
    returns (results in stream order, flush log, server)."""
    srv = tserver.StreamServer(
        tserver.smoke_cfg(), tserver.ServerConfig(microbatch=4, chunk=8,
                                                  **knobs),
        params=params, device="cpu")
    sessions = [srv.add_session(st, n_frames=N_FRAMES, start=PHASE * i)
                for i, st in enumerate(_fleet(n))]
    res = srv.serve()
    return [res[s.sid] for s in sessions], _log(srv.flush_log,
                                                 sessions[0].sid), srv


def _agree(a, b) -> float:
    assert set(a) == set(b)
    return np.mean([a[i] == b[i] for i in a])


def _same_routing(t, j):
    assert t.bucket_hits == j.bucket_hits
    assert t.bucket_launches == j.bucket_launches
    assert (t.scored_frames, t.reused_frames) == (j.scored_frames,
                                                  j.reused_frames)
    assert t.frames == j.frames == N_FRAMES


def _same_energy(t, j):
    for f in ("kfps_per_watt", "mean_frame_uj", "dense_kfps_per_watt",
              "mean_bits"):
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-12), f


# --------------------------------------------------------------------------
# within the port: interleaved vs sequential, warm start
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_streams", [2, 3])
def test_interleaved_matches_sequential_bitwise(ref, n_streams):
    """The reference's _parity_case on the port: interleaved serving equals
    N solo ``ServingEngine`` runs per stream, bitwise."""
    fleet = _fleet(n_streams)
    seq = [ServingEngine(tserver.smoke_cfg(), ServingConfig(microbatch=4,
                                                            chunk=8),
                         params=ref["params"], device="cpu").run(
        st, n_frames=N_FRAMES, start=PHASE * i) for i, st in enumerate(fleet)]
    res, _, srv = _tserve(ref["params"], n=n_streams)
    assert srv.warmed == set(srv.ladder.sizes)
    for r, s in zip(res, seq):
        assert r.predictions == s.predictions
        assert r.bucket_hits == s.bucket_hits
        assert r.bucket_launches == s.bucket_launches
        assert r.scored_frames == s.scored_frames
        assert r.mean_frame_uj == s.mean_frame_uj


def test_warm_start_is_numerics_neutral(ref):
    cold, _, cold_srv = _tserve(ref["params"], warm_start=False)
    warm, _, warm_srv = _tserve(ref["params"])
    assert cold_srv.warm_s == 0.0 and not cold_srv.warmed
    assert warm_srv.warm_s > 0
    assert warm_srv.warmed == set(warm_srv.ladder.sizes)
    assert warm_srv.graphs == {}        # CUDA graphs only on the card
    for c, w in zip(cold, warm):
        assert c.predictions == w.predictions
        assert c.bucket_hits == w.bucket_hits


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def test_gathered_serve_and_its_energy_match_reference(ref):
    jres, jlog = ref["serve"]()
    tres, tlog, _ = _tserve(ref["params"])
    assert tlog == jlog
    for t, j in zip(tres, jres):
        _same_routing(t, j)
        _same_energy(t, j)
        assert _agree(t.predictions, j.predictions) >= 0.9


def test_max_wait_flush_log_matches_reference(ref):
    """A deadline of one round pad-flushes mid-stream exactly where the
    reference does; padding reaches no frame count, prediction or energy
    (routing happens before batching, so each stream's modeled energy is
    the no-deadline run's)."""
    jres, jlog = ref["serve"](max_wait_chunks=1)
    tres, tlog, _ = _tserve(ref["params"], max_wait_chunks=1)
    free, free_log, _ = _tserve(ref["params"])
    assert tlog == jlog
    assert tlog != free_log
    assert (sum(n < 4 for _, _, n in tlog)
            > sum(n < 4 for _, _, n in free_log))
    for t, j, f in zip(tres, jres, free):
        _same_routing(t, j)
        _same_energy(t, j)
        assert sorted(t.predictions) == sorted(f.predictions)
        assert t.bucket_hits == f.bucket_hits
        assert t.mean_frame_uj == pytest.approx(f.mean_frame_uj, rel=1e-12)


def test_mix_streams_owners_match_reference(ref):
    jres, jlog = ref["serve"](mix_streams=True)
    tres, tlog, _ = _tserve(ref["params"], mix_streams=True)
    assert tlog == jlog
    assert any(len(owners) > 1 for owners, _, _ in tlog)
    for t, j in zip(tres, jres):
        _same_routing(t, j)
        _same_energy(t, j)


def test_one_shape_matches_reference(ref):
    jres, jlog = ref["serve"](one_shape=True)
    tres, tlog, _ = _tserve(ref["params"], one_shape=True)
    gathered, _, _ = _tserve(ref["params"])
    assert tlog == jlog
    for t, j, g in zip(tres, jres, gathered):
        _same_routing(t, j)
        assert _agree(t.predictions, j.predictions) >= 0.9
        assert _agree(t.predictions, g.predictions) >= 0.9


def test_force_bucket_pins_routing(ref):
    jres, jlog = ref["serve"](force_bucket=0.5)
    tres, tlog, srv = _tserve(ref["params"], force_bucket=0.5)
    assert tlog == jlog
    assert {k for _, k, _ in tlog} == {8}
    for t, j in zip(tres, jres):
        assert t.bucket_hits == {4: 0, 8: N_FRAMES, 12: 0, 16: 0}
        _same_routing(t, j)


def test_interleave_depth_serves_the_same_frames(ref):
    d1, log1, _ = _tserve(ref["params"])
    d2, log2, _ = _tserve(ref["params"], interleave_depth=2)
    assert sorted(log1) == sorted(log2)
    for a, b in zip(d1, d2):
        assert a.predictions == b.predictions


@pytest.mark.parametrize("depth", [1, 2])
def test_interleave_rounds_matches_reference(depth):
    for groups in ([[1, 2, 3], [4], [], [5, 6]], [], [[], []],
                   [["a1", "a2", "a3"], ["b1"]], [[], ["b1", "b2"], ["c1"]],
                   [[1, 2, 3, 4, 5], [6, 7, 8], [9]]):
        assert tserver.interleave_rounds(groups, depth) == jinterleave(
            groups, depth)
    with pytest.raises(ValueError):
        tserver.interleave_rounds([[1]], 0)


def test_flush_stale_order_and_padding_match_reference():
    """Oldest queue first, ties by str(key); each flush zero-padded to the
    micro-batch; rows and groups mixed; queues younger than the deadline
    untouched."""
    rng = np.random.default_rng(0)
    pushes = [("many", (8, 1), 2, 3), ("row", (16, 0), 1, 1),
              ("many", (8, 0), 1, 1), ("row", (8, 0), 1, 2),
              ("many", (4, 1), 1, 5), ("many", (16, 0), 2, 1)]
    jmb, tmb = JBatcher(4), MicroBatcher(4)
    idx = 0
    for kind, key, m, now in pushes:
        x = rng.standard_normal((m, 3, 2)).astype(np.float32)
        ids = list(range(idx, idx + m))
        idx += m
        if kind == "row":
            jmb.push(key, x[0], ids[0], now=now)
            tmb.push(key, torch.from_numpy(x[0]), ids[0], now=now)
        else:
            jmb.push_many(key, x, ids, now=now)
            tmb.push_many(key, torch.from_numpy(x), ids, now=now)
    assert tmb.pending_keys() == jmb.pending_keys()
    assert [tmb.rows(k) for k in tmb.pending_keys()] == [
        jmb.rows(k) for k in jmb.pending_keys()]
    assert tmb.flush_stale(0) == [] == jmb.flush_stale(0)
    for deadline in (1, 3, 5):
        got, want = tmb.flush_stale(deadline), jmb.flush_stale(deadline)
        assert [fb.bucket for fb in got] == [fb.bucket for fb in want]
        for g, w in zip(got, want):
            assert (g.frame_idx, g.n_real) == (w.frame_idx, w.n_real)
            assert tuple(g.tokens.shape) == (4, 3, 2)
            np.testing.assert_array_equal(g.tokens.numpy(),
                                          np.asarray(w.tokens))
            assert not g.tokens[g.n_real:].any()
        assert tmb.pending == jmb.pending
    assert tmb.pending == 0


def test_calibrate_trim_matches_reference(ref):
    """The removed set equals the reference's, with its UserWarning, and a
    warm start after it warms only the surviving buckets."""
    jsrv = JServer(_smoke_cfg("photonic_pallas", "flash", "fused"),
                   JServerConfig(microbatch=4, chunk=8, mesh="off",
                                 warm_start=False), n_classes=10, seed=0)
    tsrv = tserver.StreamServer(
        tserver.smoke_cfg(), tserver.ServerConfig(microbatch=4, chunk=8,
                                                  warm_start=False),
        params=ref["params"], device="cpu")
    assert tsrv.calibrate_trim() == ()          # no sessions: no evidence
    for srv, fleet in ((jsrv, jfleet(2, 32, 8, seed=0, cut_every=16)),
                       (tsrv, _fleet())):
        for st in fleet:
            srv.add_session(st, n_frames=16)
    with pytest.warns(UserWarning, match="calibrate_trim dropped"):
        want = jsrv.calibrate_trim()
    with pytest.warns(UserWarning, match="calibrate_trim dropped"):
        got = tsrv.calibrate_trim()
    assert got == want and got
    assert tsrv.ladder.sizes == jsrv.ladder.sizes
    tsrv.warm_start()
    assert tsrv.warmed == set(tsrv.ladder.sizes)
    for res in tsrv.serve().values():
        assert set(res.bucket_hits) == set(tsrv.ladder.sizes)
        assert sum(res.bucket_hits.values()) == 16


def test_ladder_trim_matches_reference():
    for sizes, dead, keep_cap in (((9, 18, 27, 36), (9, 27), True),
                                  ((9, 18, 36), (18, 36), True),
                                  ((9, 18, 36), (18, 36), False),
                                  ((9, 18, 36), (99,), True),
                                  ((4, 8, 12, 16), (4, 8, 12, 16), True)):
        got = BucketLadder(sizes).trim(dead, keep_cap=keep_cap)
        assert got.sizes == JLadder(sizes).trim(dead,
                                                keep_cap=keep_cap).sizes
    t = BucketLadder((9, 18, 27, 36)).trim((9, 27))
    assert t.route(5) == 18 and t.route(20) == 36
    for lad in (BucketLadder((9, 18, 36)), JLadder((9, 18, 36))):
        with pytest.raises(ValueError):
            lad.trim((9, 18, 36), keep_cap=False)


# --------------------------------------------------------------------------
# accounting (A16)
# --------------------------------------------------------------------------

def _reports_equal(t, j):
    for f in REPORT_FIELDS:
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-12), f
    assert t.total_uj == pytest.approx(j.total_uj, rel=1e-12)


@pytest.mark.parametrize("variant", ["base-224", "smoke"])
def test_accounting_matches_reference(variant):
    if variant == "smoke":
        tcfg = tserver.smoke_cfg()
        jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    else:
        tcfg = tserver.serving_cfg("base", 224)
        jcfg = jget_config("base", img_size=224, mgnet=True)
    n = (tcfg.img_size // tcfg.patch) ** 2
    ladder = BucketLadder.from_fractions(n, (0.25, 0.5, 0.75, 1.0)).sizes
    for k in ladder:
        _reports_equal(tacct.bucket_report(tcfg, k),
                       jacct.bucket_report(jcfg, k))
    _reports_equal(tacct.mgnet_report(tcfg), jacct.mgnet_report(jcfg))
    ta = tacct.StreamAccounting(tcfg, ladder_sizes=ladder)
    ja = jacct.StreamAccounting(jcfg, ladder_sizes=ladder)
    for op, k, m in (("mgnet", 0, 3), ("encode", ladder[1], 4),
                     ("encode", ladder[-1], 2), ("mgnet", 0, 1),
                     ("encode", ladder[1], 3)):
        for a in (ta, ja):
            a.add_mgnet(m) if op == "mgnet" else a.add_encode(k, m)
    _reports_equal(ta.total, ja.total)
    _reports_equal(ta.mean_frame, ja.mean_frame)
    assert ta.kfps_per_watt == pytest.approx(ja.kfps_per_watt, rel=1e-12)
    assert ta.dense_baseline_kfps_per_watt() == pytest.approx(
        ja.dense_baseline_kfps_per_watt(), rel=1e-12)
    assert ta.dead_buckets() == ja.dead_buckets() == (ladder[0], ladder[2])
    assert ta.summary(warn=False) == ja.summary(warn=False)
    with pytest.warns(UserWarning, match="dead ladder buckets"):
        ta.summary()
    # under a per-layer bit plan (A10): each layer billed at its width
    plan = tuple(8 if i % 3 == 0 else 6 - 2 * (i % 2)
                 for i in range(tcfg.n_layers))
    tp = tacct.StreamAccounting(tcfg, ladder_sizes=ladder, layer_bits=plan)
    jp = jacct.StreamAccounting(jcfg, ladder_sizes=ladder, layer_bits=plan)
    for a in (tp, jp):
        a.add_mgnet(2)
        a.add_encode(ladder[1], 4)
        a.add_encode(ladder[-1], 1)
    _reports_equal(tp.total, jp.total)
    assert tp.kfps_per_watt == pytest.approx(jp.kfps_per_watt, rel=1e-12)


# --------------------------------------------------------------------------
# ingest, launch counts, engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_keeps_order_with_host_view(depth):
    st = video_fleet(1, img_size=32, patch=8, seed=5)[0]
    chunks = [st.frames_at(8 * i, 8) for i in range(5)]
    out = list(prefetch_to_device(iter(chunks), depth=depth,
                                  keys=("frames",), device="cpu"))
    assert len(out) == len(chunks)
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got["frame_idx"], want["frame_idx"])
        assert got["frames_host"] is want["frames"]
        assert isinstance(got["frames"], torch.Tensor)
        np.testing.assert_array_equal(got["frames"].numpy(), want["frames"])
        np.testing.assert_array_equal(got["patch_mask"], want["patch_mask"])
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter(chunks), depth=0))


@pytest.mark.parametrize("entry", ["prefetch_to_device", "StreamSession"])
def test_no_card_and_no_device_raises(monkeypatch, entry):
    """Both run on the card unless the caller asks for the CPU: with no
    card and no ``device`` they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = video_fleet(1, img_size=32, patch=8, seed=5)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "prefetch_to_device":
            next(prefetch_to_device(iter([st.frames_at(0, 8)])))
        else:
            StreamSession(0, st, 8, 0, ServingConfig(), tserver.smoke_cfg())


def test_launch_counts_of_a_capture_move_to_its_replays():
    """What a capture counts is taken back out of LAUNCHES and added again
    at every replay, so a graphed encode counts what an eager one does."""
    saved = _build.LAUNCHES.copy()
    try:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update({"photonic_matmul": 5, "fused_ffn": 1})
        with _build.captured_launches() as graph:
            _build.LAUNCHES["photonic_matmul"] += 3
            _build.LAUNCHES["flash_attention_masked"] += 2
        assert graph == {"photonic_matmul": 3, "flash_attention_masked": 2}
        assert _build.LAUNCHES == {"photonic_matmul": 5, "fused_ffn": 1}
        for _ in range(2):
            _build.add_replay(graph)
        assert _build.LAUNCHES == {"photonic_matmul": 11, "fused_ffn": 1,
                                   "flash_attention_masked": 4}
        with pytest.raises(RuntimeError):
            with _build.captured_launches():
                _build.LAUNCHES["fused_ffn"] += 1
                raise RuntimeError("capture failed")
        assert _build.LAUNCHES["fused_ffn"] == 1
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_engine_shim_and_run_dense(ref):
    eng = ServingEngine(tserver.smoke_cfg(), params=ref["params"],
                        device="cpu")
    assert eng.server.serve_cfg.warm_start is False and not eng.server.warmed
    res = eng.run(_fleet(1)[0], n_frames=8)
    assert res.frames == 8 and res.kfps_per_watt > 0
    dense = eng.run_dense(_fleet(1)[0], n_frames=8)
    assert dense.frames == 8 and dense.bucket_hits == {eng.server.n_patches: 8}
    assert sorted(dense.predictions) == sorted(res.predictions)
    assert dense.scored_frames == res.scored_frames
    assert dense.mean_frame_uj > res.mean_frame_uj


def test_server_cli_flags_on_cpu(capsys):
    res = tserver.main(["--smoke", "--device", "cpu", "--streams", "2",
                        "--frames", "16", "--phase", "4", "--one-shape",
                        "--max-wait", "1", "--trim-dead-buckets",
                        "--calib-frames", "8", "--chunk", "8",
                        "--microbatch", "4"])
    assert sorted(len(r.predictions) for r in res.values()) == [16, 16]
    out = capsys.readouterr().out
    assert "warm start" in out and "KFPS/W" in out
