"""The port's faults, checkpoints and migration (A13) on the CPU: within
the port against its own clean serves, and against the JAX reference's
injector, serve, snapshot and CLI.

Within the port the fused serving point serves 3 streams x 24 frames
(chunk 8, micro-batch 4) once in a module fixture; every faulted,
paused, restored or migrated serve of the same traffic is held to it.
Against the reference, both packages serve one numpy param tree
(``bridge.init_vit``) under ``bf16``; one reference server serves every
reference run, its fault spec and knobs swapped between serves.

Tolerances, and why:

- within the port (transient faults, quarantine against never-registered,
  checkpoint round trips clean and noisy, export / adopt,
  ``serve_with_restarts``): bitwise. A retried flush re-encodes the same
  rows; a snapshot keeps each queued row and its ``now`` tick, so every
  later launch holds the rows, and the absmax scope, it would have held.
- the injector against the reference's: exact. It is the same numpy
  ``SeedSequence`` hash of the same sites.
- ``poisoned`` / ``failure`` / ``retries`` / ``shed_frames``, routing, the
  snapshot's keys, its ``extra`` and each session's meta (cursors, mask
  cache counters, histogram, pending descriptors): exact. They are
  host-side integer decisions on the same scores. The accounting inside
  the meta: 1e-12 relative (the accelerator model's float sums, as in
  ``test_torch_multistream.py``). The compat block's policy fingerprint
  is each package's own tuple (the port's policy has fewer knobs), so it
  is left out of the comparison.
- predictions against the reference: at least 90% agreement, the serving
  tests' class (``test_torch_multistream.py``).
- the snapshot's queued token rows and the mask cache's MGNet scores
  against the reference's: 1e-5, the ulp class of the embed and the gate
  (PyTorch's and XLA's sums in another order); the cache's reference
  frame and the deferred frame ids: bitwise.
- ``drift/key``, ``drift/frame``, ``drift/nm``: bitwise (host numpy
  scalars advanced by the same frames).
"""

import dataclasses
import math
import os
import warnings

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_fallback import given, settings, st

import jax
import jax.numpy as jnp

from repro.core.noise import NoiseSpec as JNoiseSpec
from repro.data.pipeline import video_fleet as jfleet
from repro.serving import faults as jfaults
from repro.serving import server as jserver
from repro.serving.engine import _smoke_cfg
from repro.serving.scheduler import MicroBatcher as JBatcher
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.checkpoint.checkpoint import load_meta
from repro_torch.core.noise import NoiseSpec
from repro_torch.data.pipeline import video_fleet
from repro_torch.serving import server as tserver
from repro_torch.serving.faults import (FatalFault, FaultInjector, FaultSpec,
                                        ServeError, TransientFault,
                                        serve_with_restarts)
from repro_torch.serving.scheduler import MicroBatcher

N_FRAMES = 24
MB, CHUNK = 4, 8


def _fleet(n=3):
    return video_fleet(n, img_size=32, patch=8)


def _server(params, cfg=None, **kw):
    return tserver.StreamServer(
        cfg or tserver.smoke_cfg(),
        tserver.ServerConfig(microbatch=MB, chunk=CHUNK, **kw),
        params=params, device="cpu")


def _serve(srv, streams, n_frames=N_FRAMES, **kw):
    for st_ in streams:
        srv.add_session(st_, n_frames=n_frames)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return srv.serve(**kw)


def _preds(res, n=N_FRAMES):
    return np.array([res.predictions[i] for i in range(n)])


@pytest.fixture(scope="module")
def env():
    """One numpy param tree for both packages, and the port's clean serve
    of 3 streams x 24 frames at the fused serving point (predictions,
    results and flush log)."""
    raw = init_vit(0, tserver.smoke_cfg(), 10)
    params = from_jax_params(raw, "cpu")
    streams = _fleet()
    srv = _server(params)
    res = _serve(srv, streams)
    return {"raw": raw, "params": params, "streams": streams, "res": res,
            "preds": {sid: _preds(r) for sid, r in res.items()},
            "log": list(srv.flush_log)}


# --------------------------------------------------------------------------
# the injector against the reference's
# --------------------------------------------------------------------------

def _outcome(fn):
    """What one seam call does: its return value, or the class and message
    of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:              # noqa: BLE001 - the outcome itself
        return (type(e).__name__, str(e))


@settings(max_examples=25, deadline=None)
@given(rate=st.sampled_from([0.0, 0.15, 0.5, 1.0]),
       fatal=st.sampled_from([0.0, 0.1]),
       transient=st.integers(1, 3), seed=st.integers(0, 2 ** 31 - 1),
       hard=st.integers(-1, 2), crash=st.integers(-1, 3))
def test_injector_decisions_equal_the_reference(rate, fatal, transient, seed,
                                                hard, crash):
    kw = dict(flush_fault_rate=rate, flush_fatal_rate=fatal,
              ingest_fault_rate=rate / 2, checkpoint_fault_rate=rate,
              stall_rate=rate / 3, stall_s=0.01,
              transient_failures=transient, hard_fail_session=hard,
              hard_fail_at_chunk=1, crash_at_round=crash, seed=seed)
    t, j = FaultInjector(FaultSpec(**kw)), jfaults.FaultInjector(
        jfaults.FaultSpec(**kw))
    for inj_t, inj_j, call in (
            *[(t, j, lambda i, s=s, c=c, a=a: i.ingest(s, c, attempt=a))
              for s in range(3) for c in range(3) for a in range(2)],
            *[(t, j, lambda i, k=k, f=f, a=a: i.flush(k, (f % 3, f),
                                                      attempt=a))
              for k in (4, 16) for f in range(6) for a in range(3)],
            *[(t, j, lambda i, k=k, f=f: i.stall_s(k, (1, f)))
              for k in (8, 12) for f in range(6)],
            *[(t, j, lambda i, s=s: i.checkpoint_io(s)) for s in range(4)],
            *[(t, j, lambda i, r=r: i.round_tick(r)) for r in range(5)]):
        assert _outcome(lambda: call(inj_t)) == _outcome(
            lambda: call(inj_j))
    assert dict(t.injected) == dict(j.injected)
    assert t.report() == j.report()


def test_injector_transient_site_clears_and_hard_fail_targets_one():
    inj = FaultInjector(FaultSpec(flush_fault_rate=1.0,
                                  transient_failures=2))
    for attempt in (0, 1):
        with pytest.raises(TransientFault):
            inj.flush(8, (0, 0), attempt=attempt)
    inj.flush(8, (0, 0), attempt=2)
    assert inj.injected["flush_transient"] == 2
    inj = FaultInjector(FaultSpec(hard_fail_session=1, hard_fail_at_chunk=2))
    inj.ingest(0, 2)
    inj.ingest(1, 1)
    with pytest.raises(FatalFault, match="session 1"):
        inj.ingest(1, 2)


# --------------------------------------------------------------------------
# the scheduler's discard / export, the cache's and accounting's state
# --------------------------------------------------------------------------

def test_batcher_export_and_discard_match_the_reference():
    """The same pushes give the same exported entries (keys, frame ids,
    ticks, row flags, token values) in the same order, and pushing them
    back into an empty batcher rebuilds the same queues."""
    rng = np.random.default_rng(0)
    t, j = MicroBatcher(4), JBatcher(4)
    pushes = [((8, 0), 3, 0), ((4, 1), 1, 0), ((8, 0), 2, 1),
              ((12, 1), 2, 1), ((4, 1), 2, 2), ((8, 2), 1, 2)]
    for n, (key, m, now) in enumerate(pushes):
        x = rng.standard_normal((m, key[0], 2)).astype(np.float32)
        ids = [(key[1], 10 * n + i) for i in range(m)]
        t.push_many(key, torch.from_numpy(x), ids, now=now)
        j.push_many(key, jnp.asarray(x), ids, now=now)
    t.push((12, 1), torch.zeros(12, 2), (1, 99), now=3)
    j.push((12, 1), jnp.zeros((12, 2)), (1, 99), now=3)
    te, je = t.export(), j.export()
    assert [(k, ix, now, r) for k, _, ix, now, r in te] == [
        (k, ix, now, r) for k, _, ix, now, r in je]
    for (_, a, *_), (_, b, *_) in zip(te, je):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rebuilt = MicroBatcher(4)
    for k, x, ix, now, is_row in te:
        if is_row:
            rebuilt.push(k, x, ix[0], now=now)
        else:
            rebuilt.push_many(k, x, ix, now=now)
    assert rebuilt.queue_stats() == t.queue_stats()
    assert [(k, ix, now) for k, _, ix, now, _ in rebuilt.export()] == [
        (k, ix, now) for k, _, ix, now, _ in te]
    sel = lambda key: key[1] == 1                         # noqa: E731
    assert t.discard(sel) == j.discard(sel) > 0
    assert t.pending_keys() == j.pending_keys()


def test_session_state_round_trips(env):
    """``state_dict`` -> ``from_state`` keeps the mask cache's walk, the
    accounting and the histogram; the deferred predictions come back as
    host arrays that ``finish`` reads as it reads device tensors."""
    srv = _server(env["params"])
    for st_ in env["streams"][:2]:
        srv.add_session(st_, n_frames=N_FRAMES)
    assert srv.serve(max_rounds=2) == {}
    s = srv._sessions[0]
    arrays, meta = s.state_dict()
    back = tserver.StreamSession.from_state(
        arrays, meta, srv.serve_cfg, srv.cfg, ladder=srv.ladder,
        device="cpu")
    assert back.cache.state_dict()["ref_idx"] == s.cache.state_dict()[
        "ref_idx"]
    np.testing.assert_array_equal(back.cache._ref_frame, s.cache._ref_frame)
    assert back.acct.state_dict() == s.acct.state_dict()
    assert back.hist.as_dict() == s.hist.as_dict()
    assert back.finish(1.0).predictions == s.finish(1.0).predictions
    back.cache.reset()
    assert back.cache._ref_frame is None and back.cache.scored_frames == 0


# --------------------------------------------------------------------------
# hygiene, retries, quarantine, ServeError (within the port)
# --------------------------------------------------------------------------

def test_no_spec_no_injector_and_zero_spec_is_bitwise(env):
    srv = _server(env["params"])
    assert srv.faults is None and srv._injector is None
    armed = _server(env["params"], faults=FaultSpec(seed=9))
    res = _serve(armed, env["streams"])
    assert armed.flush_log == env["log"]
    for sid, want in env["preds"].items():
        np.testing.assert_array_equal(_preds(res[sid]), want)
        assert not res[sid].poisoned and res[sid].retries == 0
    assert armed._injector.report() == "no faults injected"


@pytest.mark.parametrize("spec", [
    FaultSpec(flush_fault_rate=0.3, seed=7),
    FaultSpec(ingest_fault_rate=0.3, seed=11)], ids=["flush", "ingest"])
def test_transient_faults_are_bitwise_transparent(env, spec):
    srv = _server(env["params"], faults=spec, retry_backoff_s=0.0)
    res = _serve(srv, env["streams"])
    assert sum(r.retries for r in res.values()) > 0
    for sid, want in env["preds"].items():
        assert not res[sid].poisoned and res[sid].frames == N_FRAMES
        np.testing.assert_array_equal(_preds(res[sid]), want)
    if spec.flush_fault_rate:
        assert srv.flush_log == env["log"]


def test_quarantine_equals_never_registered(env):
    """The victim comes back poisoned with a partial count, and no flush
    after its failure carries its frames; the survivors are bitwise a
    serve where it was never registered."""
    streams = env["streams"]
    srv = _server(env["params"], faults=FaultSpec(hard_fail_session=1,
                                                  hard_fail_at_chunk=1))
    real, late = srv._finish, []

    def watch(fb, by_sid):
        if by_sid[1].failed_reason and any(sid == 1 for sid, _ in
                                           fb.frame_idx):
            late.append(fb.frame_idx)
        return real(fb, by_sid)

    srv._finish = watch
    with pytest.warns(UserWarning, match="quarantined session"):
        for st_ in streams:
            srv.add_session(st_, n_frames=N_FRAMES)
        res = srv.serve()
    assert res[1].poisoned and "session 1" in res[1].failure
    assert 0 < res[1].frames < N_FRAMES and not late
    assert sum(1 in o for o, _, _ in srv.flush_log) == sum(
        res[1].bucket_launches.values())
    never = _serve(_server(env["params"]), [streams[0], streams[2]])
    for sid, nsid in ((0, 0), (2, 1)):
        assert not res[sid].poisoned
        np.testing.assert_array_equal(_preds(res[sid]), env["preds"][sid])
        np.testing.assert_array_equal(_preds(never[nsid]), env["preds"][sid])


def test_retry_exhaustion_fails_only_the_owner(env):
    spec = FaultSpec(flush_fault_rate=0.08, transient_failures=5, seed=2)
    srv = _server(env["params"], faults=spec, retry_limit=2,
                  retry_backoff_s=0.0)
    res = _serve(srv, env["streams"])
    poisoned = [sid for sid, r in res.items() if r.poisoned]
    assert poisoned and len(poisoned) < len(res)
    for sid, r in res.items():
        if r.poisoned:
            assert "retry limit (2) exhausted" in r.failure
        else:
            np.testing.assert_array_equal(_preds(r), env["preds"][sid])


def test_serve_error_attributes_and_carries_partials(env):
    streams = env["streams"]
    srv = _server(env["params"])
    srv.add_session(streams[0], n_frames=8)             # drains quickly
    s1 = srv.add_session(streams[1], n_frames=N_FRAMES)
    real = srv._finish

    def sabotage(fb, by_sid):
        if {sid for sid, _ in fb.frame_idx} == {s1.sid} and \
                s1.acct.frames >= 16:
            raise RuntimeError("device lost")
        return real(fb, by_sid)

    srv._finish = sabotage
    with pytest.raises(ServeError, match="device lost") as ei:
        srv.serve()
    e = ei.value
    assert "bucket k=" in str(e) and "round" in str(e)
    assert e.context["sessions"] == [s1.sid] and e.context["round"] >= 1
    assert e.context["bucket"] in srv.ladder.sizes
    assert list(e.partial_results) == [0]
    assert e.partial_results[0].frames == 8
    np.testing.assert_array_equal(_preds(e.partial_results[0], 8),
                                  env["preds"][0][:8])
    assert srv._sessions == [] and srv._inflight is None
    # the server serves the next sessions as a fresh one would
    del srv._finish
    res = _serve(srv, streams)
    for sid, r in zip(sorted(res), sorted(env["preds"])):
        np.testing.assert_array_equal(_preds(res[sid]), env["preds"][r])


# --------------------------------------------------------------------------
# checkpoints, migration, restarts (within the port)
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_is_bitwise(env, tmp_path):
    """Pause, checkpoint, restore into a fresh server: predictions,
    accounting and mask-cache behaviour are the uninterrupted serve's."""
    streams = env["streams"]
    srv = _server(env["params"])
    for st_ in streams:
        srv.add_session(st_, n_frames=N_FRAMES)
    assert srv.serve(max_rounds=1) == {}
    path = srv.checkpoint(root=str(tmp_path))
    meta = load_meta(path)
    assert meta["extra"]["rnd"] == 1 and any(
        s["pending"] for s in meta["extra"]["sessions"])
    srv2 = _server(env["params"])
    sessions = srv2.restore_checkpoint(str(tmp_path))
    assert sorted(sessions) == [0, 1, 2]
    res = srv2.serve()
    for sid, base in env["res"].items():
        np.testing.assert_array_equal(_preds(res[sid]), env["preds"][sid])
        for f in ("frames", "scored_frames", "reused_frames", "bucket_hits",
                  "bucket_launches", "mean_frame_uj"):
            assert getattr(res[sid], f) == getattr(base, f), f
    # the paused server resumes too, to the same predictions
    res_a = srv.serve()
    for sid in env["preds"]:
        np.testing.assert_array_equal(_preds(res_a[sid]), env["preds"][sid])


def _noisy_cfg():
    return tserver.smoke_cfg().with_(
        attn_backend="xla", ffn_backend="xla",
        noise=NoiseSpec(drift_rate_nm=0.002, seed=3))


def test_noisy_checkpoint_round_trip_is_bitwise(env, tmp_path):
    """Under device noise the server's DriftState round-trips: the resumed
    noisy serve is bitwise the uninterrupted one, and the restored server
    rewrites its state before the first noisy stage."""
    cfg, streams = _noisy_cfg(), env["streams"][:2]
    base = _serve(_server(env["params"], cfg, warm_start=False), streams,
                  n_frames=16)
    srv = _server(env["params"], cfg, warm_start=False)
    for st_ in streams:
        srv.add_session(st_, n_frames=16)
    assert srv.serve(max_rounds=1) == {}
    srv.checkpoint(root=str(tmp_path))
    srv2 = _server(env["params"], cfg, warm_start=False)
    srv2.restore_checkpoint(str(tmp_path))
    assert srv2.drift == srv.drift and srv2._written is None
    res = srv2.serve()
    for sid, r in base.items():
        np.testing.assert_array_equal(_preds(res[sid], 16), _preds(r, 16))
    assert int(srv2.drift.frame) == 32
    assert np.array_equal(srv2._state_t.numpy(), srv2._written)


def test_export_adopt_is_bitwise(env):
    streams = env["streams"]
    srv_a = _server(env["params"])
    for st_ in streams:
        srv_a.add_session(st_, n_frames=N_FRAMES)
    assert srv_a.serve(max_rounds=1) == {}
    snap = srv_a.export_session(1)
    assert snap["meta"]["sid"] == 1 and snap["meta"]["pending"]
    srv_b = _server(env["params"])
    srv_b.adopt_session(snap)
    res_b, res_a = srv_b.serve(), srv_a.serve()
    assert 1 not in res_a
    np.testing.assert_array_equal(_preds(res_b[1]), env["preds"][1])
    for sid in (0, 2):
        np.testing.assert_array_equal(_preds(res_a[sid]), env["preds"][sid])
    with pytest.raises(KeyError):
        srv_a.export_session(1)


def test_checkpoint_refused_under_mix_streams_and_on_mismatch(env, tmp_path):
    srv = _server(env["params"], mix_streams=True)
    srv.add_session(env["streams"][0], n_frames=8)
    with pytest.raises(ValueError, match="mix_streams"):
        srv.checkpoint(root=str(tmp_path))
    srv = _server(env["params"])
    srv.add_session(env["streams"][0], n_frames=8)
    srv.checkpoint(root=str(tmp_path))
    other = _server(env["params"], one_shape=True)
    with pytest.raises(ValueError, match="one_shape"):
        other.restore_checkpoint(str(tmp_path))


def test_checkpoint_fault_degrades(env, tmp_path):
    srv = _server(env["params"],
                  faults=FaultSpec(checkpoint_fault_rate=1.0, seed=4),
                  checkpoint_dir=str(tmp_path), checkpoint_every=1)
    res = _serve(srv, env["streams"])
    assert srv.checkpoint_failures > 0 and not os.listdir(tmp_path)
    for sid, want in env["preds"].items():
        np.testing.assert_array_equal(_preds(res[sid]), want)


def test_serve_with_restarts_resumes_bitwise(env, tmp_path):
    streams = env["streams"]
    built = []

    def make_server(attempt):
        faults = FaultSpec(crash_at_round=2, seed=5) if attempt == 0 else None
        built.append(_server(env["params"], faults=faults,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1))
        return built[-1]

    def register(srv):
        for st_ in streams:
            srv.add_session(st_, n_frames=N_FRAMES)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res, restarts, srv = serve_with_restarts(make_server, register,
                                                 str(tmp_path))
    assert restarts == 1 and srv is built[1]
    assert built[0]._injector.injected["crash"] == 1
    for sid, base in env["res"].items():
        np.testing.assert_array_equal(_preds(res[sid]), env["preds"][sid])
        assert res[sid].frames == base.frames


def test_load_shedding_counts_its_drops(env):
    srv = _server(env["params"], max_pending_rows=4)
    res = _serve(srv, env["streams"][:2])
    assert sum(r.shed_frames for r in res.values()) > 0
    for r in res.values():
        assert r.frames + r.shed_frames == N_FRAMES and not r.poisoned


class _FakeClock:
    """The server's ``time`` module on a clock that only the injected
    stalls (``sleep``) and a fixed step an encode advance: flush walls are
    then a pure function of the stalls, whatever the host's load."""

    STEP_S = 1e-3

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def __getattr__(self, name):          # anything else: the real module
        import time
        return getattr(time, name)


def test_injected_stalls_are_flagged(env, monkeypatch):
    """Every stall once the detector has its 10 samples is flagged (the
    flush index is the telemetry's ``seq``). The server reads a fake clock
    (``_FakeClock``): each encode advances it by 1 ms and each injected
    1 s stall by 1 s, so every clean flush's wall is 1 ms and every
    stalled one's 1.001 s, on any host; a real clock on a CPU shared with
    other test workers spreads a smoke flush's wall by hundreds of ms. The
    card's 4g flags 50 ms stalls against a ~2.7 ms flush on a real
    clock."""
    stall_s = 1.0
    srv = _server(env["params"], watchdog=True,
                  faults=FaultSpec(stall_rate=0.15, stall_s=stall_s, seed=6))
    clock = _FakeClock()
    monkeypatch.setattr(tserver, "time", clock)
    encode = srv._encode

    def timed_encode(*a, **kw):
        clock.now += clock.STEP_S
        return encode(*a, **kw)

    srv._encode = timed_encode
    inj, stalled = srv._injector, []
    real = inj.stall_s

    def watch(bucket, tag):
        s = real(bucket, tag)
        if s > 0:
            stalled.append(len(srv.flush_log))
        return s

    inj.stall_s = watch
    res = _serve(srv, env["streams"])
    late = [q for q in stalled if q >= 10]
    assert late and srv.telemetry.total_recorded == len(srv.flush_log)
    flags = {o.seq for o in srv.straggler_flags}
    assert set(late) <= flags, sorted(o.wall_s for o in srv.telemetry)
    wall = {o.seq: o.wall_s for o in srv.telemetry}
    assert all(wall[q] >= stall_s for q in stalled)
    for sid, want in env["preds"].items():
        np.testing.assert_array_equal(_preds(res[sid]), want)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def _tcfg_bf16():
    return tserver.smoke_cfg().with_(matmul_backend="bf16", attn_backend="",
                                     ffn_backend="")


@pytest.fixture(scope="module")
def ref(env):
    """One reference server (bf16, warm start off, no mesh) on the shared
    param tree; ``serve(spec, **knobs)`` re-arms its injector and knobs
    and serves the 3-stream traffic (``max_rounds`` pauses)."""
    jsrv = jserver.StreamServer(
        _smoke_cfg("bf16"), jserver.ServerConfig(
            microbatch=MB, chunk=CHUNK, warm_start=False, mesh="off"),
        params=jax.tree.map(jnp.asarray, env["raw"]), n_classes=10)
    base = jsrv.serve_cfg

    def serve(spec=None, max_rounds=0, **knobs):
        jsrv.serve_cfg = dataclasses.replace(base, faults=spec, **knobs)
        jsrv.faults = spec
        jsrv._injector = (jfaults.FaultInjector(spec)
                          if spec is not None else None)
        jsrv._next_sid = 0          # the sids (fault sites) of the port's
        for s in jfleet(3, img_size=32, patch=8):
            jsrv.add_session(s, n_frames=N_FRAMES)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return jsrv.serve(max_rounds=max_rounds), jsrv

    return serve


FAULT_MODES = {
    "transient": (dict(flush_fault_rate=0.3, ingest_fault_rate=0.2,
                       seed=7), {}),
    "quarantine": (dict(hard_fail_session=2, hard_fail_at_chunk=1,
                        flush_fatal_rate=0.08, seed=3), {}),
    "shed": (None, dict(max_pending_rows=4)),
}


@pytest.mark.parametrize("mode", sorted(FAULT_MODES))
def test_faulted_serve_matches_the_reference(env, ref, mode):
    kw, knobs = FAULT_MODES[mode]
    jres, _ = ref(jfaults.FaultSpec(**kw) if kw else None, **knobs)
    srv = _server(env["params"], _tcfg_bf16(),
                  faults=FaultSpec(**kw) if kw else None, **knobs)
    tres = _serve(srv, _fleet())
    assert sorted(tres) == sorted(jres)
    for sid, t in tres.items():
        j = jres[sid]
        for f in ("poisoned", "failure", "retries", "shed_frames", "frames",
                  "bucket_hits", "bucket_launches"):
            assert getattr(t, f) == getattr(j, f), (sid, f)
        assert set(t.predictions) == set(j.predictions)
        if t.predictions:
            agree = np.mean([t.predictions[i] == j.predictions[i]
                             for i in t.predictions])
            assert agree >= 0.9, (sid, agree)
    if mode != "shed":
        assert any(r.retries or r.poisoned for r in tres.values())
    else:
        assert sum(r.shed_frames for r in tres.values()) > 0


def _close(a, b, path=""):
    """Equal JSON-able trees, floats within 1e-12 relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-300), path
    else:
        assert a == b, path


def test_snapshot_matches_the_reference(env, ref):
    """Paused at the same round, both snapshots hold the same keys, the
    same ``extra`` and the same session meta; the queued rows agree within
    the embed's ulp class and the deferred predictions at the serving
    class."""
    _, jsrv = ref(max_rounds=1)
    jst = jsrv._inflight
    jarr, jextra = jsrv._snapshot(jst["live"], jst["rnd"], jst["offset"])
    jsrv._inflight = None
    for s in jst["live"]:
        s.finished = True
    jsrv._sessions = []
    srv = _server(env["params"], _tcfg_bf16())
    assert _serve(srv, _fleet(), max_rounds=1) == {}
    st_ = srv._inflight
    tarr, textra = srv._snapshot(st_["live"], st_["rnd"], st_["offset"])
    assert sorted(tarr) == sorted(jarr)
    assert any("/pend" in k for k in tarr)
    for k, v in tarr.items():
        if "/pend" in k or "ref_scores" in k:
            np.testing.assert_allclose(v, np.asarray(jarr[k]), rtol=0,
                                       atol=1e-5)
        elif "deferred_pred" in k:
            assert np.mean(v == np.asarray(jarr[k])) >= 0.9
        else:
            np.testing.assert_array_equal(v, np.asarray(jarr[k]), k)
    for e in (textra, jextra):
        e["compat"].pop("fingerprint")
    _close(textra, jextra)


def test_drift_snapshot_matches_the_reference(env):
    """A noisy server's snapshot carries the DriftState as the reference's
    does: ``drift/key|frame|nm`` bitwise after the same frames served
    (and a recalibration's reset)."""
    spec = dict(drift_rate_nm=0.003, recal_bound_nm=0.05, seed=5)
    jsrv = jserver.StreamServer(
        _smoke_cfg("photonic_sim").with_(noise=JNoiseSpec(**spec)),
        jserver.ServerConfig(microbatch=MB, chunk=CHUNK, warm_start=False,
                             mesh="off"),
        params=jax.tree.map(jnp.asarray, env["raw"]), n_classes=10)
    srv = _server(env["params"], _noisy_cfg().with_(
        noise=NoiseSpec(**spec)), warm_start=False)
    for n in (4, 3, 4, 4, 3):
        jsrv._advance_drift(n)
        srv._advance_drift(n)
        jarr, jextra = jsrv._snapshot([], 0, 0)
        tarr, textra = srv._snapshot([], 0, 0)
        assert sorted(tarr) == sorted(jarr) == ["drift/frame", "drift/key",
                                                "drift/nm"]
        for k in tarr:
            a, b = tarr[k], np.asarray(jarr[k])
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), k
        assert textra["recalibrations"] == jextra["recalibrations"]
        assert math.isclose(textra["host_drift_nm"], jextra["host_drift_nm"],
                            rel_tol=1e-12)
    assert srv.recalibrations == 1


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _parsed(monkeypatch, mod, argv):
    got = {}

    def stub(cfg, sc, *a, **k):
        got["sc"] = sc
        raise _Stop

    monkeypatch.setattr(mod, "StreamServer", stub)
    with pytest.raises(_Stop):
        mod.main(argv)
    return got["sc"]


@pytest.mark.parametrize("argv", [
    ["--flush-fault-rate", "0.1", "--flush-fatal-rate", "0.02",
     "--ingest-fault-rate", "0.05", "--stall-rate", "0.2", "--stall-s",
     "0.01", "--fault-seed", "9", "--hard-fail-session", "1",
     "--retry-limit", "5", "--max-pending", "12", "--checkpoint-dir",
     "/tmp/x", "--checkpoint-every", "2"],
    ["--max-pending", "3"]], ids=["faults", "no-spec"])
def test_fault_flags_parse_as_the_reference(monkeypatch, argv):
    jsc = _parsed(monkeypatch, jserver, ["--smoke", "--mesh", "off"] + argv)
    tsc = _parsed(monkeypatch, tserver, ["--smoke"] + argv)
    assert (tsc.faults is None) == (jsc.faults is None)
    if tsc.faults is not None:
        assert dataclasses.asdict(tsc.faults) == dataclasses.asdict(
            jsc.faults)
    for f in ("retry_limit", "retry_backoff_s", "max_pending_rows",
              "checkpoint_dir", "checkpoint_every", "checkpoint_keep"):
        assert getattr(tsc, f) == getattr(jsc, f), f


def test_cli_reports_faults_on_cpu(tmp_path, capsys):
    import json
    res = tserver.main(["--smoke", "--device", "cpu", "--streams", "3",
                        "--frames", "16", "--flush-fault-rate", "0.2",
                        "--hard-fail-session", "1", "--checkpoint-dir",
                        str(tmp_path), "--checkpoint-every", "1", "--json",
                        "--no-warm-start"])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["poisoned"] == [False, True, False]
    assert summary["faults"]["ingest_fatal"] == 1
    assert summary["shed_frames"] == [0, 0, 0]
    assert any(line.startswith("[server] faults: ") for line in out)
    assert res[1].poisoned and sorted(os.listdir(tmp_path))
