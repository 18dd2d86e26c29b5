"""The port's fleet router (``repro_torch.serving.fleet``) on the CPU:
against the reference's ``src/repro/serving/fleet.py`` on the same smoke
config, streams, param tree and ``price_per_frame``, and within the port
against solo serves of the same streams.

Both packages' routers serve one numpy param tree (``bridge.init_vit``,
seed 0: the port's workers draw it themselves; the reference's worker 0
is handed it) under ``bf16``, the reference's own fleet-test backend;
one reference fleet run, in a module fixture, is read by every test that
compares served results. Within the port the fleet serves the fused
serving point.

Tolerances, and why:

  * placements (each job's worker), ``cost_s``, the sid ranges,
    ``queued_seconds`` / ``queued_frames``, ``rebalance``'s moved job ids,
    the aggregated dead-bucket warning text, the spawn-guard and argument
    error texts: equal. They are host-side decisions on the same prices
    and the same routing.
  * predictions against the reference's: every frame predicted, each
    prediction equal (equal argmax). The packages' bf16 encoders round in
    other places, so the logits are not bitwise; the reference's server
    keeps no flush logits to correlate, and on this traffic every argmax
    agrees.
  * within the port, each job's predictions and every flush's logits
    against the same stream served alone on a server over the same shared
    cache, and after ``migrate``, ``rebalance`` and ``drain``: bitwise.
    Micro-batches are session-pure, so a job's flushes hold the rows (and
    absmax scopes) they hold alone.
"""

import functools
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.pipeline import video_fleet as jvideo_fleet
from repro.serving import fleet as jfleet
from repro.serving.engine import _smoke_cfg
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import StreamServer as JServer
from repro.serving.session import ServingConfig as JServingConfig
from repro_torch.bridge import init_vit
from repro_torch.data.pipeline import video_fleet
from repro_torch.serving import FleetRouter, fleet as tfleet
from repro_torch.serving import server as tserver
from repro_torch.serving.control import EncodeCostModel
from repro_torch.serving.session import ServingConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ranks  # noqa: E402

# the reference CLI's skewed mix at smoke length: 8 x (1, 3, 2, 1)
FRAMES = [8 * (1 + (2 * i) % 3) for i in range(4)]
N_CLASSES = 10


def _tcfg_bf16():
    return tserver.smoke_cfg().with_(matmul_backend="bf16",
                                     attn_backend="xla", ffn_backend="xla")


def _sc(mod_sc, serving_cfg, **kw):
    return mod_sc.from_serving(serving_cfg(microbatch=4, chunk=8,
                                           force_bucket=0.5),
                               warm_start=False, **kw)


def _place(router, streams):
    return [router.add_job(st, n_frames=nf, start=8 * i)
            for i, (st, nf) in enumerate(zip(streams, FRAMES))]


def _quiet_serve(router):
    """serve(), returning the results and the fleet's warnings."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = router.serve()
    return res, [str(w.message) for w in rec]


@pytest.fixture(scope="module")
def reference():
    """The reference's fleet on the shared param tree: cost placement of
    the 4 skewed jobs over 2 workers, served once; rr placement of the
    same jobs and its ``rebalance`` (placement only)."""
    raw = init_vit(0, tserver.smoke_cfg(), N_CLASSES)
    jparams = jax.tree.map(jnp.asarray, raw)
    sc = _sc(JServerConfig, JServingConfig, mesh="off")
    cfg = _smoke_cfg("bf16")
    mp = pytest.MonkeyPatch()
    # worker 0 takes the shared tree; the others get its cache, as ever
    mp.setattr(jfleet, "StreamServer",
               functools.partial(JServer, params=jparams))
    try:
        cost = jfleet.FleetRouter(cfg, sc, workers=2, n_classes=N_CLASSES,
                                  price_per_frame=1.0)
        jobs = _place(cost, jvideo_fleet(4, img_size=32, patch=8,
                                         cut_every=16))
        loads = [(cost.queued_seconds(i), cost.queued_frames(i))
                 for i in range(2)]
        res, warned = _quiet_serve(cost)
        rr = jfleet.FleetRouter(cfg, sc, workers=2, n_classes=N_CLASSES,
                                placement="rr", price_per_frame=1.0)
        rr_jobs = _place(rr, jvideo_fleet(4, img_size=32, patch=8,
                                          cut_every=16))
        rr_place = [(j.worker, j.cost_s) for j in rr_jobs]
        moved = rr.rebalance()
        sids = [w._next_sid for w in cost.workers]
    finally:
        mp.undo()
    return SimpleNamespace(
        raw=raw, loads=loads, warned=warned, moved=moved, rr_place=rr_place,
        rr_after=[j.worker for j in rr_jobs], sids=sids,
        place=[(j.worker, j.cost_s, j.sid) for j in jobs],
        predictions=[res[j.job_id].predictions for j in jobs],
        frames=[res[j.job_id].frames for j in jobs])


def _port_router(placement="cost", cfg=None, **kw):
    return FleetRouter(cfg or _tcfg_bf16(),
                       _sc(tserver.ServerConfig, ServingConfig),
                       workers=2, placement=placement, n_classes=N_CLASSES,
                       price_per_frame=1.0, device="cpu", **kw)


def _streams():
    return video_fleet(4, img_size=32, patch=8, cut_every=16)


@pytest.fixture(scope="module")
def port_bf16(reference):
    """The port's fleet on the same config and jobs, served once."""
    router = _port_router()
    jobs = _place(router, _streams())
    loads = [(router.queued_seconds(i), router.queued_frames(i))
             for i in range(2)]
    res, warned = _quiet_serve(router)
    return SimpleNamespace(router=router, jobs=jobs, res=res, loads=loads,
                           warned=warned)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def test_argument_errors_match_the_reference():
    for kw in ({"workers": 0}, {"workers": 2, "placement": "random"}):
        want = _torch_ranks._raises(lambda: jfleet.FleetRouter(
            _smoke_cfg("bf16"), _sc(JServerConfig, JServingConfig),
            price_per_frame=1.0, **kw))
        got = _torch_ranks._raises(lambda: FleetRouter(
            _tcfg_bf16(), _sc(tserver.ServerConfig, ServingConfig),
            price_per_frame=1.0, device="cpu", **kw))
        assert got == want and got


def test_sid_ranges_match_the_reference(reference, port_bf16):
    assert tfleet._SID_STRIDE == jfleet._SID_STRIDE
    fresh = FleetRouter(_tcfg_bf16(), _sc(tserver.ServerConfig,
                                          ServingConfig),
                        workers=3, n_classes=N_CLASSES, price_per_frame=1.0,
                        device="cpu")
    assert [w._next_sid for w in fresh.workers] == [
        i * tfleet._SID_STRIDE for i in range(3)]
    assert [w._next_sid for w in port_bf16.router.workers] == reference.sids
    assert [j.sid for j in port_bf16.jobs] == [p[2] for p in reference.place]


def test_cost_placement_matches_the_reference(reference, port_bf16):
    assert [(j.worker, j.cost_s, j.sid) for j in port_bf16.jobs] == \
        reference.place
    assert port_bf16.loads == reference.loads


def test_rr_placement_and_rebalance_match_the_reference(reference):
    router = _port_router("rr")
    jobs = _place(router, _streams())
    assert [(j.worker, j.cost_s) for j in jobs] == reference.rr_place
    assert router.rebalance() == reference.moved
    assert [j.worker for j in jobs] == reference.rr_after
    assert router.rebalance() == []


def test_dead_bucket_warning_matches_the_reference(reference, port_bf16):
    fleet_w = [w for w in port_bf16.warned if "fleet dead buckets" in w]
    assert fleet_w == [w for w in reference.warned
                       if "fleet dead buckets" in w]
    assert len(fleet_w) == 1


def test_predictions_within_the_reference_class(reference, port_bf16):
    for j, want, nf in zip(port_bf16.jobs, reference.predictions,
                           reference.frames):
        got = port_bf16.res[j.job_id].predictions
        assert len(got) == nf == j.n_frames
        assert got == want, j.job_id
    assert port_bf16.router.aggregate_fps > 0
    assert len(port_bf16.router.last_walls) == 2


def test_spawn_guards_match_the_reference():
    jr = jfleet.FleetRouter(_smoke_cfg("bf16"),
                            _sc(JServerConfig, JServingConfig), workers=2,
                            n_classes=N_CLASSES, spawn=True)
    tr = FleetRouter(_tcfg_bf16(), _sc(tserver.ServerConfig, ServingConfig),
                     workers=2, n_classes=N_CLASSES, spawn=True,
                     device="cpu")
    assert tr.workers == [] and tr.price_per_frame() == 1.0
    for call in (lambda r: r.migrate(0, 1), lambda r: r.rebalance(),
                 lambda r: r.drain(0)):
        want = _torch_ranks._raises(lambda: call(jr))
        assert _torch_ranks._raises(lambda: call(tr)) == want
        assert "in-process" in want


def test_pricing_fallback_warns_as_the_reference(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no roofline")

    monkeypatch.setattr(EncodeCostModel, "from_server", broken)
    router = FleetRouter(_tcfg_bf16(), _sc(tserver.ServerConfig,
                                           ServingConfig),
                         workers=1, n_classes=N_CLASSES, device="cpu")
    with pytest.warns(UserWarning) as rec:
        assert router.price_per_frame() == 1.0
    assert [str(w.message) for w in rec] == [
        "fleet pricing fell back to 1.0 s/frame (frame-count balancing): "
        "no roofline"]


@pytest.mark.parametrize("force", [0.5, 0.0], ids=["forced", "cap"])
def test_price_is_the_cost_models_per_frame_seconds(force):
    sc = tserver.ServerConfig.from_serving(
        ServingConfig(microbatch=4, chunk=8, force_bucket=force),
        warm_start=False)
    router = FleetRouter(tserver.smoke_cfg(), sc, workers=1,
                         n_classes=N_CLASSES, device="cpu")
    w0 = router.workers[0]
    bucket = (w0.ladder.route(int(round(force * w0.n_patches))) if force
              else w0.ladder.cap)
    want = EncodeCostModel.from_server(w0, buckets=()).ensure(
        bucket).per_frame_s
    assert router.price_per_frame() == want > 0
    job = router.add_job(_streams()[0], n_frames=8)
    assert job.cost_s == 8 * want


# --------------------------------------------------------------------------
# within the port: the fused serving point, bitwise against solo serves
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solo():
    """Each stream's job served alone, on a server over the fused fleet's
    shared cache: predictions and flush logits by frame index."""
    router = _port_router(cfg=tserver.smoke_cfg())
    srv = tserver.StreamServer(tserver.smoke_cfg(), router.server_cfg,
                               params=router.workers[0].params,
                               n_classes=N_CLASSES, device="cpu")
    out = []
    for i, (st, nf) in enumerate(zip(_streams(), FRAMES)):
        logged = _torch_ranks.log_flushes(srv)
        s = srv.add_session(st, n_frames=nf, start=8 * i)
        res = srv.serve()
        del srv._finish
        out.append((res[s.sid].predictions,
                    {tuple(f for _, f in k): v for k, v in logged.items()}))
    return SimpleNamespace(router=router, out=out)


def _fused_serve(solo, change=None):
    """The 4 jobs on a fresh fused 2-worker fleet (the same seed, so the
    same cache as ``solo``'s; ``change(router, jobs)`` runs before the
    serve); every job checked against its solo serve, bitwise. Returns
    the router and jobs."""
    router = _port_router(cfg=tserver.smoke_cfg())
    jobs = _place(router, _streams())
    if change is not None:
        change(router, jobs)
    logs = [_torch_ranks.log_flushes(w) for w in router.workers]
    res, _ = _quiet_serve(router)
    logged = {}
    for log in logs:
        logged.update(log)
    for j, (preds, flushes) in zip(jobs, solo.out):
        assert j.done and res[j.job_id].predictions == preds
        mine = {tuple(f for _, f in k): v for k, v in logged.items()
                if k[0][0] == j.sid}
        assert mine.keys() == flushes.keys()
        for k, v in flushes.items():
            np.testing.assert_array_equal(mine[k], v)
    return router, jobs


def test_fleet_jobs_are_bitwise_their_solo_serves(solo):
    router, jobs = _fused_serve(solo)
    assert {j.worker for j in jobs} == {0, 1}
    assert all(r > 0 for r in router.last_walls)


def test_migrate_and_rebalance_are_bitwise(solo):
    def change(router, jobs):
        assert router.migrate(jobs[0].job_id, 1).worker == 1
        assert router.migrate(jobs[1].job_id, jobs[1].worker) is jobs[1]
        router.rebalance()

    router, jobs = _fused_serve(solo, change)
    with pytest.raises(ValueError, match="already served"):
        router.migrate(jobs[0].job_id, 0)


def test_drain_is_bitwise(solo, tmp_path):
    def change(router, jobs):
        old = router.workers[0]
        repl = router.drain(0, root=str(tmp_path))
        assert router.workers[0] is repl and repl is not old
        # the shared cache: the same int8 storage as every other worker
        w1 = [w.params["blocks"]["ffn"]["w1"] for w in router.workers]
        assert w1[0].wq.data_ptr() == w1[1].wq.data_ptr()
        assert w1[0].wt.data_ptr() == w1[1].wt.data_ptr()

    _fused_serve(solo, change)


@pytest.mark.filterwarnings("ignore:fleet dead buckets")
def test_cli_serves_the_smoke_fleet(capsys):
    router = tfleet.main(["--smoke", "--device", "cpu", "--workers", "2",
                          "--streams", "3", "--frames", "8"])
    out = capsys.readouterr().out
    assert "[fleet] 3 jobs, walls:" in out
    assert sum(j.result.frames for j in router.jobs.values()) == 8 + 24 + 16
