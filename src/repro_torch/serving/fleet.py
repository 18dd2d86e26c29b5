"""Load-aware fleet front end: N ``StreamServer`` workers behind a router
(the reference's src/repro/serving/fleet.py).

One ``StreamServer`` multiplexes many camera sessions on one card; the
fleet question is the next scale step: given W hosts (or W servers on one
card), which worker should own each incoming stream so that aggregate
frames/s stays near W times one worker? ``FleetRouter`` answers with the
control-plane pieces the serving stack already has:

  * **placement** uses the cost model's per-bucket prices
    (``serving.control.EncodeCostModel``, the H100 roofline): a job of
    ``n_frames`` costs ``n_frames * per_frame_s`` at the bucket its
    operating point routes to, and the router places it on the worker
    with the least *predicted queued seconds* (greedy least-loaded;
    ``placement="rr"`` keeps blind round-robin as the baseline);
  * **rebalance()** migrates queued sessions off the hottest worker through
    ``export_session`` / ``adopt_session`` (the remaining predictions are
    bitwise those of staying put: micro-batches are session-pure);
  * **drain(i)** retires a worker through ``checkpoint`` /
    ``restore_checkpoint`` into a fresh replacement, keeping every queued
    session.

Workers are in-process by default. They share worker 0's prepared int8
weight cache (``prepare_params`` passes cached leaves through, so only
worker 0 quantizes), and each warm-starts its own CUDA graphs over that
shared cache (a graph replays the cache it was captured over). They serve
one after another, each on its own measured wall, so aggregate frames/s
is ``total_frames / max(worker walls)``: the N-host model, where the walls
would overlap. ``spawn=True`` runs each worker's serve in a
``torch.multiprocessing`` spawn process on the same device instead (its
own CUDA context, its own graphs, the kernel library the parent built),
with weights drawn from ``seed + i`` as the reference's spawned workers
draw theirs; migration and drain need a shared address space and raise
under spawn.

Dead-bucket accounting warnings are aggregated here: workers serve with
per-session warnings muted and the router emits ONE ``UserWarning`` naming
every (worker, dead buckets) pair.

CLI (the card; ``--smoke --device cpu`` runs the plain PyTorch versions)::

    PYTHONPATH=src python -m repro_torch.serving.fleet --workers 4
    PYTHONPATH=src python -m repro_torch.serving.fleet --workers 2 --spawn \\
        --streams 6 --frames 32 --placement rr
    PYTHONPATH=src python -m repro_torch.serving.fleet --smoke --device cpu \\
        --workers 2 --streams 4 --frames 16
"""

from __future__ import annotations

import argparse
import itertools
import tempfile
import time
import warnings
from dataclasses import dataclass

from repro_torch.device import resolve_device
from repro_torch.serving.server import ServerConfig, StreamServer

__all__ = ["FleetRouter", "FleetJob"]

# disjoint per-worker sid ranges: migrated sessions keep their sid, so a
# fleet-wide sid space is what makes adopt_session collision-free
_SID_STRIDE = 1_000_000


@dataclass
class FleetJob:
    """One stream the router owns: where it lives and what it still owes."""

    job_id: int
    stream: object                # VideoStream (or any frames_at source)
    n_frames: int
    start: int
    worker: int                   # current owner index
    sid: int                      # session id on that worker (fleet-unique)
    cost_s: float                 # predicted serve seconds (placement units)
    done: bool = False
    result: object = None         # StreamResult after serve()


class FleetRouter:
    """Place, serve, migrate and drain streams across N ``StreamServer``s.

    ``placement``: ``"cost"`` (least predicted queued seconds, the
    load-aware default) or ``"rr"`` (round-robin baseline).
    ``price_per_frame``: override the cost model's per-frame price (tests
    and non-photonic backends; the relative load math only needs a
    consistent unit). Without it the router prices frames with
    ``EncodeCostModel.from_server`` on worker 0 at the ladder bucket the
    configured operating point routes to, falling back to 1.0 s/frame if
    pricing fails (placement then balances raw frame counts).
    ``device``: where every worker serves (default: the card).
    ``last_worker_info`` holds, after a spawned serve, what each child
    reported: its device, launch counts, graphs and kernel builds.
    """

    def __init__(self, cfg, server_cfg: ServerConfig | None = None,
                 workers: int = 4, placement: str = "cost",
                 n_classes: int = 10, seed: int = 0, spawn: bool = False,
                 price_per_frame: float | None = None, device=None):
        if workers < 1:
            raise ValueError("need at least one worker")
        if placement not in ("cost", "rr"):
            raise ValueError(f"placement must be 'cost' or 'rr', "
                             f"got {placement!r}")
        self.cfg = cfg
        self.server_cfg = server_cfg or ServerConfig()
        self.placement = placement
        self.n_classes = n_classes
        self.seed = seed
        self.spawn = spawn
        self.device = resolve_device(device)
        self.workers: list[StreamServer] = []
        if not spawn:
            first = StreamServer(cfg, self.server_cfg, n_classes=n_classes,
                                 seed=seed, device=self.device)
            self.workers.append(first)
            for _ in range(workers - 1):
                # share the prepared cache: prepare_params passes cached
                # leaves through, so only worker 0 quantizes
                self.workers.append(StreamServer(
                    cfg, self.server_cfg, params=first.params,
                    n_classes=n_classes, seed=seed, device=self.device))
            for i, w in enumerate(self.workers):
                w._next_sid = i * _SID_STRIDE
        self.n_workers = workers
        self.jobs: dict[int, FleetJob] = {}
        self._next_job = 0
        self._rr = itertools.cycle(range(workers))
        self._price = price_per_frame
        self.last_walls: list[float] = []
        self.last_worker_info: dict[int, dict] = {}

    # -- pricing -----------------------------------------------------------

    def price_per_frame(self) -> float:
        """Predicted seconds one frame costs a worker: the placement unit.
        Cached after the first call (one bucket warmed, worker 0)."""
        if self._price is None:
            self._price = self._price_from_cost_model()
        return self._price

    def _price_from_cost_model(self) -> float:
        if self.spawn or not self.workers:
            return 1.0
        try:
            from repro_torch.serving.control import EncodeCostModel
            w0 = self.workers[0]
            ladder = w0.ladder
            frac = self.server_cfg.force_bucket
            bucket = (ladder.route(int(round(frac * w0.n_patches)))
                      if frac else ladder.cap)
            cm = w0.cost_model or EncodeCostModel.from_server(
                w0, buckets=())
            return float(cm.ensure(int(bucket)).per_frame_s)
        except Exception as e:                       # pricing is advisory:
            warnings.warn(f"fleet pricing fell back to 1.0 s/frame "
                          f"(frame-count balancing): {e}")
            return 1.0

    # -- placement ---------------------------------------------------------

    def queued_seconds(self, worker: int) -> float:
        """Predicted seconds of unserved work on ``worker``: the live
        queue-depth signal cost placement adds prices onto."""
        return sum(j.cost_s for j in self.jobs.values()
                   if j.worker == worker and not j.done)

    def queued_frames(self, worker: int) -> int:
        return sum(j.n_frames for j in self.jobs.values()
                   if j.worker == worker and not j.done)

    def _pick_worker(self, cost_s: float) -> int:
        if self.placement == "rr":
            return next(self._rr)
        loads = [self.queued_seconds(i) for i in range(self.n_workers)]
        return min(range(self.n_workers), key=lambda i: (loads[i], i))

    def add_job(self, stream, n_frames: int = 64, start: int = 0) -> FleetJob:
        """Place one stream: pick a worker, register the session there
        (in-process mode) and record the job. Returns the ``FleetJob``."""
        cost = n_frames * self.price_per_frame()
        widx = self._pick_worker(cost)
        if self.spawn:
            sid = self._next_job + _SID_STRIDE * widx   # assigned in-child
        else:
            s = self.workers[widx].add_session(stream, n_frames=n_frames,
                                               start=start)
            sid = s.sid
        job = FleetJob(self._next_job, stream, int(n_frames), int(start),
                       widx, sid, cost)
        self.jobs[job.job_id] = job
        self._next_job += 1
        return job

    # -- serving -----------------------------------------------------------

    def serve(self, verbose: bool = False) -> dict[int, object]:
        """Serve every queued job to completion; returns
        ``{job_id: StreamResult}``.

        In-process workers run one after another, each timed on its own
        wall (``last_walls``); the fleet-model aggregate frames/s is
        ``total frames / max(wall)``: W hosts would overlap those walls.
        Per-session dead-bucket warnings are muted; the router emits one
        aggregated warning instead.
        """
        if self.spawn:
            return self._serve_spawn(verbose)
        out: dict[int, object] = {}
        self.last_walls = [0.0] * self.n_workers
        for i, w in enumerate(self.workers):
            mine = [j for j in self.jobs.values()
                    if j.worker == i and not j.done]
            if not mine:
                continue
            t0 = time.time()
            results = w.serve(verbose=False)
            self.last_walls[i] = time.time() - t0
            by_sid = {j.sid: j for j in mine}
            for sid, res in results.items():
                j = by_sid.get(sid)
                if j is None:
                    continue       # e.g. adopted sessions served pre-drain
                j.done, j.result = True, res
                out[j.job_id] = res
                if verbose:
                    print(f"[fleet] worker {i} job {j.job_id}:",
                          res.summary())
        self._warn_dead_buckets(out)
        return out

    def _serve_spawn(self, verbose: bool) -> dict[int, object]:
        import torch.multiprocessing as mp

        if self.device.type == "cuda":
            # the children load the library built here: none compiles
            from repro_torch.kernels import _build
            _build.build()
        ctx = mp.get_context("spawn")
        out: dict[int, object] = {}
        self.last_walls = [0.0] * self.n_workers
        self.last_worker_info = {}
        procs = []
        try:
            for i in range(self.n_workers):
                mine = [j for j in self.jobs.values()
                        if j.worker == i and not j.done]
                if not mine:
                    continue
                parent, child = ctx.Pipe(duplex=False)
                spec = [(j.job_id, j.stream, j.n_frames, j.start)
                        for j in mine]
                p = ctx.Process(target=_spawn_serve,
                                args=(self.cfg, self.server_cfg,
                                      self.n_classes, self.seed + i, spec,
                                      child, str(self.device)))
                p.start()
                child.close()
                procs.append((i, mine, p, parent))
            for i, mine, p, parent in procs:
                try:
                    payload = parent.recv()
                except EOFError as e:
                    raise RuntimeError(
                        f"spawned fleet worker {i} died without a "
                        f"result") from e
                p.join()
                if isinstance(payload, BaseException):
                    raise RuntimeError(
                        f"spawned fleet worker {i} died") from payload
                wall, results, info = payload
                self.last_walls[i] = wall
                self.last_worker_info[i] = info
                for job_id, res in results:
                    self.jobs[job_id].done = True
                    self.jobs[job_id].result = res
                    out[job_id] = res
                    if verbose:
                        print(f"[fleet] worker {i} job {job_id}:",
                              res.summary())
        finally:
            for _, _, p, _ in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        self._warn_dead_buckets(out)
        return out

    @property
    def aggregate_fps(self) -> float:
        """Fleet throughput of the last ``serve()``: total frames over the
        slowest worker's wall (walls overlap across hosts)."""
        frames = sum(j.result.frames for j in self.jobs.values()
                     if j.done and j.result is not None)
        wall = max(self.last_walls, default=0.0)
        return frames / wall if wall > 0 else 0.0

    def _warn_dead_buckets(self, results: dict) -> None:
        if self.spawn or not results:
            return
        dead_map = {}
        for i, w in enumerate(self.workers):
            hits: dict[int, int] = {}
            for j in self.jobs.values():
                if j.worker != i or j.result is None:
                    continue
                for k, v in j.result.bucket_hits.items():
                    hits[int(k)] = hits.get(int(k), 0) + int(v)
            if not hits:
                continue           # worker served nothing this round
            dead = [int(k) for k in w.ladder.sizes if not hits.get(int(k))]
            if dead:
                dead_map[i] = dead
        if dead_map:
            pairs = ", ".join(f"worker {i}: {d}"
                              for i, d in sorted(dead_map.items()))
            warnings.warn(
                f"fleet dead buckets ({pairs}): those ladder entries "
                f"constrain routing but served zero frames — consider "
                f"calibrate_trim() or a tighter bucket_fractions",
                stacklevel=2)

    # -- migration / drain -------------------------------------------------

    def _need_inprocess(self, what: str) -> None:
        if self.spawn:
            raise ValueError(f"{what} needs in-process workers "
                             f"(spawn processes share no session state)")

    def migrate(self, job_id: int, to_worker: int) -> FleetJob:
        """Move one queued job between workers through the migration
        surfaces; its remaining predictions are unchanged."""
        self._need_inprocess("migrate")
        j = self.jobs[job_id]
        if j.done:
            raise ValueError(f"job {job_id} already served")
        if to_worker == j.worker:
            return j
        snap = self.workers[j.worker].export_session(j.sid)
        self.workers[to_worker].adopt_session(snap, stream=j.stream)
        j.worker = to_worker
        return j

    def rebalance(self, max_moves: int = 0) -> list[int]:
        """Greedy hot->cold migration until predicted queued seconds are
        balanced: repeatedly move the hottest worker's smallest job to the
        coldest worker while that strictly shrinks the hot-cold gap.
        Returns the moved job ids (empty when already balanced)."""
        self._need_inprocess("rebalance")
        moved: list[int] = []
        while not max_moves or len(moved) < max_moves:
            loads = [self.queued_seconds(i) for i in range(self.n_workers)]
            hot = max(range(self.n_workers), key=lambda i: loads[i])
            cold = min(range(self.n_workers), key=lambda i: loads[i])
            gap = loads[hot] - loads[cold]
            cands = [j for j in self.jobs.values()
                     if j.worker == hot and not j.done]
            # smallest job that still improves balance: moving cost c
            # changes the gap to |gap - 2c|, an improvement iff c < gap
            cands = [j for j in sorted(cands, key=lambda j: j.cost_s)
                     if j.cost_s < gap and abs(gap - 2 * j.cost_s) < gap]
            if not cands:
                break
            moved.append(self.migrate(cands[0].job_id, cold).job_id)
        return moved

    def drain(self, worker: int, root: str | None = None) -> StreamServer:
        """Retire worker ``worker``: checkpoint its queued sessions, build
        a fresh replacement server on the shared prepared cache (it warms
        its own graphs over it) and restore into it. Jobs keep their ids
        and sids; the replacement takes the dead worker's slot. Returns the
        replacement."""
        self._need_inprocess("drain")
        old = self.workers[worker]
        mine = [j for j in self.jobs.values()
                if j.worker == worker and not j.done]
        repl = StreamServer(self.cfg, self.server_cfg,
                            params=self.workers[0].params,
                            n_classes=self.n_classes, seed=self.seed,
                            device=self.device)
        repl._next_sid = worker * _SID_STRIDE
        if mine:
            ckroot = root or tempfile.mkdtemp(prefix="fleet_drain_")
            path = old.checkpoint(root=ckroot)
            repl.restore_checkpoint(path,
                                    streams={j.sid: j.stream for j in mine})
        self.workers[worker] = repl
        return repl


def _spawn_serve(cfg, server_cfg, n_classes, seed, jobs, conn, device):
    """Top-level spawn target: build a worker, serve its jobs, ship
    ``(wall_s, [(job_id, StreamResult), ...], info)`` back over the pipe;
    ``info`` is the worker's device, its kernel launches over the serve,
    the buckets it captured as CUDA graphs and the kernel libraries it
    compiled (none: the parent built them)."""
    try:
        from repro_torch.kernels import _build

        srv = StreamServer(cfg, server_cfg, n_classes=n_classes, seed=seed,
                           device=device)
        sessions = {job_id: srv.add_session(st, n_frames=nf, start=s0)
                    for job_id, st, nf, s0 in jobs}
        _build.LAUNCHES.clear()
        t0 = time.time()
        results = srv.serve()
        wall = time.time() - t0
        info = {"device": str(srv.device),
                "launches": dict(_build.LAUNCHES),
                "graphs": sorted(srv.graphs),
                "built": [str(p) for p in _build.BUILT]}
        conn.send((wall, [(job_id, results[s.sid])
                          for job_id, s in sessions.items()], info))
    except BaseException as e:     # surface child failures to the router
        conn.send(e)
        raise


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI's flags (``--img`` is ``--img-size``'s alias),
    plus ``--smoke``, ``--variant``, ``--img-size``, ``--device`` and
    ``--seed``, as the server CLI has them. Without ``--smoke`` the model
    is opto-vit-base-224 (the reference: tiny-96) and the backends the
    fused serving point (the reference: bf16)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32,
                    help="base frames/stream; streams get a skewed "
                         "1x..3x mix so load-aware placement matters")
    ap.add_argument("--placement", choices=("cost", "rr"), default="cost")
    ap.add_argument("--spawn", action="store_true",
                    help="one spawn process per worker (own CUDA context)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (32x32 frames, 4 layers, d=64)")
    ap.add_argument("--variant", default="base",
                    help="opto-vit variant (tiny, small, base, large); "
                         "ignored under --smoke")
    ap.add_argument("--img-size", "--img", dest="img_size", type=int,
                    default=224,
                    help="frame side in pixels; ignored under --smoke")
    ap.add_argument("--backend", default="",
                    help="matmul backend (bf16, qat, photonic_sim, "
                         "photonic_pallas); default: the serving point's "
                         "photonic_pallas")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="per-worker model-axis shards (needs a world of "
                         "that many ranks; see README 'Scaling out')")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of worker 0's random weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    return ap


def main(argv=None):
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.serving.server import serving_cfg, smoke_cfg
    from repro_torch.serving.session import ServingConfig

    args = build_parser().parse_args(argv)
    cfg = smoke_cfg() if args.smoke else serving_cfg(args.variant,
                                                     args.img_size)
    if args.backend:
        cfg = cfg.with_(matmul_backend=args.backend)
    sc = ServerConfig.from_serving(
        ServingConfig(microbatch=4, chunk=8, force_bucket=0.5),
        warm_start=True, model_shards=args.model_shards)
    router = FleetRouter(cfg, sc, workers=args.workers,
                         placement=args.placement, spawn=args.spawn,
                         seed=args.seed, device=args.device)
    fleet = video_fleet(args.streams, img_size=cfg.img_size, patch=cfg.patch,
                        cut_every=32)
    for i, st in enumerate(fleet):
        nf = args.frames * (1 + (2 * i) % 3)      # skewed 1x/2x/3x mix
        j = router.add_job(st, n_frames=nf, start=8 * i)
        print(f"[fleet] job {j.job_id}: {nf} frames -> worker {j.worker} "
              f"(predicted {j.cost_s:.2f}s)")
    res = router.serve(verbose=True)
    walls = ", ".join(f"w{i}={t:.2f}s" for i, t in
                      enumerate(router.last_walls))
    print(f"[fleet] {len(res)} jobs, walls: {walls} -> "
          f"{router.aggregate_fps:.1f} frames/s aggregate "
          f"({args.placement} placement)")
    return router


if __name__ == "__main__":
    main()
