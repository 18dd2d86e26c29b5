"""Multi-stream session server: many cameras, one accelerator (the
reference's src/repro/serving/server.py, pared to the serving main path).

Per ingest chunk of each stream, in round-robin order:

  1. the temporal mask cache decides which frames MGNet re-scores
     (``mgnet_scores`` on the int8 photonic matmul kernel);
  2. ``embed_patches`` embeds the whole chunk;
  3. one stable descending argsort of the region scores, then a per-bucket
     top-k gather (``_gather_topk_rows``) of each frame's routed bucket;
  4. the session-pure micro-batcher queues the groups keyed (bucket,
     session), so every encode launch holds one stream's frames and its
     activation absmax scope is one stream;
  5. every ready flush runs ``forward_vit_tokens`` on the fused serving
     point (int8 photonic matmul + RoI-masked flash attention + fused FFN
     over the quantize-once int8 cache), then final LayerNorm -> head ->
     argmax.

Model-sharded serving (``ServerConfig.model_shards`` = M > 1): every rank
of a ``torch.distributed`` world of W = D x M ranks runs this same loop
over the same streams. The gate, embed, routing and micro-batcher are
deterministic and run replicated; only the encode is sharded, over the
2-D ("data", "model") mesh of ``launch.mesh.make_serving_mesh``, on this
rank's shard of the weight cache (``place_params``), through
``models/sharded_encoder.py``. Every rank ends with the same predictions.

Not ported yet (ROADMAP.md queue A): energy accounting, warm start and CUDA
graphs, one-shape mode, device noise, faults, checkpoints, the control
plane, the 1-D data mesh, ``mix_streams``, ``max_wait``, ladder trimming
and bit plans.

CLI (the card; ``--device cpu`` runs the plain PyTorch versions):

    PYTHONPATH=src python -m repro_torch.serving.server --streams 2 --frames 32
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.serving.server \
        --smoke --device cpu --model-shards 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.bridge import from_jax_params, init_vit, to_device
from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.core.backend import ExecPolicy, place_params, prepare_params
from repro_torch.core.mgnet import mask_budget, mgnet_scores
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (MODEL_RULES, ShardingCtx,
                                              use_sharding)
from repro_torch.launch.mesh import init_from_env, make_serving_mesh
from repro_torch.models.sharded_encoder import \
    sharded_encode_ineligible_reason
from repro_torch.models.vit import (_fused_encoder_ineligible_reason,
                                    embed_patches, forward_vit_tokens,
                                    mgnet_config, vit_logical_axes)
from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.scheduler import FrameBatch, MicroBatcher
from repro_torch.serving.session import (ServingConfig, StreamResult,
                                         StreamSession)

__all__ = ["StreamServer", "ServerConfig", "serving_cfg", "smoke_cfg",
           "interleave_rounds", "main"]


@dataclasses.dataclass(frozen=True)
class ServerConfig(ServingConfig):
    """ServingConfig + the multi-stream knobs (the ported subset)."""

    model_shards: int = 0        # > 1: 2-D ("data", "model") serving mesh —
    #                              attention heads + d_ff shard over "model"
    #                              (MODEL_RULES), the fused encode runs
    #                              sharded (models/sharded_encoder.py),
    #                              bitwise-equal to unsharded with the FFN's
    #                              twin. 0/1 = unsharded


def _gather_topk_rows(tokens: torch.Tensor, order: torch.Tensor,
                      keep: int) -> torch.Tensor:
    """(C, N, d) tokens + (C, N) descending score order -> (C, keep, d): the
    top-``keep`` prefix of the shared order, what ``select_topk_patches``
    would select, without re-sorting per bucket."""
    idx = order[:, :keep, None].expand(-1, -1, tokens.shape[-1])
    return torch.gather(tokens, 1, idx)


def interleave_rounds(groups) -> list:
    """Round-robin merge, one element from each list per pass:
    [[a1, a2, a3], [b1]] -> [a1, b1, a2, a3]."""
    out, i = [], 0
    while True:
        row = [g[i] for g in groups if i < len(g)]
        if not row:
            return out
        out.extend(row)
        i += 1


def serving_cfg(variant: str = "base", img_size: int = 224) -> ArchConfig:
    """A ViT + MGNet config on the fused serving point (int8 photonic
    matmul + flash attention + fused FFN)."""
    from repro_torch.configs.opto_vit import get_config
    return get_config(variant, img_size=img_size, mgnet=True).with_(
        matmul_backend="photonic_pallas", attn_backend="flash",
        ffn_backend="fused")


def smoke_cfg() -> ArchConfig:
    """The reference's serving smoke config on the fused serving point:
    4 layers, d=64, 32x32 frames in 8x8 patches, MGNet embed 32 / 2 heads."""
    return smoke_variant(serving_cfg("tiny")).with_(
        mgnet_keep_ratio=0.5, mgnet_embed=32, mgnet_heads=2)


class StreamServer:
    """Shared serving resources + the multi-stream scheduling loop.

    ``params`` is the port's param tree (``bridge.from_jax_params``), or
    None to draw one with ``bridge.init_vit(seed, ...)``. Every matmul
    weight is quantized once, on ``device`` (default: the card), before any
    stream starts: the int8 photonic matmul is the only ported backend.
    ``serve_cfg`` is a ``ServerConfig`` (a plain ``ServingConfig`` takes
    its defaults). With ``model_shards`` > 1 this process is one rank of a
    model-sharded mesh: it serves on ``cuda:(LOCAL_RANK % device_count)``
    (or the CPU) and keeps only its shard of the cache.
    """

    def __init__(self, cfg: ArchConfig, serve_cfg: ServingConfig | None = None,
                 params: dict | None = None, n_classes: int = 10,
                 seed: int = 0, device=None):
        if not cfg.mgnet:
            raise ValueError("serving needs cfg.mgnet=True (the RoI gate is "
                             "the pipeline's first stage)")
        self.cfg = cfg
        sc = serve_cfg or ServerConfig()
        if not isinstance(sc, ServerConfig):
            sc = ServerConfig(**dataclasses.asdict(sc))
        self.serve_cfg = sc
        dev = resolve_device(device)
        # the mesh exactly when model_shards > 1; None on a world of one
        # rank, and a world of more ranks without model shards raises
        self.mesh = make_serving_mesh(model=max(1, sc.model_shards),
                                      device=dev)
        self.device = self.mesh.device if self.mesh is not None else dev
        self._ctx = (ShardingCtx(self.mesh, MODEL_RULES)
                     if self.mesh is not None else None)
        self.policy = ExecPolicy.from_cfg(cfg)
        self.n_patches = (cfg.img_size // cfg.patch) ** 2
        self.ladder = BucketLadder.from_fractions(
            self.n_patches, self.serve_cfg.bucket_fractions)
        self.mcfg = mgnet_config(cfg)
        if params is None:
            params = from_jax_params(init_vit(seed, cfg, n_classes),
                                     self.device)
        self.params = self._maybe_place(prepare_params(
            to_device(params, self.device), bits=cfg.quant_bits or 8))
        self._sessions: list[StreamSession] = []
        self._next_sid = 0
        self.batcher: MicroBatcher | None = None
        self.flush_log: list[tuple] = []   # (owner sids, bucket k, n_real)
        # the newest flush and its logits, for spot checks of the served
        # numbers against another execution of the same encode
        self.last_flush: FrameBatch | None = None
        self.last_logits: torch.Tensor | None = None

    def _maybe_place(self, params):
        """This rank's shard of the prepared cache on a model-sharded mesh
        (the whole cache without one). The cache is prepared whole first,
        so every per-out-channel scale is the unsharded one. Raises with
        the reason when the sharded encode cannot run: asking for
        ``model_shards`` > 1 never serves unsharded quietly."""
        if self._ctx is None:
            return params
        reason = (_fused_encoder_ineligible_reason(params, self.cfg,
                                                   self.policy)
                  or sharded_encode_ineligible_reason(params, self.cfg,
                                                      self.policy,
                                                      self._ctx))
        if reason is not None:
            raise ValueError(
                f"model_shards={self.serve_cfg.model_shards} asks for the "
                f"model-sharded encode, which cannot run: {reason}")
        return place_params(params, vit_logical_axes(self.cfg), self._ctx)

    def add_session(self, stream: VideoStream, n_frames: int = 64,
                    start: int = 0) -> StreamSession:
        """Register a stream for the next ``serve()``; returns its session."""
        s = StreamSession(self._next_sid, stream, n_frames, start,
                          self.serve_cfg, self.ladder)
        self._next_sid += 1
        self._sessions.append(s)
        return s

    def _score_fn(self, frames: np.ndarray) -> np.ndarray:
        f = torch.from_numpy(frames).to(self.device)
        s = mgnet_scores(self.params["mgnet"], f, self.mcfg, self.policy)
        return s.float().cpu().numpy()

    def serve(self, verbose: bool = False) -> dict[int, StreamResult]:
        """Serve every registered session to completion, interleaved
        round-robin; returns ``{sid: StreamResult}``. Every result's
        ``wall_s`` is the loop's span (device work included), so the
        aggregate frames/s is ``sum(frames) / wall``."""
        live = [s for s in self._sessions if not s.finished]
        if not live:
            return {}
        for s in live:
            s.open()
        self.batcher = MicroBatcher(self.serve_cfg.microbatch)
        self.flush_log = []
        by_sid = {s.sid: s for s in live}
        t0 = time.perf_counter()
        offset, rnd = 0, 0
        while any(not s.drained for s in live):
            rot = live[offset:] + live[:offset]
            offset = (offset + 1) % len(live)
            per = {s.sid: [] for s in rot}
            for s in rot:
                if s.ingest_done:
                    continue
                batch = s.next_batch()
                if batch is not None:
                    per[s.sid].extend(self._ingest_chunk(s, batch))
            for s in rot:
                if s.ingest_done and not s.drained:
                    per[s.sid].extend(self.batcher.drain(
                        select=lambda key, sid=s.sid: key[1] == sid))
                    s.drained = True
            for fb in interleave_rounds([per[s.sid] for s in rot]):
                self._finish(fb, by_sid)
            rnd += 1
            if verbose and rnd % 4 == 0:
                done = sum(s.frames_encoded for s in live)
                print(f"[server] round {rnd:>4d}  {done:>5d} frames  "
                      f"{done / (time.perf_counter() - t0):7.1f} frames/s "
                      f"aggregate (pending {self.batcher.pending})")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        results = {s.sid: s.finish(wall) for s in live}
        self._sessions = [s for s in self._sessions if not s.finished]
        return results

    def _ingest_chunk(self, s: StreamSession, batch: dict) -> list:
        """Gate one chunk through the session's mask cache, embed it, route
        it on the ladder and push per-bucket groups into the batcher.
        Returns the flushes that became ready."""
        frames_np = batch["frames"]
        idxs = batch["frame_idx"]
        valid = idxs < s.limit
        scores_np, _ = s.cache.gate(frames_np, idxs, self._score_fn,
                                    eligible=valid)
        frames = torch.from_numpy(frames_np).to(self.device)
        toks = embed_patches(self.params, frames, self.cfg,
                             self.policy)                   # (C, N, d)
        routes = self.ladder.route_many(mask_budget(scores_np,
                                                    self.mcfg.t_reg))
        order = torch.argsort(torch.from_numpy(scores_np).to(self.device),
                              dim=-1, descending=True, stable=True)
        out = []
        for k in np.unique(routes[valid]):
            k = int(k)
            sel = np.flatnonzero((routes == k) & valid)
            pruned = _gather_topk_rows(toks, order, k)       # (C, k, d)
            s.record_route(k, len(sel))
            group = (pruned if len(sel) == frames_np.shape[0]
                     else pruned[torch.from_numpy(sel).to(self.device)])
            out.extend(self.batcher.push_many(
                (k, s.sid), group, [(s.sid, int(idxs[i])) for i in sel]))
        return out

    def _finish(self, fb: FrameBatch, by_sid: dict[int, StreamSession]) -> None:
        """Encode one flush and hand its predictions to the owning session."""
        k = fb.bucket[0]
        with use_sharding(self.mesh):
            logits = forward_vit_tokens(self.params, fb.tokens, self.cfg,
                                        self.policy, device=self.device)[0]
        preds = torch.argmax(logits[:fb.n_real], dim=-1)
        sid = fb.bucket[1]
        sess = by_sid[sid]
        sess.record_flush(k, fb.n_real)
        sess.add_deferred([fi for _, fi in fb.frame_idx], preds)
        self.flush_log.append(((sid,), k, fb.n_real))
        self.last_flush, self.last_logits = fb, logits


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (32x32 frames, 4 layers, d=64)")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per stream")
    ap.add_argument("--phase", type=int, default=16,
                    help="per-stream start offset (stream i starts at i*phase)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (bridge.init_vit)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="> 1: 2-D (data, model) serving mesh over the "
                         "torchrun world: attention heads + d_ff shard over "
                         "the model axis (needs n_heads and d_ff divisible)")
    args = ap.parse_args(argv)

    joined = init_from_env(device=args.device) is not None
    try:
        return _serve_cli(args)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _serve_cli(args):
    rank0 = (not torch.distributed.is_initialized()
             or torch.distributed.get_rank() == 0)
    say = print if rank0 else (lambda *a, **k: None)
    cfg = smoke_cfg() if args.smoke else serving_cfg()
    server = StreamServer(cfg, ServerConfig(model_shards=args.model_shards),
                          seed=args.seed, device=args.device)
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "cpu")
    mesh = ("x".join(str(n) for n in server.mesh.shape.values())
            if server.mesh is not None else "off")
    say(f"[server] {cfg.name} {cfg.img_size}x{cfg.img_size} on {where}: "
        f"ladder={list(server.ladder.sizes)} of {server.n_patches} patches "
        f"mesh={mesh}")
    streams = video_fleet(args.streams, img_size=cfg.img_size,
                          patch=cfg.patch)
    sessions = [server.add_session(st, n_frames=args.frames,
                                   start=i * args.phase)
                for i, st in enumerate(streams)]
    results = server.serve(verbose=rank0)
    total = sum(r.frames for r in results.values())
    wall = max((r.wall_s for r in results.values()), default=0.0)
    for s in sessions:
        say(f"[server] session {s.sid}:", results[s.sid].summary())
    say(f"[server] aggregate: {total} frames over {len(sessions)} streams "
        f"in {wall:.3f}s -> {total / wall if wall else 0.0:.1f} frames/s "
        f"({len(server.flush_log)} encode launches, {where})")
    return results


if __name__ == "__main__":
    main()
