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

Not ported yet (ROADMAP.md queue A): energy accounting, warm start and CUDA
graphs, one-shape mode, device noise, faults, checkpoints, the control
plane, mesh sharding, ``mix_streams``, ``max_wait``, ladder trimming and
bit plans.

CLI (the card; ``--device cpu`` runs the plain PyTorch versions):

    PYTHONPATH=src python -m repro_torch.serving.server --streams 2 --frames 32
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import from_jax_params, init_vit, to_device
from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.core.backend import ExecPolicy, prepare_params
from repro_torch.core.mgnet import mask_budget, mgnet_scores
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.device import resolve_device
from repro_torch.models.vit import (embed_patches, forward_vit_tokens,
                                    mgnet_config)
from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.scheduler import FrameBatch, MicroBatcher
from repro_torch.serving.session import (ServingConfig, StreamResult,
                                         StreamSession)

__all__ = ["StreamServer", "serving_cfg", "smoke_cfg", "interleave_rounds",
           "main"]


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
    """

    def __init__(self, cfg: ArchConfig, serve_cfg: ServingConfig | None = None,
                 params: dict | None = None, n_classes: int = 10,
                 seed: int = 0, device=None):
        if not cfg.mgnet:
            raise ValueError("serving needs cfg.mgnet=True (the RoI gate is "
                             "the pipeline's first stage)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.serve_cfg = serve_cfg or ServingConfig()
        self.policy = ExecPolicy.from_cfg(cfg)
        self.n_patches = (cfg.img_size // cfg.patch) ** 2
        self.ladder = BucketLadder.from_fractions(
            self.n_patches, self.serve_cfg.bucket_fractions)
        self.mcfg = mgnet_config(cfg)
        if params is None:
            params = from_jax_params(init_vit(seed, cfg, n_classes),
                                     self.device)
        self.params = prepare_params(to_device(params, self.device),
                                     bits=cfg.quant_bits or 8)
        self._sessions: list[StreamSession] = []
        self._next_sid = 0
        self.batcher: MicroBatcher | None = None
        self.flush_log: list[tuple] = []   # (owner sids, bucket k, n_real)
        # the newest flush and its logits, for spot checks of the served
        # numbers against another execution of the same encode
        self.last_flush: FrameBatch | None = None
        self.last_logits: torch.Tensor | None = None

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
    args = ap.parse_args(argv)

    cfg = smoke_cfg() if args.smoke else serving_cfg()
    server = StreamServer(cfg, seed=args.seed, device=args.device)
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "cpu")
    print(f"[server] {cfg.name} {cfg.img_size}x{cfg.img_size} on {where}: "
          f"ladder={list(server.ladder.sizes)} of {server.n_patches} patches")
    streams = video_fleet(args.streams, img_size=cfg.img_size,
                          patch=cfg.patch)
    sessions = [server.add_session(st, n_frames=args.frames,
                                   start=i * args.phase)
                for i, st in enumerate(streams)]
    results = server.serve(verbose=True)
    total = sum(r.frames for r in results.values())
    wall = max((r.wall_s for r in results.values()), default=0.0)
    for s in sessions:
        print(f"[server] session {s.sid}:", results[s.sid].summary())
    print(f"[server] aggregate: {total} frames over {len(sessions)} streams "
          f"in {wall:.3f}s -> {total / wall if wall else 0.0:.1f} frames/s "
          f"({len(server.flush_log)} encode launches, {where})")
    return results


if __name__ == "__main__":
    main()
