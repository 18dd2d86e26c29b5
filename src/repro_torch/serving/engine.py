"""Single-session shell over the multi-stream ``StreamServer`` (the
reference's src/repro/serving/engine.py).

``ServingEngine`` wraps one ``StreamServer`` with warm start off (every
flush runs eagerly: on the card no CUDA graph is captured) and serves
exactly one session per ``run``; each result is field for field what the
server gives that stream. The pipeline is the server's: ingest
(double-buffered to the device), RoI gate with temporal mask reuse,
bucket routing + micro-batching, the encode under the config's policy,
and the energy account. ``run_dense`` is the mask-mode dense baseline
(``StreamServer.run_dense``).

The CLI takes the reference's backend flags with the reference's
defaults: ``--backend photonic_pallas`` and the attention and FFN left
empty, which resolve to the composed ``xla`` entries (``--attn-backend
flash --ffn-backend fused`` is the fused serving point);
``--compare-dense`` runs the dense baseline after the bucketed run.

    PYTHONPATH=src python -m repro_torch.serving.engine --smoke --device cpu \\
        --compare-dense
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import available_backends
from repro_torch.data.pipeline import VideoStream
from repro_torch.serving.server import (ServerConfig, StreamServer,
                                        serving_cfg, smoke_cfg,
                                        with_backends)
from repro_torch.serving.session import ServingConfig, StreamResult

__all__ = ["ServingConfig", "StreamResult", "ServingEngine", "main"]


class ServingEngine:
    """Single-stream serving over one ViT + MGNet parameter set: one
    ``StreamServer`` built at construction, one fresh session per ``run``.
    A plain ``ServingConfig`` gets warm start off; an explicit
    ``ServerConfig`` is taken as it is."""

    def __init__(self, cfg: ArchConfig, serve_cfg: ServingConfig | None = None,
                 params: dict | None = None, n_classes: int = 10,
                 seed: int = 0, device=None):
        sc = serve_cfg or ServingConfig()
        self.serve_cfg = sc
        server_cfg = (sc if isinstance(sc, ServerConfig)
                      else ServerConfig.from_serving(sc, warm_start=False))
        self.server = StreamServer(cfg, server_cfg, params=params,
                                   n_classes=n_classes, seed=seed,
                                   device=device)

    def run(self, stream: VideoStream, n_frames: int = 64, start: int = 0,
            verbose: bool = False) -> StreamResult:
        """Stream exactly ``n_frames`` frames through the bucketed path."""
        s = self.server.add_session(stream, n_frames=n_frames, start=start)
        return self.server.serve(verbose=verbose)[s.sid]

    def run_dense(self, stream: VideoStream, n_frames: int = 64,
                  start: int = 0) -> StreamResult:
        """The mask-mode dense baseline: the same gating, every frame
        encoded at all N patches with the RoI mask on the attention key
        axis."""
        return self.server.run_dense(stream, n_frames=n_frames, start=start)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (32x32 frames, 4 layers, d=64)")
    ap.add_argument("--variant", default="base",
                    help="opto-vit variant (tiny, small, base, large); "
                         "ignored under --smoke (the reference's default: "
                         "tiny)")
    ap.add_argument("--img-size", type=int, default=224,
                    help="frame side in pixels; ignored under --smoke (the "
                         "reference's default: 96)")
    ap.add_argument("--backend", default="photonic_pallas",
                    choices=available_backends(), help="matmul backend")
    ap.add_argument("--attn-backend", default="", choices=["", "xla", "flash"],
                    help="attention core: xla (materialized scores, the "
                         "default) or flash (the RoI-masked flash kernel)")
    ap.add_argument("--ffn-backend", default="", choices=["", "xla", "fused"],
                    help="GELU-MLP: xla (composed two-linear, the default) "
                         "or fused (the fused int8 FFN kernel)")
    ap.add_argument("--attn-impl", default="standard",
                    choices=["standard", "decomposed"],
                    help="attention dataflow: standard or the paper's Eq. 2 "
                         "decomposition")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--mask-refresh", type=int, default=8)
    ap.add_argument("--delta-threshold", type=float, default=0.15)
    ap.add_argument("--buckets", default="0.25,0.5,0.75,1.0")
    ap.add_argument("--one-shape", action="store_true",
                    help="encode all frames at the ladder cap with a static "
                         "packed kept-count per bucket")
    ap.add_argument("--cut-every", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (bridge.init_vit)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--compare-dense", action="store_true",
                    help="also run the mask-mode dense baseline")
    ap.add_argument("--json", default="",
                    help="write the StreamResult to this path")
    args = ap.parse_args(argv)

    cfg = with_backends(smoke_cfg() if args.smoke
                        else serving_cfg(args.variant, args.img_size), args)
    serve_cfg = ServingConfig(
        bucket_fractions=tuple(float(f) for f in args.buckets.split(",")),
        microbatch=args.microbatch, chunk=args.chunk,
        mask_refresh=args.mask_refresh,
        delta_threshold=args.delta_threshold, one_shape=args.one_shape)
    engine = ServingEngine(cfg, serve_cfg, seed=args.seed,
                           device=args.device)
    server = engine.server
    print(f"[serve] {cfg.name} {cfg.img_size}x{cfg.img_size} on "
          f"{server.device}: {server.policy} attn_impl={cfg.attn_impl} "
          f"ladder={list(server.ladder.sizes)} of {server.n_patches} "
          f"patches")
    stream = VideoStream(img_size=cfg.img_size, patch=cfg.patch,
                         cut_every=args.cut_every)
    res = engine.run(stream, n_frames=args.frames, verbose=True)
    print("[serve]", res.summary())
    if args.compare_dense:
        dense = engine.run_dense(stream, n_frames=args.frames)
        print("[serve] dense baseline:", dense.summary())
        if dense.fps > 0:
            print(f"[serve] bucketed speedup: {res.fps / dense.fps:.2f}x "
                  f"frames/s over mask-mode dense")
    if args.json:
        payload = {
            "frames": res.frames, "fps": res.fps,
            "kfps_per_watt": res.kfps_per_watt,
            "mean_frame_uj": res.mean_frame_uj,
            "bucket_hits": res.bucket_hits,
            "bucket_launches": res.bucket_launches,
            "scored_frames": res.scored_frames,
            "reused_frames": res.reused_frames,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"[serve] wrote {args.json}")
    return res


if __name__ == "__main__":
    main()
