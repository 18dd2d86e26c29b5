#!/usr/bin/env python3
"""Same-call A/B of the ViT serving paths' frames/s between two checkouts
of the repository on one card.

    python3 scripts/serving_ab.py PARENT_DIR CHANGE_DIR [--pairs 4]

Runs each checkout in a process of its own, in the order parent, change,
change, parent, ... (``--pairs`` parent/change pairs), and prints one line
a run: path 4a (``StreamServer`` on opto-vit-base-224 + MGNet, random
weights from seed 0; after a one-chunk warm-up, three serves of 2 streams
x 32 frames) and path 4c (``chip_smoke.run_sharded``: opto-vit-large
served model-sharded by 2 ranks on the one card, checked against the
unsharded card serve, with the collectives' host time a flush). The
frames/s of these paths are host-bound and spread widely from run to run
(PERF.md), so a comparison needs the pairs of one call. Each checkout
builds its own kernels. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def one(tree: str) -> None:
    """Serve both paths from the checkout ``tree`` and print its line."""
    sys.path.insert(0, tree)
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch
    import chip_smoke
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.kernels import _build
    from repro_torch.serving.server import StreamServer, serving_cfg
    from repro_torch.serving.session import ServingConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    _build.library()
    cfg = serving_cfg("base", 224)
    server = StreamServer(cfg, ServingConfig(
        bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4, chunk=8),
        n_classes=10, seed=0)
    streams = video_fleet(2, img_size=cfg.img_size, patch=cfg.patch,
                          cut_every=32)
    server.add_session(streams[0], n_frames=8, start=1000)
    server.serve()                                     # warm-up
    fps = []
    for rep in range(3):
        for i, st in enumerate(streams):
            server.add_session(st, n_frames=32, start=16 * i + 64 * rep)
        res = server.serve()
        fps.append(64 / max(r.wall_s for r in res.values()))
    card = torch.cuda.get_device_name(0)
    sh = chip_smoke.run_sharded(torch, dev, card, serving_cfg("large", 224))
    r0 = sh["ranks"][0]
    coll_ms = sum(v for k, v in r0["stats"].items()
                  if k.endswith("_s")) * 1e3 / r0["n_flush"]
    print(f"[ab] {Path(tree).name}: 4a {' '.join(f'{f:.2f}' for f in fps)} "
          f"frames/s; 4c sharded {64 / r0['wall']:.2f} frames/s, unsharded "
          f"{64 / sh['plain']['wall']:.2f}, collectives {coll_ms:.1f} ms a "
          f"flush ({card})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one)
        return 0
    order = []
    for i in range(args.pairs):
        order += ([args.parent, args.change] if i % 2 == 0
                  else [args.change, args.parent])
    for tree in order:
        run = subprocess.run([sys.executable, __file__, args.parent,
                              args.change, "--one",
                              str(Path(tree).resolve())], timeout=600)
        if run.returncode != 0:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
