#!/usr/bin/env python3
"""Same-call A/B of the ViT serving paths' frames/s between checkouts of
the repository (or serving modes of one checkout) on one card.

    python3 scripts/serving_ab.py PARENT_DIR CHANGE_DIR [--pairs 4]
    python3 scripts/serving_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR:eager \
        --pairs 10 --only-4a

Runs each spec in a process of its own, the specs in turn and every other
round in reverse (parent, change, change, parent, ... for two specs;
``--pairs`` rounds), and prints one line a run: path 4a (``StreamServer``
on opto-vit-base-224 + MGNet, random weights from seed 0; after a
one-chunk warm-up, three serves of 2 streams x 32 frames) and, unless
``--only-4a``, path 4c (``chip_smoke.run_sharded``: opto-vit-large served
model-sharded by 2 ranks on the one card, checked against the unsharded
card serve, with the collectives' host time a flush). A spec ``DIR:eager``
serves 4a with ``warm_start=False`` (no CUDA graphs; a checkout whose
``ServerConfig`` has that knob). The frames/s of these paths are
host-bound and spread widely from run to run (PERF.md), so a comparison
needs the rounds of one call. Each checkout builds its own kernels. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def one(spec: str, only_4a: bool) -> None:
    """Serve the paths from the checkout of ``spec`` and print its line."""
    tree, _, mode = spec.partition(":")
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
    sc = ServingConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0),
                       microbatch=4, chunk=8)
    if mode == "eager":
        from repro_torch.serving.server import ServerConfig
        sc = ServerConfig.from_serving(sc, warm_start=False)
    server = StreamServer(cfg, sc, n_classes=10, seed=0)
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
    name = Path(tree).name + (f":{mode}" if mode else "")
    graphs = len(getattr(server, "graphs", {}))
    if only_4a:
        print(f"[ab] {name}: 4a {' '.join(f'{f:.2f}' for f in fps)} "
              f"frames/s, {graphs} CUDA graphs ({card})", flush=True)
        return
    sh = chip_smoke.run_sharded(torch, dev, card, serving_cfg("large", 224))
    r0 = sh["ranks"][0]
    coll_ms = sum(v for k, v in r0["stats"].items()
                  if k.endswith("_s")) * 1e3 / r0["n_flush"]
    print(f"[ab] {name}: 4a {' '.join(f'{f:.2f}' for f in fps)} "
          f"frames/s; 4c sharded {64 / r0['wall']:.2f} frames/s, unsharded "
          f"{64 / sh['plain']['wall']:.2f}, collectives {coll_ms:.1f} ms a "
          f"flush ({card})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="+",
                    help="checkout directories, each optionally :eager")
    ap.add_argument("--pairs", type=int, default=4,
                    help="rounds, each spec once a round")
    ap.add_argument("--only-4a", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.only_4a)
        return 0
    order = []
    for i in range(args.pairs):
        order += args.specs if i % 2 == 0 else args.specs[::-1]
    for spec in order:
        tree, sep, mode = spec.partition(":")
        cmd = [sys.executable, __file__, *args.specs, "--one",
               str(Path(tree).resolve()) + sep + mode]
        run = subprocess.run(cmd + (["--only-4a"] if args.only_4a else []),
                             timeout=600)
        if run.returncode != 0:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
