#!/usr/bin/env python3
"""Same-call A/B of how the collectives of the model-sharded serving path
(``chip_smoke.py`` path 4c) cross the host when two gloo ranks share one
card.

    python3 scripts/collectives_ab.py [--order direct,staged,staged,direct]

Each run spawns 2 ranks (mesh (data 1, model 2)) on the one card that
serve path 4c's traffic (opto-vit-large-224 + MGNet, 2 streams x 32
frames, weights drawn once from seed 0 in this process) with one way of
running ``distributed/collectives.py``'s two primitives patched in:

  direct   gloo is given the CUDA tensors and copies them through the host
           itself;
  staged   each op copies its operand to host memory, runs on the CPU
           tensor and copies the result back to the card;
  barrier  direct, after a barrier over the op's group that is timed
           apart ("wait"): it splits an op's time on the path into the
           lag of the other rank and the op's own time.

Every variant times its ops as ``collectives.STATS`` does (card
synchronized before the clock starts). Prints, per run, each rank's
frames/s and collective host ms per flush by op; checks that rank 0's
logits are bitwise the same in every run; ends with the card's name and
power limit and one JSON object of every run's numbers. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

VARIANTS = ("direct", "staged", "barrier")


def _patch(kind: str) -> None:
    """Replace ``collectives.all_reduce`` / ``all_gather_cat`` (which
    ``replicated_absmax_scale``, ``exact_int_psum`` and the sharded
    encoder call through the module) by the ``kind`` variant."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives

    stats = collectives.STATS

    def start(t, group) -> float:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        if kind == "barrier":
            t0 = time.perf_counter()
            dist.barrier(group=group)
            stats["wait"] += 1
            stats["wait_s"] += time.perf_counter() - t0
        return time.perf_counter()

    def all_reduce(t, op, group, name="all_reduce"):
        if dist.get_world_size(group) == 1:
            return t
        t0 = start(t, group)
        if kind == "staged":
            host = t.detach().cpu()
            dist.all_reduce(host, op=op, group=group)
            out = host.to(t.device)
        else:
            out = t.detach().clone()
            dist.all_reduce(out, op=op, group=group)
        stats[name] += 1
        stats[name + "_s"] += time.perf_counter() - t0
        return out

    def all_gather_cat(x, group, dim):
        n = dist.get_world_size(group)
        if n == 1:
            return x
        t0 = start(x, group)
        src = x.detach().contiguous()
        if kind == "staged":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim).to(x.device)
        stats["all_gather"] += 1
        stats["all_gather_s"] += time.perf_counter() - t0
        return out

    collectives.all_reduce = all_reduce
    collectives.all_gather_cat = all_gather_cat


def ab_rank(params: dict, cfg, sc, kind: str) -> dict:
    """One rank of one run: serve path 4c's traffic with ``kind``."""
    import torch
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _patch(kind)
    run = chip_smoke.serve_large(cfg, sc, params, "cuda")
    out = {"wall": run["wall"], "stats": run["stats"],
           "n_flush": len(run["server"].flush_log), "calls": run["calls"]}
    if run["server"].mesh.m == 0:
        out["flushes"] = run["flushes"]
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="direct,staged,barrier,barrier,"
                                       "staged,direct",
                    help="comma-separated variants, one run each, in order")
    args = ap.parse_args()
    order = args.order.split(",")
    if not set(order) <= set(VARIANTS):
        ap.error(f"variants are {VARIANTS}")
    if not torch.cuda.is_available():
        print("[ab] no CUDA device: this script runs on the card only",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.bridge import from_jax_params, init_vit
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.server import ServerConfig, serving_cfg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    _build.build()
    cfg = serving_cfg("large", 224)
    sc = ServerConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4,
                      chunk=8, model_shards=chip_smoke.SHARDS)
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    for t in chip_smoke._leaves(params):
        t.share_memory_()
    runs, first = [], None
    for kind in order:
        t0 = time.perf_counter()
        ranks = spawn_ranks(ab_rank, chip_smoke.SHARDS, params, cfg, sc, kind,
                            device="cuda", timeout_s=600)
        spawn_s = time.perf_counter() - t0
        logits = torch.cat(ranks[0]["flushes"])
        same = first is None or torch.equal(logits, first)
        first = logits if first is None else first
        if not same:
            print(f"[ab] {kind}: rank 0's logits differ from the first run's",
                  file=sys.stderr)
            return 1
        row = {"variant": kind, "spawn_s": spawn_s, "ranks": []}
        for i, r in enumerate(ranks):
            if r["calls"] != r["n_flush"]:
                print(f"[ab] rank {i}: {r['calls']} sharded encodes for "
                      f"{r['n_flush']} flushes", file=sys.stderr)
                return 1
            nf = r["n_flush"]
            ms = {k[:-2]: v * 1e3 / nf for k, v in r["stats"].items()
                  if k.endswith("_s")}
            coll = sum(v for k, v in ms.items() if k != "wait")
            row["ranks"].append({"frames_per_s": 64 / r["wall"],
                                 "wall_s": r["wall"], "n_flush": nf,
                                 "collective_ms_per_flush": coll,
                                 "ms_per_flush": ms,
                                 "calls": {k: v for k, v in r["stats"].items()
                                           if not k.endswith("_s")}})
            print(f"[ab] {kind:<7s} rank {i}: {64 / r['wall']:.4f} frames/s "
                  f"({r['wall']:.4f} s); collectives {coll:.3f} ms a flush "
                  f"over {nf} flushes; by op, ms a flush: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + f" ({card})", flush=True)
        runs.append(row)
    print("[ab] rank 0's logits bitwise equal in every run: True")
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
