#!/usr/bin/env python3
"""How the FSDP collectives of path 4k (``chip_smoke.py``) cross the host
when 4 gloo ranks share one card: each op at a layer's size, staged by
hand through host memory against gloo given the CUDA tensor
(``distributed/collectives.py``'s ``direct``).

    python3 scripts/fsdp_collectives_ab.py

4 ranks on a (data 2, model 2) mesh. Per rank: the all-gather of a
(768, 15232) bf16 block (23.4 MB, one rank's share of an FFN weight of
qwen2-1.5b) over the "data" pair and the f32 all-reduce of a (1536,
15232) block (93.6 MB, that weight's gradient), each staged and direct
in turns (staged, direct, direct, staged; 5 calls a reading after one
not timed, the card synchronized around them). Ends with the card's name
and power limit and one JSON object of rank 0's numbers. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts"), str(ROOT / "src")]


def _ms(torch, dist, fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def rank_body() -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 2, device="cuda")
    dev, group = mesh.device, mesh.group("data")
    x = torch.randn(768, 15232, device=dev).bfloat16()
    y = torch.randn(1536, 15232, device=dev)
    sum_ = dist.ReduceOp.SUM
    out = {"gather": {"staged": [], "direct": []},
           "all_reduce": {"staged": [], "direct": []}}
    for way in ("staged", "direct", "direct", "staged"):
        direct = way == "direct"
        out["gather"][way].append(_ms(torch, dist, lambda: collectives.
                                      all_gather_cat(x, group, 0,
                                                     direct=direct)))
        out["all_reduce"][way].append(_ms(torch, dist, lambda: collectives.
                                          all_reduce(y, sum_, group,
                                                     direct=direct)))
    return out


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn_ranks

    ranks = spawn_ranks(rank_body, 4, device="cuda", timeout_s=900)
    for i, r in enumerate(ranks):
        print(f"rank {i}: gather 23.4 MB staged "
              f"{r['gather']['staged']} ms, direct {r['gather']['direct']} "
              f"ms; all-reduce 93.6 MB f32 staged {r['all_reduce']['staged']}"
              f" ms, direct {r['all_reduce']['direct']} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "rank0": ranks[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
