#!/usr/bin/env python3
"""The LM serving path of chip_smoke.py's 4b (qwen2-1.5b at full width,
``init_model(0)`` bf16 weights, batch 4, a 128-token prompt, 32 greedy
tokens, cache 512) timed at one or more checkouts of this repo, each in a
process of its own on the card, in the order given:

    python scripts/lm_decode_ab.py TREE [TREE ...] [--reps 3] [--json PATH]

TREE is a checkout's root: its ``src/`` comes first on the path and its
kernels build there. To compare two commits on one card, unpack the
parent into a directory .gitignore lists and name the trees parent,
change, change, parent. For each tree it prints the decode loop's tok/s
of ``launch/serve.py::generate`` in each of ``--reps`` runs, a decode
step's wall ms (CUDA-synced, the 32 generated steps again on the last
run's cache) and a digest of the generated tokens (equal digests: the trees
compute the same tokens), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

BATCH, PROMPT, GEN, CACHE = 4, 128, 32, 512


def child(tree: str, reps: int) -> dict:
    """One tree's readings, in this process."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    import repro_torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, init_cache
    from repro_torch.models import api as model_api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    _build.library()
    cfg = get_config("qwen2-1.5b")
    params = model_api.init_model(0, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    generate(params, init_cache(cfg, BATCH, 8, dev), prompt[:, :4], 2, cfg)
    torch.cuda.synchronize()
    tps, toks, cache = [], None, None
    for _ in range(reps):
        cache = init_cache(cfg, BATCH, CACHE, dev)
        toks, rate = generate(params, cache, prompt, GEN, cfg)
        torch.cuda.synchronize()
        tps.append(rate)
    # a decode step's wall time: the generated steps again on the last
    # run's cache (each step rewrites its own row)
    tok = toks[:, :1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GEN):
        _, cache = model_api.decode_fn(params, cache, tok, PROMPT + i, cfg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / GEN
    return {"tree": tree, "package": repro_torch.__file__, "tps": tps,
            "step_ms": step_ms,
            "tokens": hashlib.sha256(toks.cpu().numpy().tobytes())
            .hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.reps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, tree, "--child",
                              "--reps", str(args.reps)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"{tree}: decode loop tok/s "
              + ", ".join(f"{t:.2f}" for t in row["tps"])
              + f"; a decode step {row['step_ms']:.3f} ms; tokens "
              f"{row['tokens']}; {row['package']} ({card})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
