#!/usr/bin/env python3
"""Same-call A/B of the noisy analog walk (``core/photonic.py::
analog_accumulate``, the f32 chunk walk every noisy photonic matmul takes)
on one card: the package's design (one ``bmm`` materializing every 32-wide
chunk's partial product, the partials then added in chunk order) against
an in-order ``addmm_`` loop over the chunks (no partials buffer: the same
sums, a K = 32 GEMM a chunk).

    python3 scripts/noise_walk_ab.py [--rounds 2]

Serves path 4e (A) of ``chip_smoke.py``: opto-vit-base-224 + MGNet, random
weights from seed 0, photonic_sim + flash + xla FFN under drift 0.01 nm a
frame and wander 0.01 nm, one CUDA graph per ladder bucket (49 / 98 / 147 /
196 of 196 patches, 4 frames a flush). Each round installs one variant,
re-captures every bucket's graph and times a replayed flush at each bucket
by CUDA events (its state write and copy-in included, as a served flush);
the variants take turns, every other round in reverse. Before that, the
walk alone at the flush's weight shapes (M = 4 x 197 rows), the two
variants' logits at one pinned DriftState, and the host time of the
cache's re-derivation from the raw weights, which a recalibration does not
run (it is bitwise the live cache). Prints the card's name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def addmm_loop(xq, wqf, chunk: int = 32):
    """The alternative walk: each chunk's (M, chunk) x (chunk, N) product
    added to the accumulator in chunk order by one ``addmm_``."""
    import torch
    m, k = xq.shape
    xf = xq.float()
    wf = wqf.float()
    acc = torch.zeros(m, wqf.shape[1], dtype=torch.float32, device=xq.device)
    for c in range(0, k, chunk):
        acc.addmm_(xf[:, c:c + chunk], wf[c:c + chunk])
    return acc


def _same(torch, a, b) -> bool:
    """Whether two param trees hold bitwise equal tensors."""
    if isinstance(a, dict):
        return all(_same(torch, a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if hasattr(a, "wq"):
        return all(torch.equal(getattr(a, n), getattr(b, n))
                   for n in ("wq", "scale", "wt"))
    return a == b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    from repro_torch.bridge import from_jax_params, init_vit
    from repro_torch.core import noise, photonic, threefry
    from repro_torch.kernels import _build
    from repro_torch.serving.server import (ServerConfig, StreamServer,
                                            serving_cfg)
    from repro_torch.data.pipeline import video_fleet

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    _build.build()
    _build.library()
    variants = {"bmm + adds (as built)": photonic.analog_accumulate,
                "addmm_ loop": addmm_loop}

    spec = noise.NoiseSpec(**chip_smoke.NOISE_KW)
    cfg = serving_cfg("base", 224).with_(
        matmul_backend="photonic_sim", attn_backend="flash",
        ffn_backend="xla", noise=spec)
    sc = ServerConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4,
                      chunk=8)
    server = StreamServer(cfg, sc, params=from_jax_params(
        init_vit(0, cfg, 10), "cpu"))
    streams = video_fleet(2, img_size=cfg.img_size, patch=cfg.patch,
                          cut_every=32)
    tokens = chip_smoke.noisy_tokens(torch, server, streams)
    m = tokens[max(tokens)].shape[0] * (max(tokens) + 1)

    # the walk alone at the flush's weight shapes
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in ((768, 768), (768, 3072), (3072, 768)):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int32).float()
        wqf = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int32).float()
        wqf *= 1 + 0.01 * torch.randn(k, n, generator=gen, device=dev)
        outs, times = {}, {}
        for name, fn in variants.items():
            outs[name] = fn(xq, wqf)
            times[name] = chip_smoke.cuda_ms(lambda: fn(xq, wqf), iters=20,
                                             warmup=3)
        a, b = outs.values()
        rel = float((a - b).abs().max() / a.abs().max())
        print(f"[walk] ({m},{k})x({k},{n}): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in times.items())
            + f"; max |a - b| / max |a| {rel:.3e} ({card})")

    # both variants' logits at one pinned state
    pinned = noise.DriftState(threefry.prng_key(spec.seed), 7, 0.03)
    logits = {}
    for name, fn in variants.items():
        photonic.analog_accumulate = fn
        server.drift = pinned
        logits[name] = chip_smoke.noisy_eager(torch, server,
                                              tokens[max(tokens)])
    a, b = logits.values()
    print(f"[logits] k={max(tokens)} at a pinned state: corr "
          f"{chip_smoke.corr(torch, a, b):.8f}, max |a - b| "
          f"{float((a - b).abs().max()):.3e}, argmax equal "
          f"{bool(torch.equal(a.argmax(-1), b.argmax(-1)))}")

    # what a recalibration no longer runs: the cache re-derived from the
    # raw weights (bitwise the live cache)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = server._maybe_place(server._prepare(None))
        torch.cuda.synchronize()
        print(f"[recal] the cache re-derived from the raw weights "
              f"{time.perf_counter() - t0:.4f} s; bitwise the live cache "
              f"{_same(torch, fresh, server.params)}")
    del fresh

    # replayed flushes, the variants in turn
    names = list(variants)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            photonic.analog_accumulate = variants[name]
            server.drift = pinned
            server._install(server.params)
            spans = {k: chip_smoke.cuda_ms(lambda: server._encode(k, t),
                                           iters=10, warmup=2)
                     for k, t in tokens.items()}
            print(f"[replay] round {r} {name}: re-capture "
                  f"{server.recapture_s:.2f}s; a flush at k = " + " / ".join(
                      f"{k}: {ms:.3f}" for k, ms in spans.items())
                  + f" ms ({card})")
    photonic.analog_accumulate = variants[names[0]]
    return 0


if __name__ == "__main__":
    sys.exit(main())
