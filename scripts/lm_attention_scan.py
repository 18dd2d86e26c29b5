#!/usr/bin/env python3
"""Where the LM attention kernels' time goes on one card, and the
instructions their SASS holds.

    python3 scripts/lm_attention_variants.py

A scan splits each kernel's device time into what grows with the work and
what does not:

- B5 (``flash_attention_causal``, bf16 tensor cores) at q (4, 12, S, 128),
  KV 2 heads, causal, in the path's (B, S, H, D) layout read by strides,
  for S = 64, 128 and 256 (one, two and four key tiles for the last query
  tile);
- B6 (``flash_decode``, a cluster of 8 blocks) at q (4, 1, 12, 128), cache
  (4, 512, 2, 128) bf16, at lengths 1, 160 and 512.

Each shape is checked against the plain version first (bf16: 1 ulp of
max |o|), then timed by the profiler's device time per call. Then the SASS
of the built library (``cuobjdump -sass``) is scanned, per kernel, for the
instructions the designs rest on: HMMA (mma.sync), LDGSTS (cp.async), LDSM
(ldmatrix), UCGABAR (cluster barrier) and MAPA (a cluster peer's
shared-memory address). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "UCGABAR", "MAPA")
KERNELS = ("flash_attention_causal_mma_kernel", "flash_decode_cluster_kernel")


def sass_counts(lib: Path) -> dict:
    """Kernel symbol -> Counter of SASS_OPS in its code."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        if name is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}", line):
                    counts[name][op] += 1
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    lib = _build.build()
    _build.library()
    for src, log in sorted(_build.ptxas_report().items()):
        if src in ("flash_attention_causal.cu", "flash_decode.cu"):
            for line in log.splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling")):
                    print(f"[ptxas] {src}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(7)
    b, h, hkv, d = 4, 12, 2, 128

    def timed(tag, fn, want, kname):
        e, ok, tol = chip_smoke.held(torch, fn(), want)
        if not ok:
            print(f"FAIL: {tag}: max abs err {e:.3e} outside {tol}",
                  file=sys.stderr)
            return False
        t, passes = chip_smoke.device_ms(torch, fn, chip_smoke.SYMBOLS[kname],
                                         iters=200, counter=kname)
        print(f"[scan] {tag}: {t:.5f} ms device (max abs err {e:.3e}, "
              f"profiling passes {passes}; {card})", flush=True)
        return True

    for s_ in (64, 128, 256):
        q, k, v = (torch.randn(b, s_, hh, d, generator=gen, device=dev)
                   .bfloat16().transpose(1, 2) for hh in (h, hkv, hkv))
        if not timed(f"B5 Sq = Skv = {s_}",
                     lambda: flash_attention(q, k, v),
                     ref.flash_attention_ref(q, k, v),
                     "flash_attention_causal"):
            return 1
    q6 = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    k6, v6 = (torch.randn(b, 512, hkv, d, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    for length in (1, 160, 512):
        if not timed(f"B6 length {length}",
                     lambda: flash_decode(q6, k6, v6, length),
                     ref.flash_decode_ref(q6, k6, v6, length),
                     "flash_decode"):
            return 1

    for name, c in sorted(sass_counts(lib).items()):
        if any(k in name for k in KERNELS):
            print(f"[sass] {name}: " + ", ".join(
                f"{op} {c[op]}" for op in SASS_OPS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
