#!/usr/bin/env python3
"""Which (M, K, N) ``torch._int_mm`` takes on this card: the record of the
padding rule in ``kernels/fused_ffn.py::padded_int_mm``.

    python3 scripts/int_mm_shapes.py

Runs ``torch._int_mm`` on all-ones int8 operands over a grid of M, K
(8..256 in steps of 8) and N, and prints for each (M, N) the K at which it
raised (cuBLASLt: CUBLAS_STATUS_NOT_SUPPORTED) or gave a wrong sum. Needs a
CUDA card.
"""

from __future__ import annotations

import itertools
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ms = (17, 32, 33, 48, 64, 96, 788, 800)
    ns = (8, 16, 32, 40, 64, 1008, 1024, 4096)
    ks = tuple(range(8, 264, 8))
    bad = set()
    for m, k, n in itertools.product(ms, ks, ns):
        x = torch.ones(m, k, dtype=torch.int8, device="cuda")
        w = torch.ones(k, n, dtype=torch.int8, device="cuda")
        try:
            r = torch._int_mm(x, w)
            torch.cuda.synchronize()
            ok = bool((r == k).all())
        except RuntimeError:
            ok = False
        if not ok:
            bad.add((m, k, n))
    for m in ms:
        for n in ns:
            print(f"M={m} N={n}: failing K {[k for k in ks if (m, k, n) in bad]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
