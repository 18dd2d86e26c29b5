#!/usr/bin/env python3
"""Variants of the tensor-core masked flash attention (B2), timed side by
side on one card: the record of why its tile shape and numerics are what
they are.

    python3 scripts/vit_kernel_variants.py

Each variant is a text edit of a copy of ``kernels/csrc/flash_attention.cu``
(a constant of the ``tc`` namespace, or one expression), built with the
package's nvcc flags into a library of its own and called through its C
entry on the same inputs: (4, 12, S, 64) f32, all keys live, q/k/v as the
(B, S, H, D) projection layout permuted, S = 50, 99, 148, 197. Each is
checked against the plain version (rtol = atol = 2e-5) and timed by the
profiler's device time per call; each variant's registers and spills come
from ``-Xptxas -v``. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
ENTRY = "flash_attention_masked_tc_f32"


def const(name: str, value: int):
    """Set ``constexpr int name`` of the tc namespace to ``value``."""
    return rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};"


# name -> (edits of the tc namespace, keys per tile the wrapper must count)
VARIANTS = {
    "as built": ([], 32),
    "64-key tiles": ([const("kBKV", 64)], 64),
    "2 warps (32-row blocks)": ([const("kWarps", 2)], 32),
    "8 warps (128-row blocks)": (
        [const("kWarps", 8), (r"__launch_bounds__\(kNT, 2\)",
                              "__launch_bounds__(kNT, 1)")], 32),
    "hi and lo by cvt.rna.tf32.f32": (
        [(r"return \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;",
          r'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); '
          r"return r;")], 32),
    "lo left unrounded": (
        [(r"lo = to_tf32\(x - __uint_as_float\(hi\)\);",
          "lo = __float_as_uint(x - __uint_as_float(hi));")], 32),
}


def edited(edits) -> str:
    src = SOURCE.read_text()
    cut = src.index("namespace tc {")
    head, tail = src[:cut], src[cut:]
    for pattern, repl in edits:
        tail, n = re.subn(pattern, repl, tail, count=1)
        if n != 1:
            raise RuntimeError(f"edit {pattern!r} matched nothing")
    return head + tail


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(tempfile.mkdtemp(prefix="b2_variants_"))
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(edited(edits))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: {name} does not build:\n{log}", file=sys.stderr)
            return 1
        used = re.findall(r"Compiling entry function '(\S+)'[\s\S]*?"
                          r"(Used \d+ registers[^\n]*)", log)
        regs = next(u for f, u in used if "masked_tc_kernel" in f)
        print(f"[ptxas] {name}: {regs.strip()}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), ENTRY)
        fn.argtypes = list(_build._SIGNATURES[ENTRY])
        fn.restype = ctypes.c_int
        entries[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = _build.stream_ptr(dev)
    b, h, d = 4, 12, 64
    for s in (50, 99, 148, 197):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .transpose(1, 2) for _ in range(3))
        keep = torch.ones(b, s, device=dev)
        want = ref.flash_attention_masked_ref(q, k, v, keep)
        for name, fn in entries.items():
            tile = VARIANTS[name][1]
            nkv = -(-s // tile)
            mask = torch.nn.functional.pad(keep, (0, nkv * tile - s))
            nlive = mask.reshape(b, nkv, tile).sum(-1).to(torch.int32)
            o = torch.empty(b, s, h, d, device=dev).transpose(1, 2)
            strides = _build.strides_arg(*(x for t in (q, k, v, o)
                                           for x in t.stride()[:3]))

            def call():
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                mask.data_ptr(), nlive.data_ptr(),
                                o.data_ptr(), strides, b, h, h, h, s, s, nkv,
                                1.0 / math.sqrt(d), stream), name)
            call()
            e = (o - want).abs().max().item()
            if not torch.allclose(o, want, rtol=2e-5, atol=2e-5):
                print(f"FAIL: {name} at S={s}: max abs err {e:.3e}",
                      file=sys.stderr)
                return 1
            t, _ = chip_smoke.device_ms(
                torch, call, ("flash_attention_masked_tc_kernel",), iters=200)
            print(f"[variant] S={s} {name}: {t:.5f} ms device, max abs err "
                  f"{e:.2e} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
