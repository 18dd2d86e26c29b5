#!/usr/bin/env python3
"""Variants of B2's wide tensor-core entry (Eq. 2's attention core), timed
side by side on one card: the record of why its head group, D-chunk and
ring depth are what they are, beside the SIMT entry that took these head
dims before, the plain version and SDPA.

    python3 scripts/eq2_attention_variants.py

Each variant is a text edit of a copy of ``kernels/csrc/flash_attention.cu``
(a constant of the ``wide`` namespace), built with the package's nvcc flags
into a library of its own and called through its C entry on the same
inputs: Eq. 2 at ViT-Base, q (4, 12, S, 768) at unit-scale scores, one
shared key head k (4, 1, S, 768), v (4, 12, S, 64) split from the (4, S,
768) projection (a strided view), scale 1.0, all keys live, S = 50, 99,
148, 197 (the buckets' token counts), and ViT-Large's (4, 16, 197, 1024)
with 16 heads. Each is checked against the plain version (rtol = atol =
2e-5) and timed by the profiler's device time per call; each variant's
registers and spills come from ``-Xptxas -v``. The SIMT entry runs from
the package's own build through its C entry. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
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
ENTRY = "flash_attention_masked_wide_f32"
# the entry's two kernels: the attention and K's split
KERNELS = ("flash_attention_masked_wide_kernel",
           "flash_attention_masked_wide_split_kernel")


def const(name: str, value: int):
    """Set ``constexpr int name`` of the wide namespace to ``value``."""
    return rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};"


ONE_BLOCK = (r'static_assert\(2 \* \(kSmem \+ 1024\) <= 232448, "two blocks an SM"\);',
             'static_assert(kSmem <= 232448, "one block an SM");')

# name -> edits of the wide namespace
VARIANTS = {
    "as built": [],
    "2 heads a block (32 rows each)": [const("kG", 2)],
    "4 heads a block (16 rows each), one block an SM": [const("kG", 4),
                                                         ONE_BLOCK],
    "2 stages": [const("kStages", 2)],
    # diagnostics, not kernels: their results are wrong and not checked
    "diagnostic: no loads after the prologue": [
        (r"      issue\(st == 0 \? kStages - 1 : st - 1\);", "")],
    "diagnostic: no QK wgmma": [(r"        wgmma\(sc, q",
                                 "        if (0) wgmma(sc, q")] * 3,
}
SHAPES = [(4, 12, s, 768) for s in (50, 99, 148, 197)] + [(4, 16, 197, 1024)]


def edited(edits) -> str:
    src = SOURCE.read_text()
    cut = src.index("namespace wide {")
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
    from repro_torch.kernels.flash_attention import (_live_counts,
                                                     wide_scratch_floats)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(tempfile.mkdtemp(prefix="eq2_variants_"))
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(edited(edits))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    lib = _build.library()                 # the SIMT entry, as built
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: {name} does not build:\n{log}", file=sys.stderr)
            return 1
        used = re.findall(r"Compiling entry function '(\S+)'[\s\S]*?"
                          r"(Used \d+ registers[^\n]*)", log)
        regs = next(u for f, u in used if KERNELS[0] in f)
        spill = re.findall(r"Compiling entry function '\S*wide\S*'[\s\S]*?"
                           r"(\d+ bytes stack frame[^\n]*)", log)
        print(f"[ptxas] {name}: {regs.strip()}; "
              f"{spill[0] if spill else ''}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), ENTRY)
        fn.argtypes = list(_build._SIGNATURES[ENTRY])
        fn.restype = ctypes.c_int
        entries[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = _build.stream_ptr(dev)
    for b, h, s, d in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device=dev) * d ** -0.5
        k = torch.randn(b, 1, s, d, generator=gen, device=dev)
        v = torch.randn(b, s, h * 64, generator=gen, device=dev).reshape(
            b, s, h, 64).transpose(1, 2)
        keep = torch.ones(b, s, device=dev)
        want = ref.flash_attention_masked_ref(q, k, v, keep, scale=1.0)
        mask, nlive = _live_counts(keep, True)
        nkv = nlive.shape[1]
        tag = f"q({b},{h},{s},{d})"
        for name, fn in entries.items():
            o = torch.empty(b, s, h, 64, device=dev).transpose(1, 2)
            strides = _build.strides_arg(*(x for t in (q, k, v, o)
                                           for x in t.stride()[:3]))
            scratch = torch.empty(wide_scratch_floats(b, 1, nkv, d),
                                  device=dev)

            def call():
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                mask.data_ptr(), nlive.data_ptr(),
                                o.data_ptr(), strides, scratch.data_ptr(), b,
                                h, 1, h, s, s, d, nkv, 1.0, stream), name)
            call()
            torch.cuda.synchronize()
            e = (o - want).abs().max().item()
            if name.startswith("diagnostic"):
                t, _ = chip_smoke.device_ms(torch, call, KERNELS, iters=100)
                print(f"[variant] {tag} {name}: {t:.5f} ms device ({card})",
                      flush=True)
                continue
            if not torch.allclose(o, want, rtol=2e-5, atol=2e-5):
                print(f"FAIL: {name} at {tag}: max abs err {e:.3e}",
                      file=sys.stderr)
                return 1
            t, _ = chip_smoke.device_ms(torch, call, KERNELS, iters=100)
            split, _ = chip_smoke.device_ms(torch, call, (KERNELS[1],),
                                            iters=100)
            print(f"[variant] {tag} {name}: {t:.5f} ms device ({split:.5f} "
                  f"of it K's split), max abs err {e:.2e} ({card})",
                  flush=True)
        # the SIMT entry (contiguous copies, as its wrapper hands them over)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        o = torch.empty(b, h, s, 64, device=dev)

        def simt():
            _build.check(lib.flash_attention_masked_f32(
                qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), keep.data_ptr(),
                nlive.data_ptr(), o.data_ptr(), b, h, 1, h, s, s, d, 64, nkv,
                1.0, stream), "simt")
        simt()
        torch.cuda.synchronize()
        e = (o - want).abs().max().item()
        t, _ = chip_smoke.device_ms(
            torch, simt, ("flash_attention_masked_kernel",), iters=20)
        print(f"[variant] {tag} SIMT entry: {t:.5f} ms device, max abs err "
              f"{e:.2e} ({card})", flush=True)
        plain, _ = chip_smoke.device_ms(torch, lambda: ref.
                                        flash_attention_masked_ref(
                                            q, k, v, keep, scale=1.0))
        bmask = (keep > 0)[:, None, None, :]
        sdpa, _ = chip_smoke.device_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k.expand(b, h, s, d), v, attn_mask=bmask, scale=1.0))
        flops = 2 * b * h * s * s * (d + 64)
        nbytes = 4 * (b * h * s * d + b * s * d + 2 * b * h * s * 64 + b * s)
        bound = max(3 * flops / chip_smoke.PEAK_TF32_FLOPS,
                    nbytes / chip_smoke.PEAK_BYTES)
        print(f"[variant] {tag} plain {plain:.5f} ms, SDPA (key head "
              f"expanded, bool mask) {sdpa:.5f} ms, 3xTF32 bound "
              f"{bound * 1e3:.5f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
