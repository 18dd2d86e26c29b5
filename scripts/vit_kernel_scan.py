#!/usr/bin/env python3
"""Where the ViT serving kernels' time goes on one card, against their
library yardsticks and their first designs, and the instructions their
SASS holds.

    python3 scripts/vit_kernel_scan.py

- B1 (``photonic_matmul``) at the serving path's large shapes: (M, 768,
  768) for M = 200, 396, 592, 788 (4 frames at each bucket) and 1568 (the
  patch embed of 8 frames), through the wrapper (the K-major entry, weight
  read from its K-major copy), beside the N-major entry (the first design,
  called directly on the same operands) and ``torch._int_mm`` + the
  dequant;
- B2 (``flash_attention_masked``) at (4, 12, S, 64) for S = 50, 99, 148 and
  197, all keys live, q/k/v as the (B, S, H, D) projection layout permuted
  (read by strides), through the wrapper (the tensor-core entry), beside
  the SIMT entry (called directly on contiguous copies) and
  ``F.scaled_dot_product_attention``;
- B3 (``fused_ffn``) at x (4, n, 768), d_ff 3072, n = 50, 99, 148 and 197
  (M = 200, 396, 592, 788: 4 frames at each bucket), through the wrapper
  (the K-major entry, weights read from their K-major copies), each of its
  three launches apart, beside the first design (``fused_ffn_nmajor``),
  the plain version and, as a reference point, the port's own composed
  twin ``fused_ffn_xla`` (``torch._int_mm`` + B4, twice: "composed", not
  a library call).

Each shape is checked first (B1: accumulate bitwise, output within 1e-6
relative; B2: rtol = atol = 2e-5 against the plain version and against the
3xTF32 emulation ``kernels/ref.py::flash_attention_masked_tc_ref``; B3:
bitwise against its first design, one quant step against the plain
version), then timed by the profiler's device time per call. Then the
``-Xptxas -v`` lines of the three sources, each kernel's resident blocks
per SM worked out
from them, and per kernel the SASS counts of the instructions the designs
rest on: IMMA / HMMA (mma.sync int8 / f16-class, TF32 counted apart),
HGMMA (wgmma), LDGSTS (cp.async), UTMALDG (TMA) and LDSM (ldmatrix), and
for the tensor-core B2 kernel its instruction mix: the integer adds and
masks and the f32 subtractions its TF32 splits are made of, beside its
MMAs, out of all its SASS instructions. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import math
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SASS_OPS = ("IMMA", "HMMA", "HMMA.TF32", "HGMMA", "LDGSTS", "UTMALDG", "LDSM")
B3_KMAJOR, B3_FIRST = chip_smoke.B3_KMAJOR, chip_smoke.B3_FIRST_DESIGN
KERNELS = ("photonic_matmul_s8_kmajor_kernel", "photonic_matmul_s8_kernel",
           "flash_attention_masked_tc_kernel",
           "flash_attention_masked_kernel") + B3_KMAJOR + B3_FIRST
# H100 SM limits: registers, shared memory a block may use in all (the
# runtime reserves 1 KB a block), threads, blocks
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32
# (threads a block, dynamic shared memory) the launches give each kernel
LAUNCH = {"photonic_matmul_s8_kmajor_kernel": (128, 0),
          "photonic_matmul_s8_kernel": (128, 0),
          "flash_attention_masked_tc_kernel": (128, 58624),   # tc::kSmem
          "flash_attention_masked_kernel": (128, None),
          "fused_ffn_kmajor_phase0_kernel": (128, 0),
          "fused_ffn_requant_kernel": (256, 0),
          "fused_ffn_kmajor_phase1_kernel": (128, 0),
          "fused_ffn_phase0_kernel": (128, 0),
          "fused_ffn_phase1_kernel": (128, 0)}


def sass_counts(lib: Path) -> dict:
    """Kernel symbol -> Counter of SASS_OPS in its code, and of every
    opcode (the mnemonic before its first dot) under "op:<opcode>"."""
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
            ins = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_]*)", line)
            if ins:
                counts[name]["op:" + ins.group(1)] += 1
            for op in ("IMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDSM"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
            if re.search(r"\bHMMA\b", line):
                counts[name]["HMMA"] += 1
                if "TF32" in line:
                    counts[name]["HMMA.TF32"] += 1
    return counts


def resident_blocks(log: str) -> dict:
    """Kernel symbol -> (registers, static smem, resident blocks per SM)
    from a source's ``-Xptxas -v`` output and ``LAUNCH``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            key = next((k for k in LAUNCH if k in name), None)
            if key is not None:
                regs, smem = int(m.group(1)), int(m.group(2) or 0)
                threads, dyn = LAUNCH[key]
                warps = threads // 32
                per_warp = math.ceil(regs * 32 / 256) * 256
                lim = [SM_REGS // (per_warp * warps), SM_THREADS // threads,
                       SM_BLOCKS]
                if dyn is not None:
                    lim.append(SM_SMEM // (smem + dyn + 1024))
                out[key] = (regs, smem + (dyn or 0), min(lim))
            name = None
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (KV_TILE,
                                                     flash_attention_masked)
    from repro_torch.kernels.fused_ffn import (fused_ffn, fused_ffn_nmajor,
                                               fused_ffn_xla)
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    lib_path = _build.build()
    lib = _build.library()
    for src in ("photonic_matmul.cu", "flash_attention.cu", "fused_ffn.cu"):
        log = _build.ptxas_report().get(src, "")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"[ptxas] {src}: {line.strip()}", flush=True)
        for k, (regs, smem, blocks) in resident_blocks(log).items():
            print(f"[occupancy] {k}: {regs} registers, {smem} bytes of "
                  f"shared memory a block -> {blocks} resident blocks a SM, "
                  f"{132 * blocks} on the card's 132 SMs", flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)
    stream = _build.stream_ptr(dev)

    def dev_ms(fn, match, counter=None):
        return chip_smoke.device_ms(torch, fn, match, iters=200,
                                    counter=counter)

    # -- B1 ------------------------------------------------------------------
    k = n = 768
    for m in (200, 396, 592, 788, 1568):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq, sw = chip_smoke.qweight(torch, gen, k, n, 8, dev)
        wt = wq.t().contiguous()
        sx = torch.rand((), generator=gen, device=dev) * 1e-2
        one, ones = torch.ones((), device=dev), torch.ones(n, device=dev)
        acc = photonic_matmul_int8(xq, wq, one, ones, wt=wt)
        if not torch.equal(acc.long(), ref.int_accumulate_ref(xq, wq).long()):
            print(f"FAIL: B1 ({m},{k},{n}): accumulate not bitwise",
                  file=sys.stderr)
            return 1
        got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
        want = ref.photonic_matmul_ref(xq, wq, sx, sw)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if rel > 1e-6:
            print(f"FAIL: B1 ({m},{k},{n}): relative error {rel:.3e}",
                  file=sys.stderr)
            return 1
        old = torch.empty_like(got)

        def nmajor():
            _build.check(lib.photonic_matmul_s8(
                xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                old.data_ptr(), m, k, n, stream), "photonic_matmul_s8")
        nmajor()
        if not torch.equal(old, got):
            print(f"FAIL: B1 ({m},{k},{n}): the two entries differ",
                  file=sys.stderr)
            return 1
        t_new, _ = dev_ms(lambda: photonic_matmul_int8(xq, wq, sx, sw, wt=wt),
                          ("photonic_matmul_s8_kmajor_kernel",),
                          "photonic_matmul")
        t_old, _ = dev_ms(nmajor, ("photonic_matmul_s8_kernel",))
        t_lib, _ = dev_ms(lambda: torch._int_mm(xq, wq).float() * sx * sw, ())
        print(f"[scan] B1 ({m},{k},{n}): K-major entry {t_new:.5f} ms, "
              f"N-major entry {t_old:.5f} ms, torch._int_mm + dequant "
              f"{t_lib:.5f} ms device (accumulate bitwise, rel err "
              f"{rel:.2e}; {card})", flush=True)

    # -- B2 ------------------------------------------------------------------
    b, h, d = 4, 12, 64
    for s in (50, 99, 148, 197):
        q, kk, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                    .transpose(1, 2) for _ in range(3))
        keep = torch.ones(b, s, device=dev)
        got = flash_attention_masked(q, kk, v, keep)
        for tag, want in (("plain", ref.flash_attention_masked_ref(
                q, kk, v, keep)), ("emulation", ref.flash_attention_masked_tc_ref(
                q.cpu(), kk.cpu(), v.cpu(), keep.cpu()).to(dev))):
            e = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
                print(f"FAIL: B2 S={s} against the {tag}: max abs err {e:.3e}",
                      file=sys.stderr)
                return 1
        e = (got - want).abs().max().item()
        qc, kc, vc = (t.contiguous() for t in (q, kk, v))
        nkv = -(-s // KV_TILE)
        nlive = torch.full((b, nkv), KV_TILE, dtype=torch.int32, device=dev)
        old = torch.empty(b, h, s, d, device=dev)

        def simt():
            _build.check(lib.flash_attention_masked_f32(
                qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), keep.data_ptr(),
                nlive.data_ptr(), old.data_ptr(), b, h, h, h, s, s, d, d, nkv,
                1.0 / math.sqrt(d), stream), "flash_attention_masked_f32")
        simt()
        if not torch.allclose(old, got, rtol=2e-5, atol=2e-5):
            print(f"FAIL: B2 S={s}: the two entries differ", file=sys.stderr)
            return 1
        bmask = (keep > 0)[:, None, None, :]
        t_new, _ = dev_ms(lambda: flash_attention_masked(q, kk, v, keep),
                          ("flash_attention_masked_tc_kernel",),
                          "flash_attention_masked")
        t_old, _ = dev_ms(simt, ("flash_attention_masked_kernel",))
        t_lib, _ = dev_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=bmask), ())
        print(f"[scan] B2 ({b},{h},{s},{d}) strided: tensor-core entry "
              f"{t_new:.5f} ms, SIMT entry {t_old:.5f} ms, SDPA {t_lib:.5f} "
              f"ms device (max abs err {e:.3e} against the emulation; "
              f"{card})", flush=True)

    # -- B3 ------------------------------------------------------------------
    d, dff = 768, 3072
    for n in (50, 99, 148, 197):
        x = torch.randn(4, n, d, generator=gen, device=dev)
        w1q, s1 = chip_smoke.qweight(torch, gen, d, dff, 8, dev)
        w2q, s2 = chip_smoke.qweight(torch, gen, dff, d, 8, dev)
        b1 = torch.randn(dff, generator=gen, device=dev) * 0.1
        b2 = torch.randn(d, generator=gen, device=dev) * 0.1
        args = (x, w1q, s1, b1, w2q, s2, b2)
        w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
        got = fused_ffn(*args, w1t=w1t, w2t=w2t)
        want = ref.fused_ffn_ref(*args)
        e = (got - want).abs().max().item()
        if not torch.equal(got, fused_ffn_nmajor(*args)):
            print(f"FAIL: B3 n={n}: the K-major entry is not bitwise its "
                  f"first design", file=sys.stderr)
            return 1
        if not chip_smoke.quant_step_close(torch, got, want):
            print(f"FAIL: B3 n={n}: outside one quant step of the plain "
                  f"version (max abs err {e:.3e})", file=sys.stderr)
            return 1

        def kmajor():
            return fused_ffn(*args, w1t=w1t, w2t=w2t)
        t_new, _ = dev_ms(kmajor, B3_KMAJOR, "fused_ffn")
        apart = [dev_ms(kmajor, (sym,))[0] for sym in B3_KMAJOR]
        t_old, _ = dev_ms(lambda: fused_ffn_nmajor(*args), B3_FIRST)
        t_plain, _ = dev_ms(lambda: ref.fused_ffn_ref(*args), ())
        t_twin, _ = dev_ms(lambda: fused_ffn_xla(*args), ())
        print(f"[scan] B3 x(4,{n},{d}) d_ff {dff} (M {4 * n}): K-major entry "
              f"{t_new:.5f} ms (phase 0 {apart[0]:.5f}, requant "
              f"{apart[1]:.5f}, phase 1 {apart[2]:.5f}), first design "
              f"{t_old:.5f} ms, plain {t_plain:.5f} ms, composed twin "
              f"(_int_mm + B4, twice) {t_twin:.5f} ms device (bitwise the "
              f"first design, max abs err {e:.2e} against the plain "
              f"version; {card})", flush=True)

    for name, c in sorted(sass_counts(lib_path).items()):
        if any(k_ in name for k_ in KERNELS):
            print(f"[sass] {name}: " + ", ".join(
                f"{op} {c[op]}" for op in SASS_OPS), flush=True)
        if "flash_attention_masked_tc_kernel" in name:
            total = sum(v for k_, v in c.items() if k_.startswith("op:"))
            split = sum(c["op:" + op] for op in ("IADD3", "VIADD", "LOP3",
                                                 "FADD"))
            print(f"[sass-mix] tensor-core B2: {total} instructions; "
                  f"IADD3 + VIADD + LOP3 + FADD (the TF32 splits' "
                  f"operations, with a few others) {split} "
                  f"({100 * split / total:.1f}%), HMMA {c['op:HMMA']} "
                  f"({100 * c['op:HMMA'] / total:.1f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
