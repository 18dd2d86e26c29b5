#!/usr/bin/env python3
"""Variants of B3's phase 1 (the fused FFN's w2 GEMM), timed side by side
with the built kernel on one card: the record of why it is not split.

    python3 scripts/ffn_variants.py

Phase 1 of the K-major entry walks K = d_ff = 3072 in 48 steps on only
(M / 64) x (d_out / 64) blocks (156 at M = 788, d_out = 768). Each variant
splits that walk over S blocks along K (grid z): a text edit of copies of
``kernels/csrc/int8_gemm_kmajor.cuh`` (a row stride for the operands apart
from the walked depth) and ``kernels/csrc/fused_ffn.cu`` (a split kernel
that adds its int32 partial sums into a zeroed (M, d_out) buffer with
atomicAdd), built with the package's nvcc flags into a library of its own.
The int32 sum is exact in any order, so the split phase 1 followed by the
dequant epilogue (B4, ``dequant_epilogue``) at scale2 gives the built
kernel's output bitwise; each variant is checked for that, then timed by
the profiler's device time per call: zeroing the buffer, the split GEMM and
B4, against the built phase 1 alone. Inputs: x (4, n, 768), d_ff 3072, n =
50, 99, 148, 197. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
SPLITS = (2, 4)          # the variants: phase 1's K walk over S blocks

# the operands' row stride apart from the depth a block walks
HEADER_EDITS = (
    (r"int M, int K, int N, Epi& epi\) \{",
     "int M, int K, int N, Epi& epi, int ld = 0) {\n  if (ld == 0) ld = K;"),
    (r"\(size_t\)\(m0 \+ r\) \* K \+ kc", "(size_t)(m0 + r) * ld + kc"),
    (r"\(size_t\)\(n0 \+ r\) \* K \+ kc", "(size_t)(n0 + r) * ld + kc"),
)
SPLIT_KERNEL = r'''
namespace {
struct AtomicEpi {
  int* acc;
  int N;
  __device__ __forceinline__ int column(int) const { return 0; }
  __device__ __forceinline__ void operator()(int m, int n, int, int a0,
                                             int a1) const {
    int* p = acc + (size_t)m * N + n;
    atomicAdd(p, a0);
    if (n + 1 < N) atomicAdd(p + 1, a1);
  }
};

__global__ void __launch_bounds__(repro::km::kThreads)
fused_ffn_splitk_phase1_kernel(const int8_t* __restrict__ hq,
                               const int8_t* __restrict__ w2t,
                               int* __restrict__ acc, int M, int F, int N,
                               int kslice) {
  const int k0 = blockIdx.z * kslice;
  AtomicEpi epi{acc, N};
  repro::km::gemm_s8_tile(hq + k0, w2t + k0, M, min(kslice, F - k0), N, epi,
                          F);
}
}  // namespace

extern "C" int fused_ffn_splitk_phase1(const void* hq, const void* w2t,
                                       void* acc, int M, int F, int N,
                                       int splits, void* stream) {
  namespace km = repro::km;
  const int kslice = (F / splits + km::BK - 1) / km::BK * km::BK;
  fused_ffn_splitk_phase1_kernel<<<dim3((N + km::BN - 1) / km::BN,
                                        (M + km::BM - 1) / km::BM,
                                        (F + kslice - 1) / kslice),
                                   km::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w2t),
      static_cast<int*>(acc), M, F, N, kslice);
  return static_cast<int>(cudaGetLastError());
}
'''


def build(out: Path) -> Path:
    """The edited copies, built into one library in ``out``."""
    from repro_torch.kernels import _build
    for f in ("int8_gemm.cuh", "int8_gemm_kmajor.cuh", "fused_ffn.cu"):
        shutil.copy(CSRC / f, out / f)
    head = (out / "int8_gemm_kmajor.cuh").read_text()
    for pattern, repl in HEADER_EDITS:
        head, n = re.subn(pattern, repl, head, count=1)
        if n != 1:
            raise RuntimeError(f"edit {pattern!r} matched nothing")
    (out / "int8_gemm_kmajor.cuh").write_text(head)
    cu = out / "fused_ffn.cu"
    cu.write_text(cu.read_text() + SPLIT_KERNEL)
    so = out / "libffnvariants.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"the variants do not build:\n{run.stdout}"
                           f"{run.stderr}")
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "splitk" in line:
            print(f"[ptxas] {line.strip()}", flush=True)
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import quant
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ffn import dequant_epilogue, fused_ffn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = ctypes.CDLL(str(build(Path(tempfile.mkdtemp(prefix="b3_")))))
    split = lib.fused_ffn_splitk_phase1
    split.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    split.restype = ctypes.c_int
    kmajor = _build.library().fused_ffn_kmajor

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = _build.stream_ptr(dev)
    d, dff = 768, 3072
    for n in (50, 99, 148, 197):
        m = 4 * n
        x = torch.randn(4, n, d, generator=gen, device=dev)
        w1q, s1 = chip_smoke.qweight(torch, gen, d, dff, 8, dev)
        w2q, s2 = chip_smoke.qweight(torch, gen, dff, d, 8, dev)
        b1 = torch.randn(dff, generator=gen, device=dev) * 0.1
        w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
        want = fused_ffn(x, w1q, s1, b1, w2q, s2, torch.zeros(d, device=dev),
                         w1t=w1t, w2t=w2t).reshape(m, d)
        # the built entry once more on buffers of our own: its codes hq and
        # scale2 (scal[1]) feed the variants; its output is their target
        x2 = x.reshape(m, d)
        sx = quant.absmax_scale(x2, bits=8)
        xq = quant.quantize(x2, sx, bits=8).contiguous()
        hidden = torch.empty(m, dff, device=dev)
        hq = torch.empty(m, dff, dtype=torch.int8, device=dev)
        scal = torch.zeros(2, device=dev)
        out = torch.empty(m, d, device=dev)

        def built():
            scal.zero_()
            _build.check(kmajor(
                xq.data_ptr(), w1t.data_ptr(), sx.data_ptr(), s1.data_ptr(),
                b1.data_ptr(), w2t.data_ptr(), s2.data_ptr(),
                hidden.data_ptr(), hq.data_ptr(), scal.data_ptr(),
                out.data_ptr(), m, d, dff, d, 127, quant.inv_qmax(8), stream),
                "fused_ffn_kmajor")
        built()
        if not torch.equal(out, want):
            print(f"FAIL: n={n}: the built entry on own buffers differs",
                  file=sys.stderr)
            return 1
        t_built, _ = chip_smoke.device_ms(
            torch, built, ("fused_ffn_kmajor_phase1_kernel",), iters=200)
        line = f"[variant] M={m}: built phase 1 {t_built:.5f} ms"
        acc = torch.empty(m, d, dtype=torch.int32, device=dev)
        for s in SPLITS:
            def variant():
                acc.zero_()
                _build.check(split(hq.data_ptr(), w2t.data_ptr(),
                                   acc.data_ptr(), m, dff, d, s, stream),
                             "fused_ffn_splitk_phase1")
                return dequant_epilogue(acc, scal[1:], s2)
            got = variant()
            if not torch.equal(got, out):
                print(f"FAIL: n={n} split {s}: not bitwise the built "
                      f"kernel", file=sys.stderr)
                return 1
            t_all, _ = chip_smoke.device_ms(torch, variant, (), iters=200)
            t_gemm, _ = chip_smoke.device_ms(
                torch, variant, ("fused_ffn_splitk_phase1_kernel",),
                iters=200)
            line += (f"; split {s}: {t_all:.5f} ms with zeroing and B4 "
                     f"(split GEMM {t_gemm:.5f})")
        print(line + f", bitwise ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
