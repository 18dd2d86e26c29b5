"""The photonic w8a8 matmul: int8 (M, K) x int8 (K, N) -> int32 on the
tensor cores, then the dequant epilogue (f32(acc) * sx) * sw[n] -> f32.

Replaces src/repro/kernels/photonic_matmul.py::photonic_matmul_kernel
(wrapper ``photonic_matmul_int8``). The CUDA kernels are in
``csrc/photonic_matmul.cu`` (its source note says what bounds them on an
H100 and how each design answers that); their plain version is
``kernels/ref.py::photonic_matmul_ref``. The wrapper launches a kernel for
CUDA tensors and takes the plain version only for CPU tensors.

Two entries, chosen by shape only (``entry_for``): ``kmajor`` for every K
that is a multiple of 16, reading the weight's K-major copy ``wt`` (N, K)
that the quantize-once cache keeps beside its codes
(``core/backend.py::QuantizedWeight``), and ``nmajor`` (the first kernel,
reading the (K, N) codes) for the rest: MGNet's 196 x 196 score head.
Each launch counts under ``photonic_matmul``, under
``photonic_matmul.<entry>`` and under ``photonic_matmul.<entry>.K<K>``, so
a run can show which entry each contraction depth took.

The tile configuration keeps the reference's photonic tile rule: the K
tile is a whole number of 32-wide wavelength chunks and the N tile a whole
number of 64-arm groups (paper Fig. 3b).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import photonic_matmul_ref

__all__ = ["WAVELENGTHS", "ARMS", "BM", "BN", "BK", "KMAJOR_K_MULTIPLE",
           "entry_for", "photonic_matmul_int8"]

WAVELENGTHS = 32
ARMS = 64
# tiles of both entries (BM/BN/BK in csrc/int8_gemm.cuh and km:: in
# csrc/photonic_matmul.cu)
BM, BN, BK = 64, 64, 64
assert BK % WAVELENGTHS == 0 and BN % ARMS == 0, (BK, BN)
KMAJOR_K_MULTIPLE = 16           # the K-major entry's 16-byte row copies


def entry_for(k: int) -> str:
    """The entry a CUDA call of contraction depth ``k`` launches."""
    return "kmajor" if k % KMAJOR_K_MULTIPLE == 0 else "nmajor"


def _check(xq, wq, sx, sw, wt) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {xq.dtype} / {wq.dtype}")
    if wt is not None and (wt.dtype != torch.int8
                           or tuple(wt.shape) != tuple(wq.shape)[::-1]):
        raise ValueError(f"wt {wt.dtype} {tuple(wt.shape)} is not the int8 "
                         f"K-major copy of wq {tuple(wq.shape)}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"scales must be f32, got {sx.dtype} / {sw.dtype}")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"shapes {tuple(xq.shape)} x {tuple(wq.shape)}")
    if sx.numel() != 1 or sw.shape != (wq.shape[1],):
        raise ValueError(f"scales {tuple(sx.shape)} / {tuple(sw.shape)} for "
                         f"N={wq.shape[1]}")
    devs = {t.device for t in (xq, wq, sx, sw, wt) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def photonic_matmul_int8(xq: torch.Tensor, wq: torch.Tensor,
                         sx: torch.Tensor, sw: torch.Tensor, *,
                         wt: torch.Tensor | None = None) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx (1-element) f32, sw (N,) f32 ->
    (M, N) f32. Any M, K, N: ragged edges are masked inside the kernels.

    ``wt`` is wq's K-major copy (N, K), contiguous. On the card the
    ``kmajor`` entry (K a multiple of 16) reads it instead of wq and raises
    without it or on 16-byte misaligned xq / wt: the wrapper never
    transposes a weight itself. The plain version reads wq."""
    _check(xq, wq, sx, sw, wt)
    dev = xq.device
    if dev.type == "cpu":
        return photonic_matmul_ref(xq, wq, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"photonic_matmul_int8 runs on cuda or cpu, not {dev}")
    m, k = xq.shape
    n = wq.shape[1]
    entry = entry_for(k)
    xq, sx, sw = (t.contiguous() for t in (xq, sx, sw))
    if entry == "kmajor":
        if wt is None or not wt.is_contiguous():
            raise ValueError("the K-major entry reads the weight's contiguous "
                             "K-major copy: pass wt (N, K), as "
                             "QuantizedWeight.wt holds it")
        if xq.data_ptr() % 16 or wt.data_ptr() % 16:
            raise ValueError("the K-major entry needs 16-byte aligned xq and "
                             "wt")
        w, fn = wt, "photonic_matmul_s8_kmajor"
    else:
        w, fn = wq.contiguous(), "photonic_matmul_s8"
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    err = getattr(_build.library(), fn)(
        xq.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), m, k, n, _build.stream_ptr(dev))
    _build.check(err, fn)
    _build.LAUNCHES["photonic_matmul"] += 1
    _build.LAUNCHES["photonic_matmul." + entry] += 1
    _build.LAUNCHES[f"photonic_matmul.{entry}.K{k}"] += 1
    return out
