"""The photonic w8a8 matmul: int8 (M, K) x int8 (K, N) -> int32 on the
tensor cores, then the dequant epilogue (f32(acc) * sx) * sw[n] -> f32.

Replaces src/repro/kernels/photonic_matmul.py::photonic_matmul_kernel
(wrapper ``photonic_matmul_int8``). The CUDA kernel is
``csrc/photonic_matmul.cu`` (its source note says what bounds it on an
H100 and how its design answers that); its plain version is
``kernels/ref.py::photonic_matmul_ref``. The wrapper launches the kernel
for CUDA tensors and takes the plain version only for CPU tensors.

The tile configuration keeps the reference's photonic tile rule: the K
tile is a whole number of 32-wide wavelength chunks and the N tile a whole
number of 64-arm groups (paper Fig. 3b).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import photonic_matmul_ref

__all__ = ["WAVELENGTHS", "ARMS", "BM", "BN", "BK", "photonic_matmul_int8"]

WAVELENGTHS = 32
ARMS = 64
BM, BN, BK = 64, 64, 64          # = BM/BN/BK in csrc/int8_gemm.cuh
assert BK % WAVELENGTHS == 0 and BN % ARMS == 0, (BK, BN)


def _check(xq, wq, sx, sw) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {xq.dtype} / {wq.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"scales must be f32, got {sx.dtype} / {sw.dtype}")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"shapes {tuple(xq.shape)} x {tuple(wq.shape)}")
    if sx.numel() != 1 or sw.shape != (wq.shape[1],):
        raise ValueError(f"scales {tuple(sx.shape)} / {tuple(sw.shape)} for "
                         f"N={wq.shape[1]}")
    devs = {t.device for t in (xq, wq, sx, sw)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def photonic_matmul_int8(xq: torch.Tensor, wq: torch.Tensor,
                         sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx (1-element) f32, sw (N,) f32 ->
    (M, N) f32. Any M, K, N: ragged edges are masked inside the kernel."""
    _check(xq, wq, sx, sw)
    dev = xq.device
    if dev.type == "cpu":
        return photonic_matmul_ref(xq, wq, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"photonic_matmul_int8 runs on cuda or cpu, not {dev}")
    xq, wq, sx, sw = (t.contiguous() for t in (xq, wq, sx, sw))
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    err = _build.library().photonic_matmul_s8(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), m, k, n, _build.stream_ptr(dev))
    _build.check(err, "photonic_matmul_s8")
    _build.LAUNCHES["photonic_matmul"] += 1
    return out
