"""Symmetric uniform quantization (the reference's src/repro/core/quant.py).

Codes are bit-identical to the reference for equal float inputs: the scale
is ``absmax * f32(1/qmax)`` (a pre-rounded reciprocal, never a division by
qmax), ``quantize`` divides by the scale, rounds half to even
(``torch.round``) and clips to the balanced range [-qmax, qmax], so -128
is never produced. Codes are int8 for bits <= 8 and int32 above.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quant_range", "inv_qmax", "absmax_scale", "quantize", "dequantize"]


def quant_range(bits: int) -> tuple[int, int]:
    """Integer range of a signed symmetric ``bits``-bit code, e.g. 8 -> (-127, 127)."""
    if bits < 2:
        raise ValueError(f"bits must be >= 2, got {bits}")
    qmax = 2 ** (bits - 1) - 1
    return -qmax, qmax


def inv_qmax(bits: int) -> float:
    """f32(1/qmax) as a Python float (exactly representable in f32, so a
    tensor product with it is the reference's f32 reciprocal multiply)."""
    return float(np.float32(1.0 / quant_range(bits)[1]))


def absmax_scale(x: torch.Tensor, bits: int = 8, axis=None,
                 eps: float = 1e-8) -> torch.Tensor:
    """Dynamic symmetric scale s = max(absmax, eps) * f32(1/qmax).

    ``axis``: dims to reduce over (kept as size 1); None reduces everything
    to a 0-dim tensor (per-tensor). For a weight (..., K, N), ``axis=-2``
    gives the per-output-channel scale (..., 1, N).
    """
    a = x.abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, eps).float() * inv_qmax(bits)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Real quantization to int8 (bits <= 8) or int32 codes."""
    qmin, qmax = quant_range(bits)
    q = torch.clamp(torch.round(x / scale), qmin, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
