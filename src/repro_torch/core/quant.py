"""Symmetric uniform quantization (the reference's src/repro/core/quant.py).

Codes are bit-identical to the reference for equal float inputs: the scale
is ``absmax * f32(1/qmax)`` (a pre-rounded reciprocal, never a division by
qmax), ``quantize`` divides by the scale, rounds half to even
(``torch.round``) and clips to the balanced range [-qmax, qmax], so -128
is never produced. Codes are int8 for bits <= 8 and int32 above.

``fake_quant`` / ``fake_quant_ste`` (the ``qat`` matmul backend's
quantize -> dequantize) and ``quantize_params`` divide by the scale as the
reference does and return the input's dtype. Both take a precomputed
``scale`` in place of ``absmax_scale(x)``: the one of a tensor split over
ranks, MAX-reduced over them (``distributed/collectives.py``), as the
reference's GSPMD reduces every absmax over the whole logical array. ``fake_quant`` is the
inference form: its round has a zero gradient. ``fake_quant_ste`` is the
training form, with the reference's gradient: the scale is detached (the
reference's ``stop_gradient``), the round passes its gradient straight
through (``_ste_round``), and the clip's gradient is ``jnp.clip``'s VJP,
1 inside the range, 0 outside and 0.5 on either bound (``_jnp_clip``):
``torch.clamp`` would give 1 there, and the absmax element lands exactly
on the bound for most tensors (x / s = absmax / (absmax * f32(1/qmax))).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quant_range", "inv_qmax", "absmax_scale", "quantize", "dequantize",
           "fake_quant", "fake_quant_ste", "quantize_params"]


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


def fake_quant(x: torch.Tensor, bits: int = 8, axis=None,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """quantize -> dequantize in ``x.dtype``: round(x / s), clipped to the
    balanced range, times s (the inference path). ``x / s`` is taken in
    f32, as the reference promotes a low-precision x against its f32
    scale. ``scale`` (default ``absmax_scale(x, bits, axis)``) is s."""
    if scale is None:
        scale = absmax_scale(x, bits=bits, axis=axis)
    qmin, qmax = quant_range(bits)
    q = torch.clamp(torch.round(x.float() / scale), qmin, qmax)
    return (q * scale).to(x.dtype)


class _SteRound(torch.autograd.Function):
    """round half to even forward; the identity backward (Bengio et al.)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _JnpClip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)``, i.e. min(max(x, lo), hi), with JAX's
    gradient: each of max and min hands a tie half the gradient, so the
    VJP is g where lo < x < hi, 0.5 g on either bound and 0 outside."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def _jnp_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _JnpClip.apply(x, lo, hi)


def fake_quant_ste(x: torch.Tensor, bits: int = 8, axis=None,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """The training form of ``fake_quant``: clip x / s, round, times s, with
    the reference's gradient: s detached, the round straight through, the
    clip's VJP that of ``jnp.clip`` (0.5 on the bounds). Equal to
    ``fake_quant`` in value (rounding and clipping to integer bounds
    commute). ``scale`` as ``fake_quant``'s."""
    if scale is None:
        scale = absmax_scale(x, bits=bits, axis=axis)
    scale = scale.detach()
    qmin, qmax = quant_range(bits)
    clipped = _jnp_clip(x.float() / scale, float(qmin), float(qmax))
    return (_SteRound.apply(clipped) * scale).to(x.dtype)


def quantize_params(params, bits: int = 8, min_size: int = 128):
    """Post-training fake quantization of a nested-dict param tree: every
    tensor leaf of ndim >= 2 and at least ``min_size`` elements is
    fake-quantized per output channel (every axis but the last reduced);
    smaller leaves (biases, norm gains) stay as they are."""
    if isinstance(params, dict):
        return {k: quantize_params(v, bits, min_size)
                for k, v in params.items()}
    if (isinstance(params, torch.Tensor) and params.ndim >= 2
            and params.numel() >= min_size):
        return fake_quant(params, bits=bits,
                          axis=tuple(range(params.ndim - 1)))
    return params
