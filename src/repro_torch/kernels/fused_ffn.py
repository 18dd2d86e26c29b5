"""The fused int8 photonic GELU-MLP: w1 GEMM + dequant + b1 + tanh-GELU +
requantization at the hidden absmax + w2 GEMM + dequant, then + b2.

Replaces src/repro/kernels/fused_ffn.py::fused_ffn_kernel (wrapper
``fused_ffn_int8``, host pick ``fused_ffn``). The CUDA kernels are the two
phases in ``csrc/fused_ffn.cu`` (its source note says why there are two
launches, how d_ff is tiled, and what bounds them on an H100); the plain
version is ``kernels/ref.py::fused_ffn_ref``. The wrapper launches the kernels for
CUDA tensors and takes the plain version only for CPU tensors.

As in the reference, x is quantized at w1's width outside the kernel, b2
is added outside, and ``live_rows`` prefix-slices the token rows before any
work (dead rows come back as exact zeros, and the hidden absmax reduces
over live rows only).
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_ffn_ref, restore_dead, slice_live

__all__ = ["bits_pair", "fused_ffn"]


def bits_pair(bits) -> tuple[int, int]:
    """(w1 width, w2 width) from an int or a pair, each in [2, 8]."""
    if isinstance(bits, (tuple, list)):
        b1, b2 = (int(b) for b in bits)
    else:
        b1 = b2 = int(bits)
    if not (2 <= b1 <= 8 and 2 <= b2 <= 8):
        raise ValueError(f"fused FFN bit widths {bits!r} outside [2, 8]")
    return b1, b2


def fused_ffn(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
              b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
              b2: torch.Tensor, *, bits=8,
              live_rows: int | None = None) -> torch.Tensor:
    """x (..., n, d_in) float; w1q (d_in, d_ff) int8 + sw1 (d_ff,) f32 +
    b1 (d_ff,); w2q (d_ff, d_out) int8 + sw2 (d_out,) f32 + b2 (d_out,).
    Returns (..., n, d_out) in x.dtype. ``bits`` is an int or a (w1, w2)
    pair; ``live_rows`` keeps only the first token rows."""
    bits1, bits2 = bits_pair(bits)
    k1, dff = w1q.shape
    dff2, dout = w2q.shape
    if x.shape[-1] != k1 or dff != dff2 or w1q.dtype != torch.int8 \
            or w2q.dtype != torch.int8:
        raise ValueError(f"shapes/dtypes x {tuple(x.shape)} w1 "
                         f"{tuple(w1q.shape)} {w1q.dtype} w2 "
                         f"{tuple(w2q.shape)} {w2q.dtype}")
    dev = x.device
    if any(t.device != dev for t in (w1q, sw1, b1, w2q, sw2, b2)):
        raise ValueError("x and the FFN weights must share one device")
    if dev.type == "cpu":
        return fused_ffn_ref(x, w1q, sw1, b1, w2q, sw2, b2,
                             bits=(bits1, bits2), live_rows=live_rows)
    if dev.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take f32 activations, got {x.dtype}")
    n_tokens = x.shape[-2]
    xl, lv = slice_live(x, live_rows)
    if lv == 0:
        return x.new_zeros(*x.shape[:-1], dout)
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, k1)
    m = x2.shape[0]
    sx = quant.absmax_scale(x2, bits=bits1)
    xq = quant.quantize(x2, sx, bits=bits1).contiguous()
    w1q, w2q = w1q.contiguous(), w2q.contiguous()
    sw1, sw2 = sw1.float().contiguous(), sw2.float().contiguous()
    b1f = b1.float().contiguous()
    hidden = torch.empty((m, dff), dtype=torch.float32, device=dev)
    amax = torch.zeros((1,), dtype=torch.float32, device=dev)
    out = torch.empty((m, dout), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    _build.check(lib.fused_ffn_phase0(
        xq.data_ptr(), w1q.data_ptr(), sx.data_ptr(), sw1.data_ptr(),
        b1f.data_ptr(), hidden.data_ptr(), amax.data_ptr(), m, k1, dff,
        stream), "fused_ffn_phase0")
    _build.check(lib.fused_ffn_phase1(
        hidden.data_ptr(), w2q.data_ptr(), amax.data_ptr(), sw2.data_ptr(),
        out.data_ptr(), m, dff, dout, quant.quant_range(bits2)[1],
        quant.inv_qmax(bits2), stream), "fused_ffn_phase1")
    _build.LAUNCHES["fused_ffn"] += 1
    y = out + b2
    return restore_dead(y.reshape(*lead, dout), n_tokens)
