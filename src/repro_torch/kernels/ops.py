"""Serving entry points around the kernels (the reference's
src/repro/kernels/ops.py, serving subset).

``photonic_matmul_prequant`` quantizes the activations per tensor (PyTorch
ops, as the reference runs them under XLA outside its kernel) and feeds
the int8 photonic matmul with the quantize-once cached weight.
``fused_roi_attention_prequant`` is the MHSA hot path: three cached-weight
int8 projections feeding the RoI-masked flash attention kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels.flash_attention import flash_attention_masked
from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

__all__ = ["photonic_matmul_prequant", "fused_roi_attention_prequant"]


def photonic_matmul_prequant(x: torch.Tensor, wq: torch.Tensor,
                             sw: torch.Tensor, *, bits: int = 8
                             ) -> torch.Tensor:
    """x (..., K) float; wq (K, N) int8 codes; sw (N,) f32 per-out-channel
    scale. Returns (..., N) f32. Ragged M, K and N are masked inside the
    kernel, never padded."""
    lead = x.shape[:-1]
    k, n = wq.shape
    x2 = x.reshape(-1, k).float()
    sx = quant.absmax_scale(x2, bits=bits)
    xq = quant.quantize(x2, sx, bits=bits)
    return photonic_matmul_int8(xq, wq, sx, sw).reshape(*lead, n)


def fused_roi_attention_prequant(x: torch.Tensor,
                                 wq: torch.Tensor, sq_: torch.Tensor,
                                 wk: torch.Tensor, sk_: torch.Tensor,
                                 wv: torch.Tensor, sv_: torch.Tensor,
                                 key_mask: torch.Tensor | None = None, *,
                                 heads: int, kv_len: int | None = None,
                                 bits=8) -> torch.Tensor:
    """x (B, n, dm) float; wq/wk/wv (dm, dm) int8 codes with per-out-channel
    scales (dm,) f32; ``key_mask`` (B, n) keep-mask or ``kv_len`` (keys >=
    kv_len pruned). ``bits`` is an int or a (q, k, v) triple. Returns the
    merged head outputs (B, n, dm) in x.dtype; the output projection is the
    caller's ``linear``."""
    if isinstance(bits, (tuple, list)):
        bits_q, bits_k, bits_v = (int(b_) for b_ in bits)
    else:
        bits_q = bits_k = bits_v = int(bits)
    b, n, dm = x.shape
    dh = dm // heads
    xf = x.float()
    if bits_q == bits_k == bits_v:
        # one activation scale and one set of codes feed all three
        # projections: the same numbers as quantizing three times
        x2 = xf.reshape(-1, dm)
        sx = quant.absmax_scale(x2, bits=bits_q)
        xq = quant.quantize(x2, sx, bits=bits_q)
        q, k, v = (photonic_matmul_int8(xq, w, sx, s).reshape(b, n, dm)
                   for w, s in ((wq, sq_), (wk, sk_), (wv, sv_)))
    else:
        q = photonic_matmul_prequant(xf, wq, sq_, bits=bits_q)
        k = photonic_matmul_prequant(xf, wk, sk_, bits=bits_k)
        v = photonic_matmul_prequant(xf, wv, sv_, bits=bits_v)

    def split(t):
        return t.to(x.dtype).reshape(b, n, heads, dh).permute(0, 2, 1, 3)

    o = flash_attention_masked(split(q), split(k), split(v), key_mask,
                               kv_len=kv_len)
    return o.permute(0, 2, 1, 3).reshape(b, n, dm)
