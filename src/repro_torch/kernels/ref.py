"""Plain PyTorch versions of the six ported kernels (the numerics
contracts), counterparts of src/repro/kernels/ref.py, of the reference's
XLA twins and of its decode attention.

Each function here is the same function as its CUDA kernel. The wrappers
take them for tensors on the CPU, the tests hold them against the
reference, and ``chip_smoke.py`` holds each kernel against them on the
card. The integer accumulate is done in float64: every int8 product is
exact and every partial sum an integer below 2^53, so the float64 sum is
the exact int32 accumulate in any order, and float64 matrix products run
on both the CPU and the card (PyTorch has no int32 matmul on CUDA).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import quant

__all__ = ["NEG_INF", "prefix_key_mask", "expand_kv_heads", "gelu_tanh",
           "int_accumulate_ref", "dequant_epilogue_ref",
           "photonic_matmul_ref",
           "flash_attention_masked_ref", "flash_attention_ref",
           "flash_decode_ref", "fused_ffn_ref", "slice_live", "restore_dead"]

NEG_INF = -1e30


def prefix_key_mask(kv_len, b: int, skv: int, device=None) -> torch.Tensor:
    """Packed kept-count -> (b, skv) f32 prefix keep-mask (key j kept iff
    j < kv_len; kv_len an int, or a tensor of shape () or (b,))."""
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    lens = lens.expand(b)
    ar = torch.arange(skv, dtype=torch.int32, device=lens.device)
    return (ar[None, :] < lens[:, None]).float()


def expand_kv_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., hk, s, d) -> (..., h, s, d): query head i reads KV head
    i // (h // hk) (contiguous GQA repeat; hk == 1 broadcasts)."""
    hk = t.shape[-3]
    if hk == h:
        return t
    if hk == 1:
        return t.expand(*t.shape[:-3], h, *t.shape[-2:])
    return torch.repeat_interleave(t, h // hk, dim=-3)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in the reference's operation order
    (``jax.nn.gelu``'s default): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))."""
    c = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def int_accumulate_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulate of int8 codes: (M, K) . (K, N) -> (M, N)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def dequant_epilogue_ref(acc: torch.Tensor, sx: torch.Tensor,
                         sw: torch.Tensor) -> torch.Tensor:
    """Per-tensor x per-out-channel dequant of an int32 accumulate: acc
    (M, N) int32; sx () f32; sw (N,) f32 -> (M, N) f32 = (f32(acc) * sx) *
    sw, two rounded products in that order and no bias."""
    return (acc.float() * sx.reshape(())) * sw[None, :]


def photonic_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """Integer-exact w8a8 matmul + dequant. xq (M, K) int8; wq (K, N) int8;
    sx () f32; sw (N,) f32 -> (M, N) f32 = (f32(acc) * sx) * sw."""
    return dequant_epilogue_ref(int_accumulate_ref(xq, wq), sx, sw)


def flash_attention_masked_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               key_mask: torch.Tensor | None = None, *,
                               kv_len=None,
                               scale: float | None = None) -> torch.Tensor:
    """Key-masked bidirectional attention with materialized scores.

    q (B, H, Sq, D); k (B, Hk, Skv, D); v (B, Hv, Skv, Dv) -> (B, H, Sq, Dv).
    ``key_mask`` (B, Skv) {0,1} keep-mask or ``kv_len`` (key j kept iff
    j < kv_len); at most one. Masked keys score NEG_INF; batch rows with no
    live key output exactly 0. ``scale`` defaults to 1/sqrt(D).
    """
    b, h, _, d = q.shape
    skv = k.shape[2]
    if key_mask is not None and kv_len is not None:
        raise ValueError("give key_mask or kv_len, not both")
    if kv_len is not None:
        key_mask = prefix_key_mask(kv_len, b, skv, q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    s = qf @ expand_kv_heads(k, h).float().transpose(-1, -2)
    if key_mask is not None:
        s = s + ((key_mask.float() - 1.0) * -NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = p @ expand_kv_heads(v, h).float()
    if key_mask is not None:
        o = o * (key_mask.sum(-1) > 0).float()[:, None, None, None]
    return o.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Causal / local-window GQA attention with materialized scores (the
    reference's ``flash_attention_ref``). q (B, H, Sq, D); k/v (B, Hkv,
    Skv, D) -> (B, H, Sq, D) in q.dtype; f32 inside.

    Query i sees key j iff (not causal or i >= j) and (window == 0 or
    i - j < window); hidden keys score NEG_INF. ``scale`` (default
    1/sqrt(D)) multiplies q. Rows with no visible key return exactly 0.
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = (q.float() * scale) @ expand_kv_heads(k, h).float().transpose(-1, -2)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= q_pos - kv_pos < window
    s = torch.where(mask, s, NEG_INF)
    o = torch.softmax(s, dim=-1) @ expand_kv_heads(v, h).float()
    o = torch.where(mask.any(-1)[:, None], o, 0.0)
    return o.to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """One-token GQA attention against the first ``length`` rows of a KV
    cache, in the op order of the reference's ``decode_attention`` (window
    0, f32 compute): q / sqrt(D), scores over every cache row, rows >=
    ``length`` set to NEG_INF, max-subtracted exp, sum, PV, divide.

    q (B, 1, H, D); k/v_cache (B, S, Hkv, D) -> (B, 1, H, D) in q.dtype.
    """
    b, _, h, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).float() / math.sqrt(d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    valid = torch.arange(s_len, device=q.device) < length
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()) / l
    return o.reshape(b, 1, h, d).to(q.dtype)


def slice_live(x: torch.Tensor, live_rows: int | None):
    """Static packed skip: keep the first ``live_rows`` token rows (axis -2).
    Returns (live slice, live count)."""
    n = x.shape[-2]
    if live_rows is None:
        return x, n
    lv = max(0, min(n, int(live_rows)))
    return x[..., :lv, :], lv


def restore_dead(y: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-fill the dead token tail back to ``n`` rows."""
    if y.shape[-2] == n:
        return y
    pad = y.new_zeros(*y.shape[:-2], n - y.shape[-2], y.shape[-1])
    return torch.cat([y, pad], dim=-2)


def _int8_linear_ref(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     bits: int) -> torch.Tensor:
    sx = quant.absmax_scale(x2, bits=bits)
    return photonic_matmul_ref(quant.quantize(x2, sx, bits=bits), wq, sx, sw)


def fused_ffn_ref(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
                  b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
                  b2: torch.Tensor, *, bits=(8, 8),
                  live_rows: int | None = None) -> torch.Tensor:
    """The fused int8 FFN's arithmetic (the reference's ``fused_ffn_xla``):
    quantize x at bits1, int8 GEMM + dequant, cast to x.dtype, + b1, GELU,
    cast, requantize at bits2 over the live rows, int8 GEMM + dequant,
    cast, + b2. ``live_rows`` drops the dead token tail before any work and
    returns it as exact zeros."""
    bits1, bits2 = bits
    n_tokens = x.shape[-2]
    xl, lv = slice_live(x, live_rows)
    if lv == 0:
        return x.new_zeros(*x.shape[:-1], w2q.shape[1])
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, x.shape[-1]).float()
    h = _int8_linear_ref(x2, w1q, sw1, bits1).to(x.dtype) + b1
    g = gelu_tanh(h.float()).to(x.dtype)
    y = _int8_linear_ref(g.float(), w2q, sw2, bits2).to(x.dtype) + b2
    return restore_dead(y.reshape(*lead, w2q.shape[1]), n_tokens)
