"""Plain PyTorch versions of the six ported kernels (the numerics
contracts), counterparts of src/repro/kernels/ref.py, of the reference's
XLA twins and of its decode attention (its ring-buffer decode too), and
of the port's noise-draw kernel (the reference's jax.random draws of
core/noise.py).

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

import numpy as np
import torch

from repro_torch.core import quant

__all__ = ["NEG_INF", "prefix_key_mask", "expand_kv_heads", "gelu_tanh",
           "int_accumulate_ref", "dequant_epilogue_ref",
           "photonic_matmul_ref",
           "flash_attention_masked_ref", "flash_attention_ref",
           "flash_decode_ref", "flash_decode_partial_ref", "ring_decode_ref",
           "flash_attention_tc_ref",
           "tf32_rna", "flash_attention_masked_tc_ref",
           "flash_decode_split_ref", "fused_ffn_ref", "slice_live",
           "restore_dead", "transmission_codes_ref", "readout_shot_ref",
           "draw_bits_ref"]

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
    live key output exactly 0. ``scale`` defaults to 1/sqrt(D). Computes in
    f32, or in float64 for float64 q (the exact function, for the checks).
    """
    b, h, _, d = q.shape
    skv = k.shape[2]
    if key_mask is not None and kv_len is not None:
        raise ValueError("give key_mask or kv_len, not both")
    if kv_len is not None:
        key_mask = prefix_key_mask(kv_len, b, skv, q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct) * scale
    s = qf @ expand_kv_heads(k, h).to(ct).transpose(-1, -2)
    if key_mask is not None:
        s = s + ((key_mask.to(ct) - 1.0) * -NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = p @ expand_kv_heads(v, h).to(ct)
    if key_mask is not None:
        o = o * (key_mask.sum(-1) > 0).to(ct)[:, None, None, None]
    return o.to(q.dtype)


def _visible(sq: int, skv: int, causal: bool, window: int, device):
    q_pos = torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= q_pos - kv_pos < window
    return mask


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
    mask = _visible(sq, skv, causal, window, q.device)
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


def ring_decode_ref(q: torch.Tensor, k_ring: torch.Tensor,
                    v_ring: torch.Tensor, pos: int) -> torch.Tensor:
    """One-token GQA attention over a ring-buffer window cache, the
    reference's ``_ring_decode_attention`` in f32: slot s of W holds the
    latest absolute position p <= ``pos`` with p mod W == s, valid iff
    p >= 0; q / sqrt(D), scores, invalid slots NEG_INF, max-subtracted
    exp, PV, divided by the sum. The valid slots are exactly the first
    min(pos + 1, W), so B6 over that many rows computes this function.

    q (B, 1, H, D); k/v_ring (B, W, Hkv, D) -> (B, 1, H, D) in q.dtype."""
    b, _, h, d = q.shape
    w, hkv = k_ring.shape[1], k_ring.shape[2]
    slots = torch.arange(w, device=q.device)
    cur = pos % w
    abs_pos = torch.where(slots <= cur, pos - cur + slots,
                          pos - cur + slots - w)
    valid = abs_pos >= 0
    qf = q.reshape(b, hkv, h // hkv, d).float() / math.sqrt(d)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_ring.float())
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_ring.float())
    o = o / p.sum(-1, keepdim=True)
    return o.reshape(b, 1, h, d).to(q.dtype)


def flash_decode_partial_ref(q: torch.Tensor, k_rows: torch.Tensor,
                             v_rows: torch.Tensor, row0: int,
                             length: int) -> tuple:
    """B6's partial entry: one-token GQA attention against rows [row0,
    row0 + S_r) of a KV cache split along its sequence, global positions
    >= ``length`` masked, in the op order of ``flash_decode_ref`` over
    those rows: q / sqrt(D), scores, masked rows NEG_INF, the max m,
    p = exp(s - m), l = sum p, o = PV / l; and lse = m + log(l). A range
    with no valid row gives o = 0 and lse = NEG_INF (the reference's
    formula there would average the masked rows and give lse = -1e30
    + log(S_r) = -1e30 in f32: a merge weight of exactly 0 either way).

    q (B, 1, H, D); k/v_rows (B, S_r, Hkv, D) -> (o (B, 1, H, D) f32,
    lse (B, H) f32)."""
    b, _, h, d = q.shape
    s_r, hkv = k_rows.shape[1], k_rows.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).float() / math.sqrt(d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_rows.float())
    valid = torch.arange(s_r, device=q.device) + row0 < length
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_rows.float()) / l
    some = l > 0
    o = torch.where(some, o, 0.0)
    lse = torch.where(some, m + torch.log(l), NEG_INF)
    return o.reshape(b, 1, h, d), lse.reshape(b, h)


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0,
                           scale: float | None = None,
                           kv_tile: int = 64) -> torch.Tensor:
    """The bf16 tensor-core B5 kernel's numerics, for the tests (no path
    calls it): 64-key tiles under an online softmax, S = (q k^T) * scale
    (the product of the inputs as given, in f32, then the scale), and
    O += hi V + lo V with P split into hi = bf16(p), lo = bf16(p - hi).
    Same shapes and masks as ``flash_attention_ref``; o * (1 / max(l,
    1e-30))."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kf, vf = (expand_kv_heads(t, h).float() for t in (k, v))
    mask = _visible(sq, skv, causal, window, q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for j0 in range(0, skv, kv_tile):
        kt, vt = kf[:, :, j0:j0 + kv_tile], vf[:, :, j0:j0 + kv_tile]
        vis = mask[:, j0:j0 + kv_tile]
        s = torch.where(vis, (qf @ kt.transpose(-1, -2)) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return (acc * (1.0 / l.clamp_min(1e-30))).to(q.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, the low 13 zero),
    ties away from zero: what ``cvt.rna.tf32.f32`` gives for finite x
    (half a TF32 ulp added to the magnitude, then truncated)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def flash_attention_masked_tc_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  key_mask: torch.Tensor | None = None, *,
                                  kv_len=None, scale: float | None = None,
                                  kv_tile: int = 32,
                                  d_chunk: int | None = None,
                                  passes: int = 3) -> torch.Tensor:
    """The tensor-core B2 kernels' numerics, for the tests (no path calls
    it): q scaled in f32; every matmul operand x split into hi =
    tf32_rna(x) and lo = tf32_rna(x - hi), and S = (q * scale) k^T and
    P V each taken as lo.hi + hi.lo + hi.hi (``passes=3``; ``passes=1``
    keeps hi.hi alone, one TF32 pass); ``kv_tile``-key tiles under an
    online softmax, a tile with no live key skipped for its batch row;
    masked keys score NEG_INF; o = acc / max(l, 1e-30), so rows with no
    live key are exactly 0. ``d_chunk`` takes S as the wide entry walks
    it: summed in f32 chunk by chunk over ``d_chunk``-wide slices of D,
    each chunk's three passes added in turn (D a multiple of it); None is
    the (64, 64) entry's one product over D. Shapes, masks and defaults as
    ``flash_attention_masked_ref``."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    b, h, sq, d = q.shape
    if d_chunk is not None and d % d_chunk:
        raise ValueError(f"D {d} is not a multiple of d_chunk {d_chunk}")
    skv = k.shape[2]
    if key_mask is not None and kv_len is not None:
        raise ValueError("give key_mask or kv_len, not both")
    if kv_len is not None:
        key_mask = prefix_key_mask(kv_len, b, skv, q.device)
    keep = (torch.ones((b, skv), dtype=torch.bool, device=q.device)
            if key_mask is None else key_mask.float() > 0)
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def mm(x, y):
        xh, yh = tf32_rna(x), tf32_rna(y)
        if passes == 1:
            return xh @ yh
        xl, yl = tf32_rna(x - xh), tf32_rna(y - yh)
        return xl @ yh + xh @ yl + xh @ yh

    def scores(x, kt):
        if d_chunk is None:
            return mm(x, kt.transpose(-1, -2))
        s = None
        for c0 in range(0, d, d_chunk):
            part = mm(x[..., c0:c0 + d_chunk],
                      kt[..., c0:c0 + d_chunk].transpose(-1, -2))
            s = part if s is None else s + part
        return s

    qs = q.float() * scale
    kf, vf = (expand_kv_heads(t, h).float() for t in (k, v))

    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), device=q.device)
    for j0 in range(0, skv, kv_tile):
        live = keep[:, j0:j0 + kv_tile][:, None, None, :]
        s = torch.where(live, scores(qs, kf[:, :, j0:j0 + kv_tile]),
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - torch.where(m_new == NEG_INF, 0.0, m_new))
        run = live.any(-1, keepdim=True)      # the tile holds a live key
        l = torch.where(run, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * alpha + mm(p, vf[:, :, j0:j0 + kv_tile]),
                          acc)
        m = torch.where(run, m_new, m)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: int,
                           splits: int) -> torch.Tensor:
    """The cluster B6 kernel's algorithm, for the tests (no path calls it):
    split c of ``splits`` takes cache rows [c * chunk, min((c + 1) * chunk,
    length)), chunk = ceil(length / splits), and keeps its own (max m_c,
    sum l_c, accumulator acc_c) (m_c = NEG_INF, l_c = 0 with no rows); the
    splits merge in order c = 0, 1, ... at the global max m: l = sum l_c
    exp(m_c - m), acc likewise, o = acc / l. q is divided by sqrt(D) first,
    as in ``flash_decode_ref``. Shapes as ``flash_decode_ref``."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qf = q.reshape(b, hkv, h // hkv, d).float() / math.sqrt(d)
    chunk = -(-length // splits)
    parts = []
    for c in range(splits):
        lo, hi = c * chunk, min((c + 1) * chunk, length)
        if lo >= hi:
            parts.append((qf.new_full(qf.shape[:-1] + (1,), NEG_INF),
                          qf.new_zeros(qf.shape[:-1] + (1,)),
                          qf.new_zeros(qf.shape)))
            continue
        s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache[:, lo:hi].float())
        m_c = s.amax(-1, keepdim=True)
        p = torch.exp(s - m_c)
        parts.append((m_c, p.sum(-1, keepdim=True), torch.einsum(
            "bhgs,bshd->bhgd", p, v_cache[:, lo:hi].float())))
    m = torch.stack([m_c for m_c, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for m_c, l_c, a_c in parts:
        f = torch.exp(m_c - m)
        l = l + l_c * f
        acc = acc + a_c * f
    return (acc / l).reshape(b, 1, h, d).to(q.dtype)


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


def _absmax_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    return quant.absmax_scale(x, bits=bits)


def _int8_linear_ref(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     bits: int, scale_fn=_absmax_scale) -> torch.Tensor:
    sx = scale_fn(x2, bits)
    return photonic_matmul_ref(quant.quantize(x2, sx, bits=bits), wq, sx, sw)


def fused_ffn_ref(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
                  b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
                  b2: torch.Tensor, *, bits=(8, 8),
                  live_rows: int | None = None,
                  scale_fn=_absmax_scale) -> torch.Tensor:
    """The fused int8 FFN's arithmetic (the reference's ``fused_ffn_xla``):
    quantize x at bits1, int8 GEMM + dequant, cast to x.dtype, + b1, GELU,
    cast, requantize at bits2 over the live rows, int8 GEMM + dequant,
    cast, + b2. ``live_rows`` drops the dead token tail before any work and
    returns it as exact zeros. ``scale_fn(t, bits)`` takes both absmax
    scales (x's and the hidden state's; the wrapper passes the sharding
    scope's, ``collectives.scoped_absmax_scale``)."""
    bits1, bits2 = bits
    n_tokens = x.shape[-2]
    xl, lv = slice_live(x, live_rows)
    if lv == 0:
        return x.new_zeros(*x.shape[:-1], w2q.shape[1])
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, x.shape[-1]).float()
    h = _int8_linear_ref(x2, w1q, sw1, bits1, scale_fn).to(x.dtype) + b1
    g = gelu_tanh(h.float()).to(x.dtype)
    y = _int8_linear_ref(g.float(), w2q, sw2, bits2,
                         scale_fn).to(x.dtype) + b2
    return restore_dead(y.reshape(*lead, w2q.shape[1]), n_tokens)


# --------------------------------------------------------------------------
# the noise-draw kernel's plain versions (kernels/noise_draw.py)
# --------------------------------------------------------------------------

def transmission_codes_ref(w: torch.Tensor, state: torch.Tensor,
                           salts: tuple, counter: int, fpv_key, mr,
                           fpv_sigma: float,
                           wander_sigma_nm: float) -> torch.Tensor:
    """f32(w) * M: the drifted-branch transmission multiplier M of
    ``core.noise.transmission_error`` under the call's draw key (derived
    from the state tensor, int32[4], with ``salts`` and ``counter``) and
    the state's drift, FPV from ``fpv_key``."""
    from repro_torch.core import noise
    kc = noise.state_draw_key(state, salts, counter)
    m = noise.transmission_error(kc, tuple(w.shape), mr, fpv_sigma,
                                 fpv_key=fpv_key,
                                 drift_nm=noise.state_drift(state),
                                 wander_sigma_nm=wander_sigma_nm)
    return w.float() * m


def readout_shot_ref(y: torch.Tensor, state: torch.Tensor, salts: tuple,
                     counter: int, sigma: float,
                     offset: int = 0) -> torch.Tensor:
    """y * (1 + sigma * n), n = normal(fold_in(draw key, SHOT)) over y's
    shape, as one fused multiply-add; with ``offset``, n is the elements
    [offset, offset + y.numel()) of a larger draw's flat index."""
    from repro_torch.core import noise, threefry
    ks = noise.shot_key(noise.state_draw_key(state, salts, counter))
    n = threefry.normal(ks, tuple(y.shape), offset=offset)
    return y * threefry.fma(n, float(np.float32(sigma)), 1.0)


def draw_bits_ref(state: torch.Tensor, salts: tuple, counter: int,
                  fold: int, shape) -> torch.Tensor:
    """``random_bits`` (int64 of uint32 values) under the call's draw key,
    folded once more with ``fold`` when it is not 0."""
    from repro_torch.core import noise, threefry
    k = noise.state_draw_key(state, salts, counter)
    if fold:
        k = threefry.fold_in(k, fold)
    return threefry.random_bits(k, tuple(shape))
