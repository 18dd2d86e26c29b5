"""Multi-head self-attention dataflows (the reference's
src/repro/core/decomposed_attention.py): the standard one and the paper's
Eq. 2 decomposition.

Standard attention scores S = Q K^T with Q = X W_Q and K = X W_K. On the
photonic core one operand of every product is tuned onto MR banks, so the
paper re-associates (Eq. 2):

    Q K^T = Q (X W_K)^T = (Q W_K^T) X^T

and folds 1/sqrt(d_k) into the tuned W_K^T. Every operand to be tuned
(W_Q, W_K^T, X^T, softmax(S), W_V) is known when the step starts. The
decomposed form spends 2 n^2 (d_m - d_k) more score FLOPs a head; its gain
on the hardware is the removed tuning bubble, not FLOPs
(``decomposition_flops``).

Both dataflows route their weight products through ``linear`` and their
score-softmax-PV core through ``attend`` (the ``xla`` materialized scores
or the RoI-masked flash attention kernel, which takes D_qk != D_v: Eq. 2
calls it with q (B, H, n, d_m), one shared key head X (B, 1, n, d_m) and
v (B, H, n, d_k)). ``mhsa_standard`` on the int8 photonic matmul + flash
attention with cached Q/K/V runs the fused serving branch
(kernels/ops.py::fused_roi_attention_prequant); asked for with weights it
cannot take, it raises with the reason where the reference warns once and
runs the composed dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import (ExecPolicy, QuantizedWeight,
                                      _no_backward_reason, attend, linear)

__all__ = ["attention_scores_standard", "attention_scores_decomposed",
           "attention_heads", "mhsa_standard", "mhsa_decomposed", "decomposition_flops"]


def _as_array(w) -> torch.Tensor:
    """The float weight of either form: the decomposed path re-derives
    W_K^T slices (a re-tuning on the hardware), so a cached weight is
    dequantized first."""
    return w.dequantize() if isinstance(w, QuantizedWeight) else w


def _inv_sqrt(dh: int) -> float:
    """1 / sqrt(dh) as the reference's f32 ``1.0 / jnp.sqrt(dh)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def attention_scores_standard(x: torch.Tensor, wq: torch.Tensor,
                              wk: torch.Tensor, scale: float) -> torch.Tensor:
    """S = (X W_Q)(X W_K)^T * scale.  x (..., n, dm); wq/wk (dm, dk)."""
    q = x @ wq
    k = x @ wk
    return (q @ k.transpose(-1, -2)) * scale


def attention_scores_decomposed(x: torch.Tensor, wq: torch.Tensor,
                                wk: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """S = ((X W_Q) (W_K^T * scale)) X^T: Eq. 2 with the scale folded into
    the tuned W_K^T, as the paper tunes the MR bank."""
    q = x @ wq                                    # (..., n, dk)
    qwk = q @ (wk.transpose(-1, -2) * scale)      # (..., n, dm)
    return qwk @ x.transpose(-1, -2)              # (..., n, n)


def _heads_split(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., n, h * dh) -> (..., h, n, dh), a view."""
    *lead, n, d = t.shape
    return t.reshape(*lead, n, h, d // h).transpose(-2, -3)


def _fused_prequant_ineligible_reason(params: dict,
                                      policy: ExecPolicy | None,
                                      x: torch.Tensor) -> str | None:
    """None when the whole MHSA block can take the fused serving branch:
    the int8 photonic matmul, the flash attention core and Q/K/V cached
    at (possibly different) widths of at most 8 bits, on (B, n, dm)
    tokens; else why not. Calibrated device noise is the first reason:
    the fused branch is the clean digital contract."""
    p = policy or ExecPolicy()
    if p.noise is not None:
        return ("calibrated device noise is active (ExecPolicy.noise) — "
                "the fused prequant kernel is the clean digital contract; "
                "noisy execution runs the composed analog dispatch")
    if p.resolve_attn_backend() != "flash":
        return (f"attention backend is {p.resolve_attn_backend()!r}, "
                f"fused prequant needs 'flash'")
    if p.backend != "photonic_pallas":
        return (f"matmul backend is {p.backend!r}, fused prequant needs "
                f"'photonic_pallas'")
    if x.ndim != 3:
        return f"x.ndim == {x.ndim}, fused prequant needs (B, n, dm)"
    if not all(isinstance(params[n], QuantizedWeight)
               for n in ("wq", "wk", "wv")):
        return "QKV not quantize-once cached (run prepare_params)"
    bits = tuple(params[n].bits for n in ("wq", "wk", "wv"))
    if not all(isinstance(b, int) and b <= 8 for b in bits):
        return (f"QKV bit widths {bits} not all single <= 8-bit widths "
                f"(stacked per-layer bits must be sliced first)")
    return None


def attention_heads(x: torch.Tensor, params: dict, heads: int,
                    policy: ExecPolicy | None = None,
                    mask: torch.Tensor | None = None,
                    kv_len: int | None = None) -> torch.Tensor:
    """The standard dataflow's merged head outputs before wo, (..., n,
    heads * dh): the Q/K/V projections through ``linear`` and the core
    through ``attend``. ``heads`` is the count wq/wk/wv's columns hold
    (this rank's under a head split)."""
    q = _heads_split(linear(x, params["wq"], policy=policy), heads)
    k = _heads_split(linear(x, params["wk"], policy=policy), heads)
    v = _heads_split(linear(x, params["wv"], policy=policy), heads)
    o = attend(q, k, v, policy, mask=mask, kv_len=kv_len)  # (..., h, n, dh)
    return o.transpose(-2, -3).reshape(*x.shape[:-1], -1)


def mhsa_standard(x: torch.Tensor, params: dict, heads: int,
                  policy: ExecPolicy | None = None,
                  mask: torch.Tensor | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """Multi-head self-attention, standard dataflow.

    x (..., n, dm); params wq/wk/wv/wo (dm, dm), raw or cached. ``mask``
    (..., n) keep-mask removes tokens from the key axis; ``kv_len`` is the
    packed alternative (keys >= kv_len pruned). On photonic_pallas + flash
    with cached Q/K/V the fused serving branch runs (three int8
    projections into the flash kernel); with that pair and weights it
    cannot take, this raises. Otherwise the four projections go through
    ``linear`` and the core through ``attend`` (``attention_heads``)."""
    p = policy or ExecPolicy()
    if p.resolve_attn_backend() == "flash" and p.backend == "photonic_pallas":
        _no_backward_reason(p, "fused attention", x,
                            *(params[n] for n in ("wq", "wk", "wv")))
    reason = _fused_prequant_ineligible_reason(params, policy, x)
    if reason is None:
        from repro_torch.kernels.ops import fused_roi_attention_prequant

        if mask is not None:
            mask = torch.broadcast_to(mask, x.shape[:2])
        o = fused_roi_attention_prequant(
            x, params["wq"].wq, params["wq"].scale.reshape(-1),
            params["wk"].wq, params["wk"].scale.reshape(-1),
            params["wv"].wq, params["wv"].scale.reshape(-1),
            mask, heads=heads, kv_len=kv_len,
            bits=tuple(params[n].bits for n in ("wq", "wk", "wv")),
            kmajor=tuple(params[n].wt for n in ("wq", "wk", "wv")))
        return linear(o, params["wo"], policy=policy)
    if p.resolve_attn_backend() == "flash" and p.backend == "photonic_pallas":
        raise ValueError(f"the fused attention branch (photonic_pallas + "
                         f"flash) was asked for but cannot run: {reason}")
    o = attention_heads(x, params, heads, policy, mask, kv_len)
    return linear(o, params["wo"], policy=policy)


def mhsa_decomposed(x: torch.Tensor, params: dict, heads: int,
                    policy: ExecPolicy | None = None,
                    mask: torch.Tensor | None = None,
                    kv_len: int | None = None) -> torch.Tensor:
    """Multi-head self-attention with the Eq. 2 score dataflow, per head:
    S_h = (X Wq_h) (Wk_h^T / sqrt(dh)) X^T.

    Q, V and O go through ``linear``; each head's W_K^T / sqrt(dh) is its
    own tuned weight, passed raw (from W_K, dequantized when cached) and
    quantized per call on the quantizing backends, head by head; on bf16
    one einsum gives the same numbers. The core goes through ``attend``
    with X itself as the one shared key head and the scale already
    folded."""
    dm = x.shape[-1]
    dh = dm // heads
    scale = _inv_sqrt(dh)
    wk = _as_array(params["wk"]).reshape(dm, heads, dh)
    q = _heads_split(linear(x, params["wq"], policy=policy), heads)
    if (policy or ExecPolicy()).backend == "bf16":
        dt = torch.promote_types(q.dtype, wk.dtype)
        qwk = torch.einsum("...hnk,dhk->...hnd", q.to(dt), wk.to(dt)) * scale
    else:
        qwk = torch.stack(
            [linear(q[..., h, :, :], wk[:, h, :].t() * scale, policy=policy)
             for h in range(heads)], dim=-3)
    v = _heads_split(linear(x, params["wv"], policy=policy), heads)
    o = attend(qwk, x[..., None, :, :], v, policy, mask=mask, kv_len=kv_len,
               scale=1.0)
    o = o.transpose(-2, -3).reshape(*x.shape[:-1], dm)
    return linear(o, params["wo"], policy=policy)


def decomposition_flops(n: int, dm: int, dk: int) -> dict:
    """FLOPs of the two score dataflows, per head:
    standard   K projection 2 n dm dk + scores 2 n^2 dk;
    decomposed Q W_K^T      2 n dk dm + scores 2 n^2 dm
    (the Q projection and softmax(S) V are common to both)."""
    std = 2 * n * dm * dk + 2 * n * n * dk
    dec = 2 * n * dk * dm + 2 * n * n * dm
    return {"standard": std, "decomposed": dec, "ratio": dec / std}
