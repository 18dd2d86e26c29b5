"""LM attention: GQA causal flash attention (prefill) and cache decode (the
reference's src/repro/models/attention.py, dense-LM subset).

Layouts are the reference's: q (B, S, H, D), k/v (B, S, Hkv, D), caches
(B, S, Hkv, D). ``blockwise_attention`` runs the causal flash attention
kernel on the card (kernels/flash_attention.py::flash_attention, which
replaces the TPU ``flash_attention_kernel``) and its plain version on the
CPU; the reference's XLA scan and its ``full_attention`` fallback at or
below one KV block compute the same function (the tests hold the plain
version against ``full_attention``). ``decode_attention`` runs the flash
decode kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode

__all__ = ["blockwise_attention", "decode_attention", "update_kv_cache"]


def blockwise_attention(q, k, v, *, causal=True, window=0):
    """Flash attention. q (B, Sq, H, D); k/v (B, Skv, Hkv, D) ->
    (B, Sq, H, D) in q.dtype.

    On the card: the causal/local-window flash attention kernel, which
    tiles on its own and always skips invisible KV tiles (the reference's
    XLA tiling knobs ``block_q``, ``block_kv`` and ``block_skip`` choose
    among ways to compute this same function, so the port takes none).
    On the CPU: the kernel's plain version. Queries start at key 0. The
    head/sequence swap is a view both ways: the kernel reads by strides
    and writes its output in q's layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, length: int, *, window=0):
    """One-token attention against a KV cache. q (B, 1, H, D); k/v_cache
    (B, S, Hkv, D); ``length`` a host int count of valid cache rows (the
    new token's K/V already written at ``length - 1``). Returns
    (B, 1, H, D) in q.dtype.

    On the card: the flash decode kernel, which reads only the first
    ``length`` rows; on the CPU its plain version. ``window > 0`` (the
    hybrid family's local attention) is not ported yet."""
    if window > 0:
        raise NotImplementedError(
            "decode_attention with a local window is hybrid-only and not "
            "ported yet (ROADMAP.md queue A15)")
    return flash_decode(q, k_cache, v_cache, length)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos: int):
    """Write the new token's K/V (B, 1, Hkv, D) at row ``pos`` of the
    caches (B, S, Hkv, D) and return them.

    The write is in place: the returned tensors are the arguments (the
    reference returns new arrays). That is safe for the port's callers,
    because ``decode_step`` hands each layer a view of the stacked cache
    and ``launch/serve.py::generate`` never reads a cache from before a
    step again; a caller that needs the old cache copies it first."""
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
