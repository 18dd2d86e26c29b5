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

Neither kernel has a backward. A training policy's prefill (the LM's
training step) takes ``plain_attention``, the kernel's plain version, on
either device (``transformer.attn_forward`` chooses by the policy), as the
reference trains through its XLA attention and reaches no Pallas kernel;
operands that need a gradient reaching ``blockwise_attention`` raise.

Under a "model" split of the query heads (the tensor-parallel LM) each
rank holds a block of the query heads and the whole K / V; ``kv_runs``
pairs the block with the KV heads it reads (models/transformer.py
launches once a run; the hybrid's ring decode too, each run over the
whole ring).

The hybrid family's local attention reads a ring-buffer cache of W =
min(window, S) slots, slot pos mod W holding position pos
(``ring_decode_attention``). RoPE is applied to each key when it is
written, so the softmax does not depend on the order of the slots, and
the valid slots are exactly the first min(pos + 1, W): B6 runs on the
ring unchanged with that length, and a ring split along its slots is a
split cache of that length (below). A window over a linear cache
(``decode_attention(window=)``) runs B6 on the view of its last
``window`` valid rows.

Under a "kv_seq" split of the decode cache (``DEFAULT_RULES``: the
sequence over "model", the reference's flash-decoding layout) each rank
holds rows [row0, row0 + S / M) of every cache. ``update_kv_cache``
writes the new token's row on the rank that owns its position only;
``decode_attention`` takes B6's partial entry over the rank's rows
(``kernels/flash_decode.py::flash_decode_partial``), all-gathers the
partials (B x H x (D + 1) f32 a rank) and merges them in f32
(``merge_partials``), as the reference composes the merge outside its
kernel (src/repro/kernels/flash_decode.py:16-17).
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import _needs_grad
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partial
from repro_torch.kernels.ref import flash_attention_ref, ring_decode_ref

__all__ = ["blockwise_attention", "plain_attention", "decode_attention",
           "ring_decode_attention", "merge_partials", "update_kv_cache",
           "kv_runs"]


def blockwise_attention(q, k, v, *, causal=True, window=0):
    """Flash attention. q (B, Sq, H, D); k/v (B, Skv, Hkv, D) ->
    (B, Sq, H, D) in q.dtype.

    On the card: the causal/local-window flash attention kernel, which
    tiles on its own and always skips invisible KV tiles (the reference's
    XLA tiling knobs ``block_q``, ``block_kv`` and ``block_skip`` choose
    among ways to compute this same function, so the port takes none).
    On the CPU: the kernel's plain version. Queries start at key 0. The
    head/sequence swap is a view both ways: the kernel reads by strides
    and writes its output in q's layout. Operands that need a gradient
    raise on either device: the kernel has no backward (a training policy
    takes ``plain_attention``)."""
    if _needs_grad(q, k, v):
        raise ValueError(
            "operands that need a gradient reached the causal flash "
            "attention kernel, which has no backward; a training policy "
            "trains through plain_attention, and a serving forward runs "
            "under torch.no_grad() or on weights that need no gradient")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def plain_attention(q, k, v, *, causal=True, window=0):
    """``blockwise_attention``'s function through the kernel's plain
    version (kernels/ref.py::flash_attention_ref) on either device, under
    autograd: the attention of a training policy."""
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, length: int, *, window=0,
                     seq=None):
    """One-token attention against a KV cache. q (B, 1, H, D); k/v_cache
    (B, S, Hkv, D); ``length`` a host int count of valid cache rows (the
    new token's K/V already written at ``length - 1``). Returns
    (B, 1, H, D) in q.dtype.

    On the card: the flash decode kernel, which reads only the first
    ``length`` rows; on the CPU its plain version. ``seq`` (a
    ``sharding.Split`` of the cache's sequence) says the caches are this
    rank's rows of a split cache and ``length`` the global count: B6's
    partial entry over them, merged with every rank's of ``seq.group``
    (each rank must call it), the output of all q's heads. ``window > 0``
    attends the last ``window`` valid rows, [length - window, length), as
    the reference's mask: B6 on that view of the caches; under ``seq``
    the partial entry on the view of the rank's rows from the window's
    first (``row0`` shifted by as many), none where the window starts
    past them."""
    lo = max(0, length - window) if window > 0 else 0
    if seq is None:
        if window > 0:
            return flash_decode(q, k_cache[:, lo:length],
                                v_cache[:, lo:length], length - lo)
        return flash_decode(q, k_cache, v_cache, length)
    from repro_torch.distributed import collectives

    rows = k_cache.shape[1]
    row0 = seq.index * rows
    skip = max(lo - row0, 0)
    if skip >= rows:
        # every row of this rank lies before the window: an empty range
        o, lse = flash_decode_partial(q, k_cache, v_cache, row0, row0)
    else:
        o, lse = flash_decode_partial(q, k_cache[:, skip:], v_cache[:, skip:],
                                      row0 + skip, length)
    b, _, h, d = o.shape
    mine = torch.cat([o.reshape(b, h, d), lse[..., None]], -1)[None]
    parts = collectives.all_gather_cat(mine, seq.group, 0, "decode_partials")
    return merge_partials(parts[..., :d].reshape(-1, b, 1, h, d),
                          parts[..., d]).to(q.dtype)


def ring_decode_attention(q, k_ring, v_ring, pos: int):
    """One-token attention at position ``pos`` (host int) over a ring
    cache (B, W, Hkv, D) whose slot pos mod W already holds the new K/V.
    On the card: the flash decode kernel over the first min(pos + 1, W)
    slots; on the CPU the ring's plain version (``ref.ring_decode_ref``,
    the reference's ring decode in f32), the same function."""
    if q.device.type == "cpu":
        return ring_decode_ref(q, k_ring, v_ring, pos)
    return flash_decode(q, k_ring, v_ring, min(pos + 1, k_ring.shape[1]))


def merge_partials(o, lse):
    """The flash-decoding merge of R ranks' partials, in f32 and in rank
    order: o (R, B, 1, H, D) and lse (R, B, H) -> (B, 1, H, D) f32, with
    lse* = max + log sum exp(lse_r - max) and o = sum exp(lse_r - lse*)
    o_r. A rank with no valid row (lse_r = NEG_INF) weighs exactly 0."""
    m = lse.amax(0)
    total = m + torch.log(torch.exp(lse - m).sum(0))
    w = torch.exp(lse - total)
    out = w[0, :, None, :, None] * o[0]
    for r in range(1, o.shape[0]):
        out = out + w[r, :, None, :, None] * o[r]
    return out


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos: int, seq=None):
    """Write the new token's K/V (B, 1, Hkv, D) at row ``pos`` of the
    caches (B, S, Hkv, D) and return them. Under ``seq`` (the caches this
    rank's rows of a sequence split) only the rank that owns ``pos``
    writes, at ``pos - row0``.

    The write is in place: the returned tensors are the arguments (the
    reference returns new arrays). That is safe for the port's callers,
    because ``decode_step`` hands each layer a view of the stacked cache
    and ``launch/serve.py::generate`` never reads a cache from before a
    step again; a caller that needs the old cache copies it first."""
    if seq is not None:
        rows = k_cache.shape[1]
        if not 0 <= pos < rows * seq.n:
            raise IndexError(f"position {pos} outside a cache of "
                             f"{rows * seq.n} rows")
        pos -= seq.index * rows
        if not 0 <= pos < rows:
            return k_cache, v_cache
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def kv_runs(n_heads: int, kv_heads: int, split=None) -> list[tuple]:
    """The runs of this rank's query heads that share a uniform GQA group:
    ``(q0, q1, kv0, kv1)``, local query heads [q0, q1) reading KV heads
    [kv0, kv1) of the whole K / V (query head i reads KV head
    i // (H / Hkv)). Without a split, one run of every head. A block that
    covers whole groups is one run; one inside a group is one run of that
    KV head; a block that straddles groups (H 6, Hkv 3 over 2 ranks: rank
    0's heads 0-2 read KV heads 0, 0, 1) gives one run per KV head."""
    if split is None:
        return [(0, n_heads, 0, kv_heads)]
    g = n_heads // kv_heads
    h0, h1 = split.block(n_heads)
    if h0 % g == 0 and h1 % g == 0:
        return [(0, h1 - h0, h0 // g, h1 // g)]
    runs = []
    for kv in range(h0 // g, (h1 - 1) // g + 1):
        a, b = max(h0, kv * g), min(h1, (kv + 1) * g)
        runs.append((a - h0, b - h0, kv, kv + 1))
    return runs

