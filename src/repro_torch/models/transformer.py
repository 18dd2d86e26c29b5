"""Decoder-only LM assembly, dense family (the reference's
src/repro/models/transformer.py, dense subset).

Per-layer params are stacked on a leading L axis, as the reference's scan
stacks them; ``forward_lm`` and ``decode_step`` loop over the layers in
Python and hand each one a view of its slice (no copy). The decode cache
is ``{"k", "v"}`` of shape (L, B, S, Hkv, D); ``decode_step`` writes each
layer's new K/V row into it in place and returns the same dict.

Tensor parallelism. Under an installed sharding context whose rules split
"p_heads" / "p_mlp" over a "model" axis (``MODEL_RULES`` on a ("data",
"model") mesh) each rank holds its block of the query heads (wq's
columns, bq, wo's rows) and of the SwiGLU hidden dim (w_gate / w_up
columns, w_down rows), placed by ``place_lm_params``; wk / wv, the norms
and (under ``MODEL_RULES``) the tied embedding and the KV cache stay
whole, so every rank computes the whole K and V. ``collectives.
copy_to_model`` goes before the column-parallel projections and on the
K / V a rank reads in part, and the row-parallel wo / w_down reduce over
"model" (``layers.row_parallel_linear``), so the residual stream is whole
on every rank. An axis that does not divide the heads (or d_ff) leaves
that block whole, with no reduce, as the reference's ``shard`` drops it.
The batch splits over "data": each rank runs its rows. Without a context
the code path is the unsharded one.

FSDP, the vocab and the sequence (``DEFAULT_RULES`` / ``MULTIPOD_RULES``).
Every param dim on "p_embed" (d_model) is split over the batch axes
("data", or ("pod", "data")): a rank holds 1 / n of its rows or columns.
``forward_lm`` and ``decode_step`` gather each layer's blocks where the
layer runs (``layers.fsdp_layer``), so a rank holds one layer whole at a
time, and the gather's backward reduce-scatters the gradient
(``collectives.fsdp_gather``). The tied embedding splits its vocab rows
over "model" too: the lookup is vocab-parallel (``layers.
embedding_lookup``), the head gives this rank's vocab block of the logits
(``_head``; ``forward_lm`` and ``decode_step`` return that block), and
``lm_loss`` is vocab-parallel (``cross_entropy``: an f32 max and a sum
of exps over "model", the gold logit from the rank that owns it). The
decode cache splits its sequence over "model" ("kv_seq"): a rank holds
S / M rows of every layer, the new row is written by its owner, and the
attention is B6's partial entry over the rank's rows for every query
head (q all-gathered over "model"), merged across the ranks
(``attention.decode_attention``), of which each rank keeps its heads for
the row-parallel wo. Every activation absmax of a quantizing policy stays
scoped to the whole mesh (``_model_scope``), so the int8 prefill is
bitwise the unsharded one and a qat step's scales are the global
batch's; a remat's recompute re-enters the scope (``sharding.bound``).

``lm_loss`` is the training loss; ``cfg.remat`` checkpoints each layer
(each hybrid super-block) under autograd (``torch.utils.checkpoint``,
non-reentrant), as the reference's ``jax.checkpoint``: values are
unchanged.

The hybrid family (RecurrentGemma): ``blocks`` stacks (rec0, rec1, attn)
super-blocks on a leading axis and ``tail_blocks`` the remainder's
recurrent layers, as the reference's scan over super-blocks does. A
recurrent layer is the RG-LRU block (models/rglru.py) and a SwiGLU; the
attention layer is the dense layer with a local ``window`` (B5's window
in the prefill). Its decode cache holds each super-block's two
recurrent states (``rec_h`` f32, ``rec_conv``) and a ring of ``min(window,
S)`` K / V slots (``attn_k``, ``attn_v``), written at slot ``pos mod W``
and read by B6 over its first ``min(pos + 1, W)`` slots
(``attention.ring_decode_attention``); the tail's states are ``tail_h`` /
``tail_conv``. It trains (``lm_loss``; under ``cfg.remat`` each
super-block and each tail layer is checkpointed, the bodies the
reference remats) and runs under every table: under ``MODEL_RULES`` /
``DATA_RULES`` the attention layer as the dense one (its 16 query heads
split over "model" on the one KV head), the SwiGLU on its d_ff block,
the RG-LRU on its block of the width (``lru_split``, models/rglru.py),
the recurrent states split on "mlp" and "batch", the ring on "batch"
only. Under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` every layer's
"p_embed" dims are FSDP-split too and gathered where the layer runs
(each recurrent layer's tree, the attention layer's, the embedding and
the head), the vocab splits as the dense LM's, and the ring splits along
its slots over "model" ("kv_seq"): a rank holds slots [r W / n, (r + 1)
W / n). The valid slots are always the prefix [0, min(pos + 1, W)), so
the new row goes to slot pos mod W on the rank that owns it and the
attention is B6's partial entry over the rank's slots at that length,
merged across the ranks: the dense cache's sequence split with the
ring's length.

The other families (moe / ssm) raise ``NotImplementedError`` naming
ROADMAP.md queue A15, as does the decomposed (Eq. 2) attention.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.attention import (blockwise_attention,
                                          decode_attention, plain_attention,
                                          ring_decode_attention,
                                          update_kv_cache)
from repro_torch.models.layers import (ExecPolicy, apply_rope,
                                       embedding_lookup, fsdp_layer,
                                       layer_view, linear, rmsnorm, rope,
                                       row_parallel_linear)

__all__ = ["attention_shapes", "lm_shapes", "attention_logical_axes",
           "dense_layer_axes", "lm_logical_axes", "lm_placement_axes",
           "place_lm_params", "heads_split", "mlp_split", "fsdp_split",
           "vocab_split", "seq_split", "attn_forward", "decode_rope",
           "attn_decode", "dense_layer_fwd", "forward_lm", "cross_entropy",
           "lm_loss", "cache_spec", "decode_step", "check_family",
           "rec_layer_axes", "rec_layer_fwd", "rec_layer_step", "ring_slot",
           "lru_split", "hybrid_splits", "super_block_fwd"]


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is an LM the port carries under the installed
    context (``sharding.check_model_rules``): dense and hybrid under
    every table, with standard attention. Both train and serve."""
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"LM family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue A15); ported: dense, hybrid")
    if cfg.attn_impl != "standard":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (paper Eq. 2) is not ported for "
            f"the LM yet (ROADMAP.md queue A15)")
    if cfg.family == "dense" and cfg.window:
        raise NotImplementedError(
            "a local-attention window is hybrid-only: the dense LM "
            "attends causally (ROADMAP.md queue A15)")


def attention_shapes(cfg: ArchConfig) -> dict:
    """Per-layer attention param shapes (the reference's init_attention)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    return shapes


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return (n,) + tuple(tree)


def dense_layer_shapes(cfg: ArchConfig) -> dict:
    """One dense layer's leaf shapes (the hybrid's attention layer too)."""
    d, dff = cfg.d_model, cfg.d_ff
    return {"ln1": (d,), "attn": attention_shapes(cfg), "ln2": (d,),
            "ffn": {"w_gate": (d, dff), "w_up": (d, dff), "w_down": (dff, d)}}


def rec_layer_shapes(cfg: ArchConfig) -> dict:
    """One recurrent layer's leaf shapes: the RG-LRU block and a SwiGLU."""
    layer = dense_layer_shapes(cfg)
    del layer["attn"]
    return {"ln1": layer["ln1"], "rec": rglru_mod.rglru_shapes(cfg),
            "ln2": layer["ln2"], "ffn": layer["ffn"]}


def hybrid_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(super-blocks of (rec, rec, attn), tail recurrent layers)."""
    return cfg.n_layers // 3, cfg.n_layers % 3


def lm_shapes(cfg: ArchConfig) -> dict:
    """The param tree's leaf shapes (``init_lm``'s, without drawing). A
    hybrid's ``blocks`` are (rec0, rec1, attn) super-blocks stacked on a
    leading axis, its ``tail_blocks`` the remainder's recurrent layers."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d), "final_ln": (d,)}
    if cfg.family == "hybrid":
        nsb, rem = hybrid_counts(cfg)
        rec = rec_layer_shapes(cfg)
        shapes["blocks"] = _stacked({"rec0": rec, "rec1": rec,
                                     "attn": dense_layer_shapes(cfg)}, nsb)
        if rem:
            shapes["tail_blocks"] = _stacked(rec, rem)
    else:
        shapes["blocks"] = _stacked(dense_layer_shapes(cfg), cfg.n_layers)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def attention_logical_axes(cfg: ArchConfig) -> dict:
    """The reference's: the query heads on "p_heads" (wq's columns, bq,
    wo's rows); wk / wv whole."""
    ax = {"wq": ("p_embed", "p_heads"), "wk": ("p_embed", None),
          "wv": ("p_embed", None), "wo": ("p_heads", "p_embed")}
    if cfg.qkv_bias:
        ax.update({"bq": ("p_heads",), "bk": (None,), "bv": (None,)})
    return ax


def dense_layer_axes(cfg: ArchConfig) -> dict:
    return {"ln1": (None,), "attn": attention_logical_axes(cfg),
            "ln2": (None,), "ffn": ffn_mod.swiglu_logical_axes()}


def _prepend(tree, axis="p_layers"):
    if isinstance(tree, dict):
        return {k: _prepend(v, axis) for k, v in tree.items()}
    return (axis,) + tuple(tree)


def rec_layer_axes(cfg: ArchConfig) -> dict:
    return {"ln1": (None,), "rec": rglru_mod.rglru_logical_axes(cfg),
            "ln2": (None,), "ffn": ffn_mod.swiglu_logical_axes()}


def lm_logical_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every param leaf, the reference's tree."""
    check_family(cfg)
    ax = {"embed": ("p_vocab", "p_embed"), "final_ln": (None,)}
    if cfg.family == "hybrid":
        ax["blocks"] = _prepend({"rec0": rec_layer_axes(cfg),
                                 "rec1": rec_layer_axes(cfg),
                                 "attn": dense_layer_axes(cfg)})
        if hybrid_counts(cfg)[1]:
            ax["tail_blocks"] = _prepend(rec_layer_axes(cfg))
    else:
        ax["blocks"] = _prepend(dense_layer_axes(cfg))
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("p_embed", "p_vocab")
    return ax


def heads_split(cfg: ArchConfig):
    """This rank's block of the query heads (``sharding.split_of``), or
    None where every rank holds all of them."""
    return sharding.split_of("p_heads", cfg.n_heads)


def mlp_split(cfg: ArchConfig):
    """This rank's block of the SwiGLU hidden dim, or None."""
    return sharding.split_of("p_mlp", cfg.d_ff)


def lru_split(cfg: ArchConfig):
    """This rank's block of the RG-LRU width (the reference's "p_mlp" axes
    of ``rglru_logical_axes``), or None."""
    return sharding.split_of("p_mlp", cfg.lru_dim)


def fsdp_split(cfg: ArchConfig):
    """This rank's block of d_model, the "p_embed" dim every layer's
    params are FSDP-split on, or None where they stay whole."""
    return sharding.split_of("p_embed", cfg.d_model)


def vocab_split(cfg: ArchConfig):
    """This rank's block of the vocab (the embedding's rows, the head's
    columns and the logits' last dim), or None."""
    return sharding.split_of("p_vocab", cfg.vocab)


def seq_split(rows: int):
    """This rank's block of a decode cache's sequence, for a cache of
    ``rows`` local rows (the whole cache's rows are ``rows`` times the
    "kv_seq" axis's ranks: ``cache_spec`` refuses a length they do not
    divide), or None."""
    return sharding.split_of("kv_seq", rows * sharding.axis_size("kv_seq"))


def lm_placement_axes(cfg: ArchConfig, axes: dict | None = None) -> dict:
    """``axes`` (default ``lm_logical_axes``; a train state's tree too) with
    the axes the installed context cannot split dropped: "p_heads" unless
    ``heads_split`` (a model axis may divide wq's columns but not the
    heads), "p_mlp" unless ``mlp_split`` (inside a hybrid's ``rec``
    subtree, the RG-LRU's, unless ``lru_split``), "p_embed" unless
    ``fsdp_split`` and "p_vocab" unless ``vocab_split``."""
    drop = set()
    for ax, split in (("p_heads", heads_split(cfg)), ("p_mlp", mlp_split(cfg)),
                      ("p_embed", fsdp_split(cfg)),
                      ("p_vocab", vocab_split(cfg))):
        if split is None:
            drop.add(ax)
    drop_rec = drop - {"p_mlp"}
    if lru_split(cfg) is None:
        drop_rec.add("p_mlp")

    def walk(t, dropped):
        if isinstance(t, dict):
            return {k: walk(v, drop_rec if k == "rec" else dropped)
                    for k, v in t.items()}
        return tuple(None if a in dropped else a for a in t)
    return walk(lm_logical_axes(cfg) if axes is None else axes, drop)


def place_lm_params(params: dict, cfg: ArchConfig) -> dict:
    """This rank's blocks of a whole param tree (raw or ``prepare_params``'d)
    under the installed context; the tree itself without one."""
    ctx = sharding.current_ctx()
    if ctx is None:
        return params
    from repro_torch.core.backend import place_params
    sharding.check_model_rules(ctx, cfg.family)
    return place_params(params, lm_placement_axes(cfg), ctx)


def _model_scope(policy):
    """Under a mesh of more than one rank a quantizing policy (qat,
    photonic_sim, photonic_pallas) takes every per-launch activation
    absmax over the whole mesh (the rows split over "data", the
    row-parallel contractions over "model": ``sharding.mesh_scope``): the
    unsharded launch's scale on every rank."""
    ctx = sharding.current_ctx()
    if ctx is None:
        return contextlib.nullcontext()
    sharding.check_model_rules(ctx)
    if policy.backend == "bf16":
        return contextlib.nullcontext()
    return sharding.mesh_scope()


def _project_qkv(p, x, cfg, policy, positions, split):
    b, s, _ = x.shape
    hkv, hd = cfg.kv_heads, cfg.head_dim
    h = cfg.n_heads if split is None else cfg.n_heads // split.n
    xq = x if split is None else collectives.copy_to_model(x, split.group)
    q = linear(xq, p["wq"], p.get("bq"), policy).reshape(b, s, h, hd)
    k = linear(x, p["wk"], p.get("bk"), policy).reshape(b, s, hkv, hd)
    v = linear(x, p["wv"], p.get("bv"), policy).reshape(b, s, hkv, hd)
    cos, sin = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _kv_read_in_part(k, v, split):
    """Under a head split each rank reads part of the whole K / V, so
    their gradient is summed over "model" (one reduce for both)."""
    if split is None:
        return k, v
    kv = collectives.copy_to_model(torch.stack([k, v]), split.group)
    return kv[0], kv[1]


def _attend(q, k, v, cfg: ArchConfig, policy, split,
            window: int = 0) -> torch.Tensor:
    """Causal (and, with ``window``, local) attention of q (B, S, h, D),
    this rank's heads, against the whole k / v (B, S, Hkv, D). A serving
    policy launches the flash attention kernel (``blockwise_attention``),
    a training policy takes its plain version (``plain_attention``: no
    kernel has a backward, and the reference trains through its XLA
    attention). Under a head split one call a ``attention.kv_runs`` run;
    the head slices are views."""
    attend = plain_attention if policy.training else blockwise_attention
    if split is None:
        return attend(q, k, v, causal=True, window=window)
    outs = [attend(q[:, :, q0:q1], k[:, :, a:b], v[:, :, a:b], causal=True,
                   window=window)
            for q0, q1, a, b in attn_mod.kv_runs(cfg.n_heads, cfg.kv_heads,
                                                 split)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _decode(q, k_cache, v_cache, length: int, cfg: ArchConfig,
            split, attend=None) -> torch.Tensor:
    """``attend(q, k, v, length)`` (default ``decode_attention``) against
    the whole caches (B, S, Hkv, D); under a head split one call a run,
    the caches sliced to its KV heads (views the kernel reads by
    strides)."""
    attend = attend or decode_attention
    if split is None:
        return attend(q, k_cache, v_cache, length)
    outs = [attend(q[:, :, q0:q1], k_cache[:, :, a:b], v_cache[:, :, a:b],
                   length)
            for q0, q1, a, b in attn_mod.kv_runs(cfg.n_heads, cfg.kv_heads,
                                                 split)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _ring(q, k_ring, v_ring, pos: int):
    """``ring_decode_attention`` at position ``pos`` (``_decode``'s
    ``attend``, whose length argument is the position here)."""
    return ring_decode_attention(q, k_ring, v_ring, pos)


def _decode_seq(q, k_rows, v_rows, length: int, cfg: ArchConfig, split,
                seq, window: int = 0) -> torch.Tensor:
    """``decode_attention`` (over the last ``window`` valid rows where it
    is above 0) against this rank's rows of caches split along their
    sequence (``seq``): every query head attends the rows (q all-gathered
    over the head split's group, in head order), the partials merge
    across ``seq``'s group, and the rank keeps its heads."""
    if split is None:
        return decode_attention(q, k_rows, v_rows, length, window=window,
                                seq=seq)
    q_all = collectives.all_gather_cat(q, split.group, 2, "decode_q")
    o = decode_attention(q_all, k_rows, v_rows, length, window=window,
                         seq=seq)
    h0, h1 = split.block(cfg.n_heads)
    return o[:, :, h0:h1]


def _out_proj(o, w, policy, split):
    if split is None:
        return linear(o, w, policy=policy)
    return row_parallel_linear(o, w, policy, split.group)


def attn_forward(p, x, cfg: ArchConfig, policy, split=None, window=0):
    """Full-sequence causal self attention (prefill, training), local over
    ``window`` keys where it is above 0 (the hybrid's attention layers).
    ``split`` is this rank's block of the query heads (``heads_split``),
    None for all of them. Returns (out, (k, v)): the whole K / V on every
    rank."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, policy, positions, split)
    kr, vr = _kv_read_in_part(k, v, split)
    o = _attend(q, kr, vr, cfg, policy, split, window=window)
    o = o.reshape(b, s, q.shape[2] * cfg.head_dim)
    return _out_proj(o, p["wo"], policy, split), (k, v)


def decode_rope(pos: int, cfg: ArchConfig, device):
    """RoPE tables (cos, sin) of shape (1, head_dim / 2) at ``pos``, built
    on ``device`` without a host-to-device copy (which would wait for the
    queued work): one pair serves every layer of a decode step."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=device)
    return rope(positions, cfg.head_dim, cfg.rope_theta)


def ring_slot(pos: int, slots: int) -> int:
    """The ring-buffer cache slot of position ``pos``: pos mod W."""
    return pos % slots


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg: ArchConfig, policy,
                rope_tables, split=None, seq=None, window=0):
    """One-token attention at position ``pos`` (host int); writes the new
    K/V into the caches in place. ``rope_tables`` is ``decode_rope(pos)``,
    built once per step by the caller; ``split`` this rank's block of the
    query heads (``heads_split``), ``seq`` of the caches' rows
    (``seq_split``). With ``window`` > 0 and caches of at most ``window``
    rows in all (the hybrid's) the caches are a ring of W slots: the new
    row goes to slot ``ring_slot(pos, W)`` and B6 reads the first
    min(pos + 1, W) slots, as the reference's ring decode (under a head
    split the rank's query heads over the whole ring; under ``seq`` the
    slot's owner writes it and every rank reads its slots of that prefix,
    B6's partial entry merged across ``seq``'s group); a longer cache
    attends its last ``window`` rows. Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    hkv, hd = cfg.kv_heads, cfg.head_dim
    h = cfg.n_heads if split is None else cfg.n_heads // split.n
    xq = x if split is None else collectives.copy_to_model(x, split.group)
    q = linear(xq, p["wq"], p.get("bq"), policy).reshape(b, 1, h, hd)
    k = linear(x, p["wk"], p.get("bk"), policy).reshape(b, 1, hkv, hd)
    v = linear(x, p["wv"], p.get("bv"), policy).reshape(b, 1, hkv, hd)
    cos, sin = rope_tables
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = cache_k.shape[1] * (1 if seq is None else seq.n)
    if 0 < window and rows <= window:
        slot = ring_slot(pos, rows)
        cache_k, cache_v = update_kv_cache(cache_k, cache_v, k, v, slot, seq)
        if seq is None:
            o = _decode(q, cache_k, cache_v, pos, cfg, split, attend=_ring)
        else:
            o = _decode_seq(q, cache_k, cache_v, min(pos + 1, rows), cfg,
                            split, seq)
    elif seq is None:
        cache_k, cache_v = update_kv_cache(cache_k, cache_v, k, v, pos)
        o = _decode(q, cache_k, cache_v, pos + 1, cfg, split, attend=(
            (lambda *a: decode_attention(*a, window=window)) if window
            else None))
    else:
        cache_k, cache_v = update_kv_cache(cache_k, cache_v, k, v, pos, seq)
        o = _decode_seq(q, cache_k, cache_v, pos + 1, cfg, split, seq, window)
    o = o.reshape(b, 1, h * hd)
    return _out_proj(o, p["wo"], policy, split), cache_k, cache_v


def dense_layer_fwd(p, x, cfg: ArchConfig, policy,
                    splits=(None, None, None), window=0):
    """Pre-norm residual layer: attention (local over ``window`` keys
    where it is above 0), then SwiGLU. ``splits`` is (``heads_split``,
    ``mlp_split``, ``fsdp_split``), read once a forward: a remat's
    recompute runs in the backward, where no context need be installed
    (the card's backward runs on autograd's device thread). ``p`` is this
    rank's blocks of the layer, FSDP-gathered here, so a remat's
    recompute gathers again."""
    heads, mlp, fsdp = splits
    p = fsdp_layer(p, dense_layer_axes(cfg), fsdp, cfg.d_model)
    h, _ = attn_forward(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                        policy, heads, window)
    x = x + h
    return x + ffn_mod.swiglu(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                              policy, split=mlp)


def hybrid_splits(cfg: ArchConfig) -> tuple:
    """(``heads_split``, ``mlp_split``, ``lru_split``, ``fsdp_split``) of
    the installed context: the hybrid's layers' splits, read once a
    forward (a remat's recompute runs where no context need be
    installed)."""
    return heads_split(cfg), mlp_split(cfg), lru_split(cfg), fsdp_split(cfg)


def rec_layer_fwd(p, x, cfg: ArchConfig, policy,
                  splits=(None, None, None, None)):
    """Pre-norm residual recurrent layer over the whole sequence: the
    RG-LRU block (from a zero state), then SwiGLU. ``splits`` as
    ``hybrid_splits`` gives them (the heads' unused here); ``p`` is this
    rank's blocks, FSDP-gathered here (each "p_embed" dim, found by its
    axis name: the "p_mlp" dims, the LRU width and d_ff, keep their
    blocks), so a remat's recompute gathers again."""
    _, mlp, lru, fsdp = splits
    p = fsdp_layer(p, rec_layer_axes(cfg), fsdp, cfg.d_model)
    y, _ = rglru_mod.rglru_forward(p["rec"], rmsnorm(x, p["ln1"],
                                                     cfg.norm_eps), cfg,
                                   policy, split=lru)
    x = x + y
    return x + ffn_mod.swiglu(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                              policy, split=mlp)


def rec_layer_step(p, x, h_state, conv_state, cfg: ArchConfig, policy,
                   splits=(None, None, None, None)):
    """One decode step of a recurrent layer (its blocks FSDP-gathered);
    writes its new state into ``h_state`` (B, W) f32 and ``conv_state``
    (B, K - 1, W), in place (the cache's slices; under a width split the
    rank's W / n columns)."""
    _, mlp, lru, fsdp = splits
    p = fsdp_layer(p, rec_layer_axes(cfg), fsdp, cfg.d_model)
    y, st = rglru_mod.rglru_decode_step(
        p["rec"], rmsnorm(x, p["ln1"], cfg.norm_eps),
        {"h": h_state, "conv": conv_state}, cfg, policy, split=lru)
    h_state.copy_(st["h"])
    conv_state.copy_(st["conv"])
    x = x + y
    return x + ffn_mod.swiglu(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                              policy, split=mlp)


def super_block_fwd(sb, x, cfg: ArchConfig, policy,
                    splits=(None, None, None, None)):
    """One (rec0, rec1, attn) super-block over the whole sequence: the
    reference's scanned ``hbody``, the unit it remats."""
    heads, mlp, _, fsdp = splits
    x = rec_layer_fwd(sb["rec0"], x, cfg, policy, splits)
    x = rec_layer_fwd(sb["rec1"], x, cfg, policy, splits)
    return dense_layer_fwd(sb["attn"], x, cfg, policy, (heads, mlp, fsdp),
                           window=cfg.window)


def _dense_forward(params, x, cfg: ArchConfig, policy, fsdp):
    """The dense layer stack over the whole sequence; under ``cfg.remat``
    and autograd each layer is checkpointed (``sharding.bound`` carries
    the context into the recompute)."""
    remat = cfg.remat and torch.is_grad_enabled()
    splits = (heads_split(cfg), mlp_split(cfg), fsdp)
    for i in range(cfg.n_layers):
        lp = layer_view(params["blocks"], i)
        if remat:
            from torch.utils.checkpoint import checkpoint
            x = checkpoint(sharding.bound(dense_layer_fwd), lp, x, cfg,
                           policy, splits, use_reentrant=False)
        else:
            x = dense_layer_fwd(lp, x, cfg, policy, splits)
    return x


def _hybrid_forward(params, x, cfg: ArchConfig, policy):
    """The hybrid's layer stack over the whole sequence: each super-block's
    two recurrent layers and its local-attention layer, then the tail.
    Under ``cfg.remat`` and autograd each super-block and each tail layer
    is checkpointed (``sharding.bound`` carries the context into the
    recompute)."""
    nsb, rem = hybrid_counts(cfg)
    splits = hybrid_splits(cfg)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, p, x):
        if remat:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(sharding.bound(fn), p, x, cfg, policy, splits,
                              use_reentrant=False)
        return fn(p, x, cfg, policy, splits)

    for i in range(nsb):
        x = run(super_block_fwd, layer_view(params["blocks"], i), x)
    for i in range(rem):
        x = run(rec_layer_fwd, layer_view(params["tail_blocks"], i), x)
    return x


def _hybrid_decode(params, cache, x, pos: int, cfg: ArchConfig, policy,
                   tables):
    """The hybrid's one-token layer stack; every state and ring slot is
    written into ``cache`` in place (under a "kv_seq" split this rank's
    slots of each ring)."""
    nsb, rem = hybrid_counts(cfg)
    splits = hybrid_splits(cfg)
    heads, mlp, _, fsdp = splits
    seq = seq_split(cache["attn_k"].shape[2]) if nsb else None
    for i in range(nsb):
        sb = layer_view(params["blocks"], i)
        for j, name in enumerate(("rec0", "rec1")):
            x = rec_layer_step(sb[name], x, cache["rec_h"][i, j],
                               cache["rec_conv"][i, j], cfg, policy, splits)
        lp = fsdp_layer(sb["attn"], dense_layer_axes(cfg), fsdp, cfg.d_model)
        o, _, _ = attn_decode(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                              cache["attn_k"][i], cache["attn_v"][i], pos,
                              cfg, policy, tables, heads, seq,
                              window=cfg.window)
        x = x + o
        x = x + ffn_mod.swiglu(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                               policy, split=mlp)
    for i in range(rem):
        x = rec_layer_step(layer_view(params["tail_blocks"], i), x,
                           cache["tail_h"][i], cache["tail_conv"][i], cfg,
                           policy, splits)
    return x


def _embed_table(params, cfg, fsdp):
    """The embedding (this rank's vocab block under a vocab split) with its
    FSDP-split d_model gathered: the lookup's table and the tied head's."""
    return fsdp_layer({"embed": params["embed"]},
                      {"embed": ("p_vocab", "p_embed")}, fsdp,
                      cfg.d_model)["embed"]


def _head(params, table, cfg, fsdp, x, policy):
    """The LM head's logits of ``x``: the tied embedding's transposed view
    (never a contiguous copy: it is vocab x d_model) or ``lm_head``
    (FSDP-gathered). Under a vocab split the head is this rank's columns
    and the logits its vocab block; ``x`` is whole on every rank of the
    split, so its gradient is summed over it (``copy_to_model``)."""
    if cfg.tie_embeddings:
        w = table.T
    else:
        w = fsdp_layer({"w": params["lm_head"]}, {"w": ("p_embed", "p_vocab")},
                       fsdp, cfg.d_model)["w"]
    vs = vocab_split(cfg)
    if vs is not None:
        x = collectives.copy_to_model(x, vs.group)
    return linear(x, w, policy=policy)


def forward_lm(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
               policy: ExecPolicy | None = None):
    """tokens (B, S) -> (logits (B, S, V), aux loss 0.0), as the reference;
    under a vocab split the logits are this rank's block (B, S, V / n)."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    check_family(cfg)
    with _model_scope(policy):
        fsdp = fsdp_split(cfg)
        table = _embed_table(params, cfg, fsdp)
        x = embedding_lookup(table, tokens, vocab_split(cfg))
        if cfg.family == "hybrid":
            x = _hybrid_forward(params, x, cfg, policy)
        else:
            x = _dense_forward(params, x, cfg, policy, fsdp)
        x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
        logits = _head(params, table, cfg, fsdp, x, policy)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  split=None) -> torch.Tensor:
    """Per-token softmax cross-entropy in f32: the logsumexp minus the gold
    logit, (...). ``split`` (``vocab_split``) says ``logits`` is this
    rank's vocab block: the max of the f32 logits over the split's group
    (no gradient), the sum of exp(logits - max) summed over it, and the
    gold logit from the rank whose block holds the label (zero on the
    others, summed); every rank of the group gets the same values."""
    lf = logits.float()
    if split is None:
        lse = torch.logsumexp(lf, dim=-1)
        return lse - torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    n = lf.shape[-1]
    m = collectives.vocab_max(lf.amax(-1), split.group)
    lse = m + torch.log(collectives.vocab_sum(
        torch.exp(lf - m[..., None]).sum(-1), split.group))
    local = labels.long() - split.index * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = collectives.vocab_sum(torch.where(mine, gold, 0.0), split.group)
    return lse - gold


def lm_loss(params: dict, batch: dict, cfg: ArchConfig,
            policy: ExecPolicy | None = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (both (B, S)): the f32 logsumexp minus the gold
    logit (vocab-parallel under a vocab split, ``cross_entropy``), meaned
    over this rank's rows, plus ``aux_weight`` times the forward's aux
    loss (0 for dense), as the reference's."""
    logits, aux = forward_lm(params, batch["tokens"], cfg, policy)
    nll = cross_entropy(logits, batch["labels"], vocab_split(cfg))
    return nll.mean() + aux_weight * aux


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16) -> tuple[dict, dict]:
    """(shapes, logical_axes) of the decode cache: K and V of shape
    (L, B, S, Hkv, D), the reference's axes ("p_layers", "batch",
    "kv_seq", None, None). ``launch/serve.py::init_cache`` and ``launch/
    steps.py::make_serve_step`` place them: the batch over "data", and
    under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` the sequence over
    "model" (S / M rows a rank). A length the "kv_seq" axis does not
    divide raises (the reference would keep that cache whole; the decode
    tells a rank's rows from the local shape)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        return _hybrid_cache_spec(cfg, batch, seq_len, dtype)
    _check_seq_rows(seq_len)
    shape = (cfg.n_layers, batch, seq_len, cfg.kv_heads, cfg.head_dim)
    axes = ("p_layers", "batch", "kv_seq", None, None)
    return {"k": (shape, dtype), "v": (shape, dtype)}, {"k": axes, "v": axes}


def _check_seq_rows(rows: int) -> None:
    n = sharding.axis_size("kv_seq")
    if rows % n:
        raise ValueError(f"a cache of {rows} rows does not split over the "
                         f"{n} ranks of 'kv_seq'")


def _hybrid_cache_spec(cfg: ArchConfig, batch: int, seq_len: int, dtype):
    """The hybrid's decode cache, the reference's: per super-block its two
    recurrent states (``rec_h`` (nsb, 2, B, W) f32, ``rec_conv`` (nsb, 2,
    B, K - 1, W)) and its attention layer's ring of W = min(window,
    seq_len) slots (``attn_k`` / ``attn_v`` (nsb, B, W, Hkv, D); window 0
    keeps seq_len rows, a linear cache); the tail's ``tail_h`` /
    ``tail_conv``. Placed under a context, the states split on "batch"
    and (the width) on "mlp", the rings on "batch" and their slots on
    "kv_seq" (``DEFAULT_RULES`` / ``MULTIPOD_RULES``: W / M slots a
    rank); a W the "kv_seq" axis does not divide raises, as the dense
    cache's length."""
    nsb, rem = hybrid_counts(cfg)
    w = min(cfg.window or seq_len, seq_len)
    _check_seq_rows(w)
    rst = rglru_mod.rglru_state_shape(cfg, batch)
    kv = (nsb, batch, w, cfg.kv_heads, cfg.head_dim)
    shapes = {"rec_h": ((nsb, 2) + rst["h"], torch.float32),
              "rec_conv": ((nsb, 2) + rst["conv"], dtype),
              "attn_k": (kv, dtype), "attn_v": (kv, dtype)}
    axes = {"rec_h": ("p_layers", None, "batch", "mlp"),
            "rec_conv": ("p_layers", None, "batch", None, "mlp"),
            "attn_k": ("p_layers", "batch", "kv_seq", None, None),
            "attn_v": ("p_layers", "batch", "kv_seq", None, None)}
    if rem:
        shapes["tail_h"] = ((rem,) + rst["h"], torch.float32)
        shapes["tail_conv"] = ((rem,) + rst["conv"], dtype)
        axes["tail_h"] = ("p_layers", "batch", "mlp")
        axes["tail_conv"] = ("p_layers", "batch", None, "mlp")
    return shapes, axes


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, policy: ExecPolicy | None = None):
    """One decode step. tokens (B, 1) int; ``pos`` (host int) the number of
    tokens already in the cache. Returns (logits (B, V), cache): the cache
    dict is the argument, its layer slices written in place. Under a vocab
    split the logits are this rank's block (B, V / n); under a sequence
    split the cache is this rank's rows and ``pos`` global."""
    policy = policy or ExecPolicy.from_cfg(cfg, training=False)
    check_family(cfg)
    pos = int(pos)
    fsdp = fsdp_split(cfg)
    with _model_scope(policy):
        table = _embed_table(params, cfg, fsdp)
        x = embedding_lookup(table, tokens, vocab_split(cfg))
        tables = decode_rope(pos, cfg, x.device)
        if cfg.family == "hybrid":
            x = _hybrid_decode(params, cache, x, pos, cfg, policy, tables)
        else:
            x = _dense_decode(params, cache, x, pos, cfg, policy, tables,
                              fsdp)
        x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
        logits = _head(params, table, cfg, fsdp, x, policy)[:, 0]
    return logits, cache


def _dense_decode(params, cache, x, pos: int, cfg: ArchConfig, policy,
                  tables, fsdp):
    """The dense one-token layer stack; each layer's K / V row is written
    into ``cache`` in place."""
    heads, mlp = heads_split(cfg), mlp_split(cfg)
    seq = seq_split(cache["k"].shape[2])
    axes = dense_layer_axes(cfg)
    for i in range(cfg.n_layers):
        lp = fsdp_layer(layer_view(params["blocks"], i), axes, fsdp,
                        cfg.d_model)
        o, _, _ = attn_decode(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                              cache["k"][i], cache["v"][i], pos, cfg, policy,
                              tables, heads, seq)
        x = x + o
        x = x + ffn_mod.swiglu(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                               policy, split=mlp)
    return x
