"""Decoder-only LM assembly, dense family (the reference's
src/repro/models/transformer.py, dense subset).

Per-layer params are stacked on a leading L axis, as the reference's scan
stacks them; ``forward_lm`` and ``decode_step`` loop over the layers in
Python and hand each one a view of its slice (no copy). The decode cache
is ``{"k", "v"}`` of shape (L, B, S, Hkv, D); ``decode_step`` writes each
layer's new K/V row into it in place and returns the same dict.

The other families (moe / ssm / hybrid) raise ``NotImplementedError``
naming ROADMAP.md queue A15, as does the reference's ring-buffer window
cache (hybrid only) and the decomposed (Eq. 2) attention.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.attention import (blockwise_attention,
                                          decode_attention, update_kv_cache)
from repro_torch.models.layers import (ExecPolicy, apply_rope,
                                       embedding_lookup, layer_view, linear,
                                       rmsnorm, rope)

__all__ = ["attention_shapes", "attn_forward", "decode_rope", "attn_decode",
           "dense_layer_fwd", "forward_lm", "cache_spec", "decode_step",
           "check_family"]


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a dense LM the port carries."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"LM family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue A15); ported: dense")
    if cfg.attn_impl != "standard":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (paper Eq. 2) is not ported for "
            f"the LM yet (ROADMAP.md queue A15)")
    if cfg.window:
        raise NotImplementedError(
            "a local-attention window is hybrid-only and not ported yet "
            "(ROADMAP.md queue A15)")


def attention_shapes(cfg: ArchConfig) -> dict:
    """Per-layer attention param shapes (the reference's init_attention)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    return shapes


def _project_qkv(p, x, cfg, policy, positions):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq"), policy).reshape(b, s, h, hd)
    k = linear(x, p["wk"], p.get("bk"), policy).reshape(b, s, hkv, hd)
    v = linear(x, p["wv"], p.get("bv"), policy).reshape(b, s, hkv, hd)
    cos, sin = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_forward(p, x, cfg: ArchConfig, policy):
    """Full-sequence causal self attention (prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, policy, positions)
    o = blockwise_attention(q, k, v, causal=True)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return linear(o, p["wo"], policy=policy), (k, v)


def decode_rope(pos: int, cfg: ArchConfig, device):
    """RoPE tables (cos, sin) of shape (1, head_dim / 2) at ``pos``, built
    on ``device`` without a host-to-device copy (which would wait for the
    queued work): one pair serves every layer of a decode step."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=device)
    return rope(positions, cfg.head_dim, cfg.rope_theta)


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg: ArchConfig, policy,
                rope_tables):
    """One-token attention at position ``pos`` (host int); writes the new
    K/V into the caches in place. ``rope_tables`` is ``decode_rope(pos)``,
    built once per step by the caller. Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq"), policy).reshape(b, 1, h, hd)
    k = linear(x, p["wk"], p.get("bk"), policy).reshape(b, 1, hkv, hd)
    v = linear(x, p["wv"], p.get("bv"), policy).reshape(b, 1, hkv, hd)
    cos, sin = rope_tables
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k, cache_v = update_kv_cache(cache_k, cache_v, k, v, pos)
    o = decode_attention(q, cache_k, cache_v, pos + 1)
    o = o.reshape(b, 1, h * hd)
    return linear(o, p["wo"], policy=policy), cache_k, cache_v


def dense_layer_fwd(p, x, cfg: ArchConfig, policy):
    """Pre-norm residual layer: attention, then SwiGLU."""
    h, _ = attn_forward(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                        policy)
    x = x + h
    return x + ffn_mod.swiglu(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                              policy)


def _head(params, cfg):
    """The LM head weight: the tied embedding's transposed view (never a
    contiguous copy: it is vocab x d_model) or ``lm_head``."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward_lm(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
               policy: ExecPolicy | None = None):
    """tokens (B, S) -> (logits (B, S, V), aux loss 0.0), as the reference."""
    check_family(cfg)
    policy = policy or ExecPolicy.from_cfg(cfg)
    x = embedding_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x = dense_layer_fwd(layer_view(params["blocks"], i), x, cfg, policy)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = linear(x, _head(params, cfg), policy=policy)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16) -> tuple[dict, dict]:
    """(shapes, logical_axes) of the decode cache: K and V of shape
    (L, B, S, Hkv, D). The axes are the reference's names; the port has no
    mesh yet (ROADMAP.md queue A14), so nothing reads them."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.kv_heads, cfg.head_dim)
    axes = ("p_layers", "batch", "kv_seq", None, None)
    return {"k": (shape, dtype), "v": (shape, dtype)}, {"k": axes, "v": axes}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, policy: ExecPolicy | None = None):
    """One decode step. tokens (B, 1) int; ``pos`` (host int) the number of
    tokens already in the cache. Returns (logits (B, V), cache): the cache
    dict is the argument, its layer slices written in place."""
    check_family(cfg)
    policy = policy or ExecPolicy.from_cfg(cfg, training=False)
    pos = int(pos)
    x = embedding_lookup(params["embed"], tokens)
    tables = decode_rope(pos, cfg, x.device)
    for i in range(cfg.n_layers):
        lp = layer_view(params["blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        o, _, _ = attn_decode(lp["attn"], h, cache["k"][i], cache["v"][i],
                              pos, cfg, policy, tables)
        x = x + o
        x = x + ffn_mod.swiglu(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                               policy)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = linear(x, _head(params, cfg), policy=policy)[:, 0]
    return logits, cache
