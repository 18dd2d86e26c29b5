"""Family-dispatch model API (the reference's src/repro/models/api.py,
ported families only): one surface for the launch layer.

    init_model(seed, cfg, device)               -> params
    prefill_fn(params, batch, cfg)              -> logits
    decode_fn(params, cache, tokens, pos, cfg)  -> (logits, cache)
    cache_axes_spec(cfg, batch, seq_len)        -> ({name: (shape, dtype)},
                                                    {name: logical axes})
    supports_decode(cfg)

``dense`` runs models/transformer.py; ``vit`` routes to models/vit.py.
Every other family raises ``NotImplementedError`` naming ROADMAP.md
queue A15. The parameters are the port's tree (``bridge.from_jax_params``
of the reference's, or ``init_model``); ``init_model`` does not replay
the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import ExecPolicy

__all__ = ["init_model", "prefill_fn", "decode_fn", "cache_axes_spec",
           "supports_decode"]

_UNPORTED = ("moe", "ssm", "hybrid", "encdec", "vlm")


def _unported(cfg: ArchConfig):
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
        f"yet (ROADMAP.md queue A15); ported: dense, vit")


def init_model(seed: int, cfg: ArchConfig, device=None,
               dtype=torch.bfloat16, n_classes: int = 1000):
    """Seeded random params of the reference's shapes and scales, on
    ``device`` (default: the card)."""
    from repro_torch import bridge

    if cfg.family == "dense":
        return bridge.init_lm(seed, cfg, device, dtype)
    if cfg.family == "vit":
        return bridge.from_jax_params(bridge.init_vit(seed, cfg, n_classes),
                                      device)
    raise _unported(cfg)


def prefill_fn(params, batch: dict, cfg: ArchConfig,
               policy: ExecPolicy | None = None):
    """Inference forward over the full prompt: ``batch["tokens"]`` (B, S)
    -> logits (B, S, V) for dense; ``batch["images"]`` -> logits for vit."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    if cfg.family == "dense":
        logits, _ = tf_mod.forward_lm(params, batch["tokens"], cfg, policy)
        return logits
    if cfg.family == "vit":
        from repro_torch.models.vit import forward_vit
        logits, _ = forward_vit(params, batch["images"], cfg, policy,
                                device=batch["images"].device)
        return logits
    raise _unported(cfg)


def decode_fn(params, cache: dict, tokens: torch.Tensor, pos: int,
              cfg: ArchConfig, policy: ExecPolicy | None = None):
    """One decode step (see ``transformer.decode_step``): the cache is
    written in place and returned."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    if cfg.family == "dense":
        return tf_mod.decode_step(params, cache, tokens, pos, cfg, policy)
    if cfg.family in _UNPORTED:
        raise _unported(cfg)
    raise ValueError(f"{cfg.family} has no decode step")


def supports_decode(cfg: ArchConfig) -> bool:
    return cfg.family != "vit"


def cache_axes_spec(cfg: ArchConfig, batch: int, seq_len: int,
                    dtype=torch.bfloat16):
    """(shapes {name: (shape, dtype)}, axes {name: logical axes})."""
    if cfg.family == "dense":
        return tf_mod.cache_spec(cfg, batch, seq_len, dtype)
    if cfg.family in _UNPORTED:
        raise _unported(cfg)
    raise ValueError(f"{cfg.family} has no decode cache")
