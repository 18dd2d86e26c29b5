"""Family-dispatch model API (the reference's src/repro/models/api.py,
ported families only): one surface for the launch layer.

    init_model(seed, cfg, device)               -> params
    model_logical_axes(cfg)                     -> logical-axis tree
    loss_fn(params, batch, cfg, policy)         -> scalar loss
    prefill_fn(params, batch, cfg)              -> logits
    decode_fn(params, cache, tokens, pos, cfg)  -> (logits, cache)
    batch_specs(cfg, shape)                     -> {name: (shape, dtype,
                                                    logical axes)}
    cache_axes_spec(cfg, batch, seq_len)        -> ({name: (shape, dtype)},
                                                    {name: logical axes})
    supports_decode(cfg)

``dense`` runs models/transformer.py: tensor- and data-parallel under a
("data", "model") context with ``MODEL_RULES``; under ``DEFAULT_RULES`` /
``MULTIPOD_RULES`` also FSDP-split over the batch axes, vocab-split over
"model" (``prefill_fn`` / ``decode_fn`` return this rank's vocab block of
the logits, ``loss_fn`` reduces the logsumexp and the gold logit over
"model") with the decode cache split along its sequence. ``vit`` routes
to models/vit.py. ``hybrid`` (RecurrentGemma) runs through the same LM
entry points: ``loss_fn``, ``prefill_fn`` / ``decode_fn`` on its RG-LRU
layers and local-attention ring, under every table as the dense LM
(under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` its ring split along its
slots over "model").
Every other family raises ``NotImplementedError`` naming ROADMAP.md
queue A15. The parameters are the port's tree
(``bridge.from_jax_params`` of the reference's, or ``init_model``);
``init_model`` does not replay the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import ExecPolicy

__all__ = ["init_model", "model_logical_axes", "loss_fn", "prefill_fn",
           "decode_fn", "batch_specs", "cache_axes_spec", "supports_decode",
           "BATCH_AXES"]

_UNPORTED = ("moe", "ssm", "encdec", "vlm")
_LM_FAMILIES = ("dense", "hybrid")

# logical axes of every batch key (rank must match the array)
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "img_embeds": ("batch", None, None),
    "images": ("batch", None, None, None),
    "decode_tokens": ("batch", None),
}


def _unported(cfg: ArchConfig):
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
        f"yet (ROADMAP.md queue A15); ported: dense, hybrid, vit")


def init_model(seed: int, cfg: ArchConfig, device=None,
               dtype=torch.bfloat16, n_classes: int = 1000):
    """Seeded random params of the reference's shapes and scales, on
    ``device`` (default: the card)."""
    from repro_torch import bridge

    if cfg.family in _LM_FAMILIES:
        return bridge.init_lm(seed, cfg, device, dtype)
    if cfg.family == "vit":
        return bridge.from_jax_params(bridge.init_vit(seed, cfg, n_classes),
                                      device)
    raise _unported(cfg)


def model_logical_axes(cfg: ArchConfig) -> dict:
    """The logical-axis tree of ``init_model``'s params, the reference's."""
    if cfg.family in _LM_FAMILIES:
        return tf_mod.lm_logical_axes(cfg)
    if cfg.family == "vit":
        from repro_torch.models.vit import vit_logical_axes
        return vit_logical_axes(cfg)
    raise _unported(cfg)


def batch_specs(cfg: ArchConfig, shape) -> dict:
    """{key: (shape, dtype, logical axes)} of one cell's batch (a decode
    cell's is the one-token step's input), as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32, BATCH_AXES["decode_tokens"])}
    out = {}
    if cfg.family in _LM_FAMILIES:
        out["tokens"] = ((b, s), torch.int32, BATCH_AXES["tokens"])
    elif cfg.family == "vit":
        out["images"] = ((b, cfg.img_size, cfg.img_size, 3), torch.float32,
                         BATCH_AXES["images"])
    else:
        raise _unported(cfg)
    if shape.kind == "train":
        if cfg.family == "vit":
            out["labels"] = ((b,), torch.int32, ("batch",))
        else:
            out["labels"] = ((b, s), torch.int32, BATCH_AXES["labels"])
    return out


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          split=None) -> torch.Tensor:
    """Mean softmax cross-entropy in f32: logsumexp minus the gold logit;
    vocab-parallel where ``split`` says ``logits`` is this rank's vocab
    block (``transformer.cross_entropy``)."""
    return tf_mod.cross_entropy(logits, labels, split).mean()


def loss_fn(params, batch: dict, cfg: ArchConfig,
            policy: ExecPolicy | None = None) -> torch.Tensor:
    """The training loss. dense and hybrid: ``transformer.lm_loss`` of
    ``batch["tokens"]`` / ``batch["labels"]`` (B, S). vit:
    ``batch["images"]`` (B, H, W, 3) and ``batch["labels"]`` (B,) -> the
    mean cross-entropy of the ViT's logits, the forward where the images
    live, on raw float params (a ``QuantizedWeight`` raises)."""
    if cfg.family == "vit":
        from repro_torch.models.vit import check_training_tree, forward_vit
        check_training_tree(params)
        logits, _ = forward_vit(params, batch["images"], cfg, policy,
                                device=batch["images"].device)
        return _xent(logits, batch["labels"])
    if cfg.family in _LM_FAMILIES:
        return tf_mod.lm_loss(params, batch, cfg, policy)
    raise _unported(cfg)


def prefill_fn(params, batch: dict, cfg: ArchConfig,
               policy: ExecPolicy | None = None):
    """Inference forward over the full prompt: ``batch["tokens"]`` (B, S)
    -> logits (B, S, V) for dense and hybrid (a dense LM's under a vocab
    split this rank's block (B, S, V / n)); ``batch["images"]`` -> logits
    for vit."""
    policy = policy or ExecPolicy.from_cfg(cfg, training=False)
    if cfg.family in _LM_FAMILIES:
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
    written in place and returned; under a vocab split the logits are
    this rank's block."""
    policy = policy or ExecPolicy.from_cfg(cfg, training=False)
    if cfg.family in _LM_FAMILIES:
        return tf_mod.decode_step(params, cache, tokens, pos, cfg, policy)
    if cfg.family in _UNPORTED:
        raise _unported(cfg)
    raise ValueError(f"{cfg.family} has no decode step")


def supports_decode(cfg: ArchConfig) -> bool:
    return cfg.family != "vit"


def cache_axes_spec(cfg: ArchConfig, batch: int, seq_len: int,
                    dtype=torch.bfloat16):
    """(shapes {name: (shape, dtype)}, axes {name: logical axes}): the
    whole cache's; ``launch/serve.py::init_cache`` places them (the
    sequence over "kv_seq"'s axes under ``DEFAULT_RULES``); a hybrid's
    recurrent states and attention rings (``transformer.cache_spec``)."""
    if cfg.family in _LM_FAMILIES:
        return tf_mod.cache_spec(cfg, batch, seq_len, dtype)
    if cfg.family in _UNPORTED:
        raise _unported(cfg)
    raise ValueError(f"{cfg.family} has no decode cache")
