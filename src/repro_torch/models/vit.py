"""Vision Transformer backbone + Opto-ViT serving path (the reference's
src/repro/models/vit.py, fused serving point).

Every matmul routes through ``linear`` (the int8 photonic matmul kernel
over the quantize-once cache), every attention core through the
RoI-masked flash attention kernel and every GELU-MLP through the fused
int8 FFN kernel: the reference's fully fused serving point
(photonic_pallas + flash + fused). Stacked layer weights keep their
leading L axis (as the reference's scan stacks them); a Python loop over
layers slices one layer per step in place of ``lax.scan``.

MGNet RoI pruning: patches are scored by MGNet and only the top-k
(static budget ceil(keep_ratio * N)) enter encoder block 0; the [cls]
token is always kept.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mgnet as mgnet_mod
from repro_torch.core.decomposed_attention import mhsa_standard
from repro_torch.core.mgnet import MGNetConfig, mgnet_scores, patchify
from repro_torch.device import resolve_device
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import (ExecPolicy, QuantizedWeight, layernorm,
                                       linear)

__all__ = ["embed_patches", "encoder_layer_step", "encode_tokens",
           "forward_vit", "forward_vit_tokens", "vit_matmul_shapes",
           "mgnet_config"]


def _n_patches(cfg):
    return (cfg.img_size // cfg.patch) ** 2


def mgnet_config(cfg: ArchConfig) -> MGNetConfig:
    return MGNetConfig(patch=cfg.patch, img_size=cfg.img_size,
                       embed=cfg.mgnet_embed, heads=cfg.mgnet_heads)


def embed_patches(params: dict, images: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """images (B, H, W, 3) -> position-embedded patch tokens (B, N, d). The
    pos table is added before any pruning, so gathered subsets keep their
    positions."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    pt = patchify(images, cfg.patch)                      # (B, N, p*p*3)
    x = linear(pt, params["patch_embed"]["w"], params["patch_embed"]["b"],
               policy)
    return x + params["pos"][:, 1: x.shape[1] + 1]


def encoder_layer_step(carry: torch.Tensor, lp: dict, cfg: ArchConfig,
                       policy: ExecPolicy,
                       mask: torch.Tensor | None = None,
                       attn_kv: int | None = None,
                       ffn_live: int | None = None) -> torch.Tensor:
    """One encoder layer: LN -> MHSA -> residual -> LN -> FFN -> residual.
    ``lp`` is one layer's param slice."""
    h = layernorm(carry, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    o = mhsa_standard(h, lp["attn"], cfg.n_heads, policy, mask, attn_kv)
    carry = carry + o.to(carry.dtype)
    h2 = layernorm(carry, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
    return carry + ffn_mod.mlp(lp["ffn"], h2, policy, live_rows=ffn_live)


def _layer(blocks, i: int):
    """Layer ``i`` of the stacked blocks subtree."""
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    if isinstance(blocks, QuantizedWeight):
        return blocks.layer(i)
    return blocks[i]


def _fused_encoder_ineligible_reason(params: dict, cfg: ArchConfig,
                                     policy: ExecPolicy) -> str | None:
    """None when the encoder can run the fused serving point (int8 photonic
    matmuls + flash attention + fused FFN, standard dataflow, every
    per-layer matmul weight cached at <= 8 bits); else why not. The one
    eligibility check of the encode: the attention and FFN blocks below it
    call their kernels directly."""
    triple = (policy.backend, policy.resolve_attn_backend(),
              policy.resolve_ffn_backend())
    if triple != ("photonic_pallas", "flash", "fused"):
        return (f"backends {triple} are not the fused serving triple "
                f"('photonic_pallas', 'flash', 'fused')")
    if cfg.attn_impl != "standard":
        return f"attn_impl {cfg.attn_impl!r} (fused path needs 'standard')"
    blocks = params.get("blocks")
    if not isinstance(blocks, dict):
        return "params['blocks'] missing or not a dict"
    try:
        ws = ([blocks["attn"][n] for n in ("wq", "wk", "wv")]
              + [blocks["ffn"][n] for n in ("w1", "w2")])
    except (KeyError, TypeError):
        return "blocks missing attn/ffn weight entries"
    if not all(isinstance(w, QuantizedWeight) for w in ws):
        return "block weights not quantize-once cached (run prepare_params)"
    widths = sorted({w.bits for w in ws})
    if not all(2 <= b <= 8 for b in widths):
        return f"cached bit widths {widths} outside [2, 8]"
    return None


def _check_device(params: dict, dev: torch.device) -> None:
    pdev = params["pos"].device
    if pdev.type != dev.type:
        raise ValueError(f"params live on {pdev} but the call runs on {dev}; "
                         f"move them with repro_torch.bridge.to_device")


def encode_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy | None = None,
                  patch_mask: torch.Tensor | None = None,
                  kv_len: int | None = None, *, device=None) -> torch.Tensor:
    """Encoder trunk on pre-embedded patch tokens -> logits (B, n_classes).

    tokens (B, k, d) position-embedded patch tokens; the [cls] token is
    prepended here. ``patch_mask`` (B, k) removes tokens from every
    attention key axis (RoI mask mode); ``kv_len`` is the packed
    alternative (only the first ``kv_len`` patch tokens are live: the
    flash kernel skips the dead key tiles and the fused FFN the dead rows).
    Runs on ``device`` (default: the card).
    """
    dev = resolve_device(device)
    _check_device(params, dev)
    tokens = torch.as_tensor(tokens).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    if patch_mask is not None and kv_len is not None:
        raise ValueError("give patch_mask or kv_len, not both")
    reason = _fused_encoder_ineligible_reason(params, cfg, policy)
    if reason is not None:
        raise NotImplementedError(
            f"encoder not on the fused serving point ({reason}); the composed "
            f"dispatch is not ported yet (ROADMAP.md queue A)")
    b, _, d = tokens.shape
    cls = params["cls"].expand(b, 1, d) + params["pos"][:, :1]
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    mask = None
    if patch_mask is not None:
        patch_mask = torch.as_tensor(patch_mask).to(dev)
        mask = torch.cat([patch_mask.new_ones(b, 1), patch_mask], dim=1)
    attn_kv = None if kv_len is None else int(kv_len) + 1   # + live [cls]
    for i in range(cfg.n_layers):
        x = encoder_layer_step(x, _layer(params["blocks"], i), cfg, policy,
                               mask, attn_kv, attn_kv)
    x = layernorm(x, params["final_ln_g"], params["final_ln_b"], cfg.norm_eps)
    return linear(x[:, 0], params["head"], policy=policy)


def forward_vit(params: dict, images: torch.Tensor, cfg: ArchConfig,
                policy: ExecPolicy | None = None, *, device=None):
    """images (B, H, W, 3) -> (logits (B, n_classes), kept_patches int).

    With cfg.mgnet, MGNet scores patches and a static top-k budget of
    int(keep_ratio * N) enters the encoder (the paper's masked inference).
    """
    dev = resolve_device(device)
    _check_device(params, dev)
    images = torch.as_tensor(images).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    x = embed_patches(params, images, cfg, policy)
    n = x.shape[1]
    kept = n
    if cfg.mgnet and cfg.mgnet_keep_ratio < 1.0:
        scores = mgnet_scores(params["mgnet"], images, mgnet_config(cfg),
                              policy)
        kept = max(1, int(cfg.mgnet_keep_ratio * n))
        x, _ = mgnet_mod.select_topk_patches(scores, x, kept)
    return encode_tokens(params, x, cfg, policy, device=dev), kept


def forward_vit_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       policy: ExecPolicy | None = None,
                       kv_len: int | None = None, *, device=None):
    """Pre-gathered token forward: tokens (B, k, d) -> (logits, kept). The
    serving path's bucketed encode: the gate and gather happened upstream."""
    kept = tokens.shape[1] if kv_len is None else kv_len
    return encode_tokens(params, tokens, cfg, policy, kv_len=kv_len,
                         device=device), kept


def vit_matmul_shapes(cfg: ArchConfig, kept_patches: int | None = None,
                      include_mgnet: bool = False) -> list[tuple[int, int, int]]:
    """(M, K, N) of every matmul in one ViT forward of one image.

    kept_patches: post-MGNet token count (None = all patches).
    """
    n = (kept_patches if kept_patches is not None else _n_patches(cfg)) + 1
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    n_in = 3 * cfg.patch ** 2
    shapes = [(_n_patches(cfg) if kept_patches is None else kept_patches,
               n_in, d)]                                    # patch embed
    per_layer = [
        (n, d, d), (n, d, d), (n, d, d),                    # q, k, v
        (n, d, n),                                          # scores (per-head agg)
        (n, n, d),                                          # attn @ v
        (n, d, d),                                          # out proj
        (n, d, dff), (n, dff, d),                           # mlp
    ]
    shapes += per_layer * L
    if include_mgnet:
        mcfg = mgnet_config(cfg)
        nm = mcfg.n_patches + 1
        dm = mcfg.embed
        shapes += [
            (mcfg.n_patches, 3 * mcfg.patch ** 2, dm),      # mgnet patch embed
            (nm, dm, 3 * dm), (nm, dm, nm), (nm, nm, dm), (nm, dm, dm),
            (nm, dm, 4 * dm), (nm, 4 * dm, dm),
            (1, dm, dm), (mcfg.n_patches, dm, mcfg.n_patches),  # scoring
        ]
    return shapes
