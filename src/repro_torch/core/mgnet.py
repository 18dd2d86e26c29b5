"""MGNet: the lightweight region-of-interest Mask Generation Network (the
reference's src/repro/core/mgnet.py, paper Sec. IV).

Patchify + embed, one transformer block over [cls] + patch tokens, the
Eq. 3 class-attention score q_cls . K^T / sqrt(d) and a linear region head
give per-patch region scores. Every weight matmul routes through
``linear``, so on the serving point MGNet runs on the int8 photonic
matmul kernel like the backbone; the q.K^T and att.V activation products
and the softmax stay plain PyTorch ops, as they stay XLA ops in the
reference.

Training (paper Sec. IV): ``bce_loss`` of the region scores against the
box-derived patch labels. Under a training policy ``mgnet_scores`` is
differentiable end to end; ``select_topk_patches`` passes gradients to the
tokens through the gather and none to the scores (top-k indices carry
none), as the reference's ``take_along_axis``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.backend import ExecPolicy, linear
from repro_torch.kernels.ref import gelu_tanh

__all__ = ["MGNetConfig", "patchify", "mgnet_scores", "mgnet_mask",
           "select_topk_patches", "mask_budget", "frame_delta", "mask_iou",
           "bce_loss", "mgnet_logical_axes"]


@dataclass(frozen=True)
class MGNetConfig:
    patch: int = 16
    embed: int = 192        # 384 for the detection variant
    heads: int = 3          # 6 for the detection variant
    mlp_ratio: float = 4.0
    t_reg: float = 0.5      # sigmoid threshold for the binary mask
    img_size: int = 96

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch) ** 2


def mgnet_logical_axes() -> dict:
    """Replicated (all-None) logical-axis tree of MGNet's params: MGNet is
    tiny and never partitioned, but the tree mirrors the params for
    ``core.backend.place_params``."""
    return {
        "patch_embed": {"w": (None, None), "b": (None,)},
        "cls_token": (None, None, None),
        "pos_embed": (None, None, None),
        "block": {
            "ln1": {"g": (None,), "b": (None,)},
            "wqkv": (None, None),
            "wo": (None, None),
            "ln2": {"g": (None,), "b": (None,)},
            "w1": (None, None), "b1": (None,),
            "w2": (None, None), "b2": (None,),
        },
        "score": {"wq": (None, None), "wk": (None, None),
                  "head_w": (None, None), "head_b": (None,)},
    }


def _ln(x, p, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _mhsa(x, wqkv, wo, heads, policy=None):
    b, n, d = x.shape
    qkv = linear(x, wqkv, policy=policy)
    q, k, v = torch.split(qkv, d, dim=-1)
    dh = d // heads
    q = q.reshape(b, n, heads, dh).permute(0, 2, 1, 3)
    k = k.reshape(b, n, heads, dh).permute(0, 2, 1, 3)
    v = v.reshape(b, n, heads, dh).permute(0, 2, 1, 3)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    o = (att @ v).permute(0, 2, 1, 3).reshape(b, n, d)
    return linear(o, wo, policy=policy)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, n_patches, patch*patch*C), row-major patch grid."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def mgnet_scores(params: dict, images: torch.Tensor, cfg: MGNetConfig,
                 policy: ExecPolicy | None = None) -> torch.Tensor:
    """Per-patch region scores S_region (pre-sigmoid logits), (B, N)."""
    x = linear(patchify(images, cfg.patch), params["patch_embed"]["w"],
               params["patch_embed"]["b"], policy)
    b, n, d = x.shape
    cls = params["cls_token"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][:, : n + 1]

    blk = params["block"]
    x = x + _mhsa(_ln(x, blk["ln1"]), blk["wqkv"], blk["wo"], cfg.heads,
                  policy)
    h = linear(_ln(x, blk["ln2"]), blk["w1"], blk["b1"], policy)
    x = x + linear(gelu_tanh(h), blk["w2"], blk["b2"], policy)

    # Eq. 3: S_cls_attn = q_cls . K^T / sqrt(d) over patch tokens.
    q_cls = linear(x[:, :1], params["score"]["wq"], policy=policy)  # (B,1,d)
    k_pat = linear(x[:, 1:], params["score"]["wk"], policy=policy)  # (B,N,d)
    s_cls = (q_cls @ k_pat.transpose(1, 2))[:, 0] / math.sqrt(d)    # (B, N)
    return linear(s_cls, params["score"]["head_w"],
                  params["score"]["head_b"], policy)


def mgnet_mask(params: dict, images: torch.Tensor, cfg: MGNetConfig,
               policy: ExecPolicy | None = None) -> torch.Tensor:
    """Binary patch mask (B, N) in {0., 1.}: sigmoid(S_region) > t_reg."""
    s = torch.sigmoid(mgnet_scores(params, images, cfg, policy))
    return (s > cfg.t_reg).float()


def select_topk_patches(scores: torch.Tensor, tokens: torch.Tensor, keep: int):
    """Keep the ``keep`` highest-scoring patches: stable descending argsort,
    so among equal scores the lowest patch index wins. scores (B, N);
    tokens (B, N, D) -> (pruned (B, keep, D), kept_idx (B, keep))."""
    idx = torch.argsort(scores, dim=-1, descending=True, stable=True)
    idx = idx[..., :keep]
    pruned = torch.gather(tokens, 1,
                          idx[..., None].expand(-1, -1, tokens.shape[-1]))
    return pruned, idx


def mask_budget(scores: np.ndarray, t_reg: float = 0.5) -> np.ndarray:
    """Per-frame kept-patch count of the binary mask sigmoid(s) > t_reg,
    (B,), on host numpy scores (the serving gate's routing decision)."""
    keep = 1.0 / (1.0 + np.exp(-scores.astype(np.float64))) > t_reg
    return keep.sum(axis=-1).astype(np.int32)


def frame_delta(frames: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Mean absolute pixel difference of each frame to ``ref``, (B,): the
    cheap host-side signal that decides whether MGNet re-scores."""
    d = np.abs(frames.astype(np.float32) - ref.astype(np.float32))
    return d.mean(axis=tuple(range(1, frames.ndim)))


def mask_iou(pred: torch.Tensor, gt: torch.Tensor,
             eps: float = 1e-8) -> torch.Tensor:
    """Mean IoU of binary masks (B, N): the paper's mask quality metric."""
    inter = (pred * gt).sum(-1)
    union = torch.clamp(pred + gt, 0, 1).sum(-1)
    return (inter / (union + eps)).mean()


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of region scores (pre-sigmoid) against the
    box-derived {0, 1} patch labels, mean over every element."""
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    return -torch.mean(labels * log_p + (1.0 - labels) * log_not_p)
