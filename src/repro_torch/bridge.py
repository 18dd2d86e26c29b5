"""Parameter bridge: the reference's param pytree into the port, and a
numpy-seeded initializer for runs that have no reference params.

``from_jax_params`` takes the reference's parameter tree as nested dicts
whose leaves are arrays (numpy arrays, or anything ``numpy.asarray``
accepts) and returns the port's tree of tensors with the same keys. A
cached weight arrives as a ``(wq, scale, bits)`` tuple, or as any object
with ``wq``, ``scale`` and ``bits`` attributes, and becomes a
``QuantizedWeight``. Scan-stacked ``blocks`` leaves keep their leading L
axis: the encoder slices one layer per step.

``init_vit`` draws a ViT (+ MGNet) parameter tree of the reference's
shapes and scales from ``numpy.random.default_rng(seed)``. It does NOT
reproduce the reference's ``jax.random`` draws: the port's tests bridge
the reference's own params instead.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import QuantizedWeight
from repro_torch.device import resolve_device

__all__ = ["from_jax_params", "to_device", "init_vit", "init_mgnet"]


def _is_cached(leaf) -> bool:
    return (isinstance(leaf, tuple) and len(leaf) == 3) or all(
        hasattr(leaf, a) for a in ("wq", "scale", "bits"))


def from_jax_params(tree, device=None):
    """Nested dict of arrays (+ cached-weight triples) -> nested dict of
    tensors / ``QuantizedWeight`` on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        if _is_cached(leaf):
            wq, scale, bits = (leaf if isinstance(leaf, tuple)
                               else (leaf.wq, leaf.scale, leaf.bits))
            if isinstance(bits, (tuple, list)):
                raise NotImplementedError(
                    "per-layer bit plans are not ported yet "
                    "(ROADMAP.md queue A)")
            return QuantizedWeight(
                torch.from_numpy(np.array(wq, np.int8)).to(dev),
                torch.from_numpy(np.array(scale, np.float32)).to(dev),
                int(bits))
        arr = np.array(leaf)
        return torch.from_numpy(arr).to(dev)

    return conv(tree)


def to_device(params, device):
    """The same tree with every tensor and cached weight on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


def _he(rng, shape, fan_in=None):
    fan_in = shape[-2] if fan_in is None else fan_in
    return (rng.standard_normal(shape, np.float32)
            * np.float32(np.sqrt(2.0 / fan_in)))


def _dense(rng, shape):
    return (rng.standard_normal(shape, np.float32)
            * np.float32(1.0 / np.sqrt(shape[0])))


def init_mgnet(rng: np.random.Generator, cfg) -> dict:
    """MGNet params (the reference's ``init_mgnet`` shapes and scales);
    ``cfg`` is an ``MGNetConfig``."""
    d = cfg.embed
    n_in = 3 * cfg.patch * cfg.patch
    hid = int(d * cfg.mlp_ratio)
    z = np.zeros
    return {
        "patch_embed": {"w": _dense(rng, (n_in, d)), "b": z((d,), np.float32)},
        "cls_token": rng.standard_normal((1, 1, d), np.float32) * np.float32(0.02),
        "pos_embed": rng.standard_normal((1, cfg.n_patches + 1, d),
                                         np.float32) * np.float32(0.02),
        "block": {
            "ln1": {"g": np.ones((d,), np.float32), "b": z((d,), np.float32)},
            "wqkv": _dense(rng, (d, 3 * d)),
            "wo": _dense(rng, (d, d)),
            "ln2": {"g": np.ones((d,), np.float32), "b": z((d,), np.float32)},
            "w1": _dense(rng, (d, hid)), "b1": z((hid,), np.float32),
            "w2": _dense(rng, (hid, d)), "b2": z((d,), np.float32),
        },
        "score": {
            "wq": _dense(rng, (d, d)),
            "wk": _dense(rng, (d, d)),
            "head_w": _dense(rng, (cfg.n_patches, cfg.n_patches)),
            "head_b": z((cfg.n_patches,), np.float32),
        },
    }


def init_vit(seed: int, cfg: ArchConfig, n_classes: int = 1000) -> dict:
    """Numpy param tree of the reference's ``init_vit`` shapes and scales
    (stacked ``blocks`` with a leading L axis), drawn from
    ``numpy.random.default_rng(seed)``. Feed it to ``from_jax_params``."""
    from repro_torch.models.vit import mgnet_config

    rng = np.random.default_rng(seed)
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    n_in = 3 * cfg.patch ** 2
    n = (cfg.img_size // cfg.patch) ** 2
    ones, zeros = np.ones((L, d), np.float32), np.zeros((L, d), np.float32)
    params = {
        "patch_embed": {"w": _he(rng, (n_in, d)),
                        "b": np.zeros((d,), np.float32)},
        "cls": rng.standard_normal((1, 1, d), np.float32) * np.float32(0.02),
        "pos": rng.standard_normal((1, n + 1, d), np.float32) * np.float32(0.02),
        "blocks": {
            "ln1_g": ones, "ln1_b": zeros,
            "attn": {k: _he(rng, (L, d, d)) for k in ("wq", "wk", "wv", "wo")},
            "ln2_g": ones.copy(), "ln2_b": zeros.copy(),
            "ffn": {"w1": _he(rng, (L, d, dff)),
                    "b1": np.zeros((L, dff), np.float32),
                    "w2": _he(rng, (L, dff, d)),
                    "b2": np.zeros((L, d), np.float32)},
        },
        "final_ln_g": np.ones((d,), np.float32),
        "final_ln_b": np.zeros((d,), np.float32),
        "head": _he(rng, (d, n_classes)),
    }
    if cfg.mgnet:
        params["mgnet"] = init_mgnet(rng, mgnet_config(cfg))
    return params
