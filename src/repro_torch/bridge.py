"""Parameter bridge: the reference's param pytree into the port, and
seeded initializers for runs that have no reference params.

``from_jax_params`` takes the reference's parameter tree as nested dicts
whose leaves are arrays (numpy arrays, or anything ``numpy.asarray``
accepts) and returns the port's tree of tensors with the same keys. A
bfloat16 leaf (numpy holds it as ``ml_dtypes.bfloat16``, which torch
cannot read) crosses bit for bit as ``torch.bfloat16``. A cached weight
arrives as a ``(wq, scale, bits)`` tuple, or as any object with ``wq``,
``scale`` and ``bits`` attributes, and becomes a ``QuantizedWeight`` (a
per-layer ``bits`` tuple, from a mixed-precision bit plan, included; the
K-major copy ``wt`` is made once here).
Scan-stacked ``blocks`` leaves keep their leading L axis: the models slice
one layer per step. ``from_jax_state`` takes the reference's train state
(``{"params", "opt": {"m", "v", "count"}, "step"}``) the same way: bf16
moments bit for bit, ``count`` and ``step`` as 0-d int32.

``init_vit`` draws a ViT (+ MGNet) parameter tree of the reference's
shapes and scales from ``numpy.random.default_rng(seed)``; ``init_lm``
draws a dense or hybrid LM tree on the target device from a seeded
``torch.Generator`` (numpy would take minutes over 1.5 G normals; the
hybrid's recurrentgemma-9b has 10.4 G), each leaf in the reference's
dtype (a hybrid's ``lambda``, ``b_a`` and ``b_x`` stay f32). Neither
reproduces the reference's ``jax.random`` draws: the port's tests bridge
the reference's own params instead.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import QuantizedWeight
from repro_torch.device import resolve_device

__all__ = ["from_jax_params", "from_jax_state", "to_device", "init_vit",
           "init_mgnet", "init_lm"]


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
            return QuantizedWeight(
                torch.from_numpy(np.array(wq, np.int8)).to(dev),
                torch.from_numpy(np.array(scale, np.float32)).to(dev),
                bits)
        return _to_tensor(leaf).to(dev)

    return conv(tree)


def from_jax_state(state: dict, device=None) -> dict:
    """The reference's train state (``launch/train.py::init_state``, or a
    step's output) as the port's: every leaf a tensor of the same dtype
    and bits on ``device`` (default: the card)."""
    if set(state) != {"params", "opt", "step"} or \
            set(state["opt"]) != {"m", "v", "count"}:
        raise ValueError(f"not a train state: keys {sorted(state)}")
    out = from_jax_params(state, device)
    for name, t in (("opt/count", out["opt"]["count"]),
                    ("step", out["step"])):
        if t.dtype != torch.int32 or t.ndim != 0:
            raise ValueError(f"{name} is {t.dtype} of shape "
                             f"{tuple(t.shape)}, not a 0-d int32")
    return out


def _to_tensor(leaf) -> torch.Tensor:
    """An array leaf as a CPU tensor of the same dtype, bit for bit. numpy
    holds bfloat16 as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses: its 16-bit patterns are carried through int16 and viewed as
    ``torch.bfloat16``."""
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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


def init_vit(seed: int, cfg: ArchConfig, n_classes: int = 1000,
             rng=None) -> dict:
    """Numpy param tree of the reference's ``init_vit`` shapes and scales
    (stacked ``blocks`` with a leading L axis), drawn from
    ``numpy.random.default_rng(seed)`` (or ``rng``, anything with its
    ``standard_normal``). Feed it to ``from_jax_params``."""
    from repro_torch.models.vit import mgnet_config

    rng = np.random.default_rng(seed) if rng is None else rng
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


def init_lm(seed: int, cfg: ArchConfig, device=None,
            dtype=torch.bfloat16, place: bool = False) -> dict:
    """An LM param tree of the reference's shapes and scales
    (``init_lm``/``init_dense_layer``/``init_attention``/``init_swiglu``,
    and for a hybrid ``init_rec_layer``/``init_rglru``):
    embed N(0, 0.02); every matmul weight He-normal over its fan-in;
    biases 0; norm gains 1; stacked ``blocks`` with a leading L axis; an
    ``lm_head`` only without tied embeddings. Drawn in f32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card), then cast to ``dtype``.

    ``place``: cut the tree to this rank's blocks under the installed
    sharding context (``transformer.place_lm_params``'s blocks, bitwise:
    the draws are the same); a hybrid's subtrees (``embed``, ``lm_head``,
    each layer kind of ``blocks``, ``tail_blocks``) each as soon as it is
    drawn, so a rank never holds the whole tree (recurrentgemma-9b's is
    20.9 GB)."""
    from repro_torch.distributed.sharding import current_ctx
    from repro_torch.models.transformer import (attention_shapes,
                                                check_family,
                                                lm_placement_axes)

    check_family(cfg)
    dev = resolve_device(device)
    ctx = current_ctx() if place else None
    axes = lm_placement_axes(cfg) if ctx is not None else None

    def keep(tree, ax):
        """``tree`` cut to this rank's blocks of axes ``ax`` (``place``)."""
        if ctx is None:
            return tree
        from repro_torch.core.backend import place_params
        return place_params(tree, ax, ctx)

    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def normal(shape, std):
        # scaled in place: a leaf's transient is one f32 copy (llama3-405b's
        # embedding: 8.4 GB)
        return torch.randn(shape, generator=gen, device=dev).mul_(std).to(
            dtype)

    def he(shape):                       # fan-in: the per-layer rows
        return normal(shape, (2.0 / shape[-2]) ** 0.5)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if cfg.family == "hybrid":
        return _init_hybrid(gen, cfg, dev, dtype, normal, he, const, keep,
                            axes)

    attn = {}
    for name, shape in attention_shapes(cfg).items():
        attn[name] = he((L,) + shape) if len(shape) == 2 else \
            const((L,) + shape, 0.0)
    params = {
        "embed": normal((cfg.vocab, d), 0.02),
        "final_ln": const((d,), 1.0),
        "blocks": {
            "ln1": const((L, d), 1.0),
            "attn": attn,
            "ln2": const((L, d), 1.0),
            "ffn": {"w_gate": he((L, d, dff)), "w_up": he((L, d, dff)),
                    "w_down": he((L, dff, d))},
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he((d, cfg.vocab))
    return keep(params, axes)


def _init_hybrid(gen, cfg: ArchConfig, dev, dtype, normal, he, const, keep,
                 axes) -> dict:
    """``init_lm``'s hybrid tree (the reference's ``init_lm`` hybrid
    branch, ``init_rec_layer``, ``init_dense_layer``): embed, the untied
    head, then ``blocks`` of (rec0, rec1, attn) super-blocks and the
    tail's recurrent layers, every leaf stacked on its leading axis; each
    of those subtrees ``keep(subtree, its axes)`` as soon as it is
    drawn."""
    from repro_torch.models import rglru
    from repro_torch.models.transformer import attention_shapes, hybrid_counts

    d, dff = cfg.d_model, cfg.d_ff
    nsb, rem = hybrid_counts(cfg)
    ax = axes or {}
    params = {"embed": keep(normal((cfg.vocab, d), 0.02), ax.get("embed")),
              "final_ln": const((d,), 1.0)}
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(he((d, cfg.vocab)), ax.get("lm_head"))

    def ffn(n):
        return {"w_gate": he((n, d, dff)), "w_up": he((n, d, dff)),
                "w_down": he((n, dff, d))}

    def rec_layer(n):
        return {"ln1": const((n, d), 1.0),
                "rec": rglru.init_rglru(gen, cfg, n, dev, dtype),
                "ln2": const((n, d), 1.0), "ffn": ffn(n)}

    def attn_layer(n):
        attn = {name: he((n,) + shape) if len(shape) == 2 else
                const((n,) + shape, 0.0)
                for name, shape in attention_shapes(cfg).items()}
        return {"ln1": const((n, d), 1.0), "attn": attn,
                "ln2": const((n, d), 1.0), "ffn": ffn(n)}

    blocks = {}
    for name, make in (("rec0", rec_layer), ("rec1", rec_layer),
                       ("attn", attn_layer)):
        blocks[name] = keep(make(nsb), ax.get("blocks", {}).get(name))
    params["blocks"] = blocks
    if rem:
        params["tail_blocks"] = keep(rec_layer(rem), ax.get("tail_blocks"))
    return params
