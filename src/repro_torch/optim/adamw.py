"""AdamW + SGD and the learning-rate schedule, on trees of tensors (the
reference's src/repro/optim/adamw.py, operation for operation).

Trees are nested dicts of tensors. Every walk over leaves follows the
reference's ``jax.tree_util`` order, dict keys sorted (``tree_leaves``):
the cross-leaf sum of ``clip_by_global_norm`` adds the leaves' squares in
that order, as any other order moves the norm by ulps.

All update math is f32. Two storage modes for the moments, as the
reference's: f32, or bf16 (``low_mem``), rounded to nearest even as
``astype`` rounds; only storage is rounded. The bias corrections are f32
powers ``b ** count`` of 0-d tensors, as the reference computes them.
Python scalars enter f32 arithmetic as f32, as JAX's weak types do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "sgd_init",
           "sgd_update", "warmup_cosine", "clip_by_global_norm",
           "tree_leaves", "tree_unflatten", "tree_map"]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``like``'s structure with its leaves taken in ``tree_leaves`` order
    from ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    low_mem: bool = False          # bf16 m/v storage


def _store_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.low_mem else torch.float32


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = _store_dtype(cfg)
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


# elements of a leaf updated at once: the update is elementwise, so chunks
# give the bits of the whole leaf, and the f32 temporaries of a 1 G-element
# embedding stay a few hundred MB instead of tens of GB
_CHUNK = 1 << 26


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """Returns (new_params, new_state). All math f32; storage per cfg;
    each leaf in chunks of ``_CHUNK`` elements."""
    count = state["count"] + 1
    cf = count.float()
    one = torch.ones((), dtype=torch.float32, device=cf.device)
    b1c = 1.0 - (one * cfg.b1) ** cf
    b2c = 1.0 - (one * cfg.b2) ** cf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=cf.device)
    store_dt = _store_dtype(cfg)

    def chunk(g, m, v, p):
        gf = g.float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat = mf / b1c
        vhat = vf / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (step + cfg.weight_decay * pf)
        return pf, mf, vf

    def upd(g, m, v, p):
        new = (torch.empty(p.shape, dtype=p.dtype, device=p.device),
               torch.empty(p.shape, dtype=store_dt, device=p.device),
               torch.empty(p.shape, dtype=store_dt, device=p.device))
        flat = [t.reshape(-1) for t in (g, m, v, p)]
        for i in range(0, max(p.numel(), 1), _CHUNK):
            for out, val in zip(new, chunk(*(t[i:i + _CHUNK] for t in flat))):
                out.view(-1)[i:i + _CHUNK].copy_(val)
        return new

    out = tree_map(lambda g, m, v, p: upd(g, m, v, p), grads, state["m"],
                   state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}


def sgd_init(params, momentum: float = 0.9) -> dict:
    return {"mom": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)}


@torch.no_grad()
def sgd_update(grads, state: dict, params, lr: float,
               momentum: float = 0.9):
    def upd(g, mo, p):
        mo = momentum * mo + g.float()
        return (p.float() - lr * mo).to(p.dtype), mo

    out = tree_map(upd, grads, state["mom"], params)
    return (tree_map(lambda o: o[0], out),
            {"mom": tree_map(lambda o: o[1], out)})


def warmup_cosine(step, *, peak_lr_scale: float = 1.0, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    """LR multiplier (a 0-d f32 tensor): linear warmup, then cosine decay
    to floor * peak. ``step`` an int or a 0-d tensor (its device kept)."""
    s = torch.as_tensor(step).float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr_scale * torch.where(s < warmup, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0, split=None,
                        group=None, donate: bool = False):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before scaling). The leaves' sums of squares are added in the
    reference's leaf order.

    ``split`` (a tree like ``grads``) names what each leaf is a block of:
    a false value (``()``) for a whole leaf, else a key of ``group``, a
    dict of process groups (the mesh axes the leaf is split over, as
    ``launch/steps.py::_split_leaves`` gives them, to that axes' group).
    The blocks' sums of squares of each key are added in leaf order and
    summed over its group once, the keys in sorted order, after the whole
    leaves', so the norm is the logical gradient's on every rank.

    ``donate``: the grads are the caller's to overwrite, and f32 leaves
    are scaled in place (the same f32 product, without a second copy of
    a train step's accumulated gradient)."""
    gn = 0
    parts: dict = {}
    for leaf, sp in zip(tree_leaves(grads), tree_leaves(split) if split
                        is not None else [()] * len(tree_leaves(grads))):
        sq = torch.sum(leaf.float() ** 2)
        if sp:
            parts[sp] = parts.get(sp, 0) + sq
        else:
            gn = gn + sq
    if parts:
        import torch.distributed as dist

        from repro_torch.distributed import collectives
        for sp in sorted(parts):
            gn = gn + collectives.all_reduce(parts[sp], dist.ReduceOp.SUM,
                                             group[sp], "grad_norm_sum")
    gn = torch.sqrt(gn)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)

    def scaled(g):
        if donate and g.dtype == torch.float32:
            return g.mul_(scale)
        return (g.float() * scale).to(g.dtype)
    return tree_map(scaled, grads), gn
