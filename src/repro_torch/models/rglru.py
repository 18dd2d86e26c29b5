"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; the
reference's src/repro/models/rglru.py).

Recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  with c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the recurrence Griffin-style: in-proj, the short causal
conv, the RG-LRU, gated by a parallel tanh-GELU branch, then out-proj.
The gates and the recurrence are f32 (the projections' bf16 weights cast
to f32, so the card's f32 matmuls must not run in TF32: the serving
entry points set ``device.full_precision_matmuls``); ``Lambda``, ``b_a``
and ``b_x`` are f32 leaves of a bf16 tree.

The full-sequence recurrence is a log-depth scan in plain PyTorch on the
affine composition (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2), the
combine of the reference's ``jax.lax.associative_scan``: ceil(log2 S)
elementwise passes over (B, S, W) (Hillis-Steele), never a loop over
positions. Its association order differs from the reference's, so h
agrees to f32 rounding (the tests hold 1e-5 relative). The reference has
no Pallas kernel for the RG-LRU, so none is written here.

Training. The gradients of the scan and of the gates come from autograd.
The doubling scan keeps ceil(log2 S) pairs of (B, S, W) f32 tensors for
the backward (about 1.6 GB a layer at S 4096, W 4096 and batch 1), which
is why the LM remats each super-block (models/transformer.py). The
floor under sqrt(1 - a^2) is ``jnp.maximum``'s: a value exactly on it
passes half the gradient (``quant._jnp_clip``), where ``torch.clamp_min``
would pass all of it. The f32 gate GEMMs need the card's full-precision
matmuls in the backward too; the train step sets them
(``launch/steps.py``).

Tensor parallelism. ``split`` (a ``sharding.Split`` of the LRU width
over "model", ``transformer.lru_split``) says the params hold this
rank's block of the reference's "p_mlp" axes: ``in_proj`` / ``gate_proj``
columns (their input through ``collectives.copy_to_model``), ``w_a`` /
``w_x`` rows, ``out_proj`` rows (``layers.row_parallel_linear``). The
short conv runs on the rank's channel block with that block of the whole
``conv_w``. The gate GEMMs contract the split width: each rank's f32
partial products (B, S, W) are summed over the group in f32 in rank order
(``collectives.reduce_from_model``, ``_reduce_gates``) before ``b_a`` /
``b_x`` and the sigmoid, each bias added once; then the rank keeps its
columns. ``lambda``, the scan, ``i * u`` and the GELU gate run on the
rank's block: the scan is per channel. The decode state is the rank's
(B, W / n) and (B, K - 1, W / n) block. A whole leaf read in blocks
(``conv_w``, ``lambda``, ``b_a``, ``b_x``) goes through
``copy_to_model``, so its gradient, nonzero on each rank in that rank's
columns only, is summed over the group: every rank then holds the whole
gradient, and AdamW updates the leaf the same on every rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.quant import _jnp_clip
from repro_torch.distributed import collectives
from repro_torch.kernels.ref import gelu_tanh
from repro_torch.models.layers import (ExecPolicy, causal_conv1d, linear,
                                       row_parallel_linear)

__all__ = ["init_rglru", "rglru_shapes", "lru_linspace", "lambda_init",
           "rglru_forward", "rglru_decode_step", "rglru_logical_axes",
           "rglru_state_shape", "lru_scan"]

_C = 8.0


def rglru_shapes(cfg) -> dict:
    """The block's leaf shapes (``init_rglru``'s, without drawing)."""
    d, w = cfg.d_model, cfg.lru_dim
    return {"in_proj": (d, w), "gate_proj": (d, w),
            "conv_w": (cfg.conv_kernel, w), "w_a": (w, w), "b_a": (w,),
            "w_x": (w, w), "b_x": (w,), "lambda": (w,), "out_proj": (w, d)}


# the leaves kept in f32 whatever the tree's dtype
F32_LEAVES = ("b_a", "b_x", "lambda")


def lru_linspace(w: int, device=None) -> torch.Tensor:
    """linspace(0.9, 0.999, w) in f32 as start + (stop - start) t, t =
    i / (w - 1), the stop appended: within 1 f32 ulp of ``jnp.linspace``
    (whose compiled arithmetic XLA rewrites; its own formula, start (1 - t)
    + stop t, evaluated op by op is 2 ulps off)."""
    if w == 1:
        return torch.full((1,), 0.9, dtype=torch.float32, device=device)
    t = torch.arange(w - 1, dtype=torch.float32, device=device) / (w - 1)
    start = torch.tensor(0.9, dtype=torch.float32, device=device)
    stop = torch.tensor(0.999, dtype=torch.float32, device=device)
    return torch.cat([start + (stop - start) * t, stop[None]])


def lambda_init(w: int, device=None) -> torch.Tensor:
    """Lambda so that a spans ~(0.9, 0.999) at r = 1 (Griffin's appendix):
    log(expm1(-log(lru_linspace(w)) / c)), f32. Near 0.999 the log of a
    small expm1 amplifies the linspace's ulp ~25x, so lambda is the
    reference's to that amplified ulp (the tests bridge the reference's
    own lambda)."""
    return torch.log(torch.expm1(-torch.log(lru_linspace(w, device)) / _C))


def init_rglru(gen: torch.Generator, cfg, n: int, device=None,
               dtype=torch.bfloat16) -> dict:
    """Seeded random params of ``n`` stacked layers (every leaf with a
    leading axis of n), the reference's shapes, scales and dtypes: the
    projections He-normal over their fan-in in ``dtype``, ``conv_w``
    N(0, 0.1) in ``dtype``, ``b_a`` / ``b_x`` zeros and ``lambda``
    (``lambda_init``) in f32. Drawn in f32 from ``gen`` on ``device``, one
    draw a leaf in ``rglru_shapes``' order."""

    def normal(shape, std):
        return (torch.randn((n,) + shape, generator=gen, device=device)
                * std).to(dtype)

    out = {}
    for name, shape in rglru_shapes(cfg).items():
        if name == "conv_w":
            out[name] = normal(shape, 0.1)
        elif name == "lambda":
            out[name] = lambda_init(shape[0], device).expand(
                (n,) + shape).clone()
        elif name in F32_LEAVES:
            out[name] = torch.zeros((n,) + shape, dtype=torch.float32,
                                    device=device)
        else:
            out[name] = normal(shape, (2.0 / shape[0]) ** 0.5)
    return out


def rglru_logical_axes(cfg) -> dict:
    return {"in_proj": ("p_embed", "p_mlp"), "gate_proj": ("p_embed", "p_mlp"),
            "conv_w": (None, None),
            "w_a": ("p_mlp", None), "b_a": (None,),
            "w_x": ("p_mlp", None), "b_x": (None,),
            "lambda": (None,),
            "out_proj": ("p_mlp", "p_embed")}


def rglru_state_shape(cfg, batch: int) -> dict:
    return {"h": (batch, cfg.lru_dim),
            "conv": (batch, cfg.conv_kernel - 1, cfg.lru_dim)}


def _whole_block(t: torch.Tensor, split) -> torch.Tensor:
    """This rank's columns (last dim) of a whole leaf read in blocks, its
    gradient summed over the split's group; the leaf itself without a
    split."""
    if split is None:
        return t
    c0, c1 = split.block(t.shape[-1])
    return collectives.copy_to_model(t, split.group)[..., c0:c1]


def _reduce_gates(partial: torch.Tensor, group) -> torch.Tensor:
    """The gate GEMMs' f32 partial products summed over ``group`` (in
    rank order, rounded once); the sum's gradient, of which each rank
    reads its columns only, summed over the group too."""
    return collectives.copy_to_model(
        collectives.reduce_from_model(partial, group), group)


def _gate_preacts(params, uf, split):
    """(W_a u + b_a, W_x u + b_x) in f32 from the f32 conv output uf: this
    rank's columns under ``split``, where uf is its block of the width
    and w_a / w_x its rows (the two partials reduced in one call)."""
    if split is None:
        return (uf @ params["w_a"].float() + params["b_a"],
                uf @ params["w_x"].float() + params["b_x"])
    partial = torch.stack([uf @ params["w_a"].float(),
                           uf @ params["w_x"].float()])
    whole = _reduce_gates(partial, split.group)
    c0, c1 = split.block(whole.shape[-1])
    return (whole[0, ..., c0:c1] + _whole_block(params["b_a"], split),
            whole[1, ..., c0:c1] + _whole_block(params["b_x"], split))


def _gates(params, u, split=None):
    """(a, b) of the recurrence, f32, from the conv output u (this rank's
    block of the width under ``split``)."""
    uf = u.float()
    za, zx = _gate_preacts(params, uf, split)
    r = torch.sigmoid(za)
    i = torch.sigmoid(zx)
    lam = _whole_block(params["lambda"], split)
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(_jnp_clip(1.0 - torch.exp(2.0 * log_a), 1e-12,
                             math.inf)) * (i * uf)
    return a, b


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along dim 1, every t: the
    inclusive scan of the affine maps (a_t, b_t) under (a1, b1) then (a2,
    b2) -> (a1 a2, a2 b1 + b2), by doubling (pass k combines each t with
    t - 2^k). (B, S, W) f32 in, h (B, S, W) f32 out."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def _gate_branch(params, x, policy):
    return gelu_tanh(linear(x, params["gate_proj"], policy=policy).float())


def _in(x, split):
    """The input of the column-parallel in_proj / gate_proj: under a split
    its gradient is summed over the group (one reduce for both)."""
    return x if split is None else collectives.copy_to_model(x, split.group)


def _out_proj(params, y, policy, split):
    if split is None:
        return linear(y, params["out_proj"], policy=policy)
    return row_parallel_linear(y, params["out_proj"], policy, split.group)


def rglru_forward(params: dict, x: torch.Tensor, cfg,
                  policy: ExecPolicy | None = None, initial_state=None,
                  split=None):
    """x (B, S, d_model) -> (y (B, S, d_model) in x.dtype, final state
    {"h": (B, W) f32, "conv": (B, K - 1, W)}); under ``split`` the params
    and the state are this rank's blocks (W / n wide) and y is whole."""
    xin = _in(x, split)
    u = linear(xin, params["in_proj"], policy=policy)
    conv0 = None if initial_state is None else initial_state["conv"]
    u, conv_state = causal_conv1d(u, _whole_block(params["conv_w"], split),
                                  conv0)
    a, b = _gates(params, u, split)                   # (B, S, W) f32
    if initial_state is not None:
        # fold h0 into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * initial_state["h"].float()[:, None],
                       b[:, 1:]], 1)
    h = lru_scan(a, b)
    y = (h * _gate_branch(params, xin, policy)).to(x.dtype)
    return _out_proj(params, y, policy, split), {"h": h[:, -1],
                                                 "conv": conv_state}


def rglru_decode_step(params: dict, x: torch.Tensor, state: dict, cfg,
                      policy: ExecPolicy | None = None, split=None):
    """x (B, 1, d_model), state {"h", "conv"} -> (y, new state); the new
    state's tensors are new (the caller writes them into its cache). Under
    ``split`` the state is this rank's block of the width."""
    xin = _in(x, split)
    u = linear(xin, params["in_proj"], policy=policy)
    u, conv_state = causal_conv1d(u, _whole_block(params["conv_w"], split),
                                  state["conv"])
    a, b = _gates(params, u, split)                   # (B, 1, W)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = (h[:, None] * _gate_branch(params, xin, policy)).to(x.dtype)
    return _out_proj(params, y, policy, split), {"h": h, "conv": conv_state}
