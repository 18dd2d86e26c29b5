"""Step builders of the port (the reference's src/repro/launch/steps.py):
the train step, and on a mesh the sharded train / prefill / serve steps.

    state = {"params", "opt": {"m", "v", "count"}, "step"}

``make_train_fn`` is the reference's ``make_train_fn``, operation for
operation:

  * the loss's gradient over the flattened param leaves
    (``torch.autograd.grad``, the reference's ``value_and_grad``); a leaf
    the loss does not reach gets a zero gradient (MGNet's, under RoI
    pruning: top-k indices carry none);
  * ``cfg.microbatch_steps`` k > 1 splits the batch into k sequential
    microbatches of B / k rows, accumulates the gradients in
    ``cfg.grad_accum_dtype`` and divides by k (the reference's
    ``lax.scan``); on a mesh each rank's rows are its share of every
    global microbatch (``data/pipeline.py::_rank_rows``), so local
    microbatch i is its rows of the reference's microbatch i, quantized
    at that global microbatch's scales (``sharding.mesh_scope``);
  * global-norm clip at 1.0, the warmup-cosine multiplier at step + 1
    (``warmup_cosine(0)`` is 0, which would waste the first step), AdamW
    with bf16 moments unless ``cfg.use_fp32_master``.

The step runs on the composed entries of a training policy
(``ExecPolicy.from_cfg(cfg, training=True)``): no hand-written kernel has
a backward, and the reference's train step reaches none. On the card it
sets ``device.full_precision_matmuls`` before the forward: the setting
is the process's, so the backward's f32 GEMMs (the hybrid's gates) run
in full f32 too.

On a mesh. The reference is single-controller: ``jit`` with
``NamedSharding``s lays one global state over the devices. Here each
rank holds its own block (SPMD), under any of the four tables for the
dense LM, the hybrid LM (its whole leaves read in column blocks summed
over "model" in the model's backward: models/rglru.py) and the ViT, and
a step built under an installed sharding
context (``make_train_fn``, or ``make_train_step(cfg, shape, ctx)``)
runs the model's mesh forward on this rank's rows (every fake-quant
scale the global batch's: ``sharding.mesh_scope``) and also:

  * means the gradients over the batch axes ("data", or MULTIPOD's
    ("pod", "data")): an f32 sum over their group divided by its size,
    rounded once to each leaf's dtype; an FSDP-split leaf (a dim on
    "p_embed", ``DEFAULT_RULES`` / ``MULTIPOD_RULES``) gets its block of
    that mean from its gather's backward, a reduce-scatter
    (``collectives.reduce_scatter_mean``), a whole leaf from an all-reduce
    (``_data_mean``); the loss is reported as the global batch's mean;
  * clips by the norm of the logical gradient: the sums of squares of the
    leaves split over the same mesh axes are added over those axes once,
    the whole leaves' once (``optim/adamw.py::clip_by_global_norm``).

The builders return ``(fn, specs)`` where ``specs`` are ``meta`` tensors
of this rank's local shapes and dtypes (the reference's sharded
ShapeDtypeStructs); ``fn`` installs the context around each call.
``abstract_params`` / ``abstract_state`` are the reference's
``eval_shape`` trees as ``meta`` tensors, drawn from nothing. The dry
run's ``build_cell`` comes with A15 (ROADMAP.md queue A).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import full_precision_matmuls
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import ShardingCtx, named_sharding
from repro_torch.models import api as model_api
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import ExecPolicy
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map, tree_unflatten, warmup_cosine)

__all__ = ["abstract_params", "abstract_state", "state_logical_axes",
           "placement_axes", "tree_shardings", "tree_specs",
           "batch_arg_specs", "gather_tree", "make_grad_fn",
           "make_train_fn", "make_train_step", "make_prefill_step",
           "make_serve_step"]


# --------------------------------------------------------------------------
# abstract state and shardings
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _MetaRng:
    """A stand-in for ``bridge.init_vit``'s numpy generator whose draws are
    ``meta`` tensors: the tree's shapes and dtypes, nothing drawn."""

    def standard_normal(self, shape, dtype=np.float32):
        return _meta(shape, torch.float32)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The param tree's shapes and dtypes as ``meta`` tensors (the
    reference's ``eval_shape`` of ``init_model``; the ViT's 1000 classes
    and f32)."""
    if cfg.family in ("dense", "hybrid"):
        tf_mod.check_family(cfg)
        return _lm_meta(tf_mod.lm_shapes(cfg), dtype)
    if cfg.family == "vit":
        from repro_torch import bridge
        tree = bridge.init_vit(0, cfg, 1000, rng=_MetaRng())
        return tree_map(lambda a: a if isinstance(a, torch.Tensor)
                        else _meta(a.shape, torch.float32), tree)
    raise model_api._unported(cfg)


def _lm_meta(shapes, dtype, name: str = ""):
    """``meta`` tensors of an LM shape tree in ``dtype``, a hybrid's f32
    leaves (``lambda``, ``b_a``, ``b_x``) in f32."""
    from repro_torch.models.rglru import F32_LEAVES

    if isinstance(shapes, dict):
        return {k: _lm_meta(v, dtype, k) for k, v in shapes.items()}
    return _meta(shapes, torch.float32 if name in F32_LEAVES else dtype)


def abstract_state(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The train state's shapes and dtypes (the reference's
    ``abstract_state``): AdamW's moments bf16 unless
    ``cfg.use_fp32_master``, an int32 count and step."""
    params = abstract_params(cfg, dtype)
    mdt = torch.float32 if cfg.use_fp32_master else torch.bfloat16
    mom = tree_map(lambda p: _meta(p.shape, mdt), params)
    return {"params": params,
            "opt": {"m": mom, "v": tree_map(lambda t: t, mom),
                    "count": _meta((), torch.int32)},
            "step": _meta((), torch.int32)}


def state_logical_axes(cfg: ArchConfig) -> dict:
    """The logical-axis tree of ``abstract_state`` (opt m / v mirror the
    params), the reference's."""
    pax = model_api.model_logical_axes(cfg)
    return {"params": pax, "opt": {"m": pax, "v": pax, "count": ()},
            "step": ()}


def placement_axes(cfg: ArchConfig, axes):
    """``axes`` as this rank places them under the installed context: the
    axes the model cannot split there dropped (``transformer.
    lm_placement_axes``, ``vit.vit_placement_axes``)."""
    if cfg.family in ("dense", "hybrid"):
        return tf_mod.lm_placement_axes(cfg, axes)
    if cfg.family == "vit":
        from repro_torch.models.vit import vit_placement_axes
        return vit_placement_axes(cfg, axes)
    return axes


def _axes_map(fn, axes_tree, *trees):
    """``fn`` over the leaves of ``axes_tree`` (tuples are leaves) and the
    matching leaves of ``trees``, in the first tree's structure."""
    if isinstance(axes_tree, dict):
        keys = trees[0] if trees else axes_tree
        return {k: _axes_map(fn, axes_tree[k], *(t[k] for t in trees))
                for k in keys}
    return fn(axes_tree, *trees)


def tree_shardings(axes_tree, shape_tree, ctx: ShardingCtx):
    """A ``sharding.BlockSpec`` tree from (logical axes, shaped leaves)."""
    return _axes_map(lambda ax, s: named_sharding(s.shape, ax, ctx),
                     axes_tree, shape_tree)


def tree_specs(shape_tree, sharding_tree):
    """``meta`` tensors of each leaf's local shape and dtype."""
    return tree_map(lambda s, sh: _meta(sh.local_shape(s.shape), s.dtype),
                    shape_tree, sharding_tree)


def batch_arg_specs(cfg: ArchConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """(local ``meta`` specs, ``BlockSpec``s) of one cell's batch."""
    specs, shards = {}, {}
    for k, (shp, dt, axes) in model_api.batch_specs(cfg, shape).items():
        shards[k] = named_sharding(shp, axes, ctx)
        specs[k] = _meta(shards[k].local_shape(shp), dt)
    return specs, shards


def gather_tree(tree, axes, ctx: ShardingCtx | None):
    """The whole (logical) tensors of a tree of this rank's blocks placed
    under ``axes`` (``placement_axes``): each split dim all-gathered over
    its mesh axes (a tuple rule such as ("pod", "data") over their one
    group, block index p * D + d), in rank order; an FSDP leaf's "p_embed"
    dim and a vocab block alike (state-sized: direct on the card under
    gloo, ``collectives``' Backends). Every rank of the split's groups
    must call it."""
    if ctx is None:
        return tree

    def whole(ax, t):
        for dim, rule in enumerate(ctx.spec(*ax)):
            if rule is not None and sharding._axis_size(ctx.mesh, rule) > 1:
                t = collectives.all_gather_cat(t, ctx.mesh.group(rule), dim,
                                               direct=True)
        return t
    return _axes_map(whole, axes, tree)


def _split_leaves(axes, ctx: ShardingCtx):
    """A tree of the mesh axes (of size > 1, in the mesh's order) each
    leaf placed under ``axes`` is split over; () for a whole leaf."""
    def split(ax):
        used = set()
        for r in ctx.spec(*ax):
            for a in () if r is None else (r if isinstance(r, tuple)
                                           else (r,)):
                if ctx.mesh.shape.get(a, 1) > 1:
                    used.add(a)
        return tuple(a for a in ctx.mesh.axis_names if a in used)
    return _axes_map(split, axes)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _local_grad_fn(cfg: ArchConfig):
    """``grads_of(params, batch) -> (loss, grads)`` on this rank's rows,
    microbatched as ``cfg`` says."""
    policy = ExecPolicy.from_cfg(cfg, training=True)
    k = max(cfg.microbatch_steps, 1)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        if leaves[0].is_cuda:
            # process-wide, so in force on autograd's device thread too: the
            # hybrid's f32 gate GEMMs stay f32 in the backward
            full_precision_matmuls()
        with torch.enable_grad():
            loss = model_api.loss_fn(live, batch, cfg, policy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    def grads_of(params, batch):
        if k == 1:
            return value_and_grad(params, batch)
        micro = {n: x.reshape(k, x.shape[0] // k, *x.shape[1:])
                 for n, x in batch.items()}
        acc_dt = (torch.bfloat16 if cfg.grad_accum_dtype == "bf16"
                  else torch.float32)
        dev = tree_leaves(params)[0].device
        l_sum = torch.zeros((), dtype=torch.float32, device=dev)
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                               device=p.device), params)
        for i in range(k):
            loss, g = value_and_grad(params, {n: x[i] for n, x in
                                              micro.items()})
            # in place: the accumulator is the step's own
            tree_map(lambda a, b: a.add_(b.to(acc_dt)), g_sum, g)
            del g
            l_sum = l_sum + loss
        return l_sum / k, tree_map(lambda x: x.div_(k), g_sum)

    return grads_of


# a gradient leaf from this many bytes up is meaned by gloo on the CUDA
# tensor itself (``collectives``' Backends: direct is the faster above
# tens of MB; a 512 MB f32 all-reduce over 2 ranks on one H100, 700 W,
# 0.442 s direct against 0.660 s staged, PERF.md §6)
_DIRECT_BYTES = 16 << 20


def _data_mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` meaned over the data group: an f32 sum divided by ``n``,
    rounded once to ``t.dtype``."""
    s = collectives.all_reduce(t.float(), dist.ReduceOp.SUM, group,
                               "dp_mean",
                               direct=4 * t.numel() >= _DIRECT_BYTES)
    return (s / n).to(t.dtype)


def _mesh_facts(cfg: ArchConfig):
    """(batch group, its size, split-leaf tree, {mesh axes: group}) of the
    installed context for a train step (Nones without one): the tree
    names the mesh axes each leaf is split over (``_split_leaves``), the
    dict the group of each such tuple."""
    ctx = sharding.current_ctx()
    if ctx is None:
        return None, 1, None, None
    mesh = ctx.mesh
    if mesh.world > 1 and cfg.family == "vit" and cfg.noise is not None:
        raise NotImplementedError(
            f"training {cfg.name} under calibrated device noise on a mesh "
            f"of {mesh.world} ranks: noisy training on a mesh is not ported "
            f"(ROADMAP.md queue A, item 1)")
    sharding.check_model_rules(ctx, cfg.family)
    if (tf_mod.fsdp_split(cfg) is not None
            and ctx.rules.get("p_embed") != ctx.rules.get("batch")):
        raise NotImplementedError(
            f"FSDP over {ctx.rules.get('p_embed')!r} with the batch over "
            f"{ctx.rules.get('batch')!r}: the gather's backward means the "
            f"gradient over the batch's axes, so the two must be one")
    data_g, split, groups = None, None, None
    n_data = sharding._axis_size(mesh, ctx.rules.get("batch"))
    if n_data > 1:
        data_g = mesh.group(ctx.rules["batch"])
    if mesh.world > 1:
        axes = placement_axes(cfg, model_api.model_logical_axes(cfg))
        split = _split_leaves(axes, ctx)
        groups = {k: mesh.group(k) for k in set(tree_leaves(split)) if k}
    return data_g, n_data, split, groups


def _fsdp_leaves(cfg: ArchConfig):
    """A bool tree: the leaves FSDP-split under the installed context (a
    dim on "p_embed"), whose gradient the gather's backward means; None
    where nothing is."""
    if tf_mod.fsdp_split(cfg) is None:
        return None
    axes = placement_axes(cfg, model_api.model_logical_axes(cfg))
    return _axes_map(lambda ax: "p_embed" in ax, axes)


def make_grad_fn(cfg: ArchConfig):
    """``grads_of(params, batch) -> (loss, grads)``: the train step's loss
    and gradient tree (microbatched as ``cfg`` says), before the clip.
    Built under a sharding context: this rank's blocks of the mesh's
    gradient and the global batch's loss (both meaned over the batch
    axes: an FSDP leaf's in its gather's backward, the others here)."""
    grads_of = _local_grad_fn(cfg)
    data_g, n_data, _, _ = _mesh_facts(cfg)
    if data_g is None:
        return grads_of
    fsdp = _fsdp_leaves(cfg)

    def mean(t):
        return _data_mean(t, data_g, n_data)

    def mesh_grads_of(params, batch):
        loss, g = grads_of(params, batch)
        # in place, leaf by leaf: the gradient is the step's own
        g = (tree_map(lambda t: t.copy_(mean(t)), g) if fsdp is None else
             tree_map(lambda t, f: t if f else t.copy_(mean(t)), g, fsdp))
        return mean(loss), g

    return mesh_grads_of


def make_train_fn(cfg: ArchConfig):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: a
    new state of new tensors (the argument is not written). ``batch``
    holds tensors on the params' device. Built under a sharding context it
    is that mesh's step (the module docstring): gradients and loss meaned
    over the batch axes, the norm of the logical gradient."""
    ocfg = AdamWConfig(low_mem=not cfg.use_fp32_master)
    grads_of = make_grad_fn(cfg)
    _, _, split, groups = _mesh_facts(cfg)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss, g = grads_of(params, batch)
        g, gnorm = clip_by_global_norm(g, 1.0, split, groups, donate=True)
        lr = warmup_cosine(state["step"] + 1, warmup=cfg.lr_warmup,
                           total=cfg.lr_total)
        new_params, new_opt = adamw_update(g, state["opt"], params, ocfg, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _under(ctx: ShardingCtx, fn):
    """``fn`` with ``ctx`` installed around each call."""
    def call(*args):
        with sharding._installed(ctx):
            return fn(*args)
    return call


def make_train_step(cfg: ArchConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """(train step on this rank's blocks, (state specs, batch specs))."""
    st_abs = abstract_state(cfg)
    with sharding._installed(ctx):
        st_ax = placement_axes(cfg, state_logical_axes(cfg))
        fn = make_train_fn(cfg)
    st_specs = tree_specs(st_abs, tree_shardings(st_ax, st_abs, ctx))
    b_specs, _ = batch_arg_specs(cfg, shape, ctx)
    return _under(ctx, fn), (st_specs, b_specs)


def _param_specs(cfg: ArchConfig, ctx: ShardingCtx):
    """The serving steps' param specs: this rank's blocks, or for the ViT
    the whole tree (its serving forward on a mesh reads whole weights:
    ``models/vit.py::_mesh_route``)."""
    p_abs = abstract_params(cfg)
    if cfg.family == "vit":
        return p_abs
    with sharding._installed(ctx):
        p_ax = placement_axes(cfg, model_api.model_logical_axes(cfg))
    return tree_specs(p_abs, tree_shardings(p_ax, p_abs, ctx))


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """(prefill on this rank's blocks -> this rank's rows of the logits,
    (param specs, batch specs)); the ViT's on whole weights and the whole
    batch -> the whole batch's logits (its data-split encode)."""
    policy = ExecPolicy.from_cfg(cfg, training=False)

    def prefill(params, batch):
        with torch.no_grad():
            return model_api.prefill_fn(params, batch, cfg, policy)

    if cfg.family == "vit":
        b_specs = {k: _meta(shp, dt) for k, (shp, dt, _)
                   in model_api.batch_specs(cfg, shape).items()}
    else:
        b_specs, _ = batch_arg_specs(cfg, shape, ctx)
    return _under(ctx, prefill), (_param_specs(cfg, ctx), b_specs)


def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """One-token decode against a ``shape.seq_len`` cache: (step(params,
    cache, tokens, pos) -> (logits, cache), (param specs, cache specs,
    token spec, pos spec)); the cache is this rank's batch rows, and under
    ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` its S / M rows of the
    sequence (whole over "model" under ``MODEL_RULES``); the logits are
    this rank's vocab block where the vocab splits."""
    policy = ExecPolicy.from_cfg(cfg, training=False)
    with sharding._installed(ctx):
        shapes, axes = model_api.cache_axes_spec(cfg, shape.global_batch,
                                                 shape.seq_len)
    c_specs = {k: _meta(named_sharding(shp, axes[k], ctx).local_shape(shp),
                        dt) for k, (shp, dt) in shapes.items()}
    tshape = (shape.global_batch, 1)
    t_spec = _meta(named_sharding(tshape, model_api.BATCH_AXES[
        "decode_tokens"], ctx).local_shape(tshape), torch.int32)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model_api.decode_fn(params, cache, tokens, pos, cfg,
                                       policy)

    return _under(ctx, serve_step), (_param_specs(cfg, ctx), c_specs, t_spec,
                                     _meta((), torch.int32))
