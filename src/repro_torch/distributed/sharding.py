"""Sharding context + logical-axis rules (the reference's
src/repro/distributed/sharding.py), for SPMD ranks.

Model code names the *logical* axes of parameters and activations
("batch", "heads", "mlp", "p_heads", ...). A rules table maps each logical
axis to a mesh axis (or None = replicate). The serving layer installs a
``ShardingCtx`` (mesh + rules) with ``use_sharding``; with no context
installed everything runs unsharded.

The reference is single-controller: a ``PartitionSpec`` tells XLA how to
lay one global array over devices. Here every rank holds only its own
block, so a spec is a tuple of mesh-axis names (or None) that
``local_shard`` uses to cut this rank's block out of a replicated tensor
(the counterpart of ``jax.device_put`` with a ``NamedSharding``). The
reference's ``shard`` (a layout constraint on a global array) has no
counterpart: each rank already holds only its local tensor.

The reference's GSPMD takes every per-launch activation absmax over the
whole global array. When a launch's rows are split over ranks, the
context carries the process group of that split (``absmax_group``, set
by ``absmax_scope`` around the split region), and the kernels' wrappers
reduce each absmax over it (``collectives.scoped_absmax_scale``), so each
rank quantizes with the scale of the whole launch. Without a group every
scope is the rank's own tensor, as unsharded.

A composed forward on a mesh (the models' training forwards) runs inside
``mesh_scope``: the absmax scope of the whole mesh, so every activation
absmax is the global batch's and a row-parallel contraction's whole
row's. ``bound`` carries the installed context into a remat's recompute,
which runs on autograd's thread, where the thread-local context is
absent.

The four tables are the reference's and ``rules_for_mesh`` picks among
them as the reference does. The dense LM, the hybrid LM and the ViT run
under all four: under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` their
params are FSDP-split over "p_embed"'s axes ("data", or ("pod",
"data")) and gathered a layer at a time; an LM's embedding and head
split on the vocab over "model", and its decode cache (the hybrid's
attention ring too) on "kv_seq" over "model" (models/transformer.py).
No model has an experts axis yet: ``check_model_rules`` raises for that
(A15). ``split_of`` is what the sharded layers ask:
this rank's block of a logical dim, or None where the dim stays whole (no
context, no rule, a size-1 axis, or a dim the axes do not divide); a rule
that names a tuple of mesh axes is one axis, its first the slowest.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

__all__ = ["ShardingCtx", "use_sharding", "current_ctx", "absmax_scope",
           "absmax_group", "draw_offset", "mesh_scope", "bound",
           "logical_spec", "local_shard", "named_sharding", "param_spec",
           "BlockSpec", "Split", "split_of", "axis_size",
           "check_model_rules", "DEFAULT_RULES", "MULTIPOD_RULES",
           "DATA_RULES", "MODEL_RULES", "rules_for_mesh", "validate_rules"]

# Default logical->mesh axis rules, single-pod (data, model) mesh.
# FSDP: parameter "embed"/"mlp_in" dims shard over data; TP dims over model.
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    # activations
    "batch": "data",
    "seq": None,
    "kv_seq": "model",        # decode-time KV cache seq sharding (flash-decode)
    "embed": None,
    "heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    # parameters (FSDP axis = data; TP axis = model)
    "p_embed": "data",
    "p_heads": "model",
    "p_mlp": "model",
    "p_vocab": "model",
    "p_experts": "model",
    "p_layers": None,
    "p_state": None,
}

# Multi-pod: pod joins data-parallel batch + FSDP axes.
MULTIPOD_RULES = dict(DEFAULT_RULES)
MULTIPOD_RULES.update({
    "batch": ("pod", "data"),
    "p_embed": ("pod", "data"),
})

# the families whose layers run under every table (none has an experts
# axis, and the ViT carries no vocab or KV cache); any other family runs
# without the experts split, which comes with the moe family
_EVERY_TABLE = ("dense", "hybrid", "vit")
_EXPERTS = ("experts", "p_experts")

# Pure data parallelism over a 1-D ("data",) mesh: only the batch axis
# shards, every other logical axis replicates. This is the serving
# server's mesh with model = 1 (launch.mesh.make_serving_mesh): each rank
# encodes its rows of a flush (models/vit.py::encode_tokens), params stay
# replicated (inference over one small prepared weight set).
DATA_RULES: dict[str, str | None] = {"batch": "data"}

# Model-sharded serving over a 2-D ("data", "model") mesh
# (launch.mesh.make_serving_mesh(model=M), make_host_mesh): the batch axis
# data-parallelizes; for the ViT encode the
# data-parallelizes, while attention heads and the FFN hidden dim split
# over "model" — wq/wk/wv/w1 column-shard and w2 row-shards (their output
# columns / input rows are the head / d_ff axis via the vit logical
# axes; wo stays whole — models/sharded_encoder.py all-gathers the merged
# head outputs instead, because wo's dequant runs inside the photonic
# matmul kernel). "p_embed" is deliberately unmapped: inference weights
# replicate on their embed dims (no FSDP — the prepared int8 cache is
# small), and the kernels' per-launch activation absmax scopes stay
# global via collectives.replicated_absmax_scale. For the LM (models/
# transformer.py) the query heads (wq's columns, bq, wo's rows) and the
# SwiGLU hidden dim (w_gate / w_up columns, w_down rows) split over
# "model"; wk / wv, the tied embedding, the norms and the KV cache stay
# whole on every rank.
MODEL_RULES: dict[str, str | None] = {
    "batch": "data",
    "heads": "model",
    "mlp": "model",
    "p_heads": "model",
    "p_mlp": "model",
}


def validate_rules(mesh, rules: Mapping) -> None:
    """Raise when a mesh axis of size > 1 appears in no rule value — that
    axis would silently replicate everything, which is exactly the bug
    that made 2-D meshes fall back to batch-only sharding. Size-1 axes
    are exempt (replication over one device is a no-op by construction).
    """
    used: set[str] = set()
    for rule in rules.values():
        if rule is None:
            continue
        used.update(rule if isinstance(rule, tuple) else (rule,))
    unmapped = [ax for ax in mesh.axis_names
                if mesh.shape[ax] > 1 and ax not in used]
    if unmapped:
        raise ValueError(
            f"mesh axes {unmapped} (size > 1) are not mapped by any "
            f"sharding rule — everything would silently replicate over "
            f"them. Pass rules that use them (e.g. MODEL_RULES for a "
            f"('data','model') serving mesh) or shrink the mesh.")


def rules_for_mesh(mesh) -> Mapping | None:
    """Explicit mesh-shape -> rules selection (no silent fallback), the
    reference's:

      * ``None`` mesh            -> ``None`` (annotations disabled)
      * any mesh with a "pod"    -> MULTIPOD_RULES
      * 1-D ("data",)            -> DATA_RULES  (batch-only DP serving)
      * 2-D ("data", "model")    -> MODEL_RULES (model-sharded serving,
                                    tensor-parallel LM)
      * anything else            -> DEFAULT_RULES

    The chosen table is validated against the mesh: every size > 1 mesh
    axis must be used by some rule, else ValueError. A model runs under a
    table where ``check_model_rules`` passes for its family."""
    if mesh is None:
        return None
    axes = tuple(mesh.axis_names)
    if "pod" in axes:
        rules = MULTIPOD_RULES
    elif axes == ("data",):
        rules = DATA_RULES
    elif axes == ("data", "model"):
        rules = MODEL_RULES
    else:
        rules = DEFAULT_RULES
    validate_rules(mesh, rules)
    return rules


@dataclass
class ShardingCtx:
    mesh: object          # launch.mesh.ServingMesh (axis_names, shape)
    rules: Mapping[str, str | None]
    # the process group a launch's rows are split over, inside a split
    # region (absmax_scope): every per-launch absmax reduces over it
    absmax_group: object = None
    # this rank's block of those rows (its index in the group's rank
    # order): a noisy draw over a launch's rows starts at block x numel
    row_block: int = 0

    def spec(self, *logical_axes: str | None) -> tuple:
        """Mesh axes (or None) of each logical axis."""
        return tuple(None if ax is None else self.rules.get(ax)
                     for ax in logical_axes)


_local = threading.local()


def current_ctx() -> ShardingCtx | None:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def _installed(ctx: ShardingCtx | None):
    prev = current_ctx()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def use_sharding(mesh, rules: Mapping | None = None):
    """Install the sharding context of ``mesh`` (None mesh = disable all
    annotations) under ``rules``, by default the table ``rules_for_mesh``
    picks; given rules are validated against the mesh."""
    if mesh is None:
        return _installed(None)
    if rules is None:
        rules = rules_for_mesh(mesh)
    else:
        validate_rules(mesh, rules)
    return _installed(ShardingCtx(mesh, rules))


def absmax_scope(group, block: int = 0):
    """Inside the installed context, a region whose launches hold rows
    split over ``group``: every per-launch activation absmax (and B3's
    hidden absmax) is MAX-reduced over it. ``block`` is this rank's block
    of the rows when every launch's rows are split evenly in the group's
    rank order (the data-split encode): a noisy draw over a launch's
    output then starts at ``block`` times its local numel
    (``draw_offset``). Raises without a context."""
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("absmax_scope needs an installed sharding context")
    return _installed(dataclasses.replace(ctx, absmax_group=group,
                                          row_block=int(block)))


def absmax_group():
    """The process group of the current absmax scope, or None (every scope
    is this rank's own tensor)."""
    ctx = current_ctx()
    return None if ctx is None else ctx.absmax_group


def draw_offset(numel: int) -> int:
    """Where this rank's block of a launch's output of ``numel`` local
    elements starts in the flat index of the whole launch's output: the
    absmax scope's ``row_block`` x ``numel`` (0 outside a split)."""
    ctx = current_ctx()
    return 0 if ctx is None else ctx.row_block * int(numel)


def mesh_scope():
    """The absmax scope of the whole installed mesh (every per-launch
    absmax MAX-reduced over every rank: the rows split over the batch
    axes, a row-parallel contraction over "model", and MAX of equal
    values where a tensor is whole over an axis), inside a context of
    more than one rank and no scope yet; else a no-op."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh.world == 1 or ctx.absmax_group is not None:
        return contextlib.nullcontext()
    return absmax_scope(ctx.mesh.group(tuple(ctx.mesh.axis_names)))


def bound(fn):
    """``fn`` with the context installed now (its absmax scope included)
    installed around each call: a remat's recompute (``torch.utils.
    checkpoint``) calls it from autograd's thread, where the thread-local
    context is absent, and must quantize and gather as the forward did."""
    ctx = current_ctx()

    def call(*args, **kwargs):
        with _installed(ctx):
            return fn(*args, **kwargs)
    return call


def _axis_size(mesh, rule) -> int:
    """Ranks along a rule's mesh axes (an axis the mesh lacks counts 1)."""
    if rule is None:
        return 1
    n = 1
    for r in (rule if isinstance(rule, tuple) else (rule,)):
        n *= mesh.shape.get(r, 1)
    return n


def _axis_coord(mesh, rule) -> int:
    """This rank's block index along ``rule``: a tuple of mesh axes is one
    axis, its first the slowest (the reference's PartitionSpec order)."""
    if not isinstance(rule, tuple):
        return mesh.coord(rule)
    i = 0
    for r in rule:
        i = i * mesh.shape[r] + mesh.coord(r)
    return i


def logical_spec(shape: Sequence[int], logical_axes: Sequence[str | None],
                 ctx: ShardingCtx) -> tuple:
    """Mesh axes of each dim of a tensor of ``shape`` under the ctx rules.
    A dim whose mesh axes do not divide it evenly replicates (the
    reference's ``_axis_size`` divisibility rule)."""
    parts = []
    for dim, ax in zip(shape, logical_axes):
        rule = None if ax is None else ctx.rules.get(ax)
        if rule is not None and dim % _axis_size(ctx.mesh, rule) != 0:
            rule = None
        parts.append(rule)
    return tuple(parts)


def local_shard(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of a replicated tensor under ``spec`` (one mesh
    rule or None per dim, as ``logical_spec`` gives): a view, no copy."""
    for dim, rule in enumerate(spec):
        if rule is None:
            continue
        n = _axis_size(mesh, rule)
        step = x.shape[dim] // n
        x = x.narrow(dim, _axis_coord(mesh, rule) * step, step)
    return x


@dataclass(frozen=True)
class BlockSpec:
    """This rank's block of a global tensor: the port's counterpart of the
    reference's ``NamedSharding`` (a mesh and one mesh rule or None a
    dim). Each rank holds its block only."""

    mesh: object
    spec: tuple

    def local_shape(self, shape: Sequence[int]) -> tuple:
        return tuple(d // _axis_size(self.mesh, r)
                     for d, r in zip(shape, self.spec))

    def block(self, x: torch.Tensor) -> torch.Tensor:
        return local_shard(x, self.spec, self.mesh)


def named_sharding(shape: Sequence[int], logical_axes: Sequence[str | None],
                   ctx: ShardingCtx) -> BlockSpec:
    """The ``BlockSpec`` of a tensor of ``shape`` with ``logical_axes``
    under the ctx rules (``logical_spec``'s divisibility fallback)."""
    return BlockSpec(ctx.mesh, logical_spec(shape, logical_axes, ctx))


def param_spec(path: str, shape: tuple[int, ...], ctx: ShardingCtx):
    """The reference's heuristic, which it never implemented either."""
    raise NotImplementedError("use configs.param_logical_axes instead")


@dataclass(frozen=True)
class Split:
    """This rank's block of a logical dim split over a mesh axis (or a
    tuple of them, one axis with its first the slowest)."""

    n: int            # ranks along the axes
    index: int        # this rank's block
    group: object     # the axes' process group

    def block(self, size: int) -> tuple[int, int]:
        """[start, stop) of this rank's block of a dim of ``size``."""
        step = size // self.n
        return self.index * step, (self.index + 1) * step


def split_of(logical_axis: str, size: int) -> Split | None:
    """How the installed context splits a logical dim of ``size`` units (a
    param axis such as "p_heads" with ``size`` the head count): None where
    it stays whole on every rank (no context, no rule, a size-1 mesh
    axis, or an axis that does not divide ``size``, the reference's
    ``shard`` fallback). A tuple rule (MULTIPOD's ("pod", "data")) is one
    axis of their product's ranks, block index p * D + d, group the
    ranks that agree on every other mesh axis."""
    ctx = current_ctx()
    if ctx is None:
        return None
    rule = ctx.rules.get(logical_axis)
    if rule is None:
        return None
    n = _axis_size(ctx.mesh, rule)
    if n == 1 or size % n:
        return None
    return Split(n, _axis_coord(ctx.mesh, rule), ctx.mesh.group(rule))


def axis_size(logical_axis: str) -> int:
    """Ranks the installed context splits a logical axis over (1 without a
    context or a rule)."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    return _axis_size(ctx.mesh, ctx.rules.get(logical_axis))


def check_model_rules(ctx: ShardingCtx | None = None,
                      family: str = "dense") -> None:
    """Raise unless the ``family``'s layers of this port run under the ctx
    (by default the installed one). The dense LM, the hybrid LM and the
    ViT run under every table; any other family no experts split."""
    ctx = current_ctx() if ctx is None else ctx
    if ctx is None or family in _EVERY_TABLE:
        return
    live = [ax for ax in _EXPERTS
            if _axis_size(ctx.mesh, ctx.rules.get(ax)) > 1]
    if live:
        raise NotImplementedError(
            f"the {family} model with logical axes {live} split over the "
            f"mesh {dict(ctx.mesh.shape)}: the experts split comes with the "
            f"moe family (ROADMAP.md queue A15)")
