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
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

__all__ = ["ShardingCtx", "use_sharding", "current_ctx", "absmax_scope",
           "absmax_group", "logical_spec", "local_shard", "DATA_RULES",
           "MODEL_RULES", "rules_for_mesh", "validate_rules"]

# Pure data parallelism over a 1-D ("data",) mesh: only the batch axis
# shards, every other logical axis replicates. This is the serving
# server's mesh with model = 1 (launch.mesh.make_serving_mesh): each rank
# encodes its rows of a flush (models/vit.py::encode_tokens), params stay
# replicated (inference over one small prepared weight set).
DATA_RULES: dict[str, str | None] = {"batch": "data"}

# Model-sharded serving over a 2-D ("data", "model") mesh
# (launch.mesh.make_serving_mesh(model=M)): the encode batch axis still
# data-parallelizes, while attention heads and the FFN hidden dim split
# over "model" — wq/wk/wv/w1 column-shard and w2 row-shards (their output
# columns / input rows are the head / d_ff axis via the vit logical
# axes; wo stays whole — models/sharded_encoder.py all-gathers the merged
# head outputs instead, because wo's dequant runs inside the photonic
# matmul kernel). "p_embed" is deliberately unmapped: inference weights
# replicate on their embed dims (no FSDP — the prepared int8 cache is
# small), and the kernels' per-launch activation absmax scopes stay
# global via collectives.replicated_absmax_scale. The reference's other
# tables (single- and multi-pod training) come with the meshes that read
# them (ROADMAP.md A14, LM half).
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
    """Explicit mesh-shape -> rules selection (no silent fallback):

      * ``None`` mesh            -> ``None`` (annotations disabled)
      * 1-D ("data",)            -> DATA_RULES  (batch-only DP serving)
      * 2-D ("data", "model")    -> MODEL_RULES (model-sharded serving)

    The chosen table is validated against the mesh: every size > 1 mesh
    axis must be used by some rule, else ValueError. The reference's
    "pod" and default training tables wait for the meshes that read them
    (ROADMAP.md A14, LM half): any other axes raise here."""
    if mesh is None:
        return None
    axes = tuple(mesh.axis_names)
    if axes == ("data",):
        rules = DATA_RULES
    elif axes == ("data", "model"):
        rules = MODEL_RULES
    else:
        raise ValueError(f"no sharding rules for mesh axes {axes!r}: the "
                         f"port serves on ('data',) and ('data', 'model')")
    validate_rules(mesh, rules)
    return rules


@dataclass
class ShardingCtx:
    mesh: object          # launch.mesh.ServingMesh (axis_names, shape)
    rules: Mapping[str, str | None]
    # the process group a launch's rows are split over, inside a split
    # region (absmax_scope): every per-launch absmax reduces over it
    absmax_group: object = None

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


def absmax_scope(group):
    """Inside the installed context, a region whose launches hold rows
    split over ``group``: every per-launch activation absmax (and B3's
    hidden absmax) is MAX-reduced over it. Raises without a context."""
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("absmax_scope needs an installed sharding context")
    return _installed(dataclasses.replace(ctx, absmax_group=group))


def absmax_group():
    """The process group of the current absmax scope, or None (every scope
    is this rank's own tensor)."""
    ctx = current_ctx()
    return None if ctx is None else ctx.absmax_group


def _axis_size(mesh, rule) -> int:
    return 1 if rule is None else mesh.shape[rule]


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
        x = x.narrow(dim, mesh.coord(rule) * step, step)
    return x
