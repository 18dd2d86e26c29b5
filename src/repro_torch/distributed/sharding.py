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
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

__all__ = ["ShardingCtx", "use_sharding", "current_ctx", "logical_spec",
           "local_shard", "MODEL_RULES"]

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
# global via collectives.replicated_absmax_scale. This is the only mesh
# the port builds; the reference's other tables (single- and multi-pod
# training, the 1-D data mesh) come with the meshes that read them
# (ROADMAP.md A14).
MODEL_RULES: dict[str, str | None] = {
    "batch": "data",
    "heads": "model",
    "mlp": "model",
    "p_heads": "model",
    "p_mlp": "model",
}


@dataclass
class ShardingCtx:
    mesh: object          # launch.mesh.ServingMesh (axis_names, shape)
    rules: Mapping[str, str | None]

    def spec(self, *logical_axes: str | None) -> tuple:
        """Mesh axes (or None) of each logical axis."""
        return tuple(None if ax is None else self.rules.get(ax)
                     for ax in logical_axes)


_local = threading.local()


def current_ctx() -> ShardingCtx | None:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh):
    """Install the sharding context of ``mesh`` under MODEL_RULES (None
    mesh = disable all annotations)."""
    prev = current_ctx()
    _local.ctx = None if mesh is None else ShardingCtx(mesh, MODEL_RULES)
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


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
