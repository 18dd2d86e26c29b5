"""Exact collectives for the model-sharded serving path (the reference's
src/repro/distributed/collectives.py), on ``torch.distributed``.

``replicated_absmax_scale``
    Per-launch activation absmax scale with a *global* scope: the local
    absmax is all-reduced with MAX over the given process group before the
    epsilon clamp and the reciprocal multiply. max is exact and the ops
    after it are ``core.quant.absmax_scale``'s, in its order, so every rank
    computes the f32 scale of the unsharded launch and quantizes to the
    same codes.

``exact_int_psum``
    Integer SUM all-reduce of partial accumulates (the FFN's d_ff
    contraction). Integer addition is exact in int32 (ranks x d_ff x 127 x
    127 stays far below 2^31 for every config here), so the reduced
    accumulate equals the unsharded contraction.

``all_gather_cat``
    All-gather over a group, concatenated in group-rank order (exact data
    movement).

``scoped_absmax_scale`` / ``scoped_amax``
    What the kernels' wrappers call for a per-launch absmax: the scope the
    installed sharding context names (``sharding.absmax_scope``, set where
    a launch's rows are split over ranks: the 1-D data mesh's encode),
    else this rank's own tensor, with no collective and the ops of
    ``core.quant.absmax_scale``.

Backends. NCCL (a card per rank) takes the CUDA tensors as they are.
Under gloo (ranks sharing a card, or on the CPU) an op on a CUDA tensor
is staged by hand: the operand is copied to host memory, the op runs on
the CPU tensor and the result is copied back to the card. Gloo would
take the CUDA tensors itself, but on the sharded serving path that ran
slower: in one call on an H100 (700 W), ``scripts/collectives_ab.py``
served opto-vit-large over 2 ranks on the one card at 8.46-8.52
frames/s with 320-327 ms of collectives a flush staged, against
5.85-6.16 frames/s and 503-530 ms with gloo on the CUDA tensors (2 runs
each, interleaved).

Timing. ``STATS`` counts calls and host seconds per op. A staged op
synchronizes the card before the clock starts (its copy to the host
would wait for the card's pending work anyway), so the seconds are the
op's own, copies included; an NCCL op's seconds are its enqueue only.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from repro_torch.core import quant
from repro_torch.distributed import sharding

__all__ = ["STATS", "replicated_absmax_scale", "exact_int_psum",
           "all_gather_cat", "all_reduce", "scoped_absmax_scale",
           "scoped_amax"]

# op name -> calls, and op name + "_s" -> host seconds, since the last
# STATS.clear()
STATS: collections.Counter = collections.Counter()


def _staged(t: torch.Tensor, group) -> bool:
    """Whether an op on ``t`` over ``group`` goes through host memory (a
    CUDA tensor under gloo), after synchronizing the card (see Timing)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.synchronize(t.device)
        return True
    return False


def all_reduce(t: torch.Tensor, op, group, name: str = "all_reduce"
               ) -> torch.Tensor:
    """A new tensor: ``t`` all-reduced with ``op`` over ``group``."""
    if dist.get_world_size(group) == 1:
        return t
    staged = _staged(t, group)
    t0 = time.perf_counter()
    out = t.detach().cpu() if staged else t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    out = out.to(t.device)
    STATS[name] += 1
    STATS[name + "_s"] += time.perf_counter() - t0
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    staged = _staged(x, group)
    t0 = time.perf_counter()
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    STATS["all_gather"] += 1
    STATS["all_gather_s"] += time.perf_counter() - t0
    return out


def replicated_absmax_scale(x: torch.Tensor, bits: int, group,
                            eps: float = 1e-8) -> torch.Tensor:
    """The scale ``quant.absmax_scale(x_whole, bits)`` of the tensor whose
    rows are split over ``group``, on every rank: max(|x|) locally, MAX
    over the group, then max(., eps) and the multiply by f32(1/qmax) (never
    a divide). Pass the group of every mesh axis the launch's rows are
    split over, "model" included."""
    amax = x.abs().amax()
    amax = all_reduce(amax, dist.ReduceOp.MAX, group, "absmax_max")
    return torch.clamp_min(amax, eps).float() * quant.inv_qmax(bits)


def scoped_absmax_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The per-launch activation absmax scale of ``x`` at ``bits``: over
    the rows of every rank of the current absmax scope's group
    (``replicated_absmax_scale``), or ``quant.absmax_scale(x, bits)``
    outside a scope."""
    group = sharding.absmax_group()
    if group is None:
        return quant.absmax_scale(x, bits=bits)
    return replicated_absmax_scale(x, bits, group)


def scoped_amax(amax: torch.Tensor) -> torch.Tensor:
    """A device scalar of |values| maxima (B3's hidden absmax) MAX-reduced
    over the current absmax scope's group, in place; untouched outside a
    scope. Returns ``amax``."""
    group = sharding.absmax_group()
    if group is not None:
        amax.copy_(all_reduce(amax, dist.ReduceOp.MAX, group, "absmax_max"))
    return amax


def exact_int_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Lossless integer SUM of partial accumulates over ``group``. A float
    input is a caller bug: float partial sums do not reduce exactly."""
    if torch.is_floating_point(x) or torch.is_complex(x):
        raise TypeError(f"exact_int_psum needs an integer dtype (got "
                        f"{x.dtype}): float partial sums do not reduce "
                        f"bitwise-exactly")
    return all_reduce(x, dist.ReduceOp.SUM, group, "int_psum")
