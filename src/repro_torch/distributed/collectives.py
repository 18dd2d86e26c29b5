"""Exact collectives for the model-sharded serving path (the reference's
src/repro/distributed/collectives.py), on ``torch.distributed``.

``replicated_absmax_scale``
    Per-launch activation absmax scale (or a row-split weight's
    per-output-channel one) with a *global* scope: the local absmax is
    all-reduced with MAX over the given process group before the
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

``copy_to_model`` / ``reduce_from_model``
    The tensor-parallel LM layers' two autograd-aware collectives over the
    "model" group. ``copy_to_model`` goes before a column-parallel
    projection (wq, w_gate, w_up; and on the K / V every rank computes
    whole but reads in part): identity forward, the gradient all-reduced
    backward, since each rank's block of the product sees only part of
    it. ``reduce_from_model`` goes after a row-parallel one (wo,
    w_down): the partial products all-reduced forward, identity backward.
    Both reduce in f32 and round once to the operand's dtype, as the
    unsharded bf16 GEMM rounds its f32 accumulate once: a tensor-parallel
    layer differs from the unsharded one by the order of its f32 sums only.

``gather_from_model``
    The merged head outputs of a tensor-parallel attention all-gathered
    over "model" before a replicated projection (the ViT's wo): every
    rank then computes the same downstream, so the backward is this
    rank's slice of the gradient, no sum (summing would multiply it by
    the group's size).

``fsdp_gather`` / ``reduce_scatter_mean``
    The FSDP collectives (``DEFAULT_RULES`` / ``MULTIPOD_RULES``: the
    params' "p_embed" dim split over the batch axes), direct on the card
    under gloo (Backends). ``fsdp_gather``
    all-gathers a param's blocks where a layer uses it; its backward is
    ``reduce_scatter_mean``: the gradient summed over the group in f32,
    this rank's block kept, divided by the group's size and rounded once
    to the param's dtype. That is the train step's data-parallel mean
    (the FSDP group is the batch's), done once, as ``launch/steps.py``'s
    ``_data_mean`` rounds the whole leaves' once. Gloo has no
    reduce-scatter in every PyTorch release, so the sum is an all-reduce
    of which each rank keeps its block: the same f32 sum.

``vocab_max`` / ``vocab_sum``
    The vocab-parallel loss's reduces over "model": the max of the f32
    logits (no gradient: the logsumexp's shift), and the f32 sums of the
    exps and of the gold logit, identity backward (each rank's block gets
    the gradient of the replicated sum), as ``reduce_from_model``.

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
each, interleaved). The FSDP ops move a layer's weights (tens of MB),
where it is the other way round: ``direct=True`` hands gloo the CUDA
tensor (``scripts/fsdp_collectives_ab.py``, 4 ranks on one H100, 700 W,
2 readings a way a rank: a 23.4 MB all-gather over 2 ranks 61.2-66.0 ms
direct against 100.0-119.4 ms staged, a 93.6 MB f32 all-reduce
153.3-175.8 against 186.3-295.1 ms).

Timing. ``STATS`` counts calls and host seconds per op, ``BYTES`` the
bytes of this rank's operand per op (what it puts into the collective).
A staged op
synchronizes the card before the clock starts (its copy to the host
would wait for the card's pending work anyway), so the seconds are the
op's own, copies included; a direct gloo op on the card is timed to the
end of its copy back; an NCCL op's seconds are its enqueue only.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from repro_torch.core import quant
from repro_torch.distributed import sharding

__all__ = ["STATS", "BYTES", "replicated_absmax_scale", "exact_int_psum",
           "all_gather_cat", "all_reduce", "scoped_absmax_scale",
           "scoped_amax", "copy_to_model", "reduce_from_model",
           "gather_from_model", "fsdp_gather", "reduce_scatter_mean", "vocab_max", "vocab_sum"]

# op name -> calls, and op name + "_s" -> host seconds, since the last
# STATS.clear()
STATS: collections.Counter = collections.Counter()
# op name -> bytes of this rank's operands, since the last BYTES.clear()
BYTES: collections.Counter = collections.Counter()


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    """Whether an op on ``t`` over ``group`` is gloo's on a CUDA tensor,
    after synchronizing the card (see Timing)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.synchronize(t.device)
        return True
    return False


def _done(t: torch.Tensor, direct_gloo: bool) -> None:
    """A direct gloo op ends with copies on the card: time it to there."""
    if direct_gloo:
        torch.cuda.synchronize(t.device)


def all_reduce(t: torch.Tensor, op, group, name: str = "all_reduce",
               direct: bool = False) -> torch.Tensor:
    """A new tensor: ``t`` all-reduced with ``op`` over ``group``
    (``direct``: see Backends)."""
    if dist.get_world_size(group) == 1:
        return t
    gloo_cuda = _gloo_cuda(t, group)
    staged = gloo_cuda and not direct
    t0 = time.perf_counter()
    out = t.detach().cpu() if staged else t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    out = out.to(t.device)
    _done(out, gloo_cuda and direct)
    STATS[name] += 1
    STATS[name + "_s"] += time.perf_counter() - t0
    BYTES[name] += t.numel() * t.element_size()
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int,
                   name: str = "all_gather",
                   direct: bool = False) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (``direct``: see Backends)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    gloo_cuda = _gloo_cuda(x, group)
    staged = gloo_cuda and not direct
    t0 = time.perf_counter()
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    _done(out, gloo_cuda and direct)
    STATS[name] += 1
    STATS[name + "_s"] += time.perf_counter() - t0
    BYTES[name] += x.numel() * x.element_size()
    return out


def replicated_absmax_scale(x: torch.Tensor, bits: int, group,
                            eps: float = 1e-8, axis=None) -> torch.Tensor:
    """The scale ``quant.absmax_scale(x_whole, bits, axis)`` of the tensor
    split over ``group`` along the dims ``axis`` reduces (None: all of
    them, per tensor; -2: a weight's per-output-channel scale over rows
    split over the group), on every rank: max(|x|) locally, MAX over the
    group outside autograd, then max(., eps) and the multiply by
    f32(1/qmax) (never a divide). For an activation pass the group of
    every mesh axis the launch's rows are split over, "model" included."""
    a = x.detach().abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
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


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.float(), dist.ReduceOp.SUM, ctx.group,
                          "tp_grad_sum").to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype, name):
        ctx.in_dtype = x.dtype
        return all_reduce(x.float(), dist.ReduceOp.SUM, group,
                          name).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim, "tp_gather")

    @staticmethod
    def backward(ctx, g):
        step = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return (g.narrow(ctx.dim, dist.get_rank(ctx.group) * step, step),
                None, None)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim, "fsdp_gather", direct=True)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_mean(g, ctx.group, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over ``group`` in
    f32 and rounded once to its dtype."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(partial: torch.Tensor, group,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """The partial products of a row-parallel projection summed over
    ``group`` in f32 and rounded once to ``dtype`` (default: the
    partial's); identity backward."""
    return _ReduceFromModel.apply(partial, group, dtype or partial.dtype,
                                  "tp_sum")


def gather_from_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` over ``group``, in
    group-rank order; backward, this rank's slice of the gradient."""
    return _GatherFromModel.apply(x, group, dim % x.ndim)


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A param's blocks along ``dim`` all-gathered over ``group`` (the FSDP
    axes) in group-rank order; backward, ``reduce_scatter_mean``."""
    if dist.get_world_size(group) == 1:
        return x
    return _FsdpGather.apply(x, group, dim)


def reduce_scatter_mean(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``g`` summed over ``group`` in
    f32, divided by the group's size and rounded once to ``g.dtype``."""
    n = dist.get_world_size(group)
    s = all_reduce(g.float(), dist.ReduceOp.SUM, group, "fsdp_grad_sum",
                   direct=True)
    step = g.shape[dim] // n
    return (s.narrow(dim, dist.get_rank(group) * step, step) / n).to(g.dtype)


def vocab_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` MAX-reduced over ``group`` (no gradient)."""
    return all_reduce(x.detach(), dist.ReduceOp.MAX, group, "vocab_max")


def vocab_sum(x: torch.Tensor, group) -> torch.Tensor:
    """An f32 ``x`` SUM-reduced over ``group``; identity backward."""
    return _ReduceFromModel.apply(x, group, x.dtype, "vocab_sum")
