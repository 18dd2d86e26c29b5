"""Shared building blocks (the reference's src/repro/models/layers.py,
serving subset). ``linear``/``ExecPolicy``/``QuantizedWeight`` live in
core/backend.py and are re-exported here for the model layers.
``row_parallel_linear`` is the tensor-parallel row-split projection (the
LM's wo and w_down, the ViT's w2) under a "model" split; ``embedding_lookup`` takes a vocab
split of the table and ``fsdp_layer`` gathers a layer's FSDP-split
params where the layer is used (``DEFAULT_RULES`` / ``MULTIPOD_RULES``).

Every cast sits where the reference has it: the norms compute in f32 and
cast back to ``x.dtype`` before the gain; RoPE tables are f32 and the
rotation is done in f32 and cast back once.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy, QuantizedWeight, linear

__all__ = ["layernorm", "rmsnorm", "rope", "apply_rope", "embedding_lookup",
           "causal_conv1d", "layer_view", "fsdp_layer", "linear", "row_parallel_linear",
           "ExecPolicy", "QuantizedWeight"]


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """f32 normalization core, cast back to x.dtype, then ``* g + b``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 RMS normalization, cast back to x.dtype, then ``* g``."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def rope(positions: torch.Tensor, head_dim: int, theta: float = 500000.0):
    """Rotary tables. positions (..., seq) -> cos, sin of shape
    (..., seq, head_dim / 2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim); cos/sin (..., seq, head_dim / 2)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]          # broadcast over heads
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     split=None) -> torch.Tensor:
    """Gather rows of ``table`` (V, d) at ``ids`` (...) -> (..., d).

    ``split`` (a ``sharding.Split`` of the vocab over "model") says the
    table is this rank's block of rows [v0, v0 + V / n): an id outside it
    gives a zero row, and the rows are summed over the split's group.
    Exactly one rank contributes each row, so the f32 sum rounded to the
    table's dtype is exact; its backward is the identity (every rank of
    the group holds the same gradient of the whole rows)."""
    if split is None:
        return table[ids]
    from repro_torch.distributed import collectives

    n = table.shape[0]
    local = ids - split.index * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    part = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return collectives.reduce_from_model(part, split.group)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv (the Griffin / Mamba short conv). x (B, S, C);
    w (K, C); ``state`` (B, K - 1, C), the last K - 1 inputs of the
    sequence so far, or None for zeros. Returns (y (B, S, C) in x.dtype,
    the new state: the last K - 1 rows of [state, x]), so a decode step
    (S = 1) rolls the state. The reference's op order: K products of x's
    dtype summed left to right from the zero pad, each rounded to that
    dtype, so eager runs agree bitwise."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)                    # (B, S + K - 1, C)
    s = x.shape[-2]
    y = sum(xp[..., i:i + s, :] * w[i] for i in range(k))
    return y.to(x.dtype), xp[..., -(k - 1):, :]


def layer_view(blocks, i: int):
    """Layer ``i`` of a stacked ``blocks`` subtree (leaves with a leading L
    axis, as the reference's scan stacks them): views, no copies."""
    if isinstance(blocks, dict):
        return {k: layer_view(v, i) for k, v in blocks.items()}
    if isinstance(blocks, QuantizedWeight):
        return blocks.layer(i)
    return blocks[i]


def fsdp_layer(p, axes, split, d_model: int):
    """A layer's params with every FSDP-split dim gathered: ``p`` a dict of
    this rank's blocks (tensors or ``QuantizedWeight``s), ``axes`` their
    logical axes (without "p_layers"), ``split`` the "p_embed" split (None:
    ``p`` unchanged). A dim named "p_embed" is d_model wide, so it is a
    block where it holds d_model / n; a ``QuantizedWeight`` gathers its
    codes, its K-major copy by the swapped dim and its scale where the
    scale's dim is that block (wo, w_down: the scale is per column). The
    gather's backward reduce-scatters the gradient
    (``collectives.fsdp_gather``)."""
    if split is None:
        return p
    from repro_torch.distributed.collectives import fsdp_gather

    def gather(t, dim):
        if t.shape[dim] * split.n != d_model:
            return t
        return fsdp_gather(t, split.group, dim)

    def walk(w, ax):
        if isinstance(w, dict):
            return {k: walk(v, ax[k]) for k, v in w.items()}
        if "p_embed" not in ax:
            return w
        dim = ax.index("p_embed")
        if isinstance(w, QuantizedWeight):
            nd = w.wq.ndim
            swapped = {nd - 1: nd - 2, nd - 2: nd - 1}.get(dim, dim)
            return QuantizedWeight(gather(w.wq, dim), gather(w.scale, dim),
                                   w.bits, gather(w.wt, swapped))
        return gather(w, dim)
    return walk(p, axes)


def row_parallel_linear(x: torch.Tensor, w, policy: ExecPolicy,
                        group) -> torch.Tensor:
    """y = x @ w where x's last dim and w's rows are this rank's block of a
    contraction split over ``group`` ("model"): the whole product on every
    rank, in ``x.dtype``. The activation's per-tensor scale of a
    quantizing entry is the whole launch's: MAX-reduced over the absmax
    scope's group (``sharding.mesh_scope``: the whole mesh, "model"
    included), else over ``group``.

    bf16: each rank's partial product in f32 (exact products of the bf16
    operands, an f32 accumulate), summed over the group in f32 and rounded
    once (``collectives.reduce_from_model``), as the unsharded GEMM rounds
    its f32 accumulate once. qat: the weight fake-quantized at the whole
    weight's per-column scale (``collectives.replicated_absmax_scale`` over
    ``group``, ``axis=-2``), the activations at the whole launch's, the f32
    partial products (``backend.qat_product``) reduced as bf16's; the
    result differs from the unsharded entry by the order of the f32 sum
    only, and the gradient is the straight-through one of the same
    scales. photonic_sim and photonic_pallas: the codes at those scales,
    the int32 accumulates summed exactly over the group and dequantized
    after (``backend.photonic_sim_accumulate`` and
    ``collectives.exact_int_psum``, ``sharded_encoder.
    int8_linear_sharded``), so the result is bitwise the unsharded
    entry's. A cached weight carries its whole scale. Noisy matmuls
    raise (a noisy serving forward on a mesh keeps its weights whole)."""
    from repro_torch.core import backend, quant
    from repro_torch.distributed import collectives, sharding

    p = policy or ExecPolicy()
    if p.noise is None and p.backend == "bf16":
        wf = (w.dequantize().to(x.dtype) if isinstance(w, QuantizedWeight)
              else w)
        partial = torch.matmul(x.float(), wf.float())
        return collectives.reduce_from_model(partial, group, x.dtype)
    if p.noise is not None or p.backend not in ("qat", "photonic_sim",
                                                "photonic_pallas"):
        raise NotImplementedError(
            f"a row-parallel projection under {p!r}: a noisy matmul on "
            f"model-split weights is noisy training on a mesh, which is "
            f"not ported (its draws are keyed on the whole weight; "
            f"ROADMAP.md queue A, item 1)")
    bits = (p.quant_bits or 8 if p.backend == "qat"
            else backend._weight_bits(w, p))
    sw = (None if isinstance(w, QuantizedWeight) else
          collectives.replicated_absmax_scale(w, bits, group, axis=-2))
    # the activation's scale: the absmax scope's group, else the split's
    with sharding.absmax_scope(sharding.absmax_group() or group):
        if p.backend == "qat":
            return collectives.reduce_from_model(
                backend.qat_product(x, w, p, sw), group, x.dtype)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        if p.backend == "photonic_sim":
            acc, sx, sw = backend.photonic_sim_accumulate(x2, w, p, sw)
            acc = collectives.exact_int_psum(acc, group)
            y = acc.float() * sx * sw.reshape(1, -1)
        else:
            from repro_torch.models.sharded_encoder import int8_linear_sharded

            backend._no_backward_reason(p, "photonic matmul", x, w)
            if isinstance(w, QuantizedWeight):
                wq, sw = w.wq, w.scale
            else:
                wq = quant.quantize(w.float(), sw, bits=bits)
            y = int8_linear_sharded(x2, wq, sw.reshape(-1), bits=bits,
                                    scale_group=sharding.absmax_group(),
                                    psum_group=group)
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)
