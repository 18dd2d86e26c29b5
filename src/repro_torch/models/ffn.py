"""Feed-forward blocks (the reference's src/repro/models/ffn.py): SwiGLU,
the LM default, and the GELU-MLP the ViT routes through the FFN registry
of core/backend.py. Under a "model" split of the hidden dim SwiGLU (the
tensor-parallel LM) takes this rank's w_gate / w_up columns and w_down
rows, and the GELU-MLP (the tensor-parallel ViT) this rank's w1 columns
with b1 and w2 rows; each reduces its down projection's partial products
over the split (``layers.row_parallel_linear``)."""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy
from repro_torch.core.backend import ffn as ffn_dispatch
from repro_torch.core.backend import linear
from repro_torch.distributed import collectives
from repro_torch.models.layers import row_parallel_linear

__all__ = ["swiglu", "swiglu_logical_axes", "mlp", "mlp_logical_axes"]


def swiglu_logical_axes() -> dict:
    """The reference's: d_ff is "p_mlp" (w_gate / w_up columns, w_down
    rows)."""
    return {"w_gate": ("p_embed", "p_mlp"),
            "w_up": ("p_embed", "p_mlp"),
            "w_down": ("p_mlp", "p_embed")}


def swiglu(params: dict, x: torch.Tensor,
           policy: ExecPolicy | None = None, split=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): SiLU of the gate in f32 (as x * sigmoid(x),
    the reference's definition), cast to x.dtype, times the up projection
    in x.dtype, then the down projection. ``split`` (a
    ``sharding.Split`` of d_ff) says the params hold this rank's block of
    the hidden dim."""
    xin = x if split is None else collectives.copy_to_model(x, split.group)
    g = linear(xin, params["w_gate"], policy=policy).float()
    u = linear(xin, params["w_up"], policy=policy)
    h = (g * torch.sigmoid(g)).to(x.dtype) * u
    if split is None:
        return linear(h, params["w_down"], policy=policy)
    return row_parallel_linear(h, params["w_down"], policy, split.group)


def mlp_logical_axes() -> dict:
    """Logical axes of the GELU-MLP's params: d_ff is the "p_mlp" axis
    (w1's columns with b1, w2's rows)."""
    return {"w1": ("p_embed", "p_mlp"), "b1": ("p_mlp",),
            "w2": ("p_mlp", "p_embed"), "b2": ("p_embed",)}


def mlp(params: dict, x: torch.Tensor, policy: ExecPolicy | None = None,
        live_rows: int | None = None, split=None) -> torch.Tensor:
    """x (..., n, d) -> (..., n, d). ``live_rows`` is the packed serving
    hint: only the first token rows are computed, the rest return 0.

    ``split`` (a ``sharding.Split`` of d_ff over "model") says the params
    hold this rank's w1 columns, b1 and w2 rows: the composed ``xla``
    dataflow (w1 column-parallel after ``collectives.copy_to_model``, the
    tanh GELU in f32, w2 row-parallel, then the whole b2), in the
    unsharded entry's order of casts and adds. The fused FFN's split
    runs in the sharded encoder (models/sharded_encoder.py) and raises
    here."""
    if split is None:
        return ffn_dispatch(x, params["w1"], params["b1"], params["w2"],
                            params["b2"], policy, live_rows=live_rows)
    from repro_torch.kernels.ref import gelu_tanh

    p = policy or ExecPolicy()
    if p.resolve_ffn_backend() != "xla":
        raise NotImplementedError(
            f"the {p.resolve_ffn_backend()!r} FFN under a 'model' split of "
            f"d_ff outside the sharded encoder: the split MLP is the "
            f"composed 'xla' dataflow")
    xin = collectives.copy_to_model(x, split.group)
    h = linear(xin, params["w1"], params["b1"], p)
    h = gelu_tanh(h.float()).to(x.dtype)
    return row_parallel_linear(h, params["w2"], p, split.group) + params["b2"]
