"""Feed-forward blocks (the reference's src/repro/models/ffn.py): SwiGLU,
the LM default, and the GELU-MLP the ViT routes through the FFN registry
of core/backend.py. Under a "model" split of the hidden dim (the
tensor-parallel LM) SwiGLU takes this rank's w_gate / w_up columns and
w_down rows and reduces w_down's partial products over the split."""

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
        live_rows: int | None = None) -> torch.Tensor:
    """x (..., n, d) -> (..., n, d). ``live_rows`` is the packed serving
    hint: only the first token rows are computed, the rest return 0."""
    return ffn_dispatch(x, params["w1"], params["b1"], params["w2"],
                        params["b2"], policy, live_rows=live_rows)
