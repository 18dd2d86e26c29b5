"""Feed-forward blocks (the reference's src/repro/models/ffn.py): SwiGLU,
the LM default, and the GELU-MLP the ViT routes through the FFN registry
of core/backend.py."""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy
from repro_torch.core.backend import ffn as ffn_dispatch
from repro_torch.core.backend import linear

__all__ = ["swiglu", "mlp", "mlp_logical_axes"]


def swiglu(params: dict, x: torch.Tensor,
           policy: ExecPolicy | None = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): SiLU of the gate in f32 (as x * sigmoid(x),
    the reference's definition), cast to x.dtype, times the up projection
    in x.dtype, then the down projection."""
    g = linear(x, params["w_gate"], policy=policy).float()
    u = linear(x, params["w_up"], policy=policy)
    h = (g * torch.sigmoid(g)).to(x.dtype) * u
    return linear(h, params["w_down"], policy=policy)


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
