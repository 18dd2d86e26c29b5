"""Shared building blocks (the reference's src/repro/models/layers.py,
serving subset). ``linear``/``ExecPolicy``/``QuantizedWeight`` live in
core/backend.py and are re-exported here for the model layers."""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy, QuantizedWeight, linear

__all__ = ["layernorm", "linear", "ExecPolicy", "QuantizedWeight"]


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """f32 normalization core, cast back to x.dtype, then ``* g + b``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b
