"""GELU-MLP block (the reference's src/repro/models/ffn.py::mlp), routed
through the FFN registry of core/backend.py."""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy
from repro_torch.core.backend import ffn as ffn_dispatch

__all__ = ["mlp"]


def mlp(params: dict, x: torch.Tensor, policy: ExecPolicy | None = None,
        live_rows: int | None = None) -> torch.Tensor:
    """x (..., n, d) -> (..., n, d). ``live_rows`` is the packed serving
    hint: only the first token rows are computed, the rest return 0."""
    return ffn_dispatch(x, params["w1"], params["b1"], params["w2"],
                        params["b2"], policy, live_rows=live_rows)
