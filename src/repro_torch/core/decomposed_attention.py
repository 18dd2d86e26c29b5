"""Multi-head self-attention on the fused serving branch (the reference's
src/repro/core/decomposed_attention.py::mhsa_standard).

Only the fused branch is ported: int8 cached-weight Q/K/V projections
feeding the RoI-masked flash attention kernel
(kernels/ops.py::fused_roi_attention_prequant), then the output projection
through ``linear``. The composed per-projection dispatch and the Eq. 2
decomposed dataflow come with a later slice (ROADMAP.md queue A).
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import ExecPolicy, linear

__all__ = ["mhsa_standard"]


def mhsa_standard(x: torch.Tensor, params: dict, heads: int,
                  policy: ExecPolicy | None = None,
                  mask: torch.Tensor | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """Multi-head self-attention, standard dataflow, fused branch.

    x (B, n, dm); params wq/wk/wv/wo (dm, dm) cached weights. ``mask``
    (B, n) keep-mask removes tokens from the key axis; ``kv_len`` is the
    packed alternative (keys >= kv_len pruned)."""
    from repro_torch.kernels.ops import fused_roi_attention_prequant

    if mask is not None:
        mask = torch.broadcast_to(mask, x.shape[:2])
    o = fused_roi_attention_prequant(
        x, params["wq"].wq, params["wq"].scale.reshape(-1),
        params["wk"].wq, params["wk"].scale.reshape(-1),
        params["wv"].wq, params["wv"].scale.reshape(-1),
        mask, heads=heads, kv_len=kv_len,
        bits=tuple(params[n].bits for n in ("wq", "wk", "wv")))
    return linear(o, params["wo"], policy=policy)
