"""Where the port's entry points run: on the card unless the caller asks
for the CPU.

``StreamServer``, ``forward_vit``, ``forward_vit_tokens`` and
``encode_tokens`` resolve their ``device`` argument here: None means
``cuda``; ``"cpu"`` runs every kernel's plain PyTorch version. With no
card and no explicit CPU request they raise, never falling back quietly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev
