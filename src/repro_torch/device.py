"""Where the port's entry points run: on the card unless the caller asks
for the CPU.

``StreamServer``, ``StreamSession``, ``forward_vit``,
``forward_vit_tokens``, ``encode_tokens``, ``data/pipeline.py::
prefetch_to_device``, ``models/api.py::init_model`` and
``launch/serve.py::init_cache`` / ``main`` resolve their ``device``
argument here: None means ``cuda``; ``"cpu"`` runs every kernel's plain
PyTorch version. With no card and no explicit CPU request they raise,
never falling back quietly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "full_precision_matmuls"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


def full_precision_matmuls() -> None:
    """Make the card's matmuls keep the reference's precision: f32 products
    in full f32 (no TF32: the composed ``qat`` / ``xla`` entries and the
    bf16 einsum of Eq. 2 run f32 products through cuBLAS) and bf16 products
    accumulated in f32 and rounded once (the reference's
    ``preferred_element_type``). The serving entry points set both on the
    card; a process-wide setting of PyTorch's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
