"""Architecture registry: ``--arch <id>`` resolves here (the reference's
src/repro/configs/registry.py, ported ids only).

Ported: the dense LMs ``qwen2-1.5b``, ``qwen2.5-3b``, ``stablelm-12b`` and
``llama3-405b``, the hybrid LM ``recurrentgemma-9b`` and the paper's own
backbones ``opto-vit-{tiny,small,base,large}``. Every other id the
reference knows raises ``NotImplementedError`` naming the ROADMAP item
that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "get_config"]

# the reference's ids, in its order
ARCH_IDS = [
    "mamba2-780m",
    "stablelm-12b",
    "qwen2-1.5b",
    "llama3-405b",
    "qwen2.5-3b",
    "llama-3.2-vision-90b",
    "whisper-medium",
    "recurrentgemma-9b",
    "kimi-k2-1t-a32b",
    "qwen3-moe-30b-a3b",
    "opto-vit-tiny", "opto-vit-small", "opto-vit-base", "opto-vit-large",
]

PORTED_ARCH_IDS = ("stablelm-12b", "qwen2-1.5b", "llama3-405b", "qwen2.5-3b",
                   "recurrentgemma-9b", "opto-vit-tiny", "opto-vit-small",
                   "opto-vit-base", "opto-vit-large")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in PORTED_ARCH_IDS and arch_id.startswith("opto-vit-"):
        from repro_torch.configs.opto_vit import get_config as get
        return get(arch_id.split("-")[-1])
    if arch_id in PORTED_ARCH_IDS:      # module named after the id
        return importlib.import_module("repro_torch.configs." + arch_id.replace(
            "-", "_").replace(".", "_")).get_config()
    if arch_id in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (its "
            f"family comes with ROADMAP.md queue A15); ported: "
            f"{list(PORTED_ARCH_IDS)}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
