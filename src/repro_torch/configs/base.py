"""Architecture configuration: the vision-transformer subset of the
reference ``ArchConfig`` (src/repro/configs/base.py), field names and
defaults unchanged so a reader finds each counterpart.

Only the fields the ported serving path reads are here. The LM families,
training knobs, bit plans and device noise come with later slices of the
port (ROADMAP.md queue A).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ArchConfig", "smoke_variant"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # vit (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int

    attn_impl: str = "standard"          # standard (decomposed: later slice)

    # vit / paper-specific
    img_size: int = 224
    patch: int = 16
    mgnet: bool = False
    mgnet_keep_ratio: float = 1.0
    mgnet_embed: int = 192        # paper: 192/3 classification, 384/6 det.
    mgnet_heads: int = 3

    # paper technique knobs
    quant_bits: int = 0                  # 0 = off; 8 = paper's photonic w8a8
    matmul_backend: str = ""             # photonic_pallas (core/backend.py)
    attn_backend: str = ""               # flash
    ffn_backend: str = ""                # fused

    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests: 4 layers, d=64, 4 heads,
    d_ff=128, 32x32 images in 8x8 patches (the reference's vit smoke)."""
    return cfg.with_(n_layers=min(cfg.n_layers, 4), d_model=64, n_heads=4,
                     d_ff=128, img_size=32, patch=8)
