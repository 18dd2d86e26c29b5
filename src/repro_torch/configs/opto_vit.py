"""Opto-ViT backbones (paper Table I): ViT Tiny/Small/Base/Large with the
paper's co-design: 8-bit photonic matmul execution and MGNet RoI pruning.
Defaults: 224x224, patch 16."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]

_VARIANTS = {
    #          L   d     H   d_ff
    "tiny":  (12, 192,   3,  768),
    "small": (12, 384,   6, 1536),
    "base":  (12, 768,  12, 3072),
    "large": (24, 1024, 16, 4096),
}


def get_config(variant: str = "base", img_size: int = 224,
               quant_bits: int = 8, mgnet: bool = False,
               mgnet_keep_ratio: float = 0.33) -> ArchConfig:
    l, d, h, dff = _VARIANTS[variant]
    return ArchConfig(
        name=f"opto-vit-{variant}", family="vit",
        n_layers=l, d_model=d, n_heads=h, d_ff=dff,
        img_size=img_size, patch=16,
        quant_bits=quant_bits,
        mgnet=mgnet, mgnet_keep_ratio=mgnet_keep_ratio,
    )
