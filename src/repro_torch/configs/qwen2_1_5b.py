"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, tied embeddings, RoPE theta 1e6
(arXiv:2407.10671; the reference's src/repro/configs/qwen2_1_5b.py)."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, kv_heads=2,
        d_ff=8960, vocab=151936,
        qkv_bias=True, rope_theta=1000000.0,
        tie_embeddings=True,
    )
