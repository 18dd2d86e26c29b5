"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias, tied embeddings, RoPE theta 1e6 (hf:Qwen/Qwen2.5;
the reference's src/repro/configs/qwen2_5_3b.py)."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, kv_heads=2,
        d_ff=11008, vocab=151936,
        qkv_bias=True, rope_theta=1000000.0,
        tie_embeddings=True,
        microbatch_steps=1,
    )
