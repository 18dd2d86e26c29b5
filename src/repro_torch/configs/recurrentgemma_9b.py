"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU recurrence with local attention every 3rd layer
(pattern rec, rec, attn x 12 + 2 tail rec), window 2048
(arXiv:2402.19427; the reference's src/repro/configs/recurrentgemma_9b.py)."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]


def get_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, kv_heads=1,
        d_ff=12288, vocab=256000,
        window=2048, attn_every=3, lru_width=4096,
        rope_theta=10000.0,
        microbatch_steps=2,
    )
