"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 (hf:stabilityai family; the reference's
src/repro/configs/stablelm_12b.py). Head dim 160, four query heads a KV
head; untied, no QKV bias, RoPE theta 1e4, two microbatches a train
step. The block is the dense family's (RMSNorm, full RoPE, SwiGLU), as
the reference's, not Hugging Face's StableLM-2 block."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]


def get_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, kv_heads=8,
        d_ff=13824, vocab=100352,
        rope_theta=10000.0,
        microbatch_steps=2,
    )
