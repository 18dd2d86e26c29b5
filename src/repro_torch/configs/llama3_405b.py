"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 (arXiv:2407.21783; the reference's
src/repro/configs/llama3_405b.py). Memory policy: microbatch
accumulation + bf16 optimizer state. Untied, RoPE theta 5e5 with no
scaling (the reference has none).

The reference also sets ``attn_block_q=512, attn_block_kv=1024``, its
blockwise attention's tile sizes. Those are its ``ArchConfig`` defaults,
and the port has no such knob: its attention runs the hand-written kernel
at the kernel's own tiles (``models/attention.py::blockwise_attention``),
so the two are left out rather than added as fields nothing reads."""

from repro_torch.configs.base import ArchConfig

__all__ = ["get_config"]


def get_config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, kv_heads=8,
        d_ff=53248, vocab=128256,
        rope_theta=500000.0,
        microbatch_steps=8,          # microbatch 32 of global 256
        use_fp32_master=False,       # bf16 m/v (low_mem AdamW)
    )
