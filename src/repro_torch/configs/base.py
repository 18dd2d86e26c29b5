"""Architecture configuration: the subset of the reference ``ArchConfig``
(src/repro/configs/base.py) that the ported paths read, field names and
defaults unchanged so a reader finds each counterpart.

Three families are ported: ``vit`` (the near-sensor serving path, and
its training: QAT with the straight-through estimator, launch/steps.py),
``dense`` (the decoder-only LM: prefill + KV-cache decode, and its
training; the configs qwen2-1.5b, qwen2.5-3b, stablelm-12b and
llama3-405b) and ``hybrid`` (RecurrentGemma, recurrentgemma-9b: RG-LRU
layers with a local attention layer every third, ``attn_every``, over a
``window``-token ring; ``lru_width`` / ``lru_dim`` and ``conv_kernel``
size the recurrence).
The training knobs are the reference's: ``remat`` (activation
checkpointing of each encoder layer), ``microbatch_steps`` (gradient
accumulation), ``use_fp32_master`` (f32 AdamW moments; bf16 when off),
``lr_warmup`` / ``lr_total`` (the warmup-cosine schedule) and
``grad_accum_dtype`` (the microbatch accumulator). The other LM families
come with later slices of the port (ROADMAP.md queue A), each with the
fields its path reads. ``ShapeConfig`` is one run's (seq_len,
global_batch, kind), as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ArchConfig", "ShapeConfig", "smoke_variant", "PORTED_FAMILIES"]

PORTED_FAMILIES = ("dense", "vit", "hybrid")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | vit | hybrid (ported); moe | ssm |
    #                             encdec | vlm raise at the model entry points
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int

    # attention
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    attn_impl: str = "standard"          # standard | decomposed (Eq. 2)
    window: int = 0                      # local-attention window (hybrid)
    attn_every: int = 0                  # hybrid: attn layer every k-th layer

    # recurrence (hybrid)
    conv_kernel: int = 4                 # the RG-LRU's short causal conv
    lru_width: int = 0                   # 0 -> d_model

    # vit / paper-specific
    img_size: int = 224
    patch: int = 16
    mgnet: bool = False
    mgnet_keep_ratio: float = 1.0
    mgnet_embed: int = 192        # paper: 192/3 classification, 384/6 det.
    mgnet_heads: int = 3

    # training & memory policy
    remat: bool = True
    microbatch_steps: int = 1            # gradient-accumulation steps
    use_fp32_master: bool = False        # False: AdamW m / v stored bf16
    lr_warmup: int = 100                 # warmup steps (schedule knob)
    lr_total: int = 10000                # cosine-decay horizon
    grad_accum_dtype: str = "f32"        # microbatch grad accumulator
    #                                      ("bf16" halves its memory)

    # paper technique knobs
    quant_bits: int = 0                  # 0 = off; 8 = paper's QAT/photonic
    photonic: bool = False               # "" backend -> photonic_sim
    matmul_backend: str = ""             # bf16 | qat | photonic_sim |
    #                                      photonic_pallas; "" resolves from
    #                                      photonic / quant_bits
    #                                      (core/backend.py)
    attn_backend: str = ""               # xla | flash ("" -> xla)
    ffn_backend: str = ""                # xla | fused ("" -> xla)
    noise: object = None                 # calibrated device noise
    #                                      (core/noise.py NoiseSpec); None
    #                                      = clean. Feeds ExecPolicy.noise
    bit_plan: tuple = ()                 # per-layer bit widths (one per
    #                                      encoder block, core/bitalloc.py);
    #                                      () = uniform quant_bits. Feeds
    #                                      prepare_params(bit_plan=...) and
    #                                      ExecPolicy.bit_plan

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests, as the reference's:
    at most 4 layers (a hybrid 3: one (rec, rec, attn) super-block), d=64,
    4 heads, at most 2 KV heads, d_ff=128, vocab 256, one microbatch, no
    remat; a vit also gets 32x32 images in 8x8 patches, a hybrid an LRU
    width of 64 and a 16-token window."""
    kw = dict(n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 3,
              d_model=64, n_heads=4, kv_heads=min(cfg.kv_heads, 2), d_ff=128,
              vocab=256, microbatch_steps=1, remat=False)
    if cfg.family == "vit":
        kw.update(img_size=32, patch=8)
    elif cfg.family == "hybrid":
        kw.update(lru_width=64, window=16, attn_every=3)
    elif cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue A15); ported: {PORTED_FAMILIES}")
    return cfg.with_(**kw)
