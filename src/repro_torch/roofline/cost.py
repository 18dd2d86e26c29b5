"""Analytic FLOPs and bytes of one encode flush (the port's counterpart of
the reference's src/repro/roofline/hlo_analysis.py, which parses XLA's
optimized HLO; the port has no HLO, so it counts from its own shapes).

``encode_cost`` walks ``encode_tokens`` from the pre-embedded tokens to
the logits at one flush's exact shape: per layer Q/K/V, the scores, P V,
the output projection and the FFN's two products, then the head. The
shapes come from ``models.vit.vit_matmul_shapes`` (its patch-embed row
dropped: the embed runs at ingest, before the gather), then cut to what
the policy's kernels compute:

  * FLOPs are 2 x M x K x N a product, as the reference's HLO count
    (``hlo_analysis._dot_flops``: dots and convolutions only, so
    LayerNorm, softmax and GELU count nothing there and nothing here);
    photonic_sim's chunk walk zero-pads K to whole 32-wide wavelength
    chunks and multiplies the padding too (Eq. 2's per-head K = d_head
    products at a d_head below 32);
  * under a packed ``kv_len`` (one-shape mode: ``kv_len`` token rows of
    which the first ``k`` are live) the RoI-masked flash kernel reads only
    the live keys and the fused FFN computes only the live rows; the
    materialized (``xla``) attention and the composed FFN compute every
    row, the dead keys masked;
  * each product's FLOPs carry the dtype class it runs in on the card:
    ``int8`` (the photonic matmul and fused FFN kernels, and photonic_sim's
    chunked ``torch._int_mm``), ``tf32x3`` (the flash kernel's tensor-core
    entries), ``bf16`` (a bf16 product on bf16 activations), else ``f32``
    (TF32 is off on the card: ``device.full_precision_matmuls``; the noisy
    analog walk is f32);
  * bytes are each weight read once a flush (int8 codes plus f32
    per-channel scales when the policy quantizes, the raw dtype
    otherwise) plus each product's activations in and out at the
    activation dtype: a fused kernel's intermediates (the flash kernel's
    scores, the fused FFN's hidden layer) stay inside it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import _WAVELENGTHS, ExecPolicy
from repro_torch.kernels.flash_attention import masked_entry_for
from repro_torch.models.vit import vit_matmul_shapes

__all__ = ["Cost", "encode_cost"]

_HALF = (torch.bfloat16, torch.float16)


@dataclass
class Cost:
    """One flush's work: ``flops`` in all, ``bytes`` moved to and from
    memory, ``int8_flops`` the share on int8 products (the fields of the
    reference's ``hlo_analysis.Cost`` the cost model reads), and
    ``by_type`` every dtype class's share."""

    flops: float = 0.0
    bytes: float = 0.0
    int8_flops: float = 0.0
    by_type: dict = field(default_factory=dict)

    def add(self, flops: float, kind: str, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.by_type[kind] = self.by_type.get(kind, 0.0) + flops
        if kind == "int8":
            self.int8_flops += flops


def _linear_kind(policy: ExecPolicy, act_dtype: torch.dtype,
                 param_dtype: torch.dtype) -> str:
    """The dtype class a ``linear`` of the policy runs in on the card."""
    if policy.noise is not None:
        return "f32"                   # the analog walk: f32 chunk products
    if policy.backend in ("photonic_pallas", "photonic_sim"):
        return "int8"
    if (policy.backend == "bf16" and act_dtype == param_dtype
            and act_dtype in _HALF):
        return "bf16"
    return "f32"


def encode_cost(cfg: ArchConfig, policy: ExecPolicy, microbatch: int,
                k: int, kv_len: int | None = None, *, n_classes: int,
                act_dtype: torch.dtype = torch.float32,
                param_dtype: torch.dtype = torch.float32) -> Cost:
    """The ``Cost`` of one flush of ``microbatch`` frames at bucket ``k``:
    (microbatch, kv_len, d) tokens of which the first ``k`` are live
    (``kv_len`` None or ``k``: gathered, every row live; the ladder cap in
    one-shape mode). ``n_classes`` is the head's width; ``act_dtype`` the
    tokens' dtype and ``param_dtype`` the raw weights'."""
    rows = k if kv_len is None else int(kv_len)
    if not 1 <= k <= rows:
        raise ValueError(f"bucket {k} outside the flush's {rows} token rows")
    b, d, heads = microbatch, cfg.d_model, cfg.n_heads
    dh = d // heads
    n, live = rows + 1, k + 1                       # + the [cls] token
    a = torch.finfo(act_dtype).bits // 8
    lin = _linear_kind(policy, act_dtype, param_dtype)
    quantized = policy.is_photonic()
    flash = policy.resolve_attn_backend() == "flash"
    fused_ffn = (policy.resolve_ffn_backend() == "fused"
                 and policy.noise is None)
    kv = live if flash else n         # flash reads only the live keys
    ffn_rows = live if fused_ffn else n
    decomposed = cfg.attn_impl == "decomposed"
    pbytes = torch.finfo(param_dtype).bits // 8
    chunked = policy.backend == "photonic_sim" and policy.noise is None
    cost = Cost()

    def wbytes(kin: int, nout: int) -> int:
        return kin * nout + 4 * nout if quantized else kin * nout * pbytes

    def walked(kin: int) -> int:
        """K as the linear multiplies it (photonic_sim: whole chunks)."""
        return -(-kin // _WAVELENGTHS) * _WAVELENGTHS if chunked else kin

    def product(m: int, kin: int, nout: int, kind: str) -> None:
        cost.add(2 * b * m * walked(kin) * nout, kind,
                 wbytes(kin, nout) + a * b * m * (kin + nout))

    def attention(qk_dim: int) -> None:
        """The core: scores against ``kv`` keys of width ``qk_dim`` a head
        (dh, or d_model under Eq. 2) and P V, per head."""
        fl = 2 * b * heads * n * kv * qk_dim
        pv = 2 * b * heads * n * kv * dh
        q_in, kv_in = b * heads * n * qk_dim, b * kv * (
            (1 if decomposed else heads) * qk_dim + d)
        out = b * n * d
        if flash:
            kind = ("f32" if masked_entry_for(qk_dim, dh) == "simt"
                    else "tf32x3")
            cost.add(fl + pv, kind, a * (q_in + kv_in + out))
        else:
            kind = "bf16" if act_dtype in _HALF else "f32"
            s = b * heads * n * kv              # the materialized scores
            cost.add(fl, kind, a * (q_in + kv_in - b * kv * d + s))
            cost.add(pv, kind, a * (s + b * kv * d + out))

    shapes = vit_matmul_shapes(cfg, kept_patches=rows)[1:]
    for li in range(cfg.n_layers):
        q, wk, v, _, _, wo, w1, w2 = shapes[8 * li: 8 * (li + 1)]
        product(*q, lin)
        if decomposed:
            # each head's Q_h (W_K,h^T / sqrt(dh)), its weight raw a call
            cost.add(2 * b * n * walked(dh) * d * heads, lin,
                     4 * d * d + a * b * n * (d + heads * d))
            product(*v, lin)
            attention(d)
        else:
            product(*wk, lin)
            product(*v, lin)
            attention(dh)
        product(*wo, lin)
        if fused_ffn:
            _, din, dff = w1
            cost.add(2 * b * ffn_rows * din * dff * 2, "int8",
                     wbytes(din, dff) + wbytes(dff, din)
                     + a * b * ffn_rows * 2 * din)
        else:
            product(*w1, lin)
            product(*w2, lin)
    product(1, d, n_classes, lin)                  # the head, on [cls]
    return cost
