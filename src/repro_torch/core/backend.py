"""Execution backend: the quantize-once weight cache and the three dispatch
points the serving path funnels through (the reference's
src/repro/core/backend.py, serving subset).

  * ``ExecPolicy``   - execution-mode knobs threaded from ArchConfig;
  * ``QuantizedWeight`` + ``prepare_params`` - the quantize-once cache:
    every matmul weight replaced once by its int8 codes + per-output-
    channel f32 scale (the MR tuning step), selected by the same key rules
    as the reference, so the same leaves are cached, MGNet's included;
  * ``linear``  - matmul registry: ``photonic_pallas`` (the int8 photonic
    matmul kernel, kernels/photonic_matmul.py); the bias is added after
    the kernel;
  * ``attend``  - attention-core registry: ``flash`` (the RoI-masked flash
    attention kernel, kernels/flash_attention.py);
  * ``ffn``     - FFN registry: ``fused`` (the fused int8 FFN kernel,
    kernels/fused_ffn.py).

The reference's other registry entries (bf16 / qat / photonic_sim, the
materialized-score ``xla`` attention and the composed ``xla`` FFN) are not
ported yet: naming one raises ``NotImplementedError`` (ROADMAP.md queue A).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core import quant

__all__ = ["ExecPolicy", "QuantizedWeight", "quantize_weight",
           "prepare_params", "NON_MATMUL_KEYS", "MATMUL_WEIGHT_EXTRA",
           "get_backend", "get_attention_backend", "get_ffn_backend",
           "matmul", "linear", "attend", "ffn"]

# registry entries of the reference that later slices of the port bring
_NOT_PORTED = {
    "matmul": ("bf16", "qat", "photonic_sim"),
    "attention": ("xla",),
    "ffn": ("xla",),
}


class ExecPolicy:
    """Execution-mode knobs threaded from ArchConfig into every layer.

    ``backend`` names a matmul registry entry and must be given: the
    reference resolves an empty name from legacy flags to bf16, qat or
    photonic_sim, none of which is ported yet. ``attn_backend`` and
    ``ffn_backend`` default to the reference's "xla" entries, also not
    ported: the serving point names photonic_pallas + flash + fused.
    """

    __slots__ = ("quant_bits", "backend", "attn_backend", "ffn_backend")

    def __init__(self, quant_bits: int = 0, backend: str = "",
                 attn_backend: str = "", ffn_backend: str = ""):
        self.quant_bits = quant_bits
        self.backend = backend
        self.attn_backend = attn_backend
        self.ffn_backend = ffn_backend

    @staticmethod
    def from_cfg(cfg) -> "ExecPolicy":
        return ExecPolicy(cfg.quant_bits, cfg.matmul_backend,
                          cfg.attn_backend, cfg.ffn_backend)

    def resolve_backend(self) -> str:
        """The named matmul backend; raises when none is named or the
        named one is not ported."""
        if not self.backend:
            raise NotImplementedError(
                "no matmul backend named; the reference's legacy "
                "resolution (bf16 / qat / photonic_sim) is not ported yet "
                "(ROADMAP.md queue A): name 'photonic_pallas'")
        _lookup(BACKENDS, "matmul", self.backend)
        return self.backend

    def resolve_attn_backend(self) -> str:
        return self.attn_backend or "xla"

    def resolve_ffn_backend(self) -> str:
        return self.ffn_backend or "xla"

    def __repr__(self):
        return (f"ExecPolicy(backend={self.backend!r}, "
                f"attn={self.resolve_attn_backend()!r}, "
                f"ffn={self.resolve_ffn_backend()!r}, bits={self.quant_bits})")


_DEFAULT = ExecPolicy()


# --------------------------------------------------------------------------
# quantize-once weight cache
# --------------------------------------------------------------------------

class QuantizedWeight:
    """A matmul weight after MR tuning: int8 codes + per-out-channel scale.

    ``wq``: (..., K, N) int8; ``scale``: (..., 1, N) f32. A leading L axis
    carries scan-stacked layers (``wq[i]`` is layer i's (K, N) bank).
    ``bits`` is one int width for every layer.
    """

    __slots__ = ("wq", "scale", "bits")

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, bits: int = 8):
        self.wq = wq
        self.scale = scale
        self.bits = int(bits)

    @property
    def ndim(self):
        return self.wq.ndim

    def layer(self, i: int) -> "QuantizedWeight":
        """Layer ``i`` of a stacked cache entry."""
        return QuantizedWeight(self.wq[i], self.scale[i], self.bits)

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.wq.to(device), self.scale.to(device),
                               self.bits)

    def __repr__(self):
        return f"QuantizedWeight(shape={tuple(self.wq.shape)}, bits={self.bits})"


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QuantizedWeight:
    """Codes + scale for one weight; the scale reduces only the contraction
    axis (-2), i.e. per output channel per layer for stacked weights."""
    w32 = w.float()
    scale = quant.absmax_scale(w32, bits=bits, axis=-2)     # (..., 1, N)
    return QuantizedWeight(quant.quantize(w32, scale, bits=bits), scale, bits)


# param-tree keys whose leaves stay raw even when they look like matmul
# weights (the reference's rule set, kept whole so the same leaves match)
NON_MATMUL_KEYS = frozenset({
    "cls", "pos", "cls_token", "pos_embed", "embed", "embedding", "tok_embed",
    "wte", "conv_w", "moe", "w_a", "w_x",
})

# leaf keys that name a ``linear`` weight without the "w" prefix
MATMUL_WEIGHT_EXTRA = frozenset({
    "head", "head_w", "in_proj", "out_proj", "gate_proj",
})


def _is_matmul_weight_key(name: str) -> bool:
    return name.startswith("w") or name in MATMUL_WEIGHT_EXTRA


def prepare_params(params, bits: int = 8, min_size: int = 128,
                   exclude: frozenset = NON_MATMUL_KEYS):
    """Quantize every matmul weight of a nested-dict param tree once.

    A leaf is cached iff its key names a ``linear`` weight (``w*`` prefix
    or ``MATMUL_WEIGHT_EXTRA``), no key on its path is in ``exclude``, and
    it is a float tensor of ndim >= 2 with at least ``min_size`` elements.
    Already-cached leaves pass through. Returns a new tree.
    """
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, QuantizedWeight) or not path:
            return node
        if not _is_matmul_weight_key(path[-1]):
            return node
        if any(p in exclude for p in path):
            return node
        if node.ndim < 2 or node.numel() < min_size:
            return node
        if not torch.is_floating_point(node):
            return node
        return quantize_weight(node, bits=bits)

    return walk(params, ())


def _resolve_wq(w, bits: int):
    """(int8 codes (K, N), scale (1, N) f32) from a raw or cached weight."""
    if isinstance(w, QuantizedWeight):
        return w.wq, w.scale
    w32 = w.float()
    sw = quant.absmax_scale(w32, bits=bits, axis=-2)
    return quant.quantize(w32, sw, bits=bits), sw


def _weight_bits(w, p: ExecPolicy) -> int:
    """Width for a 2-D dispatch: the cached width for a cached weight, else
    ``policy.quant_bits`` (8 when unset). A cached width that disagrees with
    an explicit ``quant_bits`` is a stale cache and an error (per-layer bit
    plans, which make that deliberate, are not ported yet)."""
    if isinstance(w, QuantizedWeight):
        if p.quant_bits and w.bits != p.quant_bits:
            raise ValueError(
                f"cached QuantizedWeight.bits={w.bits} disagrees with "
                f"ExecPolicy.quant_bits={p.quant_bits} — re-run "
                f"prepare_params at the policy's width, or set quant_bits=0 "
                f"to defer to the cache")
        return w.bits
    return p.quant_bits or 8


# --------------------------------------------------------------------------
# registries
# --------------------------------------------------------------------------

BACKENDS: dict[str, Callable] = {}
ATTN_BACKENDS: dict[str, Callable] = {}
FFN_BACKENDS: dict[str, Callable] = {}


def _lookup(registry: dict, kind: str, name: str) -> Callable:
    if name in registry:
        return registry[name]
    if name in _NOT_PORTED[kind]:
        raise NotImplementedError(
            f"{kind} backend {name!r} is not ported to repro_torch yet (a "
            f"later slice of the port, ROADMAP.md queue A); ported: "
            f"{sorted(registry)}")
    raise KeyError(f"unknown {kind} backend {name!r}; ported: "
                   f"{sorted(registry)}")


def get_backend(name: str) -> Callable:
    return _lookup(BACKENDS, "matmul", name)


def get_attention_backend(name: str) -> Callable:
    return _lookup(ATTN_BACKENDS, "attention", name)


def get_ffn_backend(name: str) -> Callable:
    return _lookup(FFN_BACKENDS, "ffn", name)


def _photonic_pallas_matmul(x, w, p: ExecPolicy):
    """The int8 photonic matmul kernel; with a cached ``QuantizedWeight``
    only the activations are quantized per call."""
    from repro_torch.kernels.ops import photonic_matmul_prequant

    bits = _weight_bits(w, p)
    wq, sw = _resolve_wq(w, bits)
    y = photonic_matmul_prequant(x.float(), wq, sw.reshape(-1), bits=bits)
    return y.to(x.dtype)


BACKENDS["photonic_pallas"] = _photonic_pallas_matmul


def matmul(x: torch.Tensor, w, policy: ExecPolicy | None = None) -> torch.Tensor:
    """y = x @ w under the policy. x (..., d_in); w (d_in, d_out) tensor or
    cached ``QuantizedWeight``."""
    p = policy or _DEFAULT
    return BACKENDS[p.resolve_backend()](x, w, p)


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None,
           policy: ExecPolicy | None = None) -> torch.Tensor:
    """y = x @ w (+ b): the bias is added after the kernel, as a separate op."""
    y = matmul(x, w, policy)
    if b is not None:
        y = y + b
    return y


def _attend_flash(q, k, v, p: ExecPolicy, mask, kv_len, scale):
    """Fused RoI-masked flash attention: masked keys applied inside the
    streaming-softmax update, fully pruned KV tiles skipped."""
    from repro_torch.kernels.flash_attention import flash_attention_masked

    lead = q.shape[:-3]
    b = math.prod(lead)
    h, sq, d = q.shape[-3:]
    qf = q.reshape(b, h, sq, d)
    kf = k.reshape((b,) + k.shape[-3:])
    vf = v.reshape((b,) + v.shape[-3:])
    mf = None
    if mask is not None:
        mf = torch.broadcast_to(mask, lead + mask.shape[-1:]).reshape(
            b, mask.shape[-1])
    out = flash_attention_masked(qf, kf, vf, mf, kv_len=kv_len, scale=scale)
    return out.reshape(*lead, h, sq, vf.shape[-1])


ATTN_BACKENDS["flash"] = _attend_flash


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           policy: ExecPolicy | None = None, *,
           mask: torch.Tensor | None = None, kv_len: int | None = None,
           scale: float | None = None) -> torch.Tensor:
    """softmax(q @ k^T * scale + key-mask) @ v under the policy.

    q (..., H, Sq, D); k (..., Hk, Skv, D); v (..., Hv, Skv, Dv);
    ``mask`` (..., Skv) keep-mask or ``kv_len`` packed kept count (at most
    one). ``scale`` defaults to 1/sqrt(D)."""
    p = policy or _DEFAULT
    if mask is not None and kv_len is not None:
        raise ValueError("give mask or kv_len, not both")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return get_attention_backend(p.resolve_attn_backend())(q, k, v, p, mask,
                                                           kv_len, scale)


def _ffn_fused(x, w1, b1, w2, b2, p: ExecPolicy, live_rows):
    """The fused int8 photonic FFN over per-layer cached weights (the
    encoder checks eligibility; the reference's composed fallback is not
    ported yet)."""
    from repro_torch.kernels.fused_ffn import fused_ffn

    return fused_ffn(x, w1.wq, w1.scale.reshape(-1), b1,
                     w2.wq, w2.scale.reshape(-1), b2,
                     bits=(w1.bits, w2.bits), live_rows=live_rows)


FFN_BACKENDS["fused"] = _ffn_fused


def ffn(x: torch.Tensor, w1, b1: torch.Tensor, w2, b2: torch.Tensor,
        policy: ExecPolicy | None = None, *,
        live_rows: int | None = None) -> torch.Tensor:
    """y = gelu(x @ w1 + b1) @ w2 + b2 under the policy; ``live_rows`` keeps
    only the first token rows (dead rows return exact zeros)."""
    p = policy or _DEFAULT
    return get_ffn_backend(p.resolve_ffn_backend())(x, w1, b1, w2, b2, p,
                                                    live_rows)
