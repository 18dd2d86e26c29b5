"""Execution backend: the quantize-once weight cache and the three dispatch
points every ported path funnels through (the reference's
src/repro/core/backend.py, its noise dispatch aside).

  * ``ExecPolicy``   - execution-mode knobs threaded from ArchConfig, with
    the reference's resolution of an empty matmul backend name (photonic
    -> photonic_sim, quant_bits -> qat, else bf16);
  * ``QuantizedWeight`` + ``prepare_params`` - the quantize-once cache:
    every matmul weight replaced once by its int8 codes + per-output-
    channel f32 scale (the MR tuning step), selected by the same key rules
    as the reference, so the same leaves are cached, MGNet's included; a
    mixed-precision bit plan (core/bitalloc.py) gives each stacked layer
    its own width;
  * ``linear``  - matmul registry: ``bf16`` (f32 accumulate, one rounding
    to the activation dtype; a plain matmul, as the reference leaves it to
    XLA), ``qat`` (fake-quant w8a8 in float), ``photonic_sim`` (the int32
    accumulate walked in 32-wide wavelength chunks, then the dequant) and
    ``photonic_pallas`` (the int8 photonic matmul kernel,
    kernels/photonic_matmul.py); the bias is added after the matmul. The
    photonic entries share one numerics contract: their int32 accumulates
    equal ``int_accumulate_exact``'s;
  * ``attend``  - attention-core registry: ``xla`` (materialized scores,
    an additive -1e9 key bias, softmax, PV: plain PyTorch, as the
    reference computes it outside any kernel) and ``flash`` (the
    RoI-masked flash attention kernel, kernels/flash_attention.py);
  * ``ffn``     - FFN registry: ``xla`` (two ``linear`` dispatches with the
    tanh GELU between them) and ``fused`` (the fused int8 FFN kernel,
    kernels/fused_ffn.py);
  * ``place_params`` - slices the prepared tree down to one rank's shard
    of a model-sharded serving mesh.

Each registry entry is added by its decorator (``register_backend``,
``register_attention_backend``, ``register_ffn_backend``), the built-in
ones as a user's: an ``ExecPolicy`` built afterwards chooses it by name.

A fused entry asked for with weights it cannot take raises with the
reason (``_fused_ffn_ineligible_reason``): the reference warns once and
runs the composed dispatch instead, which would hide the kernel the
policy named (ROADMAP.md queue C, deviations by design).

Training (``ExecPolicy.training``, the reference's default True) picks
the ``qat`` entry's straight-through fake quant (``quant.fake_quant_ste``)
over the inference one, whose round has a zero gradient; forward values
are the same. A training policy that names a hand-written kernel
(photonic_pallas, flash, fused) raises with the reason when an operand
needs a gradient: none of those kernels has a backward
(``_no_backward_reason``). So does a ``QuantizedWeight`` met by an operand
that needs a gradient: a training tree holds raw float weights.

Calibrated device noise (``ExecPolicy.noise``, a ``core.noise.NoiseSpec``)
takes every matmul through ``_noisy_matmul`` on every backend: the tuned
weights take the MR transmission error (drawn on the card by the
noise-draw kernel, kernels/noise_draw.py), the readout shot noise and an
optional ADC. The photonic backends walk the analog float-code schedule
(``core.photonic.analog_accumulate``), bf16 and qat multiply their
effective float weight. The fused int8 entries are the clean digital
contract: under noise they are ineligible, the noise reason first.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core import bitalloc, quant

__all__ = ["ExecPolicy", "QuantizedWeight", "quantize_weight",
           "prepare_params", "place_params", "NON_MATMUL_KEYS",
           "MATMUL_WEIGHT_EXTRA", "int_accumulate_exact",
           "int_accumulate_sim", "int_accumulate_pallas",
           "qat_product", "photonic_sim_accumulate", "register_backend",
           "register_attention_backend", "register_ffn_backend",
           "get_backend", "get_attention_backend", "get_ffn_backend",
           "available_backends", "available_attention_backends",
           "available_ffn_backends", "matmul", "linear", "attend", "ffn"]

# photonic K-chunk width (32 WDM wavelength channels, paper Fig. 3b)
_WAVELENGTHS = 32


class ExecPolicy:
    """Execution-mode knobs threaded from ArchConfig into every layer.

    ``backend`` names a matmul registry entry; an empty name resolves as
    the reference's legacy flags do: ``photonic`` -> photonic_sim,
    ``quant_bits`` -> qat, else bf16. The matmul is looked up once, here,
    so an unknown name raises when the policy is built. ``attn_backend``
    and ``ffn_backend`` default to the reference's "xla" entries (the
    composed dispatch); the ViT serving point names photonic_pallas +
    flash + fused.

    ``bit_plan`` is the identity of the active mixed-precision plan
    (``core.bitalloc.plan_key`` output, or a bare per-layer tuple); None
    means uniform ``quant_bits``. Setting it lets ``_weight_bits`` accept
    cached widths that differ from ``quant_bits`` (deliberate per-layer
    widths instead of a stale cache, which without a plan is an error).

    ``noise`` is the calibrated device-noise operating point
    (``core.noise.NoiseSpec``, hashable); None is the clean path. Under
    noise every matmul runs ``_noisy_matmul``, which needs an active noise
    scope (``core.noise.noise_scope``).

    ``training`` (default True, as the reference's) selects the ``qat``
    entry's straight-through fake quant; the serving entry points build
    their policies with ``training=False``, as the reference's do.
    """

    __slots__ = ("quant_bits", "photonic", "backend", "attn_backend",
                 "ffn_backend", "matmul_fn", "bit_plan", "noise", "training")

    def __init__(self, quant_bits: int = 0, backend: str = "",
                 attn_backend: str = "", ffn_backend: str = "",
                 bit_plan=None, photonic: bool = False, noise=None,
                 training: bool = True):
        self.quant_bits = quant_bits
        self.photonic = photonic
        self.training = bool(training)
        self.backend = backend or ("photonic_sim" if photonic else
                                   "qat" if quant_bits else "bf16")
        self.matmul_fn = _lookup(BACKENDS, "matmul", self.backend)
        self.attn_backend = attn_backend
        self.ffn_backend = ffn_backend
        self.bit_plan = (tuple(bit_plan) if isinstance(bit_plan, list)
                         else bit_plan) or None
        self.noise = noise

    @staticmethod
    def from_cfg(cfg, training: bool = True) -> "ExecPolicy":
        return ExecPolicy(cfg.quant_bits, cfg.matmul_backend,
                          cfg.attn_backend, cfg.ffn_backend,
                          cfg.bit_plan or None, cfg.photonic, cfg.noise,
                          training)

    def without_noise(self) -> "ExecPolicy":
        """A clean copy of this policy (noise stripped); self when already
        clean."""
        if self.noise is None:
            return self
        return ExecPolicy(self.quant_bits, self.backend, self.attn_backend,
                          self.ffn_backend, self.bit_plan, self.photonic,
                          training=self.training)

    def gate_policy(self) -> "ExecPolicy":
        """Policy of the MGNet RoI gate: clean even under noise (noisy gate
        matmuls would make the routing, and so every bucket shape,
        stochastic) unless ``NoiseSpec.noisy_gate`` opts it in."""
        if self.noise is None or self.noise.noisy_gate:
            return self
        return self.without_noise()

    def fingerprint(self) -> tuple:
        """Hashable identity of every dispatch-relevant knob."""
        return (self.backend, self.resolve_attn_backend(),
                self.resolve_ffn_backend(), self.quant_bits, self.bit_plan,
                self.noise, self.training)

    def resolve_attn_backend(self) -> str:
        return self.attn_backend or "xla"

    def resolve_ffn_backend(self) -> str:
        return self.ffn_backend or "xla"

    def is_photonic(self) -> bool:
        return self.backend.startswith("photonic")

    def __repr__(self):
        plan = "" if self.bit_plan is None else f", plan={self.bit_plan}"
        noise = ", noise=on" if self.noise is not None else ""
        return (f"ExecPolicy(backend={self.backend!r}, "
                f"attn={self.resolve_attn_backend()!r}, "
                f"ffn={self.resolve_ffn_backend()!r}, bits={self.quant_bits}"
                f"{plan}, training={self.training}{noise})")


def _needs_grad(*ts) -> bool:
    """Whether autograd records an op on these operands."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _no_backward_reason(p: ExecPolicy, entry: str, *ts) -> None:
    """Raise when a training policy sends operands that need a gradient
    to a hand-written kernel: none has a backward. The reference's own
    train step cannot run on them either (its Pallas calls have no VJP)."""
    p = p or _DEFAULT          # a direct call of an entry names none
    if p.training and _needs_grad(*ts):
        raise ValueError(
            f"a training policy ({p!r}) sent operands that need a gradient "
            f"to the {entry} kernel, which has no backward; train on the "
            f"composed entries (qat or bf16 matmuls, xla attention, xla "
            f"FFN) and serve the trained weights on the kernels")


def _no_cached_weight(w, x, p: ExecPolicy) -> None:
    """A ``QuantizedWeight`` in a training forward is an error, not a
    dequantize: a training tree holds raw float weights."""
    if isinstance(w, QuantizedWeight) and p.training and _needs_grad(x):
        raise ValueError(
            f"a QuantizedWeight {w!r} reached a training forward; train on "
            f"the raw float params and run prepare_params on the result")




# --------------------------------------------------------------------------
# quantize-once weight cache
# --------------------------------------------------------------------------

class QuantizedWeight:
    """A matmul weight after MR tuning: int8 codes + per-out-channel scale.

    ``wq``: (..., K, N) int8; ``scale``: (..., 1, N) f32. A leading L axis
    carries scan-stacked layers (``wq[i]`` is layer i's (K, N) bank).
    ``bits`` is an int, or for a stacked (L, K, N) weight under a
    mixed-precision bit plan a length-L tuple of per-layer widths; a 2-D
    dispatch only ever sees an int (``layer(i)`` hands layer i its own).
    ``wt``: (..., N, K) int8, the same codes K-major (contiguous), which
    the photonic matmul kernel's K-major entry reads (the tensor cores take
    int8 operands K-major only). It is made once, where a cache entry is
    made or moved (given, or the transpose of ``wq`` when not), never per
    call: ``layer(i)`` slices it.
    """

    __slots__ = ("wq", "scale", "bits", "wt")

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, bits=8,
                 wt: torch.Tensor | None = None):
        self.wq = wq
        self.scale = scale
        self.bits = (tuple(int(b) for b in bits)
                     if isinstance(bits, (tuple, list)) else int(bits))
        self.wt = wq.transpose(-1, -2).contiguous() if wt is None else wt

    @property
    def ndim(self):
        return self.wq.ndim

    def layer_bits(self, i: int) -> int:
        """Width of stacked layer ``i`` (an int ``bits`` is uniform)."""
        return self.bits[i] if isinstance(self.bits, tuple) else self.bits

    def uniform_bits(self) -> int | None:
        """The single width when uniform, else None (mixed stacked)."""
        if isinstance(self.bits, tuple):
            u = set(self.bits)
            return u.pop() if len(u) == 1 else None
        return self.bits

    def dequantize(self) -> torch.Tensor:
        """The f32 weight the codes stand for: f32 codes x scale."""
        return quant.dequantize(self.wq, self.scale)

    def layer(self, i: int) -> "QuantizedWeight":
        """Layer ``i`` of a stacked cache entry at its own int width
        (views, no copies)."""
        return QuantizedWeight(self.wq[i], self.scale[i], self.layer_bits(i),
                               self.wt[i])

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.wq.to(device), self.scale.to(device),
                               self.bits, self.wt.to(device))

    def __repr__(self):
        return f"QuantizedWeight(shape={tuple(self.wq.shape)}, bits={self.bits})"


def quantize_weight(w: torch.Tensor, bits=8) -> QuantizedWeight:
    """Codes + scale for one weight; the scale reduces only the contraction
    axis (-2), i.e. per output channel per layer for stacked weights.

    ``bits`` may be a per-layer sequence for a stacked (L, K, N) weight:
    each layer is quantized at its own width (bitwise what quantizing the
    2-D slices apart gives) and codes, scales and the K-major copy are
    stacked once into one cache entry. A uniform sequence takes the int
    path."""
    w32 = w.float()
    if isinstance(bits, (tuple, list)):
        bt = tuple(int(b) for b in bits)
        if w32.ndim < 3 or w32.shape[0] != len(bt):
            raise ValueError(
                f"per-layer bits {bt} need a stacked (L={len(bt)}, K, N) "
                f"weight, got shape {tuple(w.shape)}")
        if len(set(bt)) > 1:
            parts = [quantize_weight(w32[i], bt[i]) for i in range(len(bt))]
            return QuantizedWeight(torch.stack([p.wq for p in parts]),
                                   torch.stack([p.scale for p in parts]), bt,
                                   torch.stack([p.wt for p in parts]))
        bits = bt[0]                            # uniform plan: int path
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
                   exclude: frozenset = NON_MATMUL_KEYS,
                   bit_plan=None, n_layers: int | None = None):
    """Quantize every matmul weight of a nested-dict param tree once.

    A leaf is cached iff its key names a ``linear`` weight (``w*`` prefix
    or ``MATMUL_WEIGHT_EXTRA``), no key on its path is in ``exclude``, and
    it is a float tensor of ndim >= 2 with at least ``min_size`` elements.
    Already-cached leaves pass through. Returns a new tree.

    ``bit_plan`` assigns non-uniform widths (core/bitalloc.py): a
    per-layer sequence (one width per encoder block, applied to every
    matmul weight of the stacked ``blocks`` subtree) or a dict with
    per-tensor path-suffix overrides (``{"attn/wq": 4, "ffn/w2": (8, 6,
    6, 8)}``) plus optional ``"layers"`` / ``"default"`` keys. Each leaf's
    width is ``bitalloc.resolve_bits`` of its key path; weights outside
    ``blocks`` take the plan's default (``bits`` unless overridden), and
    a per-layer width on a weight that is not stacked falls back to
    ``bits``. ``n_layers`` sizes per-layer sequences; it defaults to the
    leading dim of the stacked ``blocks`` leaves.
    """
    plan = None
    if bit_plan is not None:
        if n_layers is None:
            n_layers = _infer_n_layers(params)
        plan = bitalloc.normalize_bit_plan(bit_plan, n_layers, default=bits)

    def leaf_bits(path, node):
        if plan is None:
            return bits
        lb = bitalloc.resolve_bits(plan, path)
        if isinstance(lb, tuple) and (node.ndim < 3
                                      or node.shape[0] != len(lb)):
            return bits      # per-layer plan, non-stacked weight: default
        return lb

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
        return quantize_weight(node, bits=leaf_bits(path, node))

    return walk(params, ())


def _infer_n_layers(params) -> int:
    """Leading dim of the stacked ``blocks`` leaves (plan sizing)."""
    def first(node):
        if isinstance(node, dict):
            for v in node.values():
                n = first(v)
                if n is not None:
                    return n
            return None
        if isinstance(node, QuantizedWeight):
            node = node.wq
        return int(node.shape[0]) if getattr(node, "ndim", 0) >= 1 else None

    blocks = params.get("blocks") if isinstance(params, dict) else None
    n = first(blocks) if blocks is not None else None
    if n is None:
        raise ValueError("cannot infer n_layers for a per-layer bit plan: "
                         "no stacked 'blocks' subtree; pass n_layers=")
    return n


def place_params(params, logical_axes, ctx):
    """This rank's shard of a prepared param tree (the reference's
    ``place_params``, which pins the tree onto the mesh with a
    ``NamedSharding`` per leaf; here each rank keeps only its block).

    ``logical_axes`` is the model's per-leaf logical-axis tree
    (``models.vit.vit_logical_axes``), ``ctx`` a ``ShardingCtx`` whose rules
    map those axes to mesh axes: under MODEL_RULES the columns of
    wq/wk/wv/w1 go with their scales and b1, the rows of w2 go while its
    scale and b2 stay whole, and everything else (wo, head, LN, cls, pos,
    MGNet) stays whole. A ``QuantizedWeight`` slices its codes and its
    scale by the same axes (the scale's size-1 contraction dim replicates
    by the divisibility rule) and keeps its ``bits``, a per-layer tuple
    included. A leaf whose rank
    does not match its axes entry stays whole. Its K-major copy ``wt``
    slices by the same axes with the last two swapped (a column shard of
    ``wq`` is a row shard of ``wt``). Sliced leaves are made contiguous
    once here, so the kernels never copy them per call.
    """
    from repro_torch.distributed.sharding import local_shard, logical_spec

    def block(t, axes):
        spec = logical_spec(t.shape, axes, ctx)
        if all(r is None for r in spec):
            return t
        return local_shard(t, spec, ctx.mesh).contiguous()

    def place(w, ax):
        if isinstance(w, dict):
            return {k: place(v, ax[k]) for k, v in w.items()}
        axt = tuple(ax)
        if isinstance(w, QuantizedWeight):
            return QuantizedWeight(block(w.wq, axt), block(w.scale, axt),
                                   w.bits,
                                   block(w.wt, axt[:-2] + (axt[-1], axt[-2])))
        if isinstance(w, torch.Tensor) and w.ndim == len(axt):
            return block(w, axt)
        return w

    return place(params, logical_axes)


def _resolve_wq(w, bits: int) -> QuantizedWeight:
    """A cached weight as it is; a raw one quantized (codes, scale and
    K-major copy) for this call."""
    return w if isinstance(w, QuantizedWeight) else quantize_weight(w, bits)


def _weight_bits(w, p: ExecPolicy) -> int:
    """Width for a 2-D dispatch: the cached width for a cached weight, else
    ``policy.quant_bits`` (8 when unset). A stacked per-layer tuple here is
    an error (slice the layer first: ``QuantizedWeight.layer``), and so is
    a cached width that disagrees with an explicit ``quant_bits`` unless a
    bit plan is active (``policy.bit_plan``): without one it is a stale
    cache."""
    if isinstance(w, QuantizedWeight):
        if isinstance(w.bits, tuple):
            raise ValueError(
                f"stacked mixed-bits QuantizedWeight (bits={w.bits}) "
                f"reached a 2-D matmul dispatch; slice it to one layer "
                f"first (QuantizedWeight.layer, as the encoder does)")
        if p.quant_bits and p.bit_plan is None and w.bits != p.quant_bits:
            raise ValueError(
                f"cached QuantizedWeight.bits={w.bits} disagrees with "
                f"ExecPolicy.quant_bits={p.quant_bits} and no bit plan is "
                f"active — re-run prepare_params at the policy's width, "
                f"set quant_bits=0 to defer to the cache, or set "
                f"ExecPolicy.bit_plan for deliberate mixed precision")
        return w.bits
    return p.quant_bits or 8


# --------------------------------------------------------------------------
# registries
# --------------------------------------------------------------------------

BACKENDS: dict[str, Callable] = {}
ATTN_BACKENDS: dict[str, Callable] = {}
FFN_BACKENDS: dict[str, Callable] = {}


def _registrar(registry: dict, name: str):
    def deco(fn):
        registry[name] = fn
        return fn
    return deco


def register_backend(name: str):
    """Decorator: register ``fn(x, w, policy)`` as the matmul backend
    ``name`` (an ``ExecPolicy(backend=name)`` built afterwards takes it)."""
    return _registrar(BACKENDS, name)


def register_attention_backend(name: str):
    """Decorator: register ``fn(q, k, v, policy, mask, kv_len, scale)`` as
    the attention backend ``name``."""
    return _registrar(ATTN_BACKENDS, name)


def register_ffn_backend(name: str):
    """Decorator: register ``fn(x, w1, b1, w2, b2, policy, live_rows)`` as
    the FFN backend ``name``."""
    return _registrar(FFN_BACKENDS, name)


def _lookup(registry: dict, kind: str, name: str) -> Callable:
    if name in registry:
        return registry[name]
    raise KeyError(f"unknown {kind} backend {name!r}; available: "
                   f"{tuple(sorted(registry))}")


def get_backend(name: str) -> Callable:
    return _lookup(BACKENDS, "matmul", name)


def get_attention_backend(name: str) -> Callable:
    return _lookup(ATTN_BACKENDS, "attention", name)


def get_ffn_backend(name: str) -> Callable:
    return _lookup(FFN_BACKENDS, "ffn", name)


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(BACKENDS))


def available_attention_backends() -> tuple[str, ...]:
    return tuple(sorted(ATTN_BACKENDS))


def available_ffn_backends() -> tuple[str, ...]:
    return tuple(sorted(FFN_BACKENDS))


# --------------------------------------------------------------------------
# integer-accumulate primitives (the photonic entries' numerics contract)
# --------------------------------------------------------------------------

def int_accumulate_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """One-shot exact int32 accumulate of (M, K) and (K, N) codes, outside
    any kernel of the port (``kernels/fused_ffn.py::int_accumulate``: the
    float64 plain version on the CPU, ``torch._int_mm`` on the card)."""
    from repro_torch.kernels.fused_ffn import int_accumulate
    return int_accumulate(xq, wq)


def int_accumulate_sim(xq: torch.Tensor, wq: torch.Tensor,
                       chunk: int = _WAVELENGTHS) -> torch.Tensor:
    """The int32 accumulate walked over K in ``chunk``-wide wavelength
    groups (the paper's Fig. 6 schedule), K zero-padded to whole chunks.
    Integer addition is associative, so it equals ``int_accumulate_exact``
    bitwise; each chunk goes through the same exact accumulate."""
    from repro_torch.kernels.fused_ffn import int_accumulate
    m, k = xq.shape
    n = wq.shape[1]
    rem = (-k) % chunk
    if rem:
        xq = torch.nn.functional.pad(xq, (0, rem))
        wq = torch.nn.functional.pad(wq, (0, 0, 0, rem))
    acc = torch.zeros((m, n), dtype=torch.int32, device=xq.device)
    for c0 in range(0, k + rem, chunk):
        acc += int_accumulate(xq[:, c0:c0 + chunk].contiguous(),
                              wq[c0:c0 + chunk])
    return acc


def int_accumulate_pallas(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 accumulate through the photonic matmul kernel (B1) with
    unit scales, whose f32 output is then the raw accumulate: exact for
    |acc| < 2^24 (K <= 1040 at 8 bits, every ViT shape of the repo). The
    kernel masks ragged edges, so nothing is padded; its K-major entry
    reads a K-major copy of ``wq`` made here."""
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8
    n = wq.shape[1]
    out = photonic_matmul_int8(
        xq, wq, torch.ones((), device=xq.device),
        torch.ones(n, device=xq.device), wt=wq.t().contiguous())
    return out.to(torch.int32)


@register_backend("photonic_pallas")
def _photonic_pallas_matmul(x, w, p: ExecPolicy):
    """The int8 photonic matmul kernel; with a cached ``QuantizedWeight``
    only the activations are quantized per call."""
    from repro_torch.kernels.ops import photonic_matmul_prequant

    _no_backward_reason(p, "photonic matmul", x, w)
    bits = _weight_bits(w, p)
    qw = _resolve_wq(w, bits)
    y = photonic_matmul_prequant(x.float(), qw.wq, qw.scale.reshape(-1),
                                 bits=bits, wt=qw.wt)
    return y.to(x.dtype)


@register_backend("bf16")
def _bf16_matmul(x, w, p: ExecPolicy):
    """Plain dot with f32 accumulation and one rounding to ``x.dtype``; a
    cached ``QuantizedWeight`` is dequantized (f32 codes x scale) and cast
    to ``x.dtype`` first, as the reference does. On the card a same-dtype
    bf16/f16 product goes to cuBLAS, which accumulates in f32 and rounds
    once (with ``allow_bf16_reduced_precision_reduction`` off, as the
    entry points set it); every other case multiplies in f32 and casts.
    ``w`` may be a transposed view (the tied LM head): it is never copied
    to a contiguous layout here."""
    if isinstance(w, QuantizedWeight):
        w = w.dequantize().to(x.dtype)
    if (x.is_cuda and x.dtype == w.dtype
            and x.dtype in (torch.bfloat16, torch.float16)):
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def qat_product(x, w, p: ExecPolicy, sw=None) -> torch.Tensor:
    """The ``qat`` entry's f32 product, before its cast: the weight
    fake-quantized per output channel at ``sw`` (default its own absmax
    scale), the activations per tensor at ``scoped_absmax_scale``. A
    cached weight is dequantized instead (the cache already quantized
    it). A training policy takes the straight-through fake quant."""
    from repro_torch.distributed.collectives import scoped_absmax_scale

    bits = p.quant_bits or 8
    fq = quant.fake_quant_ste if p.training else quant.fake_quant
    if isinstance(w, QuantizedWeight):
        wq = w.dequantize().to(x.dtype)
    else:
        wq = fq(w, bits=bits, axis=tuple(range(w.ndim - 1)), scale=sw)
    xq = fq(x, bits=bits, axis=None, scale=scoped_absmax_scale(x, bits))
    return torch.matmul(xq.float(), wq.float())


@register_backend("qat")
def _qat_matmul(x, w, p: ExecPolicy):
    """Fake-quant w8a8 in float (the reference's ``qat`` entry, paper §IV):
    the weight per output channel, the activations per tensor, then one f32
    product cast to ``x.dtype`` (``qat_product``). A training policy takes
    the straight-through fake quant, as the reference's. On the card the
    f32 product runs without TF32, as the entry points set it. Inside an
    absmax scope (``sharding.absmax_scope``: x's rows split over ranks)
    the activation scale is the whole tensor's, MAX-reduced over the
    scope's group outside autograd; without one it is ``x``'s own."""
    return qat_product(x, w, p).to(x.dtype)


def photonic_sim_accumulate(x2, w, p: ExecPolicy, sw=None) -> tuple:
    """The ``photonic_sim`` entry before its dequant: (the int32
    accumulate of x2's per-tensor codes at ``scoped_absmax_scale`` against
    the weight's codes over 32-wavelength K chunks, sx, sw). ``sw`` is a
    raw weight's per-output-channel scale (default its own absmax scale);
    a cached weight carries its own."""
    from repro_torch.distributed.collectives import scoped_absmax_scale

    bits = _weight_bits(w, p)
    if isinstance(w, QuantizedWeight) or sw is None:
        qw = _resolve_wq(w, bits)
        wq, sw = qw.wq, qw.scale
    else:
        wq = quant.quantize(w.float(), sw, bits=bits)
    sx = scoped_absmax_scale(x2, bits)
    acc = int_accumulate_sim(quant.quantize(x2, sx, bits=bits), wq)
    return acc, sx, sw


@register_backend("photonic_sim")
def _photonic_sim_matmul(x, w, p: ExecPolicy):
    """The chunk-walking w8a8 oracle: per-tensor activation codes, the
    int32 accumulate over 32-wavelength K chunks (``int_accumulate_sim``),
    then the dequant (f32(acc) * sx) * sw[n], as the kernel's epilogue.
    Inside an absmax scope sx is the whole split tensor's, as ``qat``'s."""
    lead = x.shape[:-1]
    acc, sx, sw = photonic_sim_accumulate(
        x.reshape(-1, x.shape[-1]).float(), w, p)
    y = acc.float() * sx * sw.reshape(1, -1)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def _noisy_matmul(x, w, p: ExecPolicy):
    """One noisy path for every backend (the registry entries stay the
    clean contract). The weight-stationary MR banks take the transmission
    error (crosstalk floor + FPV + Lorentzian drift and wander), the
    readout shot noise and an optional range-limited ADC, keyed by the
    active noise scope's next call (``core.noise.next_call_keys``). The
    photonic backends walk the analog float-code schedule over the
    perturbed codes (both through ``photonic_matmul_prequant_noisy``: the
    reference's two photonic branches compute the same numbers); bf16 and
    qat apply the multiplier to their effective float weight (a cached
    weight dequantized, qat's fake-quantized) and take one f32 product."""
    from repro_torch.core import noise as noise_mod
    from repro_torch.kernels.noise_draw import transmission_codes

    spec = p.noise
    call = noise_mod.next_call_keys(spec)
    if p.backend.startswith("photonic"):
        from repro_torch.kernels.ops import photonic_matmul_prequant_noisy

        bits = _weight_bits(w, p)
        qw = _resolve_wq(w, bits)
        y = photonic_matmul_prequant_noisy(
            x.float(), qw.wq, qw.scale.reshape(-1), call, spec, bits=bits,
            chunk=_WAVELENGTHS)
        return y.to(x.dtype)
    bits = p.quant_bits or 8
    if isinstance(w, QuantizedWeight):
        wf = w.dequantize()
        xf = x.float()
    elif p.backend == "qat":
        from repro_torch.distributed.collectives import scoped_absmax_scale
        fq = quant.fake_quant_ste if p.training else quant.fake_quant
        wf = fq(w.float(), bits=bits, axis=tuple(range(w.ndim - 1)))
        xf = x.float()
        xf = fq(xf, bits=bits, axis=None, scale=scoped_absmax_scale(xf, bits))
    else:
        wf = w.float()
        xf = x.float()
    y = torch.matmul(xf, transmission_codes(wf.contiguous(), call, spec))
    y = noise_mod.readout_noise(y, spec, call, bits=bits)
    return y.to(x.dtype)


_DEFAULT = ExecPolicy()


def matmul(x: torch.Tensor, w, policy: ExecPolicy | None = None) -> torch.Tensor:
    """y = x @ w under the policy. x (..., d_in); w (d_in, d_out) tensor or
    cached ``QuantizedWeight``. A noisy policy takes ``_noisy_matmul``."""
    p = policy or _DEFAULT
    _no_cached_weight(w, x, p)
    if p.noise is not None:
        return _noisy_matmul(x, w, p)
    return p.matmul_fn(x, w, p)


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None,
           policy: ExecPolicy | None = None) -> torch.Tensor:
    """y = x @ w (+ b): the bias is added after the kernel, as a separate op."""
    y = matmul(x, w, policy)
    if b is not None:
        y = y + b
    return y


@register_attention_backend("flash")
def _attend_flash(q, k, v, p: ExecPolicy, mask, kv_len, scale):
    """Fused RoI-masked flash attention: masked keys applied inside the
    streaming-softmax update, fully pruned KV tiles skipped."""
    from repro_torch.kernels.flash_attention import flash_attention_masked

    _no_backward_reason(p, "flash attention", q, k, v)
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


@register_attention_backend("xla")
def _attend_xla(q, k, v, p: ExecPolicy, mask, kv_len, scale):
    """The materialized-score dataflow, plain PyTorch as the reference
    computes it outside any kernel: the full (Sq, Skv) scores, a large
    negative additive bias (mask - 1) * 1e9 on masked keys (the
    reference's constant, not the plain kernel's NEG_INF), softmax, then
    PV; rows with no live key are set to exactly 0. Runs in the operands'
    dtype. A packed ``kv_len`` is applied as a prefix mask: nothing is
    skipped."""
    from repro_torch.kernels.ref import expand_kv_heads, prefix_key_mask

    h = q.shape[-3]
    if kv_len is not None:
        # an int kv_len builds the mask on the device, copying nothing
        # from the host, so a CUDA graph can capture it
        skv = k.shape[-2]
        mask = ((torch.arange(skv, device=q.device) < kv_len).float()
                if isinstance(kv_len, int)
                else prefix_key_mask(kv_len, 1, skv, q.device)[0])
    s = (q @ expand_kv_heads(k, h).transpose(-1, -2)) * scale
    if mask is not None:
        s = s + ((mask.float() - 1.0) * 1e9).to(s.dtype)[..., None, None, :]
    o = torch.softmax(s, dim=-1) @ expand_kv_heads(v, h)
    if mask is not None:
        o = o * (mask.sum(-1) > 0)[..., None, None, None].to(o.dtype)
    return o


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


@register_ffn_backend("xla")
def _ffn_xla(x, w1, b1, w2, b2, p: ExecPolicy, live_rows):
    """The composed dataflow: two ``linear`` dispatches with the tanh GELU
    in f32 between them, cast to ``x.dtype`` after the bias and after the
    GELU. Runs on every matmul backend; ``live_rows`` is ignored (this
    entry never skips, as the reference's)."""
    from repro_torch.kernels.ref import gelu_tanh

    h = linear(x, w1, b1, policy=p)
    h = gelu_tanh(h.float()).to(x.dtype)
    return linear(h, w2, b2, policy=p)


def _fused_ffn_ineligible_reason(w1, w2,
                                 p: ExecPolicy | None) -> str | None:
    """None when the fused int8 FFN kernel can take the block: the int8
    photonic matmul backend (a policy of None, a direct call of the
    entry, names no other) and both weights quantize-once cached, per
    layer, at (possibly different) widths of at most 8 bits; else why
    not. Calibrated device noise is the first reason: the fused int8
    kernel is the clean digital contract."""
    if p is not None and p.noise is not None:
        return ("calibrated device noise is active (ExecPolicy.noise) — "
                "the fused int8 kernel is the clean digital contract; "
                "noisy execution runs the composed analog dispatch")
    if p is not None and p.backend != "photonic_pallas":
        return (f"matmul backend is {p.backend!r}, the fused FFN needs "
                f"'photonic_pallas'")
    if not (isinstance(w1, QuantizedWeight)
            and isinstance(w2, QuantizedWeight)):
        return "w1/w2 not quantize-once cached (run prepare_params)"
    if not (w1.ndim == 2 and w2.ndim == 2):
        return "w1/w2 still stacked (ndim > 2), not per-layer slices"
    if not (isinstance(w1.bits, int) and isinstance(w2.bits, int)):
        return (f"w1/w2 carry stacked per-layer bits ({w1.bits}/{w2.bits}),"
                f" not a single width")
    if not (w1.bits <= 8 and w2.bits <= 8):
        return f"bit widths ({w1.bits}, {w2.bits}) above the int8 kernel max"
    return None


@register_ffn_backend("fused")
def _ffn_fused(x, w1, b1, w2, b2, p: ExecPolicy, live_rows):
    """The fused int8 photonic FFN over per-layer cached weights. Weights
    it cannot take raise with the reason (the reference falls back to the
    composed dispatch). The kernel's K-major entry reads the cache's
    K-major copies ``wt``, made with the cache entry (``layer(i)`` slices
    them)."""
    from repro_torch.kernels.fused_ffn import fused_ffn

    _no_backward_reason(p, "fused FFN", x, w1, b1, w2, b2)
    reason = _fused_ffn_ineligible_reason(w1, w2, p)
    if reason is not None:
        raise ValueError(f"the fused FFN was asked for but cannot run: "
                         f"{reason}")
    return fused_ffn(x, w1.wq, w1.scale.reshape(-1), b1,
                     w2.wq, w2.scale.reshape(-1), b2,
                     bits=(w1.bits, w2.bits), live_rows=live_rows,
                     w1t=w1.wt, w2t=w2.wt)


def ffn(x: torch.Tensor, w1, b1: torch.Tensor, w2, b2: torch.Tensor,
        policy: ExecPolicy | None = None, *,
        live_rows: int | None = None) -> torch.Tensor:
    """y = gelu(x @ w1 + b1) @ w2 + b2 under the policy; ``live_rows`` keeps
    only the first token rows (dead rows return exact zeros)."""
    p = policy or _DEFAULT
    return get_ffn_backend(p.resolve_ffn_backend())(x, w1, b1, w2, b2, p,
                                                    live_rows)
