"""Model-sharded encoder: the fused serving encode split over the "model"
ranks of a 2-D ("data", "model") serving mesh (the reference's
src/repro/models/sharded_encoder.py), in eager SPMD.

The reference traces its fused encoder inside one ``shard_map``; here
every rank of the mesh runs ``sharded_encode`` on the same flush, with its
own shard of the weights (``core.backend.place_params``):

  * attention heads are embarrassingly parallel: wq/wk/wv column-shard
    over "model" (output columns are head-major), each rank runs the
    masked flash attention kernel (B2) on its h/M heads, the merged head
    outputs are all-gathered over "model" (exact data movement) and the wo
    projection runs whole on every rank;
  * the FFN hidden dim: w1 column-shards, w2 row-shards, one exact int32
    all-reduce of the partial accumulates and the dequant epilogue (B4)
    twice a layer (``fused_ffn_sharded``: the reference's
    ``kernels/fused_ffn.py::fused_ffn_sharded``, kept here so that the
    kernel layer holds no collective over "model": its wrappers only
    reduce absmax scopes, ``collectives.scoped_absmax_scale``);
  * the batch splits over "data" whenever the flush batch divides the axis
    (otherwise every data replica encodes the whole batch) and the logits
    are all-gathered over "data". This split is the reference's batch
    placement (``StreamServer._place`` + the shard_map in_spec): every
    rank holds the whole flush, since the gate, embed and routing run
    replicated.

Parity is a construction, as in the reference: every per-launch activation
absmax scope is widened to the global tensor
(``collectives.replicated_absmax_scale``; max is exact), the FFN's int32
reduction is exact, and every dequant runs where the unsharded encode runs
it: the projections and the head inside the photonic matmul kernel (B1,
``_pallas_proj``), the FFN's in B4 after the accumulate, as in the
reference's XLA twin ``fused_ffn_xla``. Every other op is row- or
column-local, so each rank computes bit-identical slices of the arrays of
the unsharded encode with the FFN's twin: on the CPU the sharded logits
equal ``models.vit.encode_tokens``'s bitwise. On the card the unsharded
encode runs the fused FFN kernel (B3), which the reference holds to one
quant step against its twin. A Python loop over layer views takes the
place of the reference's ``lax.scan``.
"""

from __future__ import annotations

import collections
import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.core.backend import ExecPolicy, _resolve_wq, _weight_bits
from repro_torch.distributed import collectives
from repro_torch.kernels.flash_attention import flash_attention_masked
from repro_torch.kernels.fused_ffn import (bits_pair, dequant_epilogue,
                                          ffn_twin, int_accumulate)
from repro_torch.kernels.photonic_matmul import photonic_matmul_int8
from repro_torch.models.layers import layer_view, layernorm

__all__ = ["sharded_encode", "sharded_encode_ineligible_reason",
           "sharded_encode_calls", "int8_linear_sharded",
           "fused_ffn_sharded"]

_SCALE_AXES = ("data", "model")

# "encode" -> sharded encodes run by this process
_CALLS: collections.Counter = collections.Counter()


def sharded_encode_calls() -> int:
    """How many sharded encodes this process ran: a serving run reads it
    to prove the sharded path (not an unsharded one) served its flushes."""
    return _CALLS["encode"]


def _pallas_proj(x2: torch.Tensor, weights: list, *, bits: int,
                 group) -> list[torch.Tensor]:
    """``ops.photonic_matmul_prequant`` with the per-launch activation
    absmax scope widened from this rank's rows to the global tensor
    (``replicated_absmax_scale``: a MAX all-reduce, exact). One scale and
    one set of codes feed every cached weight in ``weights``: the same
    numbers as quantizing per weight at equal ``bits``. Per-column outputs
    are independent in the kernel, so with a column shard of a weight the
    result is bitwise that column slice of the unsharded call.

    x2 (M, K) f32; each weight a ``QuantizedWeight`` ((K, N) int8 codes,
    (1, N) f32 scale, (N, K) K-major copy). Returns one (M, N) f32 per
    weight."""
    sx = collectives.replicated_absmax_scale(x2, bits, group)
    xq = quant.quantize(x2, sx, bits=bits)
    return [photonic_matmul_int8(xq, w.wq, sx, w.scale.reshape(-1), wt=w.wt)
            for w in weights]


def int8_linear_sharded(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                        *, bits: int, scale_group,
                        psum_group=None) -> torch.Tensor:
    """``kernels.fused_ffn.int8_linear_xla`` on one rank of a sharded launch
    (the reference's ``_int8_linear_sharded``): the activation absmax is
    all-reduced (MAX) over ``scale_group``, so every rank quantizes with
    the scale of the whole launch, and with ``psum_group`` the row-sharded
    partial accumulates are summed exactly in int32 before the B4 dequant.
    With wq a column shard (no psum) the result is this rank's columns of
    the whole result; with wq a row shard + psum it is the whole
    contraction."""
    sx = collectives.replicated_absmax_scale(x2, bits, scale_group)
    xq = quant.quantize(x2, sx, bits=bits)
    acc = int_accumulate(xq, wq)
    if psum_group is not None:
        acc = collectives.exact_int_psum(acc, psum_group)
    return dequant_epilogue(acc, sx, sw.contiguous())


def fused_ffn_sharded(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
                      b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
                      b2: torch.Tensor, *, bits=8,
                      live_rows: int | None = None, model_group,
                      scale_group) -> torch.Tensor:
    """``kernels.fused_ffn.fused_ffn_xla`` on one rank of the "model" axis
    (the reference's ``fused_ffn_sharded``). Per-rank operands: w1q (d_in,
    d_ff/M) columns with sw1, b1 (d_ff/M,); w2q (d_ff/M, d_out) rows with
    the whole sw2, b2 (d_out,). The hidden state stays column-sharded
    (each rank runs the GELU on its own d_ff slice); the traffic between
    ranks is two scalar MAX all-reduces over ``scale_group`` (every group
    the token rows are split over, "model" included) and one int32 SUM
    all-reduce of the w2 partial accumulates over ``model_group``. Every
    float op then sees the inputs of the unsharded ``fused_ffn_xla``, so
    the result is bitwise equal to it on the whole operands."""
    return ffn_twin(
        x, w1q, sw1, b1, w2q, sw2, b2, bits_pair(bits), live_rows,
        functools.partial(int8_linear_sharded, scale_group=scale_group),
        functools.partial(int8_linear_sharded, scale_group=scale_group,
                          psum_group=model_group))


def _encoder_bits(params: dict, policy: ExecPolicy) -> dict[str, int]:
    """Per-weight bit widths of the sharded encode. Raises ValueError (the
    ineligibility reason) for a stale cache, and for a stacked weight with
    per-layer widths (a mixed bit plan): the sharded encode reads one width
    a weight for every layer. The reference then serves unsharded; the
    port raises (``StreamServer`` names this reason)."""
    blocks = params["blocks"]
    bits = {}
    for name in ("wq", "wk", "wv", "wo"):
        bits[name] = _weight_bits(blocks["attn"][name], policy)
    for name in ("w1", "w2"):
        bits[name] = _weight_bits(blocks["ffn"][name], policy)
    bits["head"] = _weight_bits(params["head"], policy)
    return bits


def sharded_encode_ineligible_reason(params: dict, cfg: ArchConfig,
                                     policy: ExecPolicy, ctx) -> str | None:
    """None when the fused encoder can additionally run model-sharded
    under ``ctx`` (callers check fused eligibility first), else a
    human-readable reason (the reference's words)."""
    if ctx is None:
        return "no sharding context installed"
    mesh = ctx.mesh
    axes = tuple(mesh.axis_names)
    if axes != ("data", "model"):
        return (f"mesh axes {axes!r} are not the 2-D ('data', 'model') "
                f"serving layout (launch.mesh.make_serving_mesh(model=M))")
    m = mesh.shape["model"]
    if m < 2:
        return "model axis has size 1 — nothing to shard"
    if cfg.n_heads % m:
        return (f"n_heads={cfg.n_heads} not divisible by the model axis "
                f"({m}) — heads cannot split evenly")
    if cfg.d_ff % m:
        return (f"d_ff={cfg.d_ff} not divisible by the model axis ({m}) — "
                f"the FFN hidden dim cannot split evenly")
    try:
        _encoder_bits(params, policy)
    except ValueError as e:
        return str(e)
    return None


def sharded_encode(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                   policy: ExecPolicy, patch_mask: torch.Tensor | None,
                   kv_len: int | None, ctx) -> torch.Tensor:
    """The model-sharded twin of ``models.vit.encode_tokens`` on one rank.

    ``params`` is this rank's shard (``place_params``); ``tokens`` (B, k, d)
    and ``patch_mask`` (B, k) the whole flush, the same on every rank.
    Callers (``encode_tokens``) have checked fused + sharded eligibility.
    Returns the logits (B, n_classes) of the whole flush on every rank."""
    bits = _encoder_bits(params, policy)
    mesh = ctx.mesh
    n_data = mesh.shape["data"]
    scale_group = mesh.group(_SCALE_AXES)
    model_group = mesh.group("model")
    split = tokens.shape[0] % n_data == 0
    if split:
        per = tokens.shape[0] // n_data
        tokens = tokens[mesh.d * per:(mesh.d + 1) * per]
        if patch_mask is not None:
            patch_mask = patch_mask[mesh.d * per:(mesh.d + 1) * per]
    b, _, d = tokens.shape
    h_loc = cfg.n_heads // mesh.shape["model"]
    dh = d // cfg.n_heads
    d_loc = h_loc * dh
    eps = cfg.norm_eps

    cls = params["cls"].expand(b, 1, d) + params["pos"][:, :1]
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    kmask = None
    if patch_mask is not None:
        kmask = torch.cat([patch_mask.new_ones(b, 1), patch_mask], dim=1)
    attn_kv = None if kv_len is None else int(kv_len) + 1   # + live [cls]
    for i in range(cfg.n_layers):
        lp = layer_view(params["blocks"], i)
        attn, ffn = lp["attn"], lp["ffn"]
        n = x.shape[1]
        h = layernorm(x, lp["ln1_g"], lp["ln1_b"], eps)
        x2 = h.float().reshape(-1, d)
        qkv_w = {nm: _resolve_wq(attn[nm], bits[nm])
                 for nm in ("wq", "wk", "wv")}
        if bits["wq"] == bits["wk"] == bits["wv"]:
            qkv = _pallas_proj(x2, list(qkv_w.values()), bits=bits["wq"],
                               group=scale_group)
        else:
            qkv = [_pallas_proj(x2, [w], bits=bits[nm],
                                group=scale_group)[0]
                   for nm, w in qkv_w.items()]
        # (B, h_loc, n, dh) views of the projections in, a (B, h_loc, n,
        # dh) view of a (B, n, h_loc, dh) tensor out: no copy either way
        q, k, v = (t.to(h.dtype).reshape(b, n, h_loc, dh).permute(0, 2, 1, 3)
                   for t in qkv)
        o = flash_attention_masked(q, k, v, kmask, kv_len=attn_kv)
        merged = o.permute(0, 2, 1, 3).reshape(b, n, d_loc)
        # exact data movement: every rank assembles the whole head-major
        # (b, n, d) activation, then runs the whole wo projection (its
        # dequant runs inside B1, so a row split would need an int32
        # all-reduce between accumulate and dequant)
        full = collectives.all_gather_cat(merged, model_group, dim=2)
        ao = _pallas_proj(full.float().reshape(-1, d),
                          [_resolve_wq(attn["wo"], bits["wo"])],
                          bits=bits["wo"], group=scale_group)[0]
        x = x + ao.reshape(b, n, d).to(full.dtype).to(x.dtype)
        h2 = layernorm(x, lp["ln2_g"], lp["ln2_b"], eps)
        w1, w2 = ffn["w1"], ffn["w2"]
        x = x + fused_ffn_sharded(
            h2, w1.wq, w1.scale.reshape(-1), ffn["b1"], w2.wq,
            w2.scale.reshape(-1), ffn["b2"], bits=(bits["w1"], bits["w2"]),
            live_rows=attn_kv, model_group=model_group,
            scale_group=scale_group)
    x = layernorm(x, params["final_ln_g"], params["final_ln_b"], eps)
    logits = _pallas_proj(x[:, 0].float(),
                          [_resolve_wq(params["head"], bits["head"])],
                          bits=bits["head"], group=scale_group)[0]
    logits = logits.to(x.dtype)
    if split:
        logits = collectives.all_gather_cat(logits, mesh.group("data"), dim=0)
    _CALLS["encode"] += 1
    return logits
