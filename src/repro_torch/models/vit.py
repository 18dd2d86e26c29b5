"""Vision Transformer backbone + Opto-ViT serving path (the reference's
src/repro/models/vit.py).

Every matmul routes through ``linear`` (core/backend.py's matmul registry:
bf16 | qat | photonic_sim | photonic_pallas), every attention core through
``attend`` (xla materialized scores | the RoI-masked flash attention
kernel) and every GELU-MLP through ``ffn`` (xla composed two-linear | the
fused int8 FFN kernel), as the policy names them. On the fully fused
serving point (photonic_pallas + flash + fused over a cache of <= 8-bit
weights) each layer is the fused attention branch plus the fused FFN;
every other combination runs the composed dispatch, and the Eq. 2
decomposed attention dataflow runs with ``attn_impl="decomposed"``. A
fused block asked for with params it cannot take raises with the reason,
where the reference warns once and composes.

Stacked layer weights keep their leading L axis (as the reference's scan
stacks them); a Python loop over layers slices one layer per step in
place of ``lax.scan``. Under a mixed-precision bit plan each layer's
slice carries its own int widths (``QuantizedWeight.layer``): the loop is
the port's counterpart of the reference's segmented scan over equal-bits
runs.

MGNet RoI pruning: patches are scored by MGNet and only the top-k
(static budget int(keep_ratio * N)) enter encoder block 0; the [cls]
token is always kept. ``forward_vit_masked`` is the mask-mode dense
baseline: all N patches enter, the mask removes dropped ones from every
attention key axis.

Under calibrated device noise (``policy.noise``) the encode runs inside
the caller's noise scope (``core.noise.noise_scope``) and numbers its
noisy call sites as the reference's traces do: the reference scans each
run of equal bit widths (``_bit_segments``) with one traced body, so every
layer of a run draws with the same call counters, salted by its global
index, and the counter moves on by one body's calls a run; the head takes
the next. The MGNet gate scores under ``policy.gate_policy()`` (clean
unless the spec's ``noisy_gate``).

Under a sharding context whose "model" axis has more than one rank,
``encode_tokens`` runs the model-sharded encoder
(models/sharded_encoder.py) instead; ``vit_logical_axes`` names the axes
``core.backend.place_params`` shards the params by. Under the 1-D
("data",) mesh it runs the data-split encode (``_data_split_encode``):
each rank encodes its rows of the batch on the replicated params, with
every per-launch absmax scope MAX-reduced over "data", and the logits
are all-gathered.
"""

from __future__ import annotations

import collections

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mgnet as mgnet_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core.decomposed_attention import (mhsa_decomposed,
                                                   mhsa_standard)
from repro_torch.core.mgnet import MGNetConfig, mgnet_scores, patchify
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import absmax_scope, current_ctx
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import sharded_encoder
from repro_torch.models.layers import (ExecPolicy, QuantizedWeight, layernorm,
                                       layer_view, linear)

__all__ = ["embed_patches", "encoder_layer_step", "encode_tokens",
           "forward_vit", "forward_vit_tokens", "forward_vit_masked",
           "vit_matmul_shapes", "mgnet_config", "vit_logical_axes",
           "data_split_calls"]

# "split" -> data-split encodes run by this process with the batch split
# over "data"; "whole" -> those that encoded the whole batch on every rank
_DATA_CALLS: collections.Counter = collections.Counter()


def data_split_calls() -> dict:
    """How many data-mesh encodes this process ran, split and whole: a
    serving run reads it to prove which path served its flushes."""
    return {"split": _DATA_CALLS["split"], "whole": _DATA_CALLS["whole"]}


def _n_patches(cfg):
    return (cfg.img_size // cfg.patch) ** 2


def mgnet_config(cfg: ArchConfig) -> MGNetConfig:
    return MGNetConfig(patch=cfg.patch, img_size=cfg.img_size,
                       embed=cfg.mgnet_embed, heads=cfg.mgnet_heads)


def vit_logical_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every param leaf (stacked ``blocks`` leaves lead with
    "p_layers"). wq/wk/wv output columns are head-major, so a "model" mesh
    axis splits them into whole head groups; wo is deliberately not tagged
    on its head-major rows: the sharded encoder consumes it whole after
    all-gathering the merged head outputs (its dequant runs inside the
    photonic matmul kernel, so a row split could not reduce the int32
    accumulates before the dequant)."""
    layer = {"ln1_g": (None,), "ln1_b": (None,),
             "attn": {"wq": ("p_embed", "p_heads"),
                      "wk": ("p_embed", "p_heads"),
                      "wv": ("p_embed", "p_heads"), "wo": (None, "p_embed")},
             "ln2_g": (None,), "ln2_b": (None,),
             "ffn": ffn_mod.mlp_logical_axes()}

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("p_layers",) + tuple(tree)

    ax = {"patch_embed": {"w": (None, "p_embed"), "b": ("p_embed",)},
          "cls": (None, None, None), "pos": (None, None, None),
          "blocks": stacked(layer),
          "final_ln_g": (None,), "final_ln_b": (None,),
          "head": ("p_embed", None)}
    if cfg.mgnet:
        ax["mgnet"] = mgnet_mod.mgnet_logical_axes()
    return ax


def embed_patches(params: dict, images: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """images (B, H, W, 3) -> position-embedded patch tokens (B, N, d). The
    pos table is added before any pruning, so gathered subsets keep their
    positions."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    pt = patchify(images, cfg.patch)                      # (B, N, p*p*3)
    x = linear(pt, params["patch_embed"]["w"], params["patch_embed"]["b"],
               policy)
    return x + params["pos"][:, 1: x.shape[1] + 1]


def encoder_layer_step(carry: torch.Tensor, lp: dict, cfg: ArchConfig,
                       policy: ExecPolicy,
                       mask: torch.Tensor | None = None,
                       attn_kv: int | None = None,
                       ffn_live: int | None = None) -> torch.Tensor:
    """One encoder layer: LN -> MHSA (standard, or Eq. 2 under
    ``attn_impl="decomposed"``) -> residual -> LN -> FFN -> residual.
    ``lp`` is one layer's param slice."""
    h = layernorm(carry, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    mhsa = (mhsa_decomposed if cfg.attn_impl == "decomposed"
            else mhsa_standard)
    o = mhsa(h, lp["attn"], cfg.n_heads, policy, mask, attn_kv)
    carry = carry + o.to(carry.dtype)
    h2 = layernorm(carry, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
    return carry + ffn_mod.mlp(lp["ffn"], h2, policy, live_rows=ffn_live)


def _blocks_qw_leaves(blocks) -> list:
    """The cached (QuantizedWeight) leaves of the stacked blocks."""
    if isinstance(blocks, dict):
        return [q for v in blocks.values() for q in _blocks_qw_leaves(v)]
    return [blocks] if isinstance(blocks, QuantizedWeight) else []


def _bit_segments(blocks, n_layers: int) -> list[tuple[int, int]]:
    """[lo, hi) runs of consecutive layers whose cached widths agree on
    every cached leaf: the units the reference's segmented scan traces
    once each. A cache without per-layer widths is one run."""
    leaves = _blocks_qw_leaves(blocks)
    if not any(isinstance(a.bits, tuple) for a in leaves):
        return [(0, n_layers)]
    sig = [tuple(a.layer_bits(i) for a in leaves) for i in range(n_layers)]
    segs, lo = [], 0
    for i in range(1, n_layers + 1):
        if i == n_layers or sig[i] != sig[lo]:
            segs.append((lo, i))
            lo = i
    return segs


def _fused_encoder_ineligible_reason(params: dict, cfg: ArchConfig,
                                     policy: ExecPolicy) -> str | None:
    """None when the encoder can run the fused serving point (int8 photonic
    matmuls + flash attention + fused FFN, standard dataflow, every
    per-layer matmul weight cached at 2-8 bits, uniform or under a
    per-layer bit plan); else why not, calibrated device noise first."""
    if policy.noise is not None:
        return ("calibrated device noise is active (ExecPolicy.noise) — "
                "the fused encoder is the clean digital contract; noisy "
                "execution runs the composed analog dispatch")
    triple = (policy.backend, policy.resolve_attn_backend(),
              policy.resolve_ffn_backend())
    if triple != ("photonic_pallas", "flash", "fused"):
        return (f"backends {triple} are not the fused serving triple "
                f"('photonic_pallas', 'flash', 'fused')")
    if cfg.attn_impl != "standard":
        return f"attn_impl {cfg.attn_impl!r} (fused path needs 'standard')"
    blocks = params.get("blocks")
    if not isinstance(blocks, dict):
        return "params['blocks'] missing or not a dict"
    try:
        ws = ([blocks["attn"][n] for n in ("wq", "wk", "wv")]
              + [blocks["ffn"][n] for n in ("w1", "w2")])
    except (KeyError, TypeError):
        return "blocks missing attn/ffn weight entries"
    if not all(isinstance(w, QuantizedWeight) for w in ws):
        return "block weights not quantize-once cached (run prepare_params)"
    widths = sorted({b for w in ws for b in (
        w.bits if isinstance(w.bits, tuple) else (w.bits,))})
    if not all(2 <= b <= 8 for b in widths):
        return f"cached bit widths {widths} outside [2, 8]"
    return None


def _check_device(params: dict, dev: torch.device) -> None:
    pdev = params["pos"].device
    if pdev.type != dev.type:
        raise ValueError(f"params live on {pdev} but the call runs on {dev}; "
                         f"move them with repro_torch.bridge.to_device")


def encode_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy | None = None,
                  patch_mask: torch.Tensor | None = None,
                  kv_len: int | None = None, *, device=None) -> torch.Tensor:
    """Encoder trunk on pre-embedded patch tokens -> logits (B, n_classes).

    tokens (B, k, d) position-embedded patch tokens; the [cls] token is
    prepended here. ``patch_mask`` (B, k) removes tokens from every
    attention key axis (RoI mask mode); ``kv_len`` is the packed
    alternative (only the first ``kv_len`` patch tokens are live: the
    flash kernel skips the dead key tiles and the fused FFN the dead rows).
    Runs on ``device`` (default: the card).

    Every policy runs: the fused serving point (photonic_pallas + flash +
    fused over cached weights), or the composed dispatch its backends
    name. A fused block (the attention branch on photonic_pallas + flash,
    the fused FFN) whose weights it cannot take raises with the reason
    (the reference warns once and composes).

    Under a sharding context with a "model" axis of more than one rank
    the encode runs model-sharded (``sharded_encoder.sharded_encode``) on
    this rank's shard of the params, on the fused point only. If that
    path cannot run, this raises with the reason: the port never serves
    unsharded when sharding was asked for (the reference warns once and
    falls back). Under the 1-D ("data",) mesh it runs the data-split
    encode (``_data_split_encode``), on the fused point only too.
    """
    dev = resolve_device(device)
    _check_device(params, dev)
    tokens = torch.as_tensor(tokens).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    if patch_mask is not None and kv_len is not None:
        raise ValueError("give patch_mask or kv_len, not both")
    if patch_mask is not None:
        patch_mask = torch.as_tensor(patch_mask).to(dev)
    ctx = current_ctx()
    if ctx is not None and ctx.mesh.shape.get("model", 1) > 1:
        sreason = (_fused_encoder_ineligible_reason(params, cfg, policy)
                   or sharded_encoder.sharded_encode_ineligible_reason(
                       params, cfg, policy, ctx))
        if sreason is not None:
            raise ValueError(f"the model-sharded encode cannot run: "
                             f"{sreason}")
        return sharded_encoder.sharded_encode(params, tokens, cfg, policy,
                                              patch_mask, kv_len, ctx)
    if (ctx is not None and ctx.absmax_group is None
            and ctx.mesh.shape["data"] > 1):
        reason = _fused_encoder_ineligible_reason(params, cfg, policy)
        if reason is not None:
            raise ValueError(f"the data-split encode cannot run: {reason}")
        return _data_split_encode(params, tokens, cfg, policy, patch_mask,
                                  kv_len, ctx)
    return _encode_local(params, tokens, cfg, policy, patch_mask, kv_len)


def _data_split_encode(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       policy: ExecPolicy, patch_mask: torch.Tensor | None,
                       kv_len: int | None, ctx) -> torch.Tensor:
    """The encode on the 1-D ("data",) mesh, the port's form of the
    reference's batch placement (``StreamServer._place``): every rank holds
    the whole flush; rank d encodes rows [d B/D, (d+1) B/D) inside an
    absmax scope over "data", so each launch quantizes with the scale of
    the whole flush (the reference's GSPMD reduces every absmax over the
    global array), and the logits are all-gathered over "data" in rank
    order. Every other op is row-local, so the result is bitwise the
    unsplit encode. A batch that does not divide D is encoded whole on
    every rank, with no collective (each scope is then the whole flush
    already)."""
    mesh = ctx.mesh
    n_data = mesh.shape["data"]
    b = tokens.shape[0]
    if b % n_data:
        _DATA_CALLS["whole"] += 1
        return _encode_local(params, tokens, cfg, policy, patch_mask, kv_len)
    per = b // n_data
    rows = slice(mesh.d * per, (mesh.d + 1) * per)
    group = mesh.group("data")
    with absmax_scope(group):
        logits = _encode_local(params, tokens[rows], cfg, policy,
                               None if patch_mask is None
                               else patch_mask[rows], kv_len)
    _DATA_CALLS["split"] += 1
    return collectives.all_gather_cat(logits, group, dim=0)


def _encode_local(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy, patch_mask: torch.Tensor | None,
                  kv_len: int | None) -> torch.Tensor:
    """The unsharded encoder trunk on this rank's tokens -> logits."""
    b, _, d = tokens.shape
    cls = params["cls"].expand(b, 1, d) + params["pos"][:, :1]
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    mask = None
    if patch_mask is not None:
        mask = torch.cat([patch_mask.new_ones(b, 1), patch_mask], dim=1)
    attn_kv = None if kv_len is None else int(kv_len) + 1   # + live [cls]
    if policy.noise is None:
        for i in range(cfg.n_layers):
            x = encoder_layer_step(x, layer_view(params["blocks"], i), cfg,
                                   policy, mask, attn_kv, attn_kv)
    else:
        sc = noise_mod.current_scope()
        for lo, hi in _bit_segments(params["blocks"], cfg.n_layers):
            c0 = sc.counter if sc is not None else 0
            for i in range(lo, hi):
                if sc is not None:
                    sc.counter = c0        # one traced body per run
                with noise_mod.scope_salt(i):
                    x = encoder_layer_step(x, layer_view(params["blocks"], i),
                                           cfg, policy, mask, attn_kv,
                                           attn_kv)
    x = layernorm(x, params["final_ln_g"], params["final_ln_b"], cfg.norm_eps)
    return linear(x[:, 0], params["head"], policy=policy)


def forward_vit(params: dict, images: torch.Tensor, cfg: ArchConfig,
                policy: ExecPolicy | None = None, *, device=None):
    """images (B, H, W, 3) -> (logits (B, n_classes), kept_patches int).

    With cfg.mgnet, MGNet scores patches and a static top-k budget of
    int(keep_ratio * N) enters the encoder (the paper's masked inference).
    """
    dev = resolve_device(device)
    _check_device(params, dev)
    images = torch.as_tensor(images).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    x = embed_patches(params, images, cfg, policy)
    n = x.shape[1]
    kept = n
    if cfg.mgnet and cfg.mgnet_keep_ratio < 1.0:
        scores = mgnet_scores(params["mgnet"], images, mgnet_config(cfg),
                              policy.gate_policy())
        kept = max(1, int(cfg.mgnet_keep_ratio * n))
        x, _ = mgnet_mod.select_topk_patches(scores, x, kept)
    return encode_tokens(params, x, cfg, policy, device=dev), kept


def forward_vit_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       policy: ExecPolicy | None = None,
                       kv_len: int | None = None, *, device=None):
    """Pre-gathered token forward: tokens (B, k, d) -> (logits, kept). The
    serving path's bucketed encode: the gate and gather happened upstream."""
    kept = tokens.shape[1] if kv_len is None else kv_len
    return encode_tokens(params, tokens, cfg, policy, kv_len=kv_len,
                         device=device), kept


def forward_vit_masked(params: dict, images: torch.Tensor,
                       patch_mask: torch.Tensor, cfg: ArchConfig,
                       policy: ExecPolicy | None = None, *, device=None):
    """Mask-mode dense forward: images (B, H, W, 3), patch_mask (B, N) ->
    (logits (B, n_classes), N). All N patches enter the encoder and the
    mask removes dropped ones from every attention key axis: compute is not
    reduced. The baseline the bucketed top-k serve is measured against."""
    dev = resolve_device(device)
    _check_device(params, dev)
    images = torch.as_tensor(images).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    x = embed_patches(params, images, cfg, policy)
    return encode_tokens(params, x, cfg, policy, patch_mask,
                         device=dev), x.shape[1]


def vit_matmul_shapes(cfg: ArchConfig, kept_patches: int | None = None,
                      include_mgnet: bool = False) -> list[tuple[int, int, int]]:
    """(M, K, N) of every matmul in one ViT forward of one image.

    kept_patches: post-MGNet token count (None = all patches).
    """
    n = (kept_patches if kept_patches is not None else _n_patches(cfg)) + 1
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    n_in = 3 * cfg.patch ** 2
    shapes = [(_n_patches(cfg) if kept_patches is None else kept_patches,
               n_in, d)]                                    # patch embed
    per_layer = [
        (n, d, d), (n, d, d), (n, d, d),                    # q, k, v
        (n, d, n),                                          # scores (per-head agg)
        (n, n, d),                                          # attn @ v
        (n, d, d),                                          # out proj
        (n, d, dff), (n, dff, d),                           # mlp
    ]
    shapes += per_layer * L
    if include_mgnet:
        mcfg = mgnet_config(cfg)
        nm = mcfg.n_patches + 1
        dm = mcfg.embed
        shapes += [
            (mcfg.n_patches, 3 * mcfg.patch ** 2, dm),      # mgnet patch embed
            (nm, dm, 3 * dm), (nm, dm, nm), (nm, nm, dm), (nm, dm, dm),
            (nm, dm, 4 * dm), (nm, 4 * dm, dm),
            (1, dm, dm), (mcfg.n_patches, dm, mcfg.n_patches),  # scoring
        ]
    return shapes
