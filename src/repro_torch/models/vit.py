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

Training: under a training policy (``ExecPolicy.training``) with raw
float params that need gradients, ``forward_vit`` is differentiable end
to end through the composed entries (qat's straight-through fake quant,
xla attention, xla FFN); it never reaches a weight cache or a graph (a
``QuantizedWeight`` met by activations that need a gradient raises, and
``models/api.py::loss_fn`` refuses one anywhere in its tree,
``check_training_tree``),
and ``cfg.remat`` checkpoints each encoder layer
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint``: values are unchanged.

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

On a mesh, serving (``training=False``), as the reference serves: on a
("data", "model") mesh whose "model" axis has more than one rank,
``encode_tokens`` on the fused serving point runs the model-sharded
encoder (models/sharded_encoder.py) under any table, on the cache
``serving_cache`` places by ``vit_logical_axes`` under ``MODEL_RULES``
(the reference's shard_map has its own specs); weights held as a
training state's blocks are gathered first (``launch.steps.gather_tree``),
so every scale is the whole weight's. Every other serving forward (the fused
point on the 1-D data mesh or on the pod mesh, every policy off it:
composed, and calibrated noise) runs the data-split encode
(``_data_split_encode``): each rank encodes its rows of the batch along
the batch axes ("data", or ("pod", "data")) on whole weights,
replicated over "model", with every per-launch absmax scope MAX-reduced
over those axes, every noisy readout drawn at the rank's block of the
whole launch's draw, and the logits all-gathered in rank order; the
patch embed and MGNet's gate run whole on every rank.

On a mesh, training (a training policy off the fused point: the
composed entries, the reference's ``vit_logical_axes`` under GSPMD) runs
SPMD: each rank holds its rows of the batch ("batch" over the batch
axes) and its blocks of the params as ``vit_placement_axes`` places
them, and the whole forward (the patch embed, MGNet's gate, the trunk,
the head) runs inside the absmax scope of the whole mesh
(``sharding.mesh_scope``), so every fake-quant scale is the global
batch's, as GSPMD's. Under a "model" split of the
heads ("p_heads") the input goes through ``collectives.copy_to_model``,
wq / wk / wv give this rank's heads, and their merged outputs are
all-gathered over "model" before the whole wo
(``collectives.gather_from_model``: its backward is this rank's slice);
under a split of d_ff ("p_mlp") w1 is column- and w2 row-parallel
(``ffn.mlp``); LN, wo, cls, pos, the head and MGNet stay whole on every
"model" rank. Under FSDP ("p_embed" over the batch axes) each layer's
leaves, the patch embed's and the head are gathered where they are used
(``layers.fsdp_layer``; the gather's backward is the reduce-scatter
mean). A remat's recompute re-enters the context and the scope
(``sharding.bound``). Noisy training on a mesh raises (ROADMAP.md queue
A, item 1).
"""

from __future__ import annotations

import collections
import contextlib

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mgnet as mgnet_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core.decomposed_attention import (attention_heads,
                                                   mhsa_decomposed,
                                                   mhsa_standard)
from repro_torch.core.mgnet import MGNetConfig, mgnet_scores, patchify
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (absmax_scope, axis_size,
                                              bound, check_model_rules,
                                              current_ctx, mesh_scope,
                                              split_of)
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import sharded_encoder
from repro_torch.models.layers import (ExecPolicy, QuantizedWeight, fsdp_layer,
                                       layernorm, layer_view, linear)

__all__ = ["embed_patches", "encoder_layer_step", "encode_tokens",
           "forward_vit", "forward_vit_tokens", "forward_vit_masked",
           "vit_matmul_shapes", "mgnet_config", "vit_logical_axes",
           "vit_layer_axes", "vit_splits", "vit_placement_axes",
           "data_split_calls", "serving_cache",
           "check_training_tree"]

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


# logical axes of the patch embed's and the head's leaves
_PATCH_AXES = {"w": (None, "p_embed"), "b": ("p_embed",)}
_HEAD_AXES = {"head": ("p_embed", None)}


def vit_layer_axes() -> dict:
    """Logical axes of one encoder layer's leaves (``vit_logical_axes``'s
    blocks without "p_layers"). wq/wk/wv output columns are head-major, so
    a "model" mesh axis splits them into whole head groups; wo is
    deliberately not tagged on its head-major rows: the sharded encoder
    consumes it whole after all-gathering the merged head outputs (its
    dequant runs inside the photonic matmul kernel, so a row split could
    not reduce the int32 accumulates before the dequant), and the
    composed mesh trunk does the same."""
    return {"ln1_g": (None,), "ln1_b": (None,),
            "attn": {"wq": ("p_embed", "p_heads"),
                     "wk": ("p_embed", "p_heads"),
                     "wv": ("p_embed", "p_heads"), "wo": (None, "p_embed")},
            "ln2_g": (None,), "ln2_b": (None,),
            "ffn": ffn_mod.mlp_logical_axes()}


def vit_logical_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every param leaf (stacked ``blocks`` leaves lead with
    "p_layers"; one layer's are ``vit_layer_axes``)."""
    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("p_layers",) + tuple(tree)

    ax = {"patch_embed": dict(_PATCH_AXES),
          "cls": (None, None, None), "pos": (None, None, None),
          "blocks": stacked(vit_layer_axes()),
          "final_ln_g": (None,), "final_ln_b": (None,),
          "head": _HEAD_AXES["head"]}
    if cfg.mgnet:
        ax["mgnet"] = mgnet_mod.mgnet_logical_axes()
    return ax


def vit_splits(cfg: ArchConfig) -> tuple:
    """(heads, d_ff, d_model) splits of the installed context
    (``sharding.split_of`` of "p_heads" over the head count, "p_mlp" over
    d_ff, "p_embed" over d_model, the FSDP split): None where a dim stays
    whole. Read once a forward and passed down, so a remat's recompute
    sees the forward's."""
    return (split_of("p_heads", cfg.n_heads), split_of("p_mlp", cfg.d_ff),
            split_of("p_embed", cfg.d_model))


def vit_placement_axes(cfg: ArchConfig, axes: dict | None = None) -> dict:
    """``axes`` (default ``vit_logical_axes``; a train state's tree too)
    with the axes the installed context cannot split dropped: "p_heads"
    where the model axis does not divide the heads (it may divide wq's
    columns all the same), "p_mlp" where it does not divide d_ff, and
    "p_embed" where the FSDP axes do not divide d_model."""
    drop = {ax for ax, split in zip(("p_heads", "p_mlp", "p_embed"),
                                    vit_splits(cfg)) if split is None}

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return tuple(None if a in drop else a for a in t)
    return walk(vit_logical_axes(cfg) if axes is None else axes)


def embed_patches(params: dict, images: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy | None = None) -> torch.Tensor:
    """images (B, H, W, 3) -> position-embedded patch tokens (B, N, d). The
    pos table is added before any pruning, so gathered subsets keep their
    positions. Under an FSDP split the composed mesh trunk gathers the
    patch embed first; every other forward holds it whole."""
    policy = policy or ExecPolicy.from_cfg(cfg)
    pt = patchify(images, cfg.patch)                      # (B, N, p*p*3)
    split = split_of("p_embed", cfg.d_model)
    if split is not None and not _trunk(params, cfg, policy):
        split = None
    pe = fsdp_layer(params["patch_embed"], _PATCH_AXES, split, cfg.d_model)
    x = linear(pt, pe["w"], pe["b"], policy)
    return x + params["pos"][:, 1: x.shape[1] + 1]


def _split_attention(h: torch.Tensor, p: dict, cfg: ArchConfig,
                     policy: ExecPolicy, mask, kv_len, split) -> torch.Tensor:
    """The standard MHSA on this rank's heads (``split``): the input's
    gradient summed over "model", the merged heads all-gathered over it
    (backward: this rank's slice) before the whole wo."""
    if cfg.attn_impl != "standard":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (Eq. 2) under a 'model' split of "
            f"the heads: the composed mesh trunk runs the standard dataflow")
    x = collectives.copy_to_model(h, split.group)
    o = attention_heads(x, p, cfg.n_heads // split.n, policy, mask, kv_len)
    o = collectives.gather_from_model(o, split.group, -1)
    return linear(o, p["wo"], policy=policy)


def encoder_layer_step(carry: torch.Tensor, lp: dict, cfg: ArchConfig,
                       policy: ExecPolicy,
                       mask: torch.Tensor | None = None,
                       attn_kv: int | None = None,
                       ffn_live: int | None = None,
                       splits: tuple | None = None) -> torch.Tensor:
    """One encoder layer: LN -> MHSA (standard, or Eq. 2 under
    ``attn_impl="decomposed"``) -> residual -> LN -> FFN -> residual.
    ``lp`` is one layer's param slice; ``splits`` the mesh trunk's
    ``vit_splits`` (this rank's heads, d_ff and FSDP blocks), None
    unsharded. ``lp``'s FSDP blocks are gathered here, so a remat's
    recompute gathers again."""
    heads, mlp, fsdp = splits or (None, None, None)
    if fsdp is not None:
        lp = fsdp_layer(lp, vit_layer_axes(), fsdp, cfg.d_model)
    h = layernorm(carry, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    if heads is None:
        mhsa = (mhsa_decomposed if cfg.attn_impl == "decomposed"
                else mhsa_standard)
        o = mhsa(h, lp["attn"], cfg.n_heads, policy, mask, attn_kv)
    else:
        o = _split_attention(h, lp["attn"], cfg, policy, mask, attn_kv, heads)
    carry = carry + o.to(carry.dtype)
    h2 = layernorm(carry, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
    return carry + ffn_mod.mlp(lp["ffn"], h2, policy, live_rows=ffn_live,
                               split=mlp)


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


def check_training_tree(params) -> None:
    """A training tree holds raw float tensors: a ``QuantizedWeight`` in
    it is an error (train on the raw weights, then ``prepare_params``)."""
    if isinstance(params, dict):
        for k, v in params.items():
            if isinstance(v, QuantizedWeight):
                raise ValueError(
                    f"params[{k!r}] is a QuantizedWeight in a training "
                    f"tree; train on the raw float params and run "
                    f"prepare_params on the result")
            check_training_tree(v)


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

    On a mesh (``_mesh_route``): on a ("data", "model") mesh with model
    > 1 the fused point's encode runs model-sharded (``sharded_encoder.
    sharded_encode``) on this rank's shard of the cache
    (``serving_cache``), under any table; if that path cannot run, this
    raises with the reason (the reference warns once and falls back).
    Every other serving policy (the fused point on the 1-D data mesh or
    the pod mesh, any policy off it, noise included) runs the data-split
    encode over the batch axes (``_data_split_encode``) on whole weights:
    ``tokens`` are the whole flush and the logits the whole flush's. A
    training policy off the fused point runs the composed mesh trunk (the
    module docstring): ``tokens`` are then this rank's rows and the
    logits its rows'.
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
    route = _mesh_route(params, cfg, policy, ctx)
    if route == "trunk":
        with mesh_scope():
            return _encode_local(params, tokens, cfg, policy, patch_mask,
                                 kv_len, vit_splits(cfg))
    if route == "sharded":
        return sharded_encoder.sharded_encode(params, tokens, cfg, policy,
                                              patch_mask, kv_len, ctx)
    if route == "split":
        return _data_split_encode(params, tokens, cfg, policy, patch_mask,
                                  kv_len)
    return _encode_local(params, tokens, cfg, policy, patch_mask, kv_len)


def _mesh_route(params: dict, cfg: ArchConfig, policy: ExecPolicy,
                ctx) -> str:
    """How a forward under ``ctx`` runs, as the reference's does:

      * "local": no context of more than one rank, or a serving forward
        inside a split region already (an absmax scope);
      * "trunk": a training policy off the fused point: the composed mesh
        trunk on this rank's rows and blocks (the module docstring);
      * "sharded": the fused point on a ("data", "model") mesh with model
        > 1, under any table: ``sharded_encoder.sharded_encode`` on the
        cache ``serving_cache`` places (the reference's shard_map has its
        own specs); raises where it cannot run (the reference warns and
        serves unsharded);
      * "split": every other serving forward: the data-split encode over
        the batch axes on whole weights (``_data_split_encode``), the
        reference's batch placement with the weights replicated.

    Noisy training on a mesh raises: without a noise scope the
    reference's own refusal, with one naming where it waits."""
    if ctx is None or ctx.mesh.world == 1:
        return "local"
    check_model_rules(ctx, "vit")
    fused = _fused_encoder_ineligible_reason(params, cfg, policy) is None
    if not fused and policy.training:
        if policy.noise is not None:
            if noise_mod.current_scope() is None:
                noise_mod.next_call_keys(policy.noise)    # raises
            raise NotImplementedError(
                f"a noisy ViT training forward on the mesh "
                f"{dict(ctx.mesh.shape)}: noisy training on a mesh is not "
                f"ported (it needs block draws of model-split weights and "
                f"a backward through the noisy walk; ROADMAP.md queue A, "
                f"item 1); serving policies (training=False) run noisy on "
                f"every mesh")
        return "trunk"
    if (fused and tuple(ctx.mesh.axis_names) == ("data", "model")
            and ctx.mesh.shape["model"] > 1):
        sreason = sharded_encoder.sharded_encode_ineligible_reason(
            params, cfg, policy, ctx)
        if sreason is not None:
            raise ValueError(f"the model-sharded encode cannot run: "
                             f"{sreason}")
        return "sharded"
    return "split" if ctx.absmax_group is None else "local"


def serving_cache(cache: dict, cfg: ArchConfig, policy: ExecPolicy,
                  ctx) -> dict:
    """The form of a whole prepared cache that a serving forward under
    ``ctx`` reads: this rank's "model" shard where it runs the
    model-sharded encode (placed by ``vit_logical_axes`` under
    ``MODEL_RULES``, the sharded encoder's own specs, whatever the
    context's table), else the cache itself (whole on every rank). The
    caller prepares the cache from whole weights, so every per-channel
    scale is the whole weight's: a training state's blocks go through
    ``launch.steps.gather_tree`` first."""
    if ctx is None or _mesh_route(cache, cfg, policy, ctx) != "sharded":
        return cache
    from repro_torch.core.backend import place_params
    from repro_torch.distributed.sharding import MODEL_RULES, ShardingCtx
    return place_params(cache, vit_logical_axes(cfg),
                        ShardingCtx(ctx.mesh, MODEL_RULES))


def _data_split_encode(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                       policy: ExecPolicy, patch_mask: torch.Tensor | None,
                       kv_len: int | None) -> torch.Tensor:
    """The encode split over the batch axes ("batch"'s rule: "data", or
    ("pod", "data")), the port's form of the reference's batch placement
    (``StreamServer._place``) with the weights replicated: every rank
    holds the whole flush and the whole weights; the rank at block j of
    the batch axes (``Split.index``, p D + d on the pod mesh) encodes rows
    [j B/n, (j+1) B/n) inside an absmax scope over their group, so each
    launch quantizes with the scale of the whole flush (the reference's
    GSPMD reduces every absmax over the global array) and each noisy
    readout draws its block of the whole launch's draw (``absmax_scope``'s
    block, ``core.noise.readout_noise``); the logits are all-gathered in
    rank order. "model" ranks compute the same rows. Every other op is
    row-local, so the result is the unsplit encode's arithmetic. A batch
    that does not divide n is encoded whole on every rank, with no
    collective and every draw at offset 0 (each scope is then the whole
    flush already)."""
    n = axis_size("batch")
    split = split_of("batch", tokens.shape[0])
    if split is None:
        if n > 1:
            _DATA_CALLS["whole"] += 1
        return _encode_local(params, tokens, cfg, policy, patch_mask, kv_len)
    lo, hi = split.block(tokens.shape[0])
    with absmax_scope(split.group, split.index):
        logits = _encode_local(params, tokens[lo:hi], cfg, policy,
                               None if patch_mask is None
                               else patch_mask[lo:hi], kv_len)
    _DATA_CALLS["split"] += 1
    return collectives.all_gather_cat(logits, split.group, dim=0)


def _encode_local(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  policy: ExecPolicy, patch_mask: torch.Tensor | None,
                  kv_len: int | None, splits: tuple | None = None
                  ) -> torch.Tensor:
    """The encoder trunk on this rank's tokens -> logits: unsharded, or
    the composed mesh trunk on this rank's blocks (``splits``, the
    ``vit_splits`` of the installed context)."""
    b, _, d = tokens.shape
    cls = params["cls"].expand(b, 1, d) + params["pos"][:, :1]
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    mask = None
    if patch_mask is not None:
        mask = torch.cat([patch_mask.new_ones(b, 1), patch_mask], dim=1)
    attn_kv = None if kv_len is None else int(kv_len) + 1   # + live [cls]
    if policy.noise is None and cfg.remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        step = bound(encoder_layer_step)
        for i in range(cfg.n_layers):
            x = checkpoint(step, x, layer_view(params["blocks"], i), cfg,
                           policy, mask, attn_kv, attn_kv, splits,
                           use_reentrant=False)
    elif policy.noise is None:
        for i in range(cfg.n_layers):
            x = encoder_layer_step(x, layer_view(params["blocks"], i), cfg,
                                   policy, mask, attn_kv, attn_kv, splits)
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
    head = fsdp_layer({"head": params["head"]}, _HEAD_AXES,
                      None if splits is None else splits[2], cfg.d_model)
    return linear(x[:, 0], head["head"], policy=policy)


def forward_vit(params: dict, images: torch.Tensor, cfg: ArchConfig,
                policy: ExecPolicy | None = None, *, device=None):
    """images (B, H, W, 3) -> (logits (B, n_classes), kept_patches int).

    With cfg.mgnet, MGNet scores patches and a static top-k budget of
    int(keep_ratio * N) enters the encoder (the paper's masked inference).
    On a mesh off the fused point (the composed mesh trunk) ``images``
    are this rank's rows, and the whole forward, MGNet's gate included,
    runs inside the mesh's absmax scope.
    """
    dev = resolve_device(device)
    _check_device(params, dev)
    images = torch.as_tensor(images).to(dev)
    policy = policy or ExecPolicy.from_cfg(cfg)
    trunk = _trunk(params, cfg, policy)
    with mesh_scope() if trunk else contextlib.nullcontext():
        x = embed_patches(params, images, cfg, policy)
        n = x.shape[1]
        kept = n
        if cfg.mgnet and cfg.mgnet_keep_ratio < 1.0:
            scores = mgnet_scores(params["mgnet"], images, mgnet_config(cfg),
                                  policy.gate_policy())
            kept = max(1, int(cfg.mgnet_keep_ratio * n))
            x, _ = mgnet_mod.select_topk_patches(scores, x, kept)
        return encode_tokens(params, x, cfg, policy, device=dev), kept


def _trunk(params: dict, cfg: ArchConfig, policy: ExecPolicy) -> bool:
    """Whether a forward under the installed context runs the composed
    mesh trunk (``_mesh_route``), inside the mesh's absmax scope."""
    return _mesh_route(params, cfg, policy, current_ctx()) == "trunk"


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
    trunk = _trunk(params, cfg, policy)
    with mesh_scope() if trunk else contextlib.nullcontext():
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
