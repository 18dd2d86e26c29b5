"""Per-layer / per-tensor bit plans and the sensitivity-driven allocator
(the reference's src/repro/core/bitalloc.py).

Opto-ViT's energy story is quantization co-designed with the photonic
substrate: early and late layers keep 8 bits, the insensitive middle drops
to 6 or 4, and every dropped bit scales the SAR-ADC / DAC / SRAM / MR
tuning energy terms roughly linearly (core/energy.py::scale_for_bits).

  * a **bit plan** is either a per-layer sequence (one width per encoder
    block, applied to all of that block's matmul weights) or a dict with
    optional ``"layers"`` / ``"default"`` keys plus per-tensor overrides
    keyed by param-path suffix (``"attn/wq"``, ``"ffn/w2"``, ...) whose
    values are an int or a per-layer sequence;
  * ``normalize_bit_plan`` canonicalizes any of those forms (and
    ``parse_bit_plan`` the CLI string forms: ``"8,6,4,8"`` or a JSON file
    path / literal); ``plan_key`` is its hashable identity
    (``ExecPolicy.bit_plan``);
  * ``resolve_bits`` gives the width of one param-tree leaf for
    ``core.backend.prepare_params``: the longest matching per-tensor
    override, else the per-layer assignment inside ``blocks``, else the
    default (patch embed, head and MGNet stay at the default);
  * ``calibrate_bit_plan`` is the allocator: each layer's matmul weights
    are requantized alone at each candidate width and that layer re-run on
    its uniform-8 input (``layer_sensitivities``: the relative MSE of its
    output against the uniform-8 output), then greedy downgrades, cheapest
    added sensitivity per saved bit first, until the plan's mean width
    meets the target.

Widths are bounded to [2, 8]: 8 bits is the MR resolution limit of the
photonic core, and ``quant_range`` rejects anything below 2. On the card
the codes are int8 at every width, so the kernels run the same work at
each.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

__all__ = ["normalize_bit_plan", "parse_bit_plan", "plan_key",
           "resolve_bits", "plan_layer_bits", "plan_mean_bits",
           "score_layer", "layer_sensitivities", "greedy_plan",
           "calibrate_bit_plan"]

_MAX_BITS = 8        # MR resolution limit of the photonic core
_MIN_BITS = 2


def _check_bits(b) -> int:
    b = int(b)
    if not _MIN_BITS <= b <= _MAX_BITS:
        raise ValueError(f"bit width {b} outside the photonic core's "
                         f"supported [{_MIN_BITS}, {_MAX_BITS}] range")
    return b


def _as_layers(v, n_layers: int) -> tuple:
    seq = tuple(_check_bits(b) for b in v)
    if len(seq) != n_layers:
        raise ValueError(f"per-layer bit sequence has {len(seq)} entries "
                         f"for {n_layers} layers")
    return seq


def normalize_bit_plan(plan, n_layers: int, default: int = 8):
    """Canonicalize a bit plan to ``{"default", "layers", "tensors"}``.

    ``plan`` is a per-layer sequence, a dict (``"layers"`` / ``"default"``
    keys + per-tensor path-suffix overrides), or an already-normalized
    plan. Returns None for an empty/None plan (uniform quantization).
    """
    if plan is None:
        return None
    if isinstance(plan, Mapping):
        layers = plan.get("layers")
        out = {
            "default": _check_bits(plan.get("default", default)),
            "layers": (None if layers is None
                       else _as_layers(layers, n_layers)),
            "tensors": {},
        }
        for key, v in plan.items():
            if key in ("layers", "default"):
                continue
            out["tensors"][str(key)] = (
                _check_bits(v) if isinstance(v, (int, float, str))
                else _as_layers(v, n_layers))
        return out
    seq = tuple(plan)
    if not seq:
        return None
    return {"default": _check_bits(default),
            "layers": _as_layers(seq, n_layers), "tensors": {}}


def parse_bit_plan(spec: str):
    """CLI form -> plan: ``"8,6,4,8"`` (per-layer), a JSON literal, or a
    path to a JSON file holding the dict form."""
    spec = spec.strip()
    if not spec:
        return None
    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    if spec.lstrip().startswith(("{", "[")):
        return json.loads(spec)
    return tuple(int(b) for b in spec.split(","))


def plan_key(plan) -> tuple | None:
    """Hashable identity of a normalized plan."""
    if plan is None:
        return None
    return (plan["default"], plan["layers"],
            tuple(sorted(plan["tensors"].items())))


def _suffix_match(pattern: str, path_names: tuple) -> bool:
    parts = tuple(p for p in pattern.split("/") if p)
    return len(parts) <= len(path_names) and \
        tuple(path_names[-len(parts):]) == parts


def resolve_bits(plan, path_names: tuple):
    """Width for the leaf at ``path_names`` (tuple of str components).

    Per-tensor overrides (longest matching path suffix) beat the per-layer
    assignment, which applies only inside the stacked ``blocks`` subtree;
    everything else gets the default. Returns an int or, for stacked block
    weights under a per-layer assignment, the per-layer tuple.
    """
    if plan is None:
        return None
    best = None
    for pattern, bits in plan["tensors"].items():
        if _suffix_match(pattern, path_names):
            if best is None or len(pattern.split("/")) > len(best[0].split("/")):
                best = (pattern, bits)
    if best is not None:
        return best[1]
    if "blocks" in path_names and plan["layers"] is not None:
        return plan["layers"]
    return plan["default"]


def plan_layer_bits(plan, n_layers: int) -> tuple:
    """Per-layer effective widths (the energy-accounting view): the
    per-layer assignment where given, else the default everywhere."""
    if plan is None:
        return (8,) * n_layers
    if plan["layers"] is not None:
        return plan["layers"]
    return (plan["default"],) * n_layers


def plan_mean_bits(plan, n_layers: int) -> float:
    lb = plan_layer_bits(plan, n_layers)
    return sum(lb) / len(lb)


# --------------------------------------------------------------------------
# sensitivity-driven allocation (the calibrator behind --bit-budget)
# --------------------------------------------------------------------------

def _slice_layer(tree, i: int, device=None):
    """Layer ``i`` of a stacked ``blocks`` subtree, moved to ``device``
    (None: where it is). A cached weight keeps layer i's own width."""
    from repro_torch.core.backend import QuantizedWeight

    if isinstance(tree, dict):
        return {k: _slice_layer(v, i, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight):
        w = tree.layer(i)
        return w if device is None else w.to(device)
    return tree[i] if device is None else tree[i].to(device)


def _scoring_policy(policy):
    """The policy the layers are scored under: the caller's backends with
    ``quant_bits=0``, so a layer probed at a candidate width defers to its
    cache instead of reading as a stale one (``_weight_bits``)."""
    from repro_torch.core.backend import ExecPolicy

    return ExecPolicy(quant_bits=0, backend=policy.backend,
                      attn_backend=policy.attn_backend,
                      ffn_backend=policy.ffn_backend, training=False)


def score_layer(x, raw_layer: dict, cfg, policy, candidates: tuple,
                default: int = 8):
    """One layer's scores on its input ``x`` (B, n, d): returns (its
    output at ``default``, ``{bits: relative output MSE}`` for each
    candidate). ``raw_layer`` is the layer's raw weights on ``x``'s
    device; ``policy`` the scoring policy. Each score is
    mean((out - ref)^2) / (mean(ref^2) + 1e-12) in f32."""
    import torch

    from repro_torch.core.backend import prepare_params
    from repro_torch.models.vit import encoder_layer_step

    ref = encoder_layer_step(x, prepare_params(raw_layer, bits=default),
                             cfg, policy)
    ref32 = ref.float()
    denom = float(torch.mean(ref32 * ref32)) + 1e-12
    scores = {}
    for cb in candidates:
        out = encoder_layer_step(x, prepare_params(raw_layer, bits=cb), cfg,
                                 policy)
        err = out.float() - ref32
        scores[cb] = float(torch.mean(err * err)) / denom
    return ref, scores


def layer_sensitivities(params, tokens, cfg, policy,
                        candidates: tuple = (6, 4),
                        default: int = 8) -> dict:
    """``{(layer, bits): relative output MSE}`` of requantizing one layer's
    matmul weights at ``bits`` while every other layer stays at
    ``default`` (``score_layer``, on the layer's uniform-``default``
    input).

    ``params`` are the raw (un-prepared) weights, on any device; ``tokens``
    a position-embedded batch (B, k, d) on the device the layers run on.
    One layer at a time is moved there and prepared, at ``default`` and at
    each candidate; ``policy``'s backends score it with ``quant_bits=0``.
    """
    import torch

    policy = _scoring_policy(policy)
    candidates = tuple(sorted({_check_bits(b) for b in candidates},
                              reverse=True))
    dev = tokens.device
    b, _, d = tokens.shape
    cls = (params["cls"].to(dev).expand(b, 1, d)
           + params["pos"].to(dev)[:, :1])
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    sens: dict = {}
    for i in range(cfg.n_layers):
        x, scores = score_layer(x, _slice_layer(params["blocks"], i, dev),
                                cfg, policy, candidates, default)
        sens.update({(i, cb): v for cb, v in scores.items()})
    return sens


def greedy_plan(sens: dict, n_layers: int, target_mean_bits: float,
                candidates: tuple = (6, 4), default: int = 8) -> tuple:
    """Greedy downgrades from uniform ``default``: each step moves one
    layer one candidate down, the move with the least added sensitivity
    per saved bit (ties to the lowest layer index), until the plan's mean
    width is <= ``target_mean_bits`` or every layer is at the floor."""
    candidates = tuple(sorted({_check_bits(b) for b in candidates},
                              reverse=True))
    plan = [default] * n_layers
    while sum(plan) / n_layers > target_mean_bits:
        best = None
        for i in range(n_layers):
            lower = [cb for cb in candidates if cb < plan[i]]
            if not lower:
                continue
            nb = lower[0]                       # one step down at a time
            cur = sens.get((i, plan[i]), 0.0)   # the default costs 0
            cost = (sens[(i, nb)] - cur) / (plan[i] - nb)
            if best is None or cost < best[0]:
                best = (cost, i, nb)
        if best is None:                        # every layer at the floor
            break
        plan[best[1]] = best[2]
    return tuple(plan)


def calibrate_bit_plan(params, tokens, cfg, policy,
                       target_mean_bits: float,
                       candidates: tuple = (6, 4),
                       default: int = 8) -> tuple:
    """A per-layer bit plan whose mean width is <= ``target_mean_bits``
    (``layer_sensitivities`` then ``greedy_plan``). A target at or above
    ``default``, or no candidates, is the uniform plan, scored by nothing.
    Feed the result to ``prepare_params(..., bit_plan=plan)``."""
    n_layers = cfg.n_layers
    candidates = tuple(sorted({_check_bits(b) for b in candidates},
                              reverse=True))
    if not candidates or target_mean_bits >= default:
        return (default,) * n_layers
    sens = layer_sensitivities(params, tokens, cfg, policy, candidates,
                               default)
    return greedy_plan(sens, n_layers, target_mean_bits, candidates, default)
