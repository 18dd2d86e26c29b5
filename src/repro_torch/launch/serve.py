"""LM serving driver: prefill the prompt into the KV cache, then decode
token by token (the reference's src/repro/launch/serve.py).

``prefill_into_cache`` steps the decode function over the prompt's
positions, as the reference's ``_prefill_scan`` does, so every prompt
token runs the flash decode kernel once per layer; ``models/api.py::
prefill_fn`` is the full-prompt forward (the causal flash attention
kernel). ``generate`` decodes greedily or samples from an explicit
``torch.Generator``. Under a sharding context both run the sharded
layers (models/transformer.py) on this rank's blocks of the params
(``transformer.place_lm_params``) and its rows of the batch and cache
(``init_cache``; under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` the cache's
sequence splits over "model" too, and the prompt's rows land on the
ranks that own them). The ranks of a "model" group pick the same tokens:
the logits are whole on each, or under a vocab split each rank's block,
of which ``generate`` takes the argmax across the group (greedy) or
gathers the whole row (sampling). ``main`` serves on
``make_host_mesh(--data-par, --model-par)``, as the reference's, starting
its ranks with ``launch/mesh.py::spawn_ranks`` (or joining torchrun's),
and checks that the ranks of each "model" group generated equal tokens.
Entry points run on the card unless the caller passes ``device="cpu"``
(the kernels' plain PyTorch versions).

The hybrid family (``--arch recurrentgemma-9b``) serves on one device and
on the host mesh under any table (each rank draws its blocks of the
weights leaf by leaf, ``bridge.init_lm(place=True)``): its cache is the
recurrent states (split on the batch and, over "model", the LRU width)
and a ring of min(window, cache len) slots per attention layer (split on
the batch, and under ``DEFAULT_RULES`` / ``MULTIPOD_RULES`` on its slots
over "model"), so ``--cache-len`` may be shorter than the prompt and the
generated tokens (positions past it overwrite the ring's oldest slots,
the reference's ring for a cache shorter than the window).

The dense family serves every config the registry ports: qwen2-1.5b,
qwen2.5-3b, stablelm-12b (head dim 160) and llama3-405b (~812 GB in
bf16: on one card it runs only as ``--smoke``, or cut in depth by a
caller, as ``chip_smoke.py``'s path 4p cuts it to its first 2 layers).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 128 --gen 32 --cache-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \\
        --batch 4 --prompt-len 128 --gen 32 --cache-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --prompt-len 128 --gen 32 --cache-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-405b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --batch 4 --prompt-len 128 --gen 32 \\
        --cache-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --model-par 2
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --smoke --device cpu --model-par 2
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import init_lm
from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.configs.registry import get_config
from repro_torch.core.backend import BACKENDS, prepare_params
from repro_torch.device import full_precision_matmuls, resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (current_ctx, named_sharding,
                                              use_sharding)
from repro_torch.launch.mesh import (init_from_env, make_host_mesh,
                                     spawn_ranks)
from repro_torch.models import api as model_api
from repro_torch.models.layers import ExecPolicy
from repro_torch.models.transformer import place_lm_params, vocab_split

__all__ = ["init_cache", "prefill_into_cache", "generate", "main"]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode cache of ``cache_axes_spec``'s shapes on ``device``
    (a hybrid's: f32 recurrent states, bf16 conv states and attention
    rings of min(window, seq_len) slots); under a sharding context this
    rank's block: its batch rows, and under a "kv_seq" split its
    seq_len / M rows of the sequence."""
    dev = resolve_device(device)
    shapes, axes = model_api.cache_axes_spec(cfg, batch, seq_len)
    ctx = current_ctx()
    if ctx is not None:
        shapes = {k: (named_sharding(s, axes[k], ctx).local_shape(s), d)
                  for k, (s, d) in shapes.items()}
    return {k: torch.zeros(s, dtype=d, device=dev)
            for k, (s, d) in shapes.items()}


def prefill_into_cache(params, cache: dict, prompt: torch.Tensor,
                       cfg: ArchConfig, policy: ExecPolicy | None = None):
    """Write the prompt (B, P) into the cache by stepping ``decode_fn``
    over positions 0..P-1. Returns (last-position logits (B, V), cache);
    the cache is filled in place (under a sequence split each rank keeps
    the prompt's rows it owns)."""
    logits = None
    for pos in range(prompt.shape[1]):
        logits, cache = model_api.decode_fn(params, cache,
                                            prompt[:, pos:pos + 1], pos, cfg,
                                            policy)
    return logits, cache


def generate(params, cache: dict, prompt: torch.Tensor, n_tokens: int,
             cfg: ArchConfig, greedy: bool = True,
             generator: torch.Generator | None = None,
             policy: ExecPolicy | None = None):
    """Prefill ``prompt`` (B, P), then decode ``n_tokens`` tokens. The first
    token comes from the prefill's logits; each decode step feeds the last
    token back. Greedy takes the argmax; otherwise tokens are sampled from
    softmax(logits) with ``generator`` (required). Positions are host ints
    and tokens stay on the device, so the loop never waits on the card.

    Returns (generated (B, n_tokens) int64, tokens/s of the decode loop).
    The cache is filled in place and holds the prompt and all ``n_tokens``
    generated tokens: the last token is fed through a decode step too, and
    that step's logits are discarded, as in the reference's generate."""
    if not greedy and generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    b, plen = prompt.shape
    vs = vocab_split(cfg)

    def pick(logits):
        if greedy:
            return _argmax(logits, vs)
        if vs is not None:
            logits = collectives.all_gather_cat(logits, vs.group, -1)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    logits, cache = prefill_into_cache(params, cache, prompt, cfg, policy)
    tok = pick(logits)
    out = []
    if prompt.is_cuda:
        torch.cuda.synchronize(prompt.device)
    t0 = time.perf_counter()
    for i in range(n_tokens):
        out.append(tok)
        logits, cache = model_api.decode_fn(params, cache, tok, plen + i, cfg,
                                            policy)
        tok = pick(logits)
    if prompt.is_cuda:
        torch.cuda.synchronize(prompt.device)
    dt = time.perf_counter() - t0
    return torch.cat(out, dim=1), (b * n_tokens) / dt if dt > 0 else 0.0


def _argmax(logits: torch.Tensor, split) -> torch.Tensor:
    """(B, 1) argmax of (B, V) logits, or under a vocab split of this
    rank's block (B, V / n): each rank's max and its global index
    gathered over the split's group, the first rank with the largest
    value taken (``argmax``'s first maximum over the whole row)."""
    if split is None:
        return logits.argmax(-1, keepdim=True)
    idx = logits.argmax(-1)
    vals = torch.gather(logits, -1, idx[:, None])[:, 0]
    mine = torch.stack([vals.float(),
                        (idx + split.index * logits.shape[-1]).float()], -1)
    every = collectives.all_gather_cat(mine[None], split.group, 0,
                                       "vocab_argmax")
    best = every[..., 0].argmax(0, keepdim=True)
    return torch.gather(every[..., 1], 0, best)[0].long()[:, None]


def _serve_ranks(cfg: ArchConfig, args) -> tuple:
    """One rank of ``main``: the host mesh, the weights (placed), this
    rank's rows of the prompt and cache, ``generate``. Returns (this
    rank's tokens, tok/s, the "model" group's tokens agree)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        full_precision_matmuls()
    mesh = make_host_mesh(args.data_par, args.model_par, device=args.device)
    policy = ExecPolicy.from_cfg(cfg, training=False)
    with use_sharding(mesh) as ctx:
        if not policy.is_photonic():
            # each rank draws its blocks, never the whole tree at once
            params = init_lm(args.seed, cfg, dev, place=True)
        else:
            params = model_api.init_model(args.seed, cfg, dev)
            # quantize-once weight cache: every matmul weight tuned before
            # serving, so a token does only activation quant + int8 matmul
            # + dequant (embeddings and norms stay as they are)
            params = prepare_params(params, bits=cfg.quant_bits or 8)
            if _rank0():
                print(f"[serve] backend={policy.backend} "
                      "(weights pre-quantized once)")
            params = place_lm_params(params, cfg)
        cache = init_cache(cfg, args.batch, args.cache_len, dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                               generator=gen, device=dev)
        prompt = named_sharding(prompt.shape, ("batch", "seq"),
                                ctx).block(prompt)
        toks, tps = generate(params, cache, prompt, args.gen, cfg,
                             policy=policy)
        agree = True
        if mesh.model > 1:
            group = collectives.all_gather_cat(toks, mesh.group("model"), 0)
            agree = all(torch.equal(t, toks) for t in group.split(
                toks.shape[0]))
    return toks.cpu(), tps, agree


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny same-family config (configs/base.py)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompt")
    ap.add_argument("--backend", default="",
                    help=f"matmul backend ({', '.join(sorted(BACKENDS))}; "
                         "empty = resolve from the config's flags)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.backend:
        if args.backend not in BACKENDS:
            raise SystemExit(f"unknown backend {args.backend!r}; "
                             f"choose from {sorted(BACKENDS)}")
        cfg = cfg.with_(matmul_backend=args.backend)
    if not model_api.supports_decode(cfg):
        raise SystemExit(f"{args.arch} has no decode step")
    if args.prompt_len + args.gen > args.cache_len and cfg.family == "dense":
        raise SystemExit("--prompt-len + --gen must fit in --cache-len")
    world = args.data_par * args.model_par
    if world > 1 and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        ranks = spawn_ranks(_serve_ranks, world, cfg, args,
                            device=args.device, timeout_s=24 * 3600)
    else:
        init_from_env(args.device)
        ranks = [_serve_ranks(cfg, args)]
    if not all(agree for _, _, agree in ranks):
        raise RuntimeError("the ranks of a 'model' group generated different "
                           "tokens")
    # each data rank's rows, in order (the whole batch where the data
    # axis does not divide it)
    split = args.data_par > 1 and args.batch % args.data_par == 0
    toks = (torch.cat([t for t, _, _ in ranks[::args.model_par]]) if split
            else ranks[0][0])
    if not _rank0():
        return toks
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}, mesh (data, model) = "
          f"({args.data_par}, {args.model_par}): generated "
          f"{tuple(toks.shape)} tokens at {ranks[0][1]:.1f} tok/s a rank "
          f"(batch {args.batch})")
    print("[serve] first sequence:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
