"""Training driver of the port (the reference's src/repro/launch/train.py):
the train state, the (seed, step)-indexed batch stream, the loop with
checkpoints, fault injection and the straggler detector, and the CLI.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
        --device cpu --model-par 2
    python -m repro_torch.launch.train --arch qwen2-1.5b --model-par 2
    python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke \\
        --device cpu --model-par 2 --seq 32
    python -m repro_torch.launch.train --arch stablelm-12b --layers 2 \\
        --batch 2 --seq 512 --steps 3
    python -m repro_torch.launch.train --arch llama3-405b --smoke \\
        --device cpu
    python -m repro_torch.launch.train --arch opto-vit-base --steps 200 \\
        --batch 32 --ckpt-dir /tmp/ckpt --ckpt-every 50
    python -m repro_torch.launch.train --arch opto-vit-base --batch 32 \\
        --data-par 2 --model-par 2

Three families train: the dense and the hybrid LM (``lm_loss`` on
``TokenStream`` batches, bf16 weights) and the ViT (QAT with the
straight-through estimator on the composed entries, launch/steps.py, on ``ImageStream``
batches); the others raise naming A15 (ROADMAP.md queue A). The loop
runs with or without a sharding context. Under one (``main`` installs
``make_host_mesh(--data-par, --model-par)``, as the reference's, with
``MODEL_RULES``; a caller may install ``DATA_RULES``, ``DEFAULT_RULES`` or
a pod mesh's ``MULTIPOD_RULES``, under the last two of which the params
and AdamW's moments are also FSDP-split over the batch axes, and the
LM's vocab over "model") each rank trains its blocks of the state on its
rows of every batch. A checkpoint holds the logical arrays (each split dim gathered over its
mesh axes, FSDP blocks included, written by rank 0), so it restores on
any mesh, or on one device, through ``restore(..., ctx, axes)``.
``main`` starts its ranks with ``launch/mesh.py::spawn_ranks``, or joins
torchrun's (``init_from_env``). Entry points run on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import init_lm
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig, smoke_variant
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ImageStream, TokenStream
from repro_torch.device import full_precision_matmuls, resolve_device
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.distributed.sharding import current_ctx, use_sharding
from repro_torch.launch.mesh import (init_from_env, make_host_mesh,
                                     spawn_ranks)
from repro_torch.core.backend import place_params
from repro_torch.launch.steps import (gather_tree, make_train_fn,
                                      placement_axes, state_logical_axes)
from repro_torch.models import api as model_api
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map

__all__ = ["init_state", "make_stream", "train_loop", "main"]


_LM_FAMILIES = ("dense", "hybrid")


def _check_trainable(cfg: ArchConfig) -> None:
    if cfg.family not in _LM_FAMILIES + ("vit",):
        raise NotImplementedError(
            f"training family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP.md queue A15); trainable: dense, "
            f"hybrid, vit")


def init_state(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """{"params", "opt": AdamW state, "step": 0} on ``device`` (default: the
    card): an LM's (dense or hybrid) params drawn by ``bridge.init_lm``
    (under a context each leaf cut to this rank's block as it is drawn),
    the ViT's by
    ``bridge.init_vit``'s numpy initializer (1000 classes, as the
    reference's ``init_model``). Under a sharding context every rank draws
    the same whole params and keeps its blocks."""
    _check_trainable(cfg)
    dev = resolve_device(device)
    ocfg = AdamWConfig(low_mem=not cfg.use_fp32_master)
    ctx = current_ctx()
    if cfg.family in _LM_FAMILIES:
        params = init_lm(seed, cfg, dev, place=ctx is not None)
    else:
        params = model_api.init_model(seed, cfg, dev)
        if ctx is not None:
            params = place_params(params, placement_axes(
                cfg, model_api.model_logical_axes(cfg)), ctx)
    return {"params": params, "opt": adamw_init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_stream(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                device=None):
    """``step -> batch``, a pure function of (seed, step), on ``device``
    (default: the card): for an LM ``TokenStream``'s {"tokens",
    "labels"}, for the ViT ``{"images", "labels"}`` of ``ImageStream`` (8
    classes); this rank's rows under a sharding context (its share of
    every microbatch with ``cfg.microbatch_steps`` > 1)."""
    _check_trainable(cfg)
    dev = resolve_device(device)
    if cfg.family in _LM_FAMILIES:
        ts = TokenStream(cfg.vocab, shape.seq_len, shape.global_batch,
                         seed=seed, ctx=current_ctx(), device=dev,
                         microbatches=cfg.microbatch_steps)
        return ts.batch_at
    ims = ImageStream(cfg.img_size, shape.global_batch, n_classes=8,
                      patch=cfg.patch, seed=seed, device=dev,
                      ctx=current_ctx(), microbatches=cfg.microbatch_steps)
    return lambda step: {k: v for k, v in ims.batch_at(step).items()
                         if k in ("images", "labels")}


def _writer() -> bool:
    """Whether this rank writes checkpoints: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier(ctx) -> None:
    if ctx is not None and ctx.mesh.world > 1:
        dist.barrier()


def train_loop(cfg: ArchConfig, shape: ShapeConfig, n_steps: int,
               seed: int = 0, ckpt: CheckpointManager | None = None,
               log_every: int = 10, inject_fault_at: int | None = None, *,
               device=None, state: dict | None = None):
    """Run steps up to ``n_steps``; returns (final state, the losses of the
    steps run, straggler flags). Starts from ``state`` (default
    ``init_state(cfg, seed)``), or from ``ckpt``'s newest checkpoint when
    it has one; ``ckpt`` saves every ``every`` steps and at the end. At
    step ``inject_fault_at`` it raises before the step runs (a simulated
    preemption).

    Under a sharding context ``state`` is this rank's blocks
    (``init_state`` under the same context), each step the mesh's
    (``make_train_fn``), and a checkpoint the logical state: gathered over
    the split axes on every rank, written by rank 0, restored as this
    rank's blocks; the ranks meet at a barrier after the last save and
    before an injected fault raises."""
    ctx = current_ctx()
    dev = resolve_device(device)
    if dev.type == "cuda":
        full_precision_matmuls()
    step_fn = make_train_fn(cfg)
    batch_at = make_stream(cfg, shape, seed, dev)
    if state is None:
        state = init_state(cfg, seed, dev)
    axes = (None if ctx is None else
            placement_axes(cfg, state_logical_axes(cfg)))

    def save(step, force=False):
        if ctx is None:
            ckpt.maybe_save(step, state, force=force)
        elif force or (step and step % ckpt.every == 0):
            tree = gather_tree(state, axes, ctx)
            if _writer():
                ckpt.maybe_save(step, tree, force=force)

    start = 0
    if ckpt is not None:
        restored, s0 = ckpt.restore_latest(state, ctx, axes)
        if restored is not None:
            if ctx is not None:
                restored = tree_map(lambda t: t.contiguous(), restored)
            state, start = restored, s0
            if _writer():
                print(f"[train] resumed from step {start}")

    det = StragglerDetector()
    losses = []
    for step in range(start, n_steps):
        if inject_fault_at is not None and step == inject_fault_at:
            if ckpt is not None and ctx is not None:
                ckpt.wait()
                _barrier(ctx)
            raise RuntimeError("injected fault (preemption simulation)")
        batch = batch_at(step)
        with det.timer(det, step):
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if ckpt is not None:
            save(step + 1)
        if _writer() and (step % log_every == 0 or step == n_steps - 1):
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f}")
    if ckpt is not None:
        save(n_steps, force=True)
        ckpt.wait()
        _barrier(ctx)
    return state, losses, det.flags


def _train_ranks(cfg: ArchConfig, shape: ShapeConfig, n_steps: int,
                 seed: int, ckpt_dir, ckpt_every: int, data: int,
                 model: int, device) -> tuple:
    """One rank of ``main``: the host mesh, then ``train_loop`` under it.
    Returns (losses, straggler flags, seconds)."""
    mesh = make_host_mesh(data, model, device=device)
    ckpt = (CheckpointManager(ckpt_dir, every=ckpt_every)
            if ckpt_dir else None)
    with use_sharding(mesh):
        t0 = time.time()
        _, losses, flags = train_loop(cfg, shape, n_steps, seed=seed,
                                      ckpt=ckpt, device=device)
    return losses, flags, time.time() - t0


def main(argv=None) -> None:
    """The reference's flags and defaults, plus ``--device``. The run is
    ``make_host_mesh(--data-par, --model-par)``'s: one rank a mesh
    position, started here by ``spawn_ranks`` (each rank on the card, or
    all on the CPU with ``--device cpu``) or by torchrun."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduce to the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.d_model:
        cfg = cfg.with_(d_model=args.d_model)
    _check_trainable(cfg)
    world = args.data_par * args.model_par
    if args.batch % args.data_par:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"--data-par {args.data_par} ranks")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = (cfg, shape, args.steps, args.seed, args.ckpt_dir, args.ckpt_every,
           args.data_par, args.model_par, args.device)
    if world > 1 and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        losses, flags, dt = spawn_ranks(_train_ranks, world, *run,
                                        device=args.device,
                                        timeout_s=24 * 3600)[0]
    else:
        init_from_env(args.device)
        losses, flags, dt = _train_ranks(*run)
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1) * 1e3:.0f} ms/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"straggler flags: {len(flags)}")


if __name__ == "__main__":
    main()
