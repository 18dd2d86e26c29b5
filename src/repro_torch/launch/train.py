"""Training driver of the port (the reference's src/repro/launch/train.py):
the train state, the (seed, step)-indexed batch stream, the loop with
checkpoints, fault injection and the straggler detector, and the CLI.

    python -m repro_torch.launch.train --arch opto-vit-tiny --smoke \\
        --device cpu --steps 20
    python -m repro_torch.launch.train --arch opto-vit-base --steps 200 \\
        --batch 32 --ckpt-dir /tmp/ckpt --ckpt-every 50

The ViT family trains (QAT with the straight-through estimator on the
composed entries, launch/steps.py); dense-LM training comes right after
A14's LM half and the other families with A15 (ROADMAP.md queue A), and
each raises naming its item. The loop runs on one device with no sharding
context; under one it raises: the train mesh comes with A14's LM half
(the reference's loop asserts a context, and its host mesh is refused by
``use_sharding``). Entry points run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig, smoke_variant
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ImageStream
from repro_torch.device import full_precision_matmuls, resolve_device
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.distributed.sharding import current_ctx
from repro_torch.launch.steps import make_train_fn
from repro_torch.models import api as model_api
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["init_state", "make_stream", "train_loop", "main"]


def _check_trainable(cfg: ArchConfig) -> None:
    if cfg.family == "dense":
        raise NotImplementedError(
            f"training {cfg.name} (dense LM: lm_loss on TokenStream batches) "
            f"is not ported to repro_torch yet: it comes with dense-LM "
            f"training, right after A14's LM half (ROADMAP.md queue A)")
    if cfg.family != "vit":
        raise NotImplementedError(
            f"training family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP.md queue A15); trainable: vit")


def init_state(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """{"params", "opt": AdamW state, "step": 0} on ``device`` (default: the
    card); the params drawn by ``bridge.init_vit``'s numpy initializer
    (1000 classes, as the reference's ``init_model``)."""
    _check_trainable(cfg)
    dev = resolve_device(device)
    ocfg = AdamWConfig(low_mem=not cfg.use_fp32_master)
    params = model_api.init_model(seed, cfg, dev)
    return {"params": params, "opt": adamw_init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_stream(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                device=None):
    """``step -> batch``, a pure function of (seed, step): for the ViT
    ``{"images", "labels"}`` of ``ImageStream`` (8 classes) on ``device``
    (default: the card)."""
    _check_trainable(cfg)
    ims = ImageStream(cfg.img_size, shape.global_batch, n_classes=8,
                      patch=cfg.patch, seed=seed,
                      device=resolve_device(device))
    return lambda step: {k: v for k, v in ims.batch_at(step).items()
                         if k in ("images", "labels")}


def train_loop(cfg: ArchConfig, shape: ShapeConfig, n_steps: int,
               seed: int = 0, ckpt: CheckpointManager | None = None,
               log_every: int = 10, inject_fault_at: int | None = None, *,
               device=None, state: dict | None = None):
    """Run steps up to ``n_steps``; returns (final state, the losses of the
    steps run, straggler flags). Starts from ``state`` (default
    ``init_state(cfg, seed)``), or from ``ckpt``'s newest checkpoint when
    it has one; ``ckpt`` saves every ``every`` steps and at the end. At
    step ``inject_fault_at`` it raises before the step runs (a simulated
    preemption)."""
    if current_ctx() is not None:
        raise ValueError(
            "train_loop runs on one device with no sharding context; the "
            "train mesh comes with A14's LM half (ROADMAP.md queue A)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        full_precision_matmuls()
    step_fn = make_train_fn(cfg)
    batch_at = make_stream(cfg, shape, seed, dev)
    if state is None:
        state = init_state(cfg, seed, dev)

    start = 0
    if ckpt is not None:
        restored, s0 = ckpt.restore_latest(state)
        if restored is not None:
            state, start = restored, s0
            print(f"[train] resumed from step {start}")

    det = StragglerDetector()
    losses = []
    for step in range(start, n_steps):
        if inject_fault_at is not None and step == inject_fault_at:
            raise RuntimeError("injected fault (preemption simulation)")
        batch = batch_at(step)
        with det.timer(det, step):
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if ckpt is not None:
            ckpt.maybe_save(step + 1, state)
        if step % log_every == 0 or step == n_steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f}")
    if ckpt is not None:
        ckpt.maybe_save(n_steps, state, force=True)
        ckpt.wait()
    return state, losses, det.flags


def main(argv=None) -> None:
    """The reference's flags and defaults, plus ``--device``."""
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
    if args.data_par > 1 or args.model_par > 1:
        raise NotImplementedError(
            f"--data-par {args.data_par} / --model-par {args.model_par}: the "
            f"train mesh is not ported to repro_torch yet; it comes with "
            f"A14's LM half (ROADMAP.md queue A)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.d_model:
        cfg = cfg.with_(d_model=args.d_model)
    _check_trainable(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    ckpt = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
            if args.ckpt_dir else None)
    t0 = time.time()
    state, losses, flags = train_loop(cfg, shape, args.steps, seed=args.seed,
                                      ckpt=ckpt, device=args.device)
    dt = time.time() - t0
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1) * 1e3:.0f} ms/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"straggler flags: {len(flags)}")


if __name__ == "__main__":
    main()
