"""Train an Opto-ViT (QAT + MGNet) end to end on the synthetic RoI task with
the PyTorch port (``repro_torch``): the two phases of
``examples/train_opto_vit.py``.

  1. MGNet trained with BCE against box-derived patch labels (the Eq. 3
     scoring head), evaluated by mask mIoU;
  2. the 8-bit-QAT ViT backbone trained on classification with MGNet
     pruning active (the straight-through estimator end to end).

Both phases run at the reference example's reduced size (32x32 images,
8x8 patches, a 2-layer d=64 backbone) with plain SGD, as it does; on the
card by default:

    PYTHONPATH=src python examples/train_opto_vit_torch.py --steps 200
    PYTHONPATH=src python examples/train_opto_vit_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import smoke_variant
from repro_torch.configs.opto_vit import get_config
from repro_torch.core.mgnet import (MGNetConfig, bce_loss, mask_iou,
                                    mgnet_scores)
from repro_torch.data.pipeline import ImageStream
from repro_torch.device import full_precision_matmuls, resolve_device
from repro_torch.models.api import _xent
from repro_torch.models.layers import ExecPolicy
from repro_torch.models.vit import forward_vit
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def sgd_step(params, loss_of, lr: float):
    """One plain SGD step (p - lr * g, as the reference example's)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_of(live)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, tree_leaves(live))]
    new = tree_map(lambda p, g: (p - lr * g).detach(), params,
                   tree_unflatten(params, grads))
    return new, float(loss.detach())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--keep", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        full_precision_matmuls()

    stream = ImageStream(img_size=32, global_batch=args.batch, n_classes=8,
                         patch=8, seed=0, device=dev)

    # ---- phase 1: MGNet ----------------------------------------------
    mcfg = MGNetConfig(patch=8, embed=32, heads=2, img_size=32)
    mparams = bridge.from_jax_params(
        bridge.init_mgnet(np.random.default_rng(0), mcfg), dev)
    t0 = time.time()
    for i in range(args.steps):
        b = stream.batch_at(i)
        mparams, ml = sgd_step(
            mparams, lambda p: bce_loss(mgnet_scores(p, b["images"], mcfg,
                                                     ExecPolicy()),
                                        b["patch_mask"]), 0.05)
    val = stream.batch_at(9999)
    with torch.no_grad():
        pred = (torch.sigmoid(mgnet_scores(mparams, val["images"], mcfg))
                > mcfg.t_reg).float()
    miou = float(mask_iou(pred, val["patch_mask"]))
    print(f"[mgnet] {args.steps} steps in {time.time() - t0:.0f}s; "
          f"BCE {ml:.3f}; mask mIoU {miou:.3f}")

    # ---- phase 2: QAT ViT backbone with RoI pruning --------------------
    cfg = smoke_variant(get_config("tiny")).with_(
        n_layers=2, remat=False, quant_bits=8,
        mgnet=True, mgnet_keep_ratio=args.keep,
        mgnet_embed=mcfg.embed, mgnet_heads=mcfg.heads)
    params = bridge.from_jax_params(bridge.init_vit(1, cfg, n_classes=8),
                                    dev)
    params["mgnet"] = mparams          # plug the trained MGNet in
    policy = ExecPolicy.from_cfg(cfg, training=True)

    def loss_of(b):
        return lambda p: _xent(forward_vit(p, b["images"], cfg, policy,
                                           device=dev)[0], b["labels"])

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        b = stream.batch_at(10000 + i)
        params, loss = sgd_step(params, loss_of(b), args.lr)
        losses.append(loss)
        if i % 50 == 0:
            print(f"[vit] step {i:4d} loss {loss:.4f}")

    correct = total = 0
    with torch.no_grad():
        for j in range(4):
            b = stream.batch_at(20000 + j)
            lg, kept = forward_vit(params, b["images"], cfg,
                                   ExecPolicy.from_cfg(cfg, training=False),
                                   device=dev)
            correct += int((lg.argmax(-1) == b["labels"]).sum())
            total += int(b["labels"].shape[0])
    print(f"[vit] {args.steps} QAT steps in {time.time() - t0:.0f}s; "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}; "
          f"val acc {correct / total:.3f} with {kept}/{16} patches kept")


if __name__ == "__main__":
    main()
