#!/usr/bin/env python3
"""The class of a QAT step's card-vs-CPU gradient gap: GEMM summation order
(the ViT train step, launch/steps.py::make_grad_fn, on the qat + xla +
xla training policy).

    PYTHONPATH=src python scripts/qat_grad_gap.py             # card + CPU
    PYTHONPATH=src python scripts/qat_grad_gap.py --cpu-only  # the control

At smoke size (opto-vit-tiny cut to 2 layers, 32x32 images in 8x8
patches, batch 8 of ``ImageStream(32, 8, n_classes=8, patch=8)``, the
config of chip_smoke.py's 4i (C) tight check), with MGNet's pruning on
(keep 0.5) and off, one step's loss and gradients on the CPU are held
against:

  * ``order``: the CPU with every qat matmul's contraction summed in two
    halves, forward and backward (the ``qat`` matmul backend replaced by
    one in another summation order): the class GEMM order alone gives;
  * ``card``: the same step on the card (TF32 off).

Prints each side's gradient relative L2 and loss relative difference
against the CPU, and the card's name and power limit; ``--json PATH``
also writes the readings there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import smoke_variant  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import backend, quant  # noqa: E402
from repro_torch.data.pipeline import ImageStream  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.launch.train import init_state  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402


def cfg_of(pruned: bool):
    cfg = smoke_variant(get_config("opto-vit-tiny")).with_(
        n_layers=2, lr_warmup=4, lr_total=200)
    if pruned:
        return cfg.with_(mgnet=True, mgnet_keep_ratio=0.5, mgnet_embed=32,
                         mgnet_heads=2)
    return cfg


def _split(a, b, parts=2):
    """a @ b with the contraction summed in ``parts`` blocks, in order."""
    out = None
    for ak, bk in zip(torch.tensor_split(a, parts, dim=-1),
                      torch.tensor_split(b, parts, dim=0)):
        out = ak @ bk if out is None else out + ak @ bk
    return out


class _SplitMatmul(torch.autograd.Function):
    """a @ b with the contraction summed in ``parts`` blocks, forward and
    backward."""

    @staticmethod
    def forward(ctx, a, b, parts):
        ctx.save_for_backward(a, b)
        ctx.parts = parts
        return _split(a, b, parts)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _split(g, b.transpose(-1, -2), ctx.parts)
        gb = _split(a.reshape(-1, a.shape[-1]).transpose(0, 1),
                    g.reshape(-1, g.shape[-1]), ctx.parts)
        return ga, gb, None


def qat_split_in(parts: int):
    """The qat matmul backend (fake-quantized operands, an f32 product)
    with the product's contractions summed in ``parts`` blocks."""
    def entry(x, w, p):
        bits = p.quant_bits or 8
        fq = quant.fake_quant_ste if p.training else quant.fake_quant
        wq = fq(w, bits=bits, axis=tuple(range(w.ndim - 1)))
        xq = fq(x, bits=bits, axis=None)
        return _SplitMatmul.apply(xq.float(), wq.float(), parts).to(x.dtype)
    return entry


# the control: the contractions summed in two halves
_qat_split = qat_split_in(2)


def step(cfg, state, batch, order=False):
    """(loss, gradients as f64 on the CPU) of one train step."""
    saved = backend.BACKENDS["qat"]
    if order:
        backend.BACKENDS["qat"] = _qat_split
    try:
        loss, g = make_grad_fn(cfg)(state["params"], batch)
    finally:
        backend.BACKENDS["qat"] = saved
    return float(loss), tree_map(lambda t: t.detach().double().cpu(), g)


def gap(a, b) -> dict:
    """Side a against side b (the CPU)."""
    (la, ga), (lb, gb) = a, b
    num = sum(float(((x - y) ** 2).sum()) for x, y in
              zip(tree_leaves(ga), tree_leaves(gb)))
    den = sum(float((y ** 2).sum()) for y in tree_leaves(gb))
    return {"grad_rel_l2": (num / den) ** 0.5,
            "loss_rel": abs(la - lb) / abs(lb)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--json", default=None,
                    help="write the readings to this file")
    args = ap.parse_args()
    card = None
    if not args.cpu_only:
        if not torch.cuda.is_available():
            print("no CUDA device (use --cpu-only for the control)",
                  file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"card": card}
    for pruned in (True, False):
        cfg = cfg_of(pruned)
        state = init_state(cfg, 0, "cpu")
        b = {k: v for k, v in ImageStream(32, 8, n_classes=8, patch=8,
                                          seed=0, device="cpu")
             .batch_at(0).items() if k in ("images", "labels")}
        base = step(cfg, state, b)
        res = {"order": gap(step(cfg, state, b, order=True), base)}
        if card is not None:
            dev = torch.device("cuda", 0)
            res["card"] = gap(step(cfg, tree_map(lambda t: t.to(dev), state),
                                   {k: v.to(dev) for k, v in b.items()}),
                              base)
        tag = "pruning on" if pruned else "pruning off"
        out[tag] = res
        for name, r in res.items():
            print(f"[{tag}] {name} vs CPU: gradient relative L2 "
                  f"{r['grad_rel_l2']:.4g}, loss relative diff "
                  f"{r['loss_rel']:.4g}" + (f" ({card})" if card else ""),
                  flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
