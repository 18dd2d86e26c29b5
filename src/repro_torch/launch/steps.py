"""The train step of the port (the reference's src/repro/launch/steps.py::
make_train_fn, operation for operation).

    state = {"params", "opt": {"m", "v", "count"}, "step"}

  * the loss's gradient over the flattened param leaves
    (``torch.autograd.grad``, the reference's ``value_and_grad``); a leaf
    the loss does not reach gets a zero gradient (MGNet's, under RoI
    pruning: top-k indices carry none);
  * ``cfg.microbatch_steps`` k > 1 splits the batch into k sequential
    microbatches of B / k rows, accumulates the gradients in
    ``cfg.grad_accum_dtype`` and divides by k (the reference's
    ``lax.scan``);
  * global-norm clip at 1.0, the warmup-cosine multiplier at step + 1
    (``warmup_cosine(0)`` is 0, which would waste the first step), AdamW
    with bf16 moments unless ``cfg.use_fp32_master``.

The step runs on the composed entries of a training policy
(``ExecPolicy.from_cfg(cfg, training=True)``): no hand-written kernel has
a backward, and the reference's train step reaches none. The train mesh
(``make_train_step``, ``abstract_state``, the shardings) comes with A14's
LM half (ROADMAP.md queue A).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.models.layers import ExecPolicy
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map, tree_unflatten, warmup_cosine)

__all__ = ["make_grad_fn", "make_train_fn"]


def make_grad_fn(cfg: ArchConfig):
    """``grads_of(params, batch) -> (loss, grads)``: the train step's loss
    and gradient tree (microbatched as ``cfg`` says), before the clip."""
    policy = ExecPolicy.from_cfg(cfg, training=True)
    k = max(cfg.microbatch_steps, 1)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = model_api.loss_fn(live, batch, cfg, policy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    def grads_of(params, batch):
        if k == 1:
            return value_and_grad(params, batch)
        micro = {n: x.reshape(k, x.shape[0] // k, *x.shape[1:])
                 for n, x in batch.items()}
        acc_dt = (torch.bfloat16 if cfg.grad_accum_dtype == "bf16"
                  else torch.float32)
        dev = tree_leaves(params)[0].device
        l_sum = torch.zeros((), dtype=torch.float32, device=dev)
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                               device=p.device), params)
        for i in range(k):
            loss, g = value_and_grad(params, {n: x[i] for n, x in
                                              micro.items()})
            g_sum = tree_map(lambda a, b: a + b.to(acc_dt), g_sum, g)
            l_sum = l_sum + loss
        return l_sum / k, tree_map(lambda x: x / k, g_sum)

    return grads_of


def make_train_fn(cfg: ArchConfig):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: a
    new state of new tensors (the argument is not written). ``batch``
    holds tensors on the params' device."""
    ocfg = AdamWConfig(low_mem=not cfg.use_fp32_master)
    grads_of = make_grad_fn(cfg)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss, g = grads_of(params, batch)
        g, gnorm = clip_by_global_norm(g, 1.0)
        lr = warmup_cosine(state["step"] + 1, warmup=cfg.lr_warmup,
                           total=cfg.lr_total)
        new_params, new_opt = adamw_update(g, state["opt"], params, ocfg, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
