"""Hybrid-LM (RecurrentGemma) training in the port on one device, held
against the reference outside any mesh.

Two models: the reference's recurrentgemma-9b smoke config (``smoke_variant``:
3 layers, one (rec, rec, attn) super-block, d 64, 4 heads on 1 KV head,
LRU width 64, window 16, vocab 256, bf16 weights with f32 ``lambda`` /
``b_a`` / ``b_x``) and a 5-layer variant whose two tail recurrent layers
train too. Params are the reference's ``init_model`` draw with the norm
gains and the gate biases perturbed from a numpy seed (so they carry
numbers) (``_torch_lm_ref.hybrid_smoke_model``: drawn by the port's
``init_lm``, ``lambda`` the reference's own expression), carried into the
port by ``bridge``; the train state (params and AdamW moments) by
``bridge.from_jax_state``. Sequences of 32 tokens
against the 16-token window, so the window binds. Every reference run is
made once, in the module fixture.

The limits are twice the reference's distance from itself, measured here:
its scanned ``loss_fn`` under ``jax.jit`` against its eager layer
composition (``_eager_loss``: the same layer functions called one by one,
unjitted, as the port runs them), the class ROADMAP "LM anchors" gives
for the hybrid's forward (up to 5-6 bf16 ulps of the logits). The loss's
is the largest over the train loop's six batches (one batch's is a
single draw of the rounding: 4.6e-5 on one, 1.7e-3 on another). Measured
at this size: the loss 2.5e-3 (3 layers) and 1.7e-3 (5 layers), the
gradient 3.4e-2 and 4.2e-2 relative L2 over the tree; the port reads
1.2e-3 / 7.9e-4 and 3.5e-2 / 4.3e-2 against the scanned functions.

  * ``lm_loss`` / ``loss_fn`` against ``api.loss_fn`` on the first batch:
    within twice the loss's self-distance;
  * every leaf's gradient against ``jax.grad(loss_fn)``: the tree's
    relative L2 within twice the gradient's self-distance;
  * 6 steps of ``train_loop`` (``microbatch_steps`` 2, the config's
    100-step warmup, so the params move little and each step's loss
    differs by the forwards' rounding) against the reference's
    ``make_train_fn`` under ``jax.jit`` on the same ``TokenStream``
    batches: each step's loss within twice the loss's self-distance,
    each clip norm (by the triangle inequality) and the final first
    moment within twice the gradient's self-distance;
  * remat on against off: loss and gradients bitwise; a run resumed from
    its checkpoint against a straight one: bitwise;
  * the floor under sqrt(1 - a^2): ``jnp.maximum``'s gradient (0.5 on the
    bound) on a planted input.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.core.backend import ExecPolicy as JPolicy
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtf

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.core.quant import _jnp_clip
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import tree_leaves

from _torch_lm_ref import hybrid_smoke_model

SEQ, BATCH, STEPS = 32, 4, 6
TRAIN = dict(microbatch_steps=2)
LAYERS = (3, 5)


def _cfgs(n_layers: int, **kw):
    return (jsmoke(jget("recurrentgemma-9b")).with_(n_layers=n_layers, **kw),
            tsmoke(tget("recurrentgemma-9b")).with_(n_layers=n_layers, **kw))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    return [np.asarray(tree, np.float32)]


def _rel_l2(a, b) -> float:
    """Relative L2 of tree ``a`` against tree ``b`` (f64)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    num = sum(float(((x.astype(np.float64) - y) ** 2).sum())
              for x, y in zip(la, lb))
    den = sum(float((y.astype(np.float64) ** 2).sum()) for y in lb)
    return (num / den) ** 0.5


def _eager_loss(jcfg):
    """The reference's loss through its layer functions called one by one
    (no scan, no jit): the composition the port's forward mirrors."""
    pol = JPolicy.from_cfg(jcfg, training=True)

    def rec(lp, x):
        y, _ = jrglru.rglru_forward(lp["rec"], jlayers.rmsnorm(
            x, lp["ln1"], jcfg.norm_eps), jcfg, pol)
        x = x + y
        return x + jffn.swiglu(lp["ffn"], jlayers.rmsnorm(
            x, lp["ln2"], jcfg.norm_eps), pol)

    def layer(tree, i):
        return jax.tree_util.tree_map(lambda a: a[i], tree)

    def loss(p, b):
        x = jlayers.embedding_lookup(p["embed"], b["tokens"])
        for i in range(jcfg.n_layers // 3):
            sb = layer(p["blocks"], i)
            x = rec(sb["rec1"], rec(sb["rec0"], x))
            x = jtf.dense_layer_fwd(sb["attn"], x, jcfg, pol,
                                    window=jcfg.window)
        for i in range(jcfg.n_layers % 3):
            x = rec(layer(p["tail_blocks"], i), x)
        x = jlayers.rmsnorm(x, p["final_ln"], jcfg.norm_eps)
        lf = jlayers.linear(x, p["lm_head"], policy=pol).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(lf, axis=-1)
        gold = jnp.take_along_axis(lf, b["labels"][..., None], -1)[..., 0]
        return (lse - gold).mean()
    return loss


def _batch(step: int) -> dict:
    return TokenStream(256, SEQ, BATCH, seed=0).batch_at(step)


@pytest.fixture(scope="module")
def ref():
    """Every reference run of this file, once: per model the scanned loss
    and gradient on the first batch, the eager composition's gradient
    there, the two losses on each of the train loop's batches; for the
    5-layer model the train loop under ``jax.jit``."""
    out = {}
    for n in LAYERS:
        jcfg, _, tree = hybrid_smoke_model(n, seed=n, **TRAIN)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        batches = [{k: jnp.asarray(v) for k, v in _batch(i).items()}
                   for i in range(STEPS)]
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, b: japi.loss_fn(p, b, jcfg)))(jp, batches[0])
        eager = _eager_loss(jcfg)
        _, eg = jax.value_and_grad(eager)(jp, batches[0])
        scanned = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))
        r = {"tree": tree, "loss": float(loss), "grads": _f32(g),
             "self_loss": max(abs(float(scanned(jp, b)) - float(eager(jp, b)))
                              for b in batches),
             "self_grad": _rel_l2(_f32(eg), _f32(g))}
        if n == max(LAYERS):
            st = {"params": jp, "step": jnp.zeros((), jnp.int32),
                  "opt": jsteps.adamw_init(jp, jsteps.AdamWConfig(
                      low_mem=not jcfg.use_fp32_master))}
            r["state0"] = jax.tree_util.tree_map(np.asarray, st)
            fn = jax.jit(jsteps.make_train_fn(jcfg))
            losses, norms = [], []
            for b in batches:
                st, m = fn(st, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            r.update(losses=losses, norms=norms, m=_f32(st["opt"]["m"]))
        out[n] = r
    return out


def _port(ref, n, **kw):
    """(port cfg, port params) of model ``n``."""
    _, tcfg = _cfgs(n, **{**TRAIN, **kw})
    return tcfg, bridge.from_jax_params(ref[n]["tree"], "cpu")


def _tbatch(step: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in _batch(step).items()}


@pytest.mark.parametrize("n", LAYERS)
def test_lm_loss_and_loss_fn_match_reference(ref, n):
    tcfg, tp = _port(ref, n)
    r = ref[n]
    limit = 2 * r["self_loss"]
    with torch.no_grad():
        got = float(tapi.loss_fn(tp, _tbatch(0), tcfg))
        lm = float(ttf.lm_loss(tp, _tbatch(0), tcfg))
    assert got == lm
    assert abs(got - r["loss"]) <= limit, (got, r["loss"], limit)


@pytest.mark.parametrize("n", LAYERS)
def test_every_leaf_gradient_matches_reference(ref, n):
    """The port's gradient (``make_grad_fn`` of one microbatch: the whole
    batch) against ``jax.grad(loss_fn)``, every leaf present, shaped and
    typed as the param, the tree within twice the self-distance."""
    tcfg, tp = _port(ref, n, microbatch_steps=1)
    loss, g = tsteps.make_grad_fn(tcfg)(tp, _tbatch(0))
    r = ref[n]
    for got, like in zip(tree_leaves(g), tree_leaves(tp)):
        assert got.shape == like.shape and got.dtype == like.dtype
    assert _rel_l2(g, r["grads"]) <= 2 * r["self_grad"], (
        _rel_l2(g, r["grads"]), r["self_grad"])
    assert abs(float(loss) - r["loss"]) <= 2 * r["self_loss"]


def test_train_loop_matches_reference_steps(ref, capsys):
    n = max(LAYERS)
    r = ref[n]
    tcfg, _ = _port(ref, n)
    state = bridge.from_jax_state(r["state0"], "cpu")
    assert state["opt"]["m"]["blocks"]["rec0"]["rec"]["lambda"].dtype == \
        torch.bfloat16
    assert state["params"]["blocks"]["rec0"]["rec"]["lambda"].dtype == \
        torch.float32
    final, losses, _ = ttrain.train_loop(
        tcfg, ShapeConfig("t", SEQ, BATCH, "train"), STEPS, device="cpu",
        state=state, log_every=1)
    norms = [float(line.split("gnorm")[1]) for line in
             capsys.readouterr().out.splitlines() if "gnorm" in line]
    assert len(losses) == len(norms) == STEPS
    for got, want in zip(losses, r["losses"]):
        assert abs(got - want) <= 2 * r["self_loss"], (
            losses, r["losses"], r["self_loss"])
    # |‖a‖ - ‖b‖| <= ‖a - b‖; the log prints 3 decimals
    for got, want in zip(norms, r["norms"]):
        assert abs(got - want) <= 2 * r["self_grad"] * want + 5e-4, (
            norms, r["norms"])
    assert _rel_l2(final["opt"]["m"], r["m"]) <= 2 * r["self_grad"]
    assert int(final["step"]) == STEPS


def test_remat_is_bitwise(ref):
    """Each super-block and tail layer checkpointed: the same loss and
    gradients, bit for bit, at two microbatches."""
    n = max(LAYERS)
    tcfg, tp = _port(ref, n)
    batch = _tbatch(1)
    loss_on, g_on = tsteps.make_grad_fn(tcfg.with_(remat=True))(tp, batch)
    loss_off, g_off = tsteps.make_grad_fn(tcfg.with_(remat=False))(tp, batch)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_resume_from_checkpoint_is_bitwise(ref, tmp_path):
    n = min(LAYERS)
    tcfg, _ = _port(ref, n, remat=True, lr_warmup=2, lr_total=100)
    shape = ShapeConfig("t", SEQ, BATCH, "train")

    def state():
        return ttrain.init_state(tcfg, 0, "cpu")

    final, losses, _ = ttrain.train_loop(tcfg, shape, 4, device="cpu",
                                         state=state())
    _, first, _ = ttrain.train_loop(
        tcfg, shape, 2, device="cpu", state=state(),
        ckpt=CheckpointManager(str(tmp_path), every=2))
    st, rest, _ = ttrain.train_loop(
        tcfg, shape, 4, device="cpu", state=state(),
        ckpt=CheckpointManager(str(tmp_path), every=100))
    assert first + rest == losses
    assert losses[-1] < losses[0]
    for a, b in zip(tree_leaves(st), tree_leaves(final)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_floor_gradient_is_jnp_maximum_s():
    """sqrt(max(1 - a^2, 1e-12))'s floor passes the gradient as
    ``jnp.maximum``: 1 above it, 0.5 on it, 0 below (``torch.clamp_min``
    would pass 1 on it). In f32, 1 - exp(2 log a) is a multiple of
    2^-24 near 1 and so never lands on 1e-12; the tie is planted here,
    and 0 (a = 1, reachable) is below it."""
    x = np.array([np.float32(1e-12), 0.0, 0.25, np.float32(1e-13)],
                 np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sqrt(
        jnp.maximum(v, 1e-12)).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    torch.sqrt(_jnp_clip(t, 1e-12, math.inf)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(want[:3], [0.25 / np.sqrt(np.float32(1e-12)),
                                          0.0, 1.0], rtol=1e-6)
    c = torch.from_numpy(x).requires_grad_(True)
    torch.sqrt(torch.clamp_min(c, 1e-12)).sum().backward()
    assert c.grad[0] == 2 * t.grad[0]
    # the RG-LRU's gates go through it: at a = 1 (lambda's softplus
    # underflowing to 0) b is the floor's sqrt times i * u, and u gets no
    # gradient through the floor
    _, tcfg = _cfgs(3)
    w = tcfg.lru_dim
    p = {"w_a": torch.zeros(w, w), "w_x": torch.zeros(w, w),
         "b_a": torch.zeros(w), "b_x": torch.zeros(w),
         "lambda": torch.full((w,), -200.0)}
    u = torch.ones(1, 1, w, requires_grad=True)
    a, b = trglru._gates(p, u)
    assert torch.equal(a, torch.ones_like(a))
    b.sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), np.float32(1e-6) * 0.5,
                               rtol=1e-6)
