"""The tensor- and data-parallel LM on a (2, 2) ("data", "model") mesh:
4 gloo ranks on the CPU, started once for the module by
``launch.mesh.spawn_ranks`` (their body is ``_torch_ranks.lm_mesh_suite``,
which imports neither JAX nor the reference), held against the
reference's functions outside a mesh and against the port's unsharded
runs.

The model is the reference's qwen2-1.5b smoke config cut to 2 layers (d
64, 4 heads over 2 KV heads, d_ff 128, vocab 256, bf16), its params
bridged from the reference with the QKV biases and norm gains perturbed
(as ``test_torch_lm.py``). Each rank holds 2 query heads, 64 of d_ff and
its 2 of the 4 batch rows. Tolerances:

  * prefill logits against the reference's ``prefill_fn``: corr > 0.999
    and equal argmax (the reference's quantized-vs-float class; measured
    corr > 0.99998);
  * teacher-forced decode logits (the same tokens fed to both, so a
    near-tie cannot cascade) against the reference's ``decode_fn``: corr >
    0.999 and equal argmax at every step;
  * one train step's loss against the reference's ``make_train_fn``
    within 2e-4 relative, its clip norm within 2%; the gradient (bf16
    leaves) within ``GRAD_REL`` = 3e-2 relative L2 over the tree, against
    the reference's (its ``loss_fn``'s ``jax.grad`` outside a mesh;
    measured 1.40e-2) and against the port's unsharded gradient (measured
    0.93e-2). The bound is twice the control: the port's unsharded
    gradient against the reference's reads 1.34e-2, since every bf16 op
    of the backward rounds and the two forwards round differently. The
    planted fault (the "copy to model" backward with no all-reduce) must
    miss it by 10x (measured 0.75);
  * the int8 (photonic_pallas) prefill: bitwise the unsharded one;
  * a straddling GQA config (6 heads over 3 KV heads: rank 0's heads 0-2
    read KV heads 0, 0, 1) and a model axis that divides wq's columns but
    not the heads (3 heads; d_ff 130 splits, 129 does not): prefill corr
    > 0.9999 and equal argmax against the unsharded port, gradients within
    ``GRAD_REL`` (measured 0.94e-2, 1.03e-2 and 0.28e-2: the last splits
    nothing over "model");
  * a checkpoint of 2 sharded train steps: the logical state, restored on
    one device bitwise the gathered state, and into each rank's blocks
    bitwise its live state.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.launch import steps as jsteps
from repro.models import api as japi

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import restore
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_grad_fn
from repro_torch.optim.adamw import tree_leaves

import _torch_ranks

BF16 = ml_dtypes.bfloat16
B, P, T, CACHE = 4, 12, 4, 24
GRAD_REL = 3e-2
SPAWN_TIMEOUT_S = 600


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _rel_l2(a: dict, b: dict) -> float:
    la, lb = tree_leaves(a), tree_leaves(b)
    num = sum(float(((np.asarray(x, np.float64) - np.asarray(y, np.float64))
                     ** 2).sum()) for x, y in zip(la, lb))
    den = sum(float((np.asarray(y, np.float64) ** 2).sum()) for y in lb)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    jcfg = jsmoke(jget("qwen2-1.5b")).with_(n_layers=2)
    tcfg = tsmoke(tget("qwen2-1.5b")).with_(n_layers=2)
    tree = jax.tree_util.tree_map(
        np.asarray, japi.init_model(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    attn = tree["blocks"]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = (rng.standard_normal(attn[k].shape) * 0.5).astype(BF16)
    for k in ("ln1", "ln2"):
        tree["blocks"][k] = (1.0 + 0.1 * rng.standard_normal(
            tree["blocks"][k].shape)).astype(BF16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = bridge.from_jax_params(tree, "cpu")
    prompt = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    labels = np.roll(prompt, -1, axis=1)
    batch = {"tokens": prompt, "labels": labels}

    # the reference outside a mesh, each function under jax.jit
    ref = {"prefill": np.asarray(jax.jit(lambda p, t: japi.prefill_fn(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(prompt)).astype(
            jnp.float32))}
    cache = {k: jnp.zeros(s, d) for k, (s, d) in
             japi.cache_axes_spec(jcfg, B, CACHE)[0].items()}
    decode = jax.jit(lambda p, c, t, pos: japi.decode_fn(p, c, t, pos, jcfg))
    dec = []
    for pos in range(P + T):
        tok = prompt[:, pos:pos + 1] if pos < P else forced[:, pos - P:
                                                             pos - P + 1]
        lg, cache = decode(jp, cache, jnp.asarray(tok), jnp.int32(pos))
        if pos >= P - 1:
            dec.append(np.asarray(lg.astype(jnp.float32)))
    ref["decode"] = np.stack(dec, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(jp, jb)
    ref["loss"] = float(loss)
    ref["grads"] = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), g)
    st = {"params": jp, "opt": jax.tree_util.tree_map(
        jnp.asarray, jsteps.adamw_init(jp, jsteps.AdamWConfig(
            low_mem=True))), "step": jnp.zeros((), jnp.int32)}
    _, m = jax.jit(jsteps.make_train_fn(jcfg))(st, jb)
    ref["step_loss"] = float(m["loss"])
    ref["grad_norm"] = float(m["grad_norm"])

    # the port unsharded, and the extra configs' params
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l1, g1 = make_grad_fn(tcfg)(tp, tb)
    extra = {}
    for name, kw in (("straddle", dict(d_model=96, n_heads=6, kv_heads=3)),
                     ("heads3", dict(d_model=48, n_heads=3, kv_heads=1,
                                     d_ff=130)),
                     ("heads3-ff129", dict(d_model=48, n_heads=3,
                                           kv_heads=1, d_ff=129))):
        xcfg = tcfg.with_(**kw)
        extra[name] = (xcfg, bridge.init_lm(1, xcfg, "cpu"))
    ckpt = str(tmp_path_factory.mktemp("lm_mesh_ckpt"))
    ranks = spawn_ranks(_torch_ranks.lm_mesh_suite, 4, tp, tcfg, prompt,
                        forced, batch, CACHE, extra, ckpt, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return {"ref": ref, "ranks": ranks, "tcfg": tcfg, "tp": tp,
            "loss1": float(l1), "grads1": _torch_ranks._np_tree(g1),
            "ckpt": ckpt, "extra": extra}


def _rows(env, key):
    """The whole batch's rows from the ranks of model coordinate 0, in
    data order, each model pair checked equal."""
    by = {r["coords"]: r for r in env["ranks"]}
    for d in range(2):
        np.testing.assert_array_equal(by[(d, 0)][key], by[(d, 1)][key])
    return np.concatenate([by[(0, 0)][key], by[(1, 0)][key]])


def test_ranks_are_the_port_alone_on_a_2x2_mesh(env):
    coords = sorted(r["coords"] for r in env["ranks"])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in env["ranks"]:
        assert r["shape"] == {"data": 2, "model": 2}
        assert not r["jax_loaded"] and not r["repro_loaded"]
        # 2 of 4 query heads x head dim 16; 64 of d_ff; the cache whole
        # over "model", its rows split over "data"
        assert r["wq_shape"] == (2, 64, 32)
        assert r["w_down_shape"] == (2, 64, 64)
        assert r["cache_shape"] == (2, 2, CACHE, 2, 16)


def test_tp_dp_prefill_matches_reference(env):
    got, want = _rows(env, "prefill"), env["ref"]["prefill"]
    assert got.shape == want.shape
    assert _corr(got, want) > 0.999
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_teacher_forced_decode_matches_reference(env):
    got, want = _rows(env, "decode"), env["ref"]["decode"]
    assert got.shape == want.shape == (B, T + 1, 256)
    for t in range(T + 1):
        assert _corr(got[:, t], want[:, t]) > 0.999, t
        np.testing.assert_array_equal(got[:, t].argmax(-1),
                                      want[:, t].argmax(-1))
    # greedy tokens: equal within each model group (checked by _rows)
    assert _rows(env, "greedy").shape == (B, 4)


def test_train_step_loss_and_gradients(env):
    r0 = env["ranks"][0]
    for r in env["ranks"]:
        assert r["loss"] == r0["loss"] and r["gnorm"] == r0["gnorm"]
    ref = env["ref"]
    for want in (ref["loss"], ref["step_loss"]):
        assert abs(r0["loss"] - want) <= 2e-4 * abs(want)
    assert abs(r0["gnorm"] - ref["grad_norm"]) <= 2e-2 * ref["grad_norm"]
    assert _rel_l2(r0["grads"], ref["grads"]) < GRAD_REL
    assert _rel_l2(r0["grads"], env["grads1"]) < GRAD_REL
    # every rank holds the same logical gradient
    for r in env["ranks"][1:]:
        assert _rel_l2(r["grads"], r0["grads"]) == 0.0


def test_planted_copy_to_model_fault_fails_the_gradient_check(env):
    r0 = env["ranks"][0]
    got = _rel_l2(r0["grads_planted"], env["grads1"])
    assert got > 10 * GRAD_REL, got


def test_int8_tp_prefill_is_bitwise_unsharded(env):
    for r in env["ranks"]:
        assert r["int8_bitwise"], r["int8_maxdiff"]


@pytest.mark.parametrize("name", ["straddle", "heads3", "heads3-ff129"])
def test_straddling_gqa_and_non_dividing_axes(env, name):
    by = {r["coords"]: r["extra"][name] for r in env["ranks"]}
    got = np.concatenate([by[(0, 0)]["prefill"], by[(1, 0)]["prefill"]])
    one = np.concatenate([by[(0, 0)]["unsharded"], by[(1, 0)]["unsharded"]])
    assert _corr(got, one) > 0.9999
    np.testing.assert_array_equal(got.argmax(-1), one.argmax(-1))
    x = by[(0, 0)]
    assert abs(x["loss"] - x["loss1"]) <= 2e-4 * abs(x["loss1"])
    assert _rel_l2(x["grads"], x["grads1"]) < GRAD_REL
    if name == "straddle":
        assert by[(0, 0)]["runs"] == [(0, 2, 0, 1), (2, 3, 1, 2)]
        assert by[(0, 1)]["runs"] == [(0, 1, 1, 2), (1, 3, 2, 3)]
        assert x["wq_shape"] == (2, 96, 48)
    else:                       # 3 heads over 2 ranks: wq whole
        assert x["runs"] == [(0, 3, 0, 1)] and x["wq_shape"] == (2, 48, 48)
        assert x["w_gate_shape"] == ((2, 48, 65) if name == "heads3"
                                     else (2, 48, 129))


def test_sharded_checkpoint_restores_on_one_device_and_on_the_mesh(env):
    r0 = env["ranks"][0]
    for r in env["ranks"]:
        assert r["restored_step"] == 2 and r["restored_bitwise"]
        assert r["losses"] == r0["losses"]
    like = ttrain.init_state(env["tcfg"], 0, "cpu")
    back, step = restore(f"{env['ckpt']}/step_2", like)
    assert step == 2
    want = _torch_ranks._np_tree(back)
    for a, b in zip(tree_leaves(want), tree_leaves(r0["final"])):
        np.testing.assert_array_equal(a, b)
