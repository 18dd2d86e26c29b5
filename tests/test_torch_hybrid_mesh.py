"""The hybrid LM (RecurrentGemma) tensor- and data-parallel: 2 gloo ranks
on the CPU, started once for the module by ``launch.mesh.spawn_ranks``
(their body is ``_torch_ranks.hybrid_mesh_suite``, which imports neither
JAX nor the reference), under ``MODEL_RULES`` on (data 1, model 2) and
under ``DATA_RULES`` on (data 2), held against the split's arithmetic on
one device, the port's unsharded runs and the reference outside a mesh.

The model is the reference's recurrentgemma-9b smoke config at 5 layers
(one (rec, rec, attn) super-block and two tail recurrent layers, d 64, 4
heads on 1 KV head, LRU width 64, d_ff 128, window 16, vocab 256), its
params ``_torch_lm_ref.hybrid_smoke_model``'s (the port's draw, the
reference's ``lambda``, the norm gains and gate biases perturbed). Under MODEL_RULES each rank holds 2 query heads, 64 of d_ff
and 32 of the LRU width (``in_proj`` / ``gate_proj`` columns, ``w_a`` /
``w_x`` / ``out_proj`` rows), its block of the recurrent states, and the
whole ring; under DATA_RULES its 2 of the 4 rows. A 20-token prompt and 6
teacher-forced tokens on a 12-slot ring, so the ring wraps and the
window binds. Tolerances:

  * the prefill and the decode logits at every position: bitwise the
    split's arithmetic on one device (``_torch_ranks.hybrid_tp_arithmetic``
    under MODEL_RULES: the column and row blocks, the gate GEMMs' f32
    partials summed in rank order; under DATA_RULES the rank's rows);
  * against the port's unsharded run: corr > 0.9999 and equal argmax
    outside 1-ulp ties; against the reference's ``prefill_fn`` /
    ``decode_fn`` (the class of the port's forward): corr > 0.999 and the
    argmax equal wherever the unsharded port's is, outside its own 1-ulp
    ties (at these inputs the
    unsharded port's own logits sit further from the reference's scanned
    ones than the 8 bf16 ulps of tests/test_torch_hybrid.py); the
    positions before the ring wraps checked on their own (a ring written
    at a consistent wrong slot is right once it wraps);
  * one train step: both ranks' losses equal (under MODEL_RULES bitwise
    the split's arithmetic on one device, under DATA_RULES within 1e-6
    relative of the unsharded loss); the gradient within ``GRAD_FACTOR``
    times the order control (the split's arithmetic on one device,
    differentiated, against the unsharded gradient) of the unsharded
    gradient;
  * 3 steps through ``train_loop`` from ``init_state`` (each rank drawing
    its blocks, ``bridge.init_lm(place=True)``): the losses and every
    whole leaf (``conv_w``, ``lambda``, ``b_a``, ``b_x``, the norms, the
    embedding and the head, wk / wv) bitwise equal across the ranks; the
    losses within ``LOSS_REL`` of the unsharded run's (measured 4.4e-4
    under MODEL_RULES, where the step's gradient differs by its f32
    summation order and AdamW's first steps move by its sign, and 2.3e-5
    under DATA_RULES), the gathered params within 1e-4 relative L2
    (measured 3.0e-6 and 1.2e-6);
  * planted faults, the gate GEMMs' partials left unreduced and ``b_a``
    added on every rank: each must break the bitwise check and fall out
    of the reference's class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi

from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_grad_fn

import _torch_ranks
from _torch_lm_ref import (argmax_outside_ties, corr, hybrid_smoke_model,
                           rel_l2)

B, P, T, RING, STEPS = 4, 20, 6, 12, 3
GRAD_FACTOR = 4
LOSS_REL = 1e-3
SPAWN_TIMEOUT_S = 600
MESHES = ("model", "data")


@pytest.fixture(scope="module")
def env():
    jcfg, tcfg, tree = hybrid_smoke_model(5, seed=5)
    rng = np.random.default_rng(50)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = bridge.from_jax_params(tree, "cpu")
    prompt = rng.integers(0, 256, (B, P)).astype(np.int32)
    forced = rng.integers(0, 256, (B, T)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}

    # the reference outside a mesh: the prefill, and the decode at every
    # position of the prompt and the forced tokens on the ring
    ref = {"prefill": np.asarray(jax.jit(lambda p, t: japi.prefill_fn(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(prompt)), np.float32)}
    cache = {k: jnp.zeros(s, d) for k, (s, d) in
             japi.cache_axes_spec(jcfg, B, RING)[0].items()}
    decode = jax.jit(lambda p, c, t, pos: japi.decode_fn(p, c, t, pos, jcfg))
    toks = np.concatenate([prompt, forced], 1)
    dec = []
    for pos in range(P + T):
        lg, cache = decode(jp, cache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        dec.append(np.asarray(lg, np.float32))
    ref["decode"] = np.stack(dec, 1)

    # the port on one device: the gradient, its order control, 3 steps
    one = _torch_ranks._hybrid_serve(tp, tcfg, torch.from_numpy(prompt),
                                     torch.from_numpy(forced), RING, B)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads_of = make_grad_fn(tcfg)
    loss1, g1 = grads_of(tp, tb)
    with _torch_ranks.hybrid_tp_arithmetic(tp, tcfg):
        loss_tp, g_tp = grads_of(tp, tb)
    final1, losses1, _ = ttrain.train_loop(
        tcfg, ShapeConfig("hy", P, B, "train"), STEPS, device="cpu",
        state=ttrain.init_state(tcfg, 0, "cpu"), log_every=10 ** 9)
    ranks = spawn_ranks(_torch_ranks.hybrid_mesh_suite, 2, tp, tcfg, prompt,
                        forced, batch, RING, STEPS, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return {"ref": ref, "ranks": ranks, "loss1": float(loss1),
            "one": dict(zip(("prefill", "decode"), map(_torch_ranks._np32,
                                                       one))),
            "loss_tp": float(loss_tp), "grads1": _torch_ranks._np_tree(g1),
            "control": rel_l2(_torch_ranks._np_tree(g_tp),
                              _torch_ranks._np_tree(g1)),
            "losses1": losses1, "final1": _torch_ranks._np_tree(
                final1["params"])}


def _whole(env, mesh: str, key: str) -> np.ndarray:
    """The whole batch's rows of ``key`` from the ranks: under MODEL_RULES
    both ranks' (bitwise equal), under DATA_RULES their rows in order."""
    a, b = (r[mesh][key] for r in env["ranks"])
    if mesh == "model":
        np.testing.assert_array_equal(a, b)
        return a
    return np.concatenate([a, b])


def _in_class(got: np.ndarray, want: np.ndarray, one: np.ndarray) -> bool:
    """``got`` in the class of the port's forward ``one`` against the
    reference's ``want``: corr > 0.999, and the argmax ``want``'s wherever
    ``one``'s is and ``one``'s top two are more than 1 bf16 ulp apart (a
    closer pair is a tie the summation order decides)."""
    top2 = np.sort(one, -1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]) + 1e-30)) - 7)
    right = (one.argmax(-1) == want.argmax(-1)) & (
        top2[..., 1] - top2[..., 0] > ulp)
    return corr(got, want) > 0.999 and bool(
        (got.argmax(-1) == want.argmax(-1))[right].all())


def _near_unsharded(got: np.ndarray, one: np.ndarray) -> bool:
    return corr(got, one) > 0.9999 and argmax_outside_ties(got, one) == 0.0


def test_ranks_are_the_port_alone_and_hold_their_blocks(env):
    r0, r1 = env["ranks"]
    for r in (r0, r1):
        assert not r["jax_loaded"] and not r["repro_loaded"]
    assert [r["model"]["coords"] for r in (r0, r1)] == [(0, 0), (0, 1)]
    assert [r["data"]["coords"] for r in (r0, r1)] == [(0, 0), (1, 0)]
    m, d = r0["model"], r0["data"]
    assert m["shapes"] == {"in_proj": (1, 64, 32), "w_a": (1, 32, 64),
                           "out_proj": (1, 32, 64), "conv_w": (1, 4, 64),
                           "wq": (1, 64, 32), "w_down": (1, 64, 64)}
    assert m["cache"] == {"rec_h": (1, 2, B, 32), "rec_conv": (1, 2, B, 3, 32),
                          "attn_k": (1, B, RING, 1, 16),
                          "attn_v": (1, B, RING, 1, 16),
                          "tail_h": (2, B, 32), "tail_conv": (2, B, 3, 32)}
    assert d["shapes"]["in_proj"] == (1, 64, 64)
    assert d["cache"]["rec_h"] == (1, 2, B // 2, 64)
    assert d["cache"]["attn_k"] == (1, B // 2, RING, 1, 16)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key", ["prefill", "decode"])
def test_logits_bitwise_the_split_arithmetic(env, mesh, key):
    for r in env["ranks"]:
        np.testing.assert_array_equal(r[mesh][key], r[mesh]["arith_" + key])


@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_matches_reference(env, mesh):
    got, want = _whole(env, mesh, "prefill"), env["ref"]["prefill"]
    one = env["one"]["prefill"]
    assert got.shape == want.shape == (B, P, 256)
    assert _in_class(got, want, one)
    assert _near_unsharded(got, one)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("span", ["before the wrap", "after the wrap"])
def test_ring_decode_matches_reference(env, mesh, span):
    got, want = _whole(env, mesh, "decode"), env["ref"]["decode"]
    one = env["one"]["decode"]
    assert got.shape == want.shape == (B, P + T, 256)
    steps = range(RING) if span == "before the wrap" else range(RING, P + T)
    for t in steps:
        assert _in_class(got[:, t], want[:, t], one[:, t]), t
        assert _near_unsharded(got[:, t], one[:, t]), t


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_tokens_agree_within_the_model_group(env, mesh):
    assert _whole(env, mesh, "greedy").shape == (B, 4)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_loss_and_gradient(env, mesh):
    r0, r1 = (r[mesh] for r in env["ranks"])
    assert r0["loss"] == r1["loss"] and r0["gnorm"] == r1["gnorm"]
    if mesh == "model":
        assert r0["loss"] == env["loss_tp"]
    else:
        assert abs(r0["loss"] - env["loss1"]) <= 1e-6 * env["loss1"]
    assert rel_l2(r1["grads"], r0["grads"]) == 0.0
    got = rel_l2(r0["grads"], env["grads1"])
    assert got <= GRAD_FACTOR * env["control"], (got, env["control"])


@pytest.mark.parametrize("mesh", MESHES)
def test_whole_leaves_bitwise_across_ranks_after_steps(env, mesh):
    r0, r1 = (r[mesh] for r in env["ranks"])
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == STEPS
    names = {k.rsplit("/", 1)[-1] for k in r0["whole"]}
    assert {"conv_w", "lambda", "b_a", "b_x", "ln1", "final_ln", "embed",
            "lm_head", "wk"} <= names
    for k, v in r0["whole"].items():
        np.testing.assert_array_equal(v, r1["whole"][k], err_msg=k)
    for a, b in zip(env["losses1"], r0["losses"]):
        assert abs(a - b) <= LOSS_REL * a
    assert rel_l2(r0["final"], env["final1"]) < 1e-4


@pytest.mark.parametrize("fault", list(_torch_ranks.HYBRID_FAULTS))
def test_planted_gate_faults_are_caught(env, fault):
    want, one = env["ref"]["prefill"], env["one"]["prefill"]
    for r in env["ranks"]:
        got = r["model"]["planted"][fault]
        assert not np.array_equal(got, r["model"]["arith_prefill"])
        assert not _in_class(got, want, one), corr(got, want)
        assert not _near_unsharded(got, one)
