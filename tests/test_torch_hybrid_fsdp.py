"""The hybrid LM (RecurrentGemma) under the FSDP tables: 4 gloo ranks on
the CPU, started once for the module by ``launch.mesh.spawn_ranks``
(their body is ``_torch_ranks.hybrid_fsdp_suite``, which imports neither
JAX nor the reference), under ``DEFAULT_RULES`` on (data 2, model 2) and
``MULTIPOD_RULES`` on (pod 2, data 1, model 2), held against the split's
arithmetic on one device, the port's unsharded runs and the reference
outside a mesh.

The model is ``test_torch_hybrid_mesh.py``'s: the reference's
recurrentgemma-9b smoke config at 5 layers (one (rec, rec, attn)
super-block and two tail recurrent layers, d 64, 4 heads on 1 KV head,
LRU width 64, d_ff 128, window 16, vocab 256), its params
``_torch_lm_ref.hybrid_smoke_model``'s. Each rank holds half of d_model
of every "p_embed" dim over the batch axes (``in_proj`` / ``gate_proj`` /
``w_gate`` / ``w_up`` / ``wq`` / ``wk`` / ``wv`` rows, ``out_proj`` /
``w_down`` / ``wo`` columns, the embedding's and the head's d_model),
over "model" 2 query heads, 64 of d_ff, 32 of the LRU width and 128 of
the vocab, 2 of the 4 batch rows, and 6 of the 12 ring slots. A
14-token prompt and 2 teacher-forced tokens through the decode step:
positions 0-5 write model rank 0's slots, 6-11 rank 1's, and the wrap
at 12 lands in rank 0's block. One case at an LRU width of 96 (d_model
64), so a "p_mlp" block (48) cannot pass for a "p_embed" one (32),
served over the first 8 positions.
Tolerances, ``test_torch_hybrid_mesh.py``'s classes:

  * the prefill and the decode logits at every position: bitwise the
    split's arithmetic on one device (``_torch_ranks.
    hybrid_fsdp_arithmetic`` on the rank's rows: the model split's column
    and row blocks and gate partials, the head's vocab blocks, each ring
    read as two slot blocks by B6's partial entry and merged); against
    the port's unsharded run corr > 0.9999 and equal argmax outside 1-ulp
    ties; against the reference's ``prefill_fn`` / ``decode_fn`` corr >
    0.999 and the argmax equal wherever the unsharded port's is, outside
    its own 1-ulp ties; the positions before the wrap checked on their
    own;
  * one train step: the 4 ranks' losses equal and within ``LOSS_REL``
    (measured 1.5e-7) of the split's arithmetic on one device's (the
    batch meaned over the ranks' rows, the vocab-parallel cross-entropy;
    that arithmetic's own loss sits up to 3.0e-5 from the unsharded one
    at LRU width 96, its f32 sums in another order); the gradient
    (measured 1.34e-2 / 1.41e-2 against controls of 1.40e-2 / 1.38e-2,
    LRU width 64 / 96) within
    ``GRAD_FACTOR`` times the order control (the split's arithmetic on
    one device, differentiated, against the unsharded gradient) of the
    unsharded gradient;
  * 2 steps through ``train_loop`` (under DEFAULT_RULES with remat and
    2 microbatches, ``_torch_ranks.loop_cfg``), checkpointed each step,
    against the same unsharded run: the losses
    and the whole leaves (``conv_w``, ``lambda``, ``b_a``, ``b_x``, the
    norms) bitwise equal across the ranks, the losses within
    ``test_torch_hybrid_mesh.py``'s 1e-3 of the unsharded run's, the
    gathered params within 1e-4 relative L2; every rank's blocks
    restored from the checkpoint bitwise, and the checkpoint restored on
    one device bitwise the gathered state;
  * planted faults, each missing its bound: the FSDP backward without
    its reduce-scatter (the gradient), the ring written at rank 0's slot
    on every rank and the merge without the last rank's partial (the
    decode logits, bitwise and in class).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import restore
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_grad_fn
from repro_torch.optim.adamw import tree_leaves

import _torch_ranks
from _torch_lm_ref import (argmax_outside_ties, assemble, corr,
                           hybrid_smoke_model, rel_l2)

B, P, T, RING, STEPS, WIDE = 4, 14, 2, 12, 2, 96
# the LRU-width case's positions and the faults' (the last with its key in
# model rank 1's slots)
WIDE_POS, FAULT_POS = RING // 2 + 2, RING // 2 + 1
GRAD_FACTOR = 4
LOSS_REL = 1e-6
STEPS_REL = 1e-3
SPAWN_TIMEOUT_S = 600
MESHES = ("default", "multipod")
FAULTS = _torch_ranks.HYBRID_FSDP_FAULTS


def _reference(jcfg, tree, prompt, toks, decode: bool) -> dict:
    """The reference's prefill_fn over the prompt and, with ``decode``,
    its decode_fn at every position of ``toks`` on the ring."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {"prefill": np.asarray(jax.jit(lambda p, t: japi.prefill_fn(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(prompt)), np.float32)}
    if decode:
        cache = {k: jnp.zeros(s, d) for k, (s, d) in
                 japi.cache_axes_spec(jcfg, B, RING)[0].items()}
        step = jax.jit(lambda p, c, t, pos: japi.decode_fn(p, c, t, pos,
                                                           jcfg))
        dec = []
        for pos in range(toks.shape[1]):
            lg, cache = step(jp, cache, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.int32(pos))
            dec.append(np.asarray(lg, np.float32))
        out["decode"] = np.stack(dec, 1)
    return out


def _one_device(tcfg, tp, prompt, forced, tb) -> dict:
    """The port's unsharded serve and train step, and the order control:
    the split's arithmetic on one device, differentiated."""
    pre, dec = _torch_ranks._hybrid_serve(tp, tcfg, torch.from_numpy(prompt),
                                          torch.from_numpy(forced), RING, B)
    grads_of = make_grad_fn(tcfg)
    loss, g = grads_of(tp, tb)
    with _torch_ranks.hybrid_fsdp_arithmetic(tp, tcfg):
        loss_split, g_split = grads_of(tp, tb)
    g = _torch_ranks._np_tree(g)
    return {"prefill": _torch_ranks._np32(pre),
            "decode": _torch_ranks._np32(dec), "loss": float(loss),
            "loss_split": float(loss_split), "grads": g,
            "control": rel_l2(_torch_ranks._np_tree(g_split), g)}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    jcfg, tcfg, tree = hybrid_smoke_model(5, seed=5)
    wjcfg, wtcfg, wtree = hybrid_smoke_model(5, seed=6, lru_width=WIDE)
    rng = np.random.default_rng(51)
    prompt = rng.integers(0, 256, (B, P)).astype(np.int32)
    forced = rng.integers(0, 256, (B, T)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    toks = np.concatenate([prompt, forced], 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = bridge.from_jax_params(tree, "cpu")
    wtp = bridge.from_jax_params(wtree, "cpu")
    loops = {}
    for mesh in MESHES:
        final1, losses1, _ = ttrain.train_loop(
            _torch_ranks.loop_cfg(tcfg, mesh), ShapeConfig("hy", P, B,
                                                           "train"),
            STEPS, device="cpu", state=ttrain.init_state(tcfg, 0, "cpu"),
            log_every=10 ** 9)
        loops[mesh] = (losses1, _torch_ranks._np_tree(final1))
    ckpt = str(tmp_path_factory.mktemp("hybrid_fsdp_ckpt"))
    ranks = spawn_ranks(_torch_ranks.hybrid_fsdp_suite, 4, tp, tcfg, prompt,
                        forced, batch, RING, STEPS, ckpt, (wtcfg, wtp),
                        device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return {"ref": _reference(jcfg, tree, prompt, toks, True),
            "wide_ref": _reference(wjcfg, wtree, prompt[:, :WIDE_POS], toks,
                                   False),
            "one": _one_device(tcfg, tp, prompt, forced, tb),
            "wide_one": _one_device(wtcfg, wtp, prompt[:, :WIDE_POS],
                                    forced[:, :0], tb),
            "ranks": ranks, "tcfg": tcfg, "ckpt": ckpt, "loops": loops}


def _of(env, mesh: str, key: str, sub: str | None = None) -> list:
    """Each rank's dict for ``mesh`` (its ``sub`` entry) as ``assemble``
    reads it: ``key`` and the rank's (batch, model) coords."""
    out = []
    for r in env["ranks"]:
        d = r[mesh] if sub is None else r[mesh][sub]
        out.append({"coords": r[mesh]["coords"], key: d[key]})
    return out


def _whole(env, mesh: str, key: str, sub: str | None = None) -> np.ndarray:
    """The whole (batch, vocab) of ``key`` from the 4 ranks' blocks."""
    return assemble(_of(env, mesh, key, sub), key, 2, 2)


def _in_class(got: np.ndarray, want: np.ndarray, one: np.ndarray) -> bool:
    """``test_torch_hybrid_mesh.py``'s class: corr > 0.999 against the
    reference, and its argmax wherever the unsharded port's ``one`` has
    it with its top two more than 1 bf16 ulp apart."""
    top2 = np.sort(one, -1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]) + 1e-30)) - 7)
    right = (one.argmax(-1) == want.argmax(-1)) & (
        top2[..., 1] - top2[..., 0] > ulp)
    return corr(got, want) > 0.999 and bool(
        (got.argmax(-1) == want.argmax(-1))[right].all())


def _near_unsharded(got: np.ndarray, one: np.ndarray) -> bool:
    return corr(got, one) > 0.9999 and argmax_outside_ties(got, one) == 0.0


def _spans(span: str):
    return range(RING) if span == "before the wrap" else range(RING, P + T)


def test_ranks_are_the_port_alone_and_hold_their_blocks(env):
    for r in env["ranks"]:
        assert not r["jax_loaded"] and not r["repro_loaded"]
    for mesh in MESHES:
        coords = sorted(r[mesh]["coords"] for r in env["ranks"])
        assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
        for r in env["ranks"]:
            m = r[mesh]
            assert m["drawn_bitwise"]
            assert m["shapes"] == {
                "in_proj": (1, 32, 32), "out_proj": (1, 32, 32),
                "w_a": (1, 32, 64), "conv_w": (1, 4, 64),
                "tail_in_proj": (2, 32, 32), "wq": (1, 32, 32),
                "w_down": (1, 64, 32), "embed": (128, 32),
                "lm_head": (32, 128)}
            assert m["cache"] == {
                "rec_h": (1, 2, B // 2, 32), "rec_conv": (1, 2, B // 2, 3, 32),
                "attn_k": (1, B // 2, RING // 2, 1, 16),
                "attn_v": (1, B // 2, RING // 2, 1, 16),
                "tail_h": (2, B // 2, 32), "tail_conv": (2, B // 2, 3, 32)}
            assert m["m_in_proj"] == (1, 32, 32)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("key", ["prefill", "decode"])
def test_logits_bitwise_the_split_arithmetic(env, mesh, key):
    for r in env["ranks"]:
        np.testing.assert_array_equal(r[mesh][key], r[mesh]["arith_" + key])


@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_prefill_matches_reference(env, mesh):
    got, want = _whole(env, mesh, "prefill"), env["ref"]["prefill"]
    one = env["one"]["prefill"]
    assert got.shape == want.shape == (B, P, 256)
    assert _in_class(got, want, one)
    assert _near_unsharded(got, one)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("span", ["before the wrap", "after the wrap"])
def test_split_ring_decode_matches_reference(env, mesh, span):
    got, want = _whole(env, mesh, "decode"), env["ref"]["decode"]
    one = env["one"]["decode"]
    assert got.shape == want.shape == (B, P + T, 256)
    for t in _spans(span):
        assert _in_class(got[:, t], want[:, t], one[:, t]), t
        assert _near_unsharded(got[:, t], one[:, t]), t


def test_greedy_tokens_agree_within_each_model_group(env):
    by = {r["default"]["coords"]: r["default"]["greedy"]
          for r in env["ranks"]}
    for d in range(2):
        assert by[(d, 0)].shape == (B // 2, 2)
        np.testing.assert_array_equal(by[(d, 0)], by[(d, 1)])


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_loss_and_gradient(env, mesh):
    rs = [r[mesh] for r in env["ranks"]]
    one = env["one"]
    for r in rs:
        assert r["loss"] == rs[0]["loss"] and r["gnorm"] == rs[0]["gnorm"]
        assert rel_l2(r["grads"], rs[0]["grads"]) == 0.0
    assert abs(rs[0]["loss"] - one["loss_split"]) <= LOSS_REL * one["loss"]
    got = rel_l2(rs[0]["grads"], one["grads"])
    assert got <= GRAD_FACTOR * one["control"], (got, one["control"])


@pytest.mark.parametrize("mesh", MESHES)
def test_steps_and_checkpoint_round_trip(env, mesh):
    rs = [r[mesh] for r in env["ranks"]]
    for r in rs:
        assert r["losses"] == rs[0]["losses"]
        assert r["restored_step"] == STEPS and r["restored_bitwise"]
        for k, v in r["whole"].items():
            np.testing.assert_array_equal(v, rs[0]["whole"][k], err_msg=k)
    assert {k.rsplit("/", 1)[-1] for k in rs[0]["whole"]} >= {
        "conv_w", "lambda", "b_a", "b_x", "ln1", "ln2", "final_ln"}
    losses1, final1 = env["loops"][mesh]
    for a, b in zip(losses1, rs[0]["losses"]):
        assert abs(a - b) <= STEPS_REL * a
    assert rel_l2(rs[0]["final"]["params"], final1["params"]) < 1e-4
    like = ttrain.init_state(env["tcfg"], 0, "cpu")
    back, step = restore(f"{env['ckpt']}/{mesh}/step_{STEPS}", like)
    assert step == STEPS
    for a, b in zip(tree_leaves(_torch_ranks._np_tree(back)),
                    tree_leaves(rs[0]["final"])):
        np.testing.assert_array_equal(a, b)


def test_lru_width_other_than_d_model(env):
    """LRU width 96 against d_model 64: a rank holds in_proj's (32, 48)
    block (d_model over "data", the width over "model"), and the split
    serves and steps as the equal-width model does."""
    one, ref = env["wide_one"], env["wide_ref"]
    for r in env["ranks"]:
        w = r["default"]["wide"]
        assert w["in_proj"] == (1, 32, WIDE // 2)
        for key in ("prefill", "decode"):
            np.testing.assert_array_equal(w[key], w["arith_" + key])
    got = _whole(env, "default", "prefill", "wide")
    assert _in_class(got, ref["prefill"], one["prefill"])
    assert _near_unsharded(got, one["prefill"])
    dec = _whole(env, "default", "decode", "wide")
    assert dec.shape == (B, WIDE_POS, 256)
    for t in range(WIDE_POS):
        assert _near_unsharded(dec[:, t], one["decode"][:, t]), t
    w0 = env["ranks"][0]["default"]["wide"]
    assert abs(w0["loss"] - one["loss_split"]) <= LOSS_REL * one["loss"]
    assert rel_l2(w0["grads"], one["grads"]) <= GRAD_FACTOR * one["control"]


def test_planted_fsdp_backward_fault_misses_the_gradient_bound(env):
    one = env["one"]
    for r in env["ranks"]:
        got = rel_l2(r["default"]["planted"][FAULTS[0]], one["grads"])
        assert got > 10 * GRAD_FACTOR * one["control"], got


@pytest.mark.parametrize("fault", FAULTS[1:])
def test_planted_ring_faults_miss_the_decode_bounds(env, fault):
    n = FAULT_POS
    got = _whole(env, "default", fault, "planted")
    assert got.shape == (B, n, 256)
    clean = _whole(env, "default", "decode")[:, :n]
    want, one = env["ref"]["decode"], env["one"]["decode"]
    assert not np.array_equal(got, clean)
    # the first steps read model rank 0's slots only; each fault shows from
    # the first step with a key in rank 1's block, before the wrap
    missed = [t for t in range(RING // 2, n)
              if not (_in_class(got[:, t], want[:, t], one[:, t])
                      and _near_unsharded(got[:, t], one[:, t]))]
    assert missed, missed
