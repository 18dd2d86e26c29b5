"""The dense LM under ``DEFAULT_RULES`` on a (2, 2) ("data", "model")
mesh: 4 gloo ranks on the CPU, started once for the module by
``launch.mesh.spawn_ranks`` (their body is ``_torch_ranks.lm_fsdp_suite``,
which imports neither JAX nor the reference), held against the
reference's functions outside a mesh (``_torch_lm_ref``).

The model is the reference's qwen2-1.5b smoke config cut to 2 layers (d
64, 4 heads over 2 KV heads, d_ff 128, vocab 256, bf16), params bridged
from the reference. Each rank holds half of d_model of every FSDP leaf
(its "p_embed" rows or columns over "data"), half of the vocab rows of
the tied embedding and 2 query heads and 64 of d_ff (over "model"), 2 of
the 4 batch rows, and 8 of the cache's 16 rows: the 8-token prompt fills
model rank 0's rows and the 6 decode steps land on model rank 1's.
Tolerances, the classes ``test_torch_lm_mesh.py`` states:

  * prefill logits against the reference's ``prefill_fn``: corr > 0.999
    and equal argmax wherever the reference's top two logits are more
    than 1 bf16 ulp apart; equal argmax everywhere against the port's
    unsharded prefill (at one position of these inputs the top two sit 1
    ulp apart, 0.58984 and 0.59375, and the port's unsharded forward swaps
    them against the reference, as the sharded one does);
  * teacher-forced decode logits (the same tokens fed to both) against
    the reference's ``decode_fn``: corr > 0.999 and the argmax as the
    prefill's at every step;
  * one train step's loss within 2e-4 relative of the reference's
    ``loss_fn`` and ``make_train_fn``, its clip norm within 2%, the
    gradient within ``GRAD_REL`` = 3e-2 relative L2 of the reference's
    and of the port's unsharded gradient;
  * the int8 (photonic_pallas) prefill: bitwise the unsharded one;
  * a checkpoint of 2 sharded train steps: restored on one device bitwise
    the gathered state, into each rank's blocks bitwise its live state;
  * planted faults: the FSDP backward without its reduce-scatter must
    miss ``GRAD_REL`` by 10x (measured 0.69); the vocab loss with the
    local block's max must miss the loss bound (measured 7.4e-4; its
    gradient, 1.2e-2, stays inside ``GRAD_REL``) and leave the ranks'
    losses unequal; the decode merge without the last rank's partial must
    miss the decode corr at a step whose key lies there (measured 0.40).
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import restore
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_grad_fn
from repro_torch.optim.adamw import tree_leaves

import _torch_ranks
from _torch_lm_ref import (argmax_outside_ties, assemble, corr,
                           reference_runs, rel_l2, smoke_model, unsharded_runs)

B, P, T, CACHE = 4, 8, 6, 16
GRAD_REL = 3e-2
LOSS_REL = 2e-4
SPAWN_TIMEOUT_S = 600
FSDP_FAULT = "fsdp backward without its reduce-scatter"
VOCAB_FAULT = "vocab loss with the local block's max"
MERGE_FAULT = "decode merge without the last rank's partial"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    jcfg, tcfg, jp, tp, rng = smoke_model()
    prompt = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    ref = reference_runs(jcfg, jp, prompt, forced, batch, CACHE)
    one = unsharded_runs(tcfg, tp, prompt, forced, CACHE)
    l1, g1 = make_grad_fn(tcfg)(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    ckpt = str(tmp_path_factory.mktemp("lm_fsdp_ckpt"))
    ranks = spawn_ranks(_torch_ranks.lm_fsdp_suite, 4, tp, tcfg, prompt,
                        forced, batch, CACHE, ckpt, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return {"ref": ref, "one": one, "ranks": ranks, "tcfg": tcfg, "ckpt": ckpt,
            "loss1": float(l1), "grads1": _torch_ranks._np_tree(g1)}


def test_ranks_hold_their_blocks_under_default_rules(env):
    coords = sorted(r["coords"] for r in env["ranks"])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in env["ranks"]:
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["rules"]["p_embed"] == "data"
        assert r["rules"]["kv_seq"] == "model"
        assert not r["jax_loaded"] and not r["repro_loaded"]
        # FSDP: half of d_model (64) of every leaf on "p_embed"; the vocab,
        # the query heads and d_ff halved over "model"; norms whole
        assert r["shapes"] == {"embed": (128, 32), "wq": (2, 32, 32),
                               "wk": (2, 32, 32), "wo": (2, 32, 32),
                               "w_up": (2, 32, 64), "w_down": (2, 64, 32),
                               "ln1": (2, 64)}
        assert r["m_shape"] == (2, 32, 32)
        # 2 of 4 batch rows and 8 of 16 cache rows
        assert r["cache_shape"] == (2, 2, CACHE // 2, 2, 16)


def test_fsdp_prefill_matches_reference(env):
    got = assemble(env["ranks"], "prefill", 2, 2)
    want = env["ref"]["prefill"]
    assert got.shape == want.shape == (B, P, 256)
    assert corr(got, want) > 0.999
    assert argmax_outside_ties(got, want) == 0.0
    np.testing.assert_array_equal(got.argmax(-1),
                                  env["one"]["prefill"].argmax(-1))


def test_kv_seq_split_decode_matches_reference(env):
    got = assemble(env["ranks"], "decode", 2, 2)
    want = env["ref"]["decode"]
    assert got.shape == want.shape == (B, T + 1, 256)
    for t in range(T + 1):
        assert corr(got[:, t], want[:, t]) > 0.999, t
        assert argmax_outside_ties(got[:, t], want[:, t]) == 0.0, t
    np.testing.assert_array_equal(got.argmax(-1),
                                  env["one"]["decode"].argmax(-1))


@pytest.mark.parametrize("key,n", [("greedy", T), ("sampled", 2)])
def test_generated_tokens_agree_within_each_model_group(env, key, n):
    """Greedy: the argmax across the vocab blocks; sampled: the whole row
    gathered, one generator seed on every rank."""
    by = {r["coords"]: r[key] for r in env["ranks"]}
    for d in range(2):
        assert by[(d, 0)].shape == (B // 2, n)
        np.testing.assert_array_equal(by[(d, 0)], by[(d, 1)])
        assert 0 <= by[(d, 0)].min() and by[(d, 0)].max() < 256


def test_fsdp_train_step_loss_and_gradients(env):
    r0, ref = env["ranks"][0], env["ref"]
    for r in env["ranks"]:
        assert r["loss"] == r0["loss"] and r["gnorm"] == r0["gnorm"]
        assert rel_l2(r["grads"], r0["grads"]) == 0.0
    for want in (ref["loss"], ref["step_loss"]):
        assert abs(r0["loss"] - want) <= LOSS_REL * abs(want)
    assert abs(r0["gnorm"] - ref["grad_norm"]) <= 2e-2 * ref["grad_norm"]
    assert rel_l2(r0["grads"], ref["grads"]) < GRAD_REL
    assert rel_l2(r0["grads"], env["grads1"]) < GRAD_REL


def test_planted_fsdp_backward_fault_misses_the_gradient_bound(env):
    _, grads, _ = env["ranks"][0]["planted"][FSDP_FAULT]
    got = rel_l2(grads, env["grads1"])
    assert got > 10 * GRAD_REL, got


def test_planted_vocab_max_fault_misses_the_loss_bound(env):
    loss, _, _ = env["ranks"][0]["planted"][VOCAB_FAULT]
    assert abs(loss - env["loss1"]) > LOSS_REL * abs(env["loss1"]), loss
    # and the model ranks' losses, equal in a sound step, disagree
    assert len({r["planted"][VOCAB_FAULT][0] for r in env["ranks"]}) > 1


def test_planted_merge_fault_misses_the_decode_bound(env):
    for r in env["ranks"]:
        r["merge_fault"] = r["planted"][MERGE_FAULT]
    got = assemble(env["ranks"], "merge_fault", 2, 2)
    want = env["ref"]["decode"]
    # the prompt's steps read model rank 0's rows only: unchanged there;
    # each forced step's own key lies on rank 1
    assert corr(got[:, 0], want[:, 0]) > 0.999
    assert min(corr(got[:, t], want[:, t]) for t in range(1, T + 1)) < 0.999


def test_int8_fsdp_prefill_is_bitwise_unsharded(env):
    for r in env["ranks"]:
        assert r["int8_bitwise"], r["int8_maxdiff"]


def test_fsdp_checkpoint_restores_on_one_device_and_on_the_mesh(env):
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
