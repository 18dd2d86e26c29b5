"""The dense LM on a (2, 1, 2) ("pod", "data", "model") mesh, for which
``rules_for_mesh`` picks ``MULTIPOD_RULES``: the batch and the FSDP dim
("p_embed") over ("pod", "data"), the vocab, the query heads, d_ff and the
decode cache's sequence over "model". 4 gloo ranks on the CPU, started
once for the module (``_torch_ranks.lm_fsdp_suite`` with ``pod``; the
mesh is ``launch/mesh.py::_build_mesh(..., n_pod=2)``), held against the
reference's functions outside a mesh with the model, inputs and
tolerances of ``test_torch_lm_fsdp.py``: one prefill, the prompt and 4
teacher-forced decode steps (on model rank 1's cache rows), one train
step, and the int8 prefill bitwise the unsharded one.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import MULTIPOD_RULES
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_grad_fn

import _torch_ranks
from _torch_lm_ref import (argmax_outside_ties, assemble, corr,
                           reference_runs, rel_l2, smoke_model, unsharded_runs)

B, P, T, CACHE = 4, 8, 4, 16
GRAD_REL = 3e-2
LOSS_REL = 2e-4
SPAWN_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def env():
    jcfg, tcfg, jp, tp, rng = smoke_model()
    prompt = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    ref = reference_runs(jcfg, jp, prompt, forced, batch, CACHE)
    one = unsharded_runs(tcfg, tp, prompt, forced, CACHE)
    _, g1 = make_grad_fn(tcfg)(tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    ranks = spawn_ranks(_torch_ranks.lm_fsdp_suite, 4, tp, tcfg, prompt,
                        forced, batch, CACHE, None, True, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return {"ref": ref, "one": one, "ranks": ranks,
            "grads1": _torch_ranks._np_tree(g1)}


def test_pod_mesh_takes_multipod_rules_and_splits_over_pod(env):
    assert sorted(r["coords"] for r in env["ranks"]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in env["ranks"]:
        assert r["shape"] == {"pod": 2, "data": 1, "model": 2}
        assert r["rules"] == MULTIPOD_RULES
        assert not r["jax_loaded"] and not r["repro_loaded"]
        # the FSDP dim over ("pod", "data"): 2 ranks, half of d_model
        assert r["shapes"]["wq"] == (2, 32, 32)
        assert r["shapes"]["embed"] == (128, 32)
        assert r["shapes"]["w_down"] == (2, 64, 32)
        assert r["cache_shape"] == (2, 2, CACHE // 2, 2, 16)


def test_multipod_prefill_and_decode_match_reference(env):
    ranks, ref, one = env["ranks"], env["ref"], env["one"]
    got = assemble(ranks, "prefill", 2, 2)
    assert got.shape == ref["prefill"].shape == (B, P, 256)
    assert corr(got, ref["prefill"]) > 0.999
    assert argmax_outside_ties(got, ref["prefill"]) == 0.0
    np.testing.assert_array_equal(got.argmax(-1), one["prefill"].argmax(-1))
    dec = assemble(ranks, "decode", 2, 2)
    assert dec.shape == ref["decode"].shape == (B, T + 1, 256)
    for t in range(T + 1):
        assert corr(dec[:, t], ref["decode"][:, t]) > 0.999, t
        assert argmax_outside_ties(dec[:, t], ref["decode"][:, t]) == 0.0
    np.testing.assert_array_equal(dec.argmax(-1), one["decode"].argmax(-1))
    by = {r["coords"]: r["greedy"] for r in ranks}
    for p in range(2):
        np.testing.assert_array_equal(by[(p, 0)], by[(p, 1)])


def test_multipod_train_step_loss_and_gradients(env):
    r0, ref = env["ranks"][0], env["ref"]
    for r in env["ranks"]:
        assert r["loss"] == r0["loss"] and r["gnorm"] == r0["gnorm"]
    for want in (ref["loss"], ref["step_loss"]):
        assert abs(r0["loss"] - want) <= LOSS_REL * abs(want)
    assert abs(r0["gnorm"] - ref["grad_norm"]) <= 2e-2 * ref["grad_norm"]
    assert rel_l2(r0["grads"], ref["grads"]) < GRAD_REL
    assert rel_l2(r0["grads"], env["grads1"]) < GRAD_REL


def test_int8_multipod_prefill_is_bitwise_unsharded(env):
    for r in env["ranks"]:
        assert r["int8_bitwise"], r["int8_maxdiff"]
