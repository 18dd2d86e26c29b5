"""The port's checkpoints (``repro_torch.checkpoint``) and restartable step
loop (``distributed.fault_tolerance.run_with_restarts``) on torch trees,
the ground of the reference's ``test_checkpoint.py`` and
``test_fault_tolerance.py``, and the on-disk format across packages: a
directory either package writes verifies (checksum) and loads in the
other, bf16 leaves included. Every comparison is bitwise: a checkpoint
stores the leaves' bits."""

import os
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint.checkpoint import (CheckpointManager, async_save,
                                               latest_step, load_meta,
                                               restore, restore_flat, save)
from repro_torch.distributed.fault_tolerance import run_with_restarts
from repro_torch.distributed.sharding import MODEL_RULES, ShardingCtx


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32) + seed,
                       "c": torch.tensor(3.5 + seed)},
            "opt": {"m": torch.randn(4, 8, generator=g).bfloat16()},
            "host": np.arange(5, dtype=np.uint32) * (seed + 1)}


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert a.shape == b.shape and torch.equal(a, b)
    else:
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_save_restore_round_trip_keeps_dtypes(tmp_path):
    t = _tree()
    save(str(tmp_path / "ck"), t, step=7)
    t2, step = restore(str(tmp_path / "ck"), t)
    assert step == 7
    _assert_equal(t, t2)
    assert t2["opt"]["m"].dtype == torch.bfloat16
    meta = load_meta(str(tmp_path / "ck"))
    assert meta["dtypes"]["opt/m"] == "bfloat16"
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        ["meta.json", "a.npy", "nested__b.npy", "nested__c.npy",
         "opt__m.npy", "host.npy"])


def test_restore_flat_needs_no_template(tmp_path):
    t = _tree(1)
    save(str(tmp_path / "ck"), t, step=2, extra={"why": "test"})
    flat, step, extra = restore_flat(str(tmp_path / "ck"))
    assert (step, extra) == (2, {"why": "test"})
    assert sorted(flat) == ["a", "host", "nested/b", "nested/c", "opt/m"]
    assert flat["nested/c"].shape == () and flat["opt/m"].dtype == \
        torch.bfloat16
    assert torch.equal(flat["opt/m"], t["opt"]["m"])
    np.testing.assert_array_equal(flat["host"].numpy(), t["host"])


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    save(path, t, step=1)
    fn = os.path.join(path, "a.npy")
    np.save(fn, np.load(fn) + 1)
    with pytest.raises(IOError, match="checksum"):
        restore(path, t)
    with pytest.raises(IOError, match="checksum"):
        restore_flat(path)


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "ck")
    save(path, _tree(0), step=1)
    save(path, _tree(1), step=2)
    t2, step = restore(path, _tree(0))
    assert step == 2
    _assert_equal(t2, _tree(1))
    assert os.listdir(tmp_path) == ["ck"]            # no tmp dir left


def test_async_save_joinable_and_copied_at_call(tmp_path):
    t = _tree()
    want = {k: v for k, v in t.items()}
    want["a"] = t["a"].clone()
    th = async_save(str(tmp_path / "ck"), t, step=3)
    t["a"].add_(1.0)                  # after the call: not in the snapshot
    th.join()
    t2, step = restore(str(tmp_path / "ck"), _tree())
    assert step == 3
    assert torch.equal(t2["a"], want["a"])


def test_manager_retention_interval_and_empty_root(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), every=1, keep=2)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, _tree())
    mgr.wait()
    mgr._gc()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path / "r"))
    assert steps == [3, 4] and latest_step(str(tmp_path / "r")) == 4
    mgr = CheckpointManager(str(tmp_path / "i"), every=10, keep=5)
    for s in range(1, 25):
        mgr.maybe_save(s, _tree())
    mgr.wait()
    assert sorted(int(d.split("_")[1])
                  for d in os.listdir(tmp_path / "i")) == [10, 20]
    empty = CheckpointManager(str(tmp_path / "e"))
    assert empty.restore_latest(_tree()) == (None, 0)
    assert latest_step(str(tmp_path / "nowhere")) is None


@dataclass
class _StubMesh:
    """Rank (0, 1) of a (data 1, model 2) mesh: what ``local_shard``
    reads of ``launch.mesh.ServingMesh``."""

    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}

    def coord(self, axis):
        return {"data": 0, "model": 1}[axis]


def test_restore_with_ctx_returns_this_ranks_block(tmp_path):
    """Under MODEL_RULES on a two-way model mesh rank 1 gets the second
    half of a column-sharded ("p_mlp") and a head-sharded leaf; an axis
    the mesh does not divide, and a leaf without axes, stay whole."""
    t = {"w1": torch.arange(24.0).reshape(4, 6),
         "wq": torch.arange(40.0).reshape(2, 4, 5),
         "odd": torch.arange(15.0).reshape(5, 3),
         "ln": torch.ones(6)}
    axes = {"w1": ("p_embed", "p_mlp"), "wq": (None, "heads", None),
            "odd": ("p_mlp", None)}
    save(str(tmp_path / "ck"), t, step=5)
    got, step = restore(str(tmp_path / "ck"), t,
                        ShardingCtx(_StubMesh(), MODEL_RULES), axes)
    assert step == 5
    assert torch.equal(got["w1"], t["w1"][:, 3:])
    assert torch.equal(got["wq"], t["wq"][:, 2:])
    assert torch.equal(got["odd"], t["odd"])
    assert torch.equal(got["ln"], t["ln"])


def test_run_with_restarts_resumes_to_the_fault_free_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5, keep=3)
    armed = {"on": True}

    def step_fn(state, step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected preemption")
        return {"x": state["x"] + 1.0, "hist": state["hist"] + step}

    init = {"x": torch.zeros(()), "hist": torch.zeros((), dtype=torch.int64)}
    final, restarts = run_with_restarts(step_fn, init, 10, mgr)
    assert restarts == 1
    assert float(final["x"]) == 10.0 and int(final["hist"]) == sum(range(10))
    assert final["hist"].dtype == torch.int64
    assert latest_step(str(tmp_path)) == 10


def test_run_with_restarts_raises_past_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=100)
    calls = []

    def step_fn(state, step):
        calls.append(step)
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError, match="permafail"):
        run_with_restarts(step_fn, {"x": torch.zeros(())}, 5, mgr,
                          max_restarts=2)
    assert len(calls) == 3


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    """The reference's ``save`` (bf16 through ml_dtypes) -> the port's
    ``restore_flat`` and ``restore``: the checksum passes and the bits are
    the reference's."""
    k = jax.random.PRNGKey(0)
    jt = {"a": jax.random.normal(k, (4, 8)),
          "nested": {"b": jnp.arange(6, dtype=jnp.int32),
                     "c": jnp.float32(3.5)},
          "opt": {"m": jax.random.normal(k, (3, 5)).astype(jnp.bfloat16)},
          "key": jax.random.PRNGKey(7)}
    path = str(tmp_path / "ck")
    jckpt.save(path, jt, step=4, extra={"from": "reference"})
    flat, step, extra = restore_flat(path)
    assert (step, extra) == (4, {"from": "reference"})
    for key, leaf in (("a", jt["a"]), ("nested/b", jt["nested"]["b"]),
                      ("nested/c", jt["nested"]["c"]), ("key", jt["key"])):
        want = np.asarray(leaf)
        assert flat[key].numpy().dtype == want.dtype
        np.testing.assert_array_equal(flat[key].numpy(), want)
    m = flat["opt/m"]
    assert m.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jt["opt"]["m"]).view(np.uint16))
    like = {"a": torch.zeros(4, 8), "nested": {
        "b": torch.zeros(6, dtype=torch.int32), "c": torch.zeros(())},
        "opt": {"m": torch.zeros(3, 5, dtype=torch.bfloat16)},
        "key": np.zeros(2, np.uint32)}
    got, _ = restore(path, like)
    assert torch.equal(got["opt"]["m"], m)
    np.testing.assert_array_equal(got["key"], np.asarray(jt["key"]))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """The port's ``save`` (bf16 as uint16 bits) -> the reference's
    ``restore_flat`` and ``restore``: the checksum passes and the bits are
    the port's, the bf16 leaf read back as bfloat16."""
    t = _tree(2)
    path = str(tmp_path / "ck")
    save(path, t, step=6, extra={"from": "port"})
    host, step, extra = jckpt.restore_flat(path)
    assert (step, extra) == (6, {"from": "port"})
    assert str(host["opt/m"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        host["opt/m"].view(np.uint16),
        t["opt"]["m"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(host["a"], t["a"].numpy())
    np.testing.assert_array_equal(host["host"], t["host"])
    assert host["nested/c"].shape == ()
    like = {"a": jnp.zeros((4, 8)), "nested": {
        "b": jnp.zeros(6, jnp.int32), "c": jnp.float32(0)},
        "opt": {"m": jnp.zeros((4, 8), jnp.bfloat16)},
        "host": jnp.zeros(5, jnp.uint32)}
    got, step = jckpt.restore(path, like)
    assert step == 6 and got["opt"]["m"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["opt"]["m"]).view(np.uint16), host["opt/m"].view(
            np.uint16))
