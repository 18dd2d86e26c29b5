"""ViT QAT training on every mesh: the port's train step under
``DATA_RULES`` (("data",) 4), ``MODEL_RULES`` and ``DEFAULT_RULES`` ((2,
2) ("data", "model")) and ``MULTIPOD_RULES`` ((2, 1, 2) ("pod", "data",
"model")), all four built in one group of 4 gloo ranks on the CPU
(``launch.mesh.spawn_ranks``; the body is ``_torch_ranks.vit_mesh_suite``,
which imports neither JAX nor the reference), held against the
reference's ``make_train_fn`` under ``jax.jit`` outside a mesh (it has no
green mesh anchor) and against the port's unsharded step.

The model is the reference's opto-vit smoke config (d 64, 4 heads, d_ff
128, 32x32 images in 8x8 patches) cut to 2 layers, plain and with MGNet
pruning (keep 0.5); the state is a numpy tree (``bridge.init_vit``'s
params, zero moments) fed to the reference's step as it is and to the
port's through ``bridge.from_jax_state``; the batch is ``ImageStream(32, 8,
n_classes=8, patch=8)``'s step 0, 2 rows a rank under DATA_RULES, 4 under
the others. Under MODEL_RULES each rank holds 2 of the 4 heads (wq / wk /
wv columns) and 64 of d_ff (w1 columns, b1, w2 rows); under the FSDP
tables also half of d_model of every "p_embed" leaf (the patch embed,
wq / wk / wv / w1 rows, wo / w2 / b2 columns, the head's rows).

Tolerances, the classes of ``test_torch_train.py::STEP_TOL``:

  * one mesh step: the loss within 1e-6 relative of the reference's and
    of the port's unsharded step, the clip norm and every leaf of the new
    first moment (0.1 x the clipped gradient, f32) within 1e-5 relative
    L2 without MGNet, 2e-2 with its pruning, or twice a measured control,
    whichever is larger (``CONTROL_FACTOR``): an activation at a
    rounding or clip boundary flips a code and the flip cascades. Against
    the port's unsharded step the control is its own summation order
    (with pruning it moves a leaf by 3.3e-2 at this batch, and the
    row-parallel sums under MODEL_RULES move it as far; without, 8e-7);
    against the reference's step also the reference against itself with
    its images one ulp up (3.1e-3 without pruning at this draw, where the
    port's step lands); MGNet's leaves zero in all. The tight link to the
    reference is a chain: each mesh step within 1e-5 of the port's
    unsharded step here (``test_mesh_step_matches_unsharded_step``), and
    that step within 1e-5 of the reference's on the reference's own init
    state (``test_torch_train.py::test_train_step_matches_reference``);
  * ``row_parallel_linear``: photonic_sim bitwise the unsharded entry,
    qat within 1e-6 relative L2; the LM's bf16 qat projection within one
    bf16 ulp of the reference's ``_qat_matmul`` (the f32 partial sums
    round once, in another order); the LM's qat gradient under
    MODEL_RULES within ``test_torch_lm_fsdp.py``'s 3e-2 of the port's
    unsharded one;
  * a 2-step checkpoint under DEFAULT_RULES: restored on one device
    bitwise the gathered state, into each rank's blocks bitwise;
  * planted faults, each against the unsharded gradient: rank-local
    activation scales (DATA_RULES), w2's weight absmax without its MAX
    over "model" (MODEL_RULES) and the FSDP backward without its
    reduce-scatter (DEFAULT_RULES) must each miss 1e-5 by 10x;
  * the fused serving encode under DEFAULT_RULES and MULTIPOD_RULES, on
    a cache the ranks gather from their blocks and prepare: bitwise the
    port's one-device encode of that cache (both encoders' contract),
    and against the reference's fused encode on one device the
    end-to-end class (corr > 0.999, equal top-1: PyTorch's and XLA's
    float ops differ by an ulp, so a requant may flip a code).
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.core import backend as jbackend
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import vit as jvit
from repro.models.layers import ExecPolicy as JPolicy

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import restore
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backend as tbackend
from repro_torch.core.backend import ExecPolicy, prepare_params
from repro_torch.core import noise as tnoise
from repro_torch.core.noise import NoiseSpec
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import ImageStream
from repro_torch.distributed import sharding
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import vit as tvit
from repro_torch.optim.adamw import tree_leaves

import _torch_ranks

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from qat_grad_gap import _qat_split  # noqa: E402

MG = dict(mgnet=True, mgnet_keep_ratio=0.5, mgnet_embed=32, mgnet_heads=2)
STEP = dict(lr_warmup=4, lr_total=200, use_fp32_master=True)
CASES = {"plain": {}, "mgnet": MG}
TABLES = ("data", "model", "default", "multipod")
STEP_TOL = {"plain": 1e-5, "mgnet": 2e-2}
LOSS_REL = 1e-6
# a case is held to its class or to CONTROL_FACTOR x a measured control,
# whichever is larger: against the port's unsharded step its own
# summation-order control (``_order_control``), against the reference's
# also the reference against itself with its images one ulp up. With
# pruning the order control reads 1.6e-2 at batch 4 (where the 2e-2 class
# was measured) and 3.3e-2 at this batch 8; at this draw the reference's
# own one-ulp control reads 3.1e-3 without pruning (an activation sits at
# a rounding boundary), where the port's step lands
CONTROL_FACTOR = 2
LM_GRAD_REL = 3e-2
B = 8
SPAWN_TIMEOUT_S = 600
# row_parallel_linear's cases: (x, w, policy kwargs, dtype); the last is
# the LM's w_down at smoke width, in bf16
_RNG = np.random.default_rng(28)
_X = _RNG.standard_normal((8, 128)).astype(np.float32)
_W = _RNG.standard_normal((128, 64)).astype(np.float32)
RP_CASES = [(_X, _W, dict(quant_bits=8, backend="photonic_sim"), "f32"),
            (_X, _W, dict(quant_bits=8, backend="qat"), "f32"),
            (_X, 0.05 * _W, dict(quant_bits=8, backend="qat"), "bf16")]
# the fused serving encode's flush: 4 frames of 16 patch tokens
TOKENS = _RNG.standard_normal((4, 16, 64)).astype(np.float32)


def _jcfg(**kw):
    return jsmoke(jget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _tcfg(**kw):
    return tsmoke(tget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcache(tree):
    """The port's prepared cache as the reference's."""
    if isinstance(tree, dict):
        return {k: _jcache(v) for k, v in tree.items()}
    if isinstance(tree, tbackend.QuantizedWeight):
        return jbackend.QuantizedWeight(jnp.asarray(tree.wq.numpy()),
                                        jnp.asarray(tree.scale.numpy()),
                                        tree.bits)
    return jnp.asarray(tree.numpy())


def _train_state(params: dict) -> dict:
    """A fresh train state of numpy leaves around ``params`` (f32
    moments, as ``use_fp32_master``), the shape of the reference's
    ``init_state``; drawn with ``bridge.init_vit``, which skips JAX's
    per-leaf random init."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return np.zeros_like(t, dtype=np.float32)
    return {"params": params,
            "opt": {"m": zeros(params), "v": zeros(params),
                    "count": np.zeros((), np.int32)},
            "step": np.zeros((), np.int32)}


def _drop_mgnet(state):
    """The plain config's state: the MGNet config's without its leaves."""
    def strip(t):
        return {k: v for k, v in t.items() if k != "mgnet"}
    return {"params": strip(state["params"]),
            "opt": {"m": strip(state["opt"]["m"]),
                    "v": strip(state["opt"]["v"]),
                    "count": state["opt"]["count"]},
            "step": state["step"]}


def _rel_l2(a, b):
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n > 0 else np.linalg.norm(a)


def _order_control(cfg, state, batch, m1) -> float:
    """The worst leaf's relative L2 of the unsharded step's first moment
    with every qat product summed in two halves against ``m1``: the
    class the GEMMs' summation order alone gives (scripts/
    qat_grad_gap.py's control)."""
    saved = tbackend.BACKENDS["qat"]
    tbackend.BACKENDS["qat"] = _qat_split
    try:
        new, _ = tsteps.make_train_fn(cfg)(state, batch)
    finally:
        tbackend.BACKENDS["qat"] = saved
    return max(_rel_l2(a, b) for a, b in zip(
        tree_leaves(_torch_ranks._np_tree(new["opt"]["m"])),
        tree_leaves(m1)) if b.any())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Every reference run, the port's unsharded steps and the 4 ranks'
    suite, once."""
    st = _train_state(bridge.init_vit(0, _tcfg(**MG), 1000))
    jstates = {"plain": _drop_mgnet(st), "mgnet": st}
    b = jpipe.ImageStream(32, B, n_classes=8, patch=8, seed=0).batch_at(0)
    batch = {k: np.array(b[k]) for k in ("images", "labels")}
    out = {"ref": {}, "one": {}, "batch": batch, "control": {},
           "one_tol": {}, "ref_tol": {}}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    states = {}
    up = dict(batch, images=np.nextafter(batch["images"],
                                         np.float32(np.inf)))
    for name, kw in CASES.items():
        ref_step = jax.jit(jsteps.make_train_fn(_jcfg(**kw)))
        new, m = ref_step(jstates[name], batch)
        out["ref"][name] = {"m": _np(new["opt"]["m"]),
                            "loss": float(m["loss"]),
                            "gnorm": float(m["grad_norm"])}
        # the reference against itself with its images one ulp up
        new_up, _ = ref_step(jstates[name], up)
        ulp = max(_rel_l2(np.asarray(a), np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(new_up["opt"]["m"]),
            jax.tree_util.tree_leaves(out["ref"][name]["m"])) if b.any())
        cfg = _tcfg(**kw)
        states[name] = bridge.from_jax_state(jstates[name], "cpu")
        tnew, tm = tsteps.make_train_fn(cfg)(states[name], tb)
        out["one"][name] = {"m": _torch_ranks._np_tree(tnew["opt"]["m"]),
                            "loss": float(tm["loss"]),
                            "gnorm": float(tm["grad_norm"])}
        ctl = _order_control(cfg, states[name], tb, out["one"][name]["m"])
        out["control"][name] = {"order": ctl, "reference_ulp": ulp}
        out["one_tol"][name] = max(STEP_TOL[name], CONTROL_FACTOR * ctl)
        out["ref_tol"][name] = max(out["one_tol"][name], CONTROL_FACTOR * ulp)
    # the LM's w_down projection under the reference's unsharded qat entry
    x, w, _, _ = RP_CASES[2]
    out["lm_ref"] = np.asarray(jbackend._qat_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        JPolicy(quant_bits=8, training=True)).astype(jnp.float32))
    # the dense LM with qat: its unsharded gradient in the port
    lcfg = tsmoke(tget("qwen2-1.5b")).with_(n_layers=2, quant_bits=8)
    ltree = bridge.init_lm(0, lcfg, "cpu")
    toks = _RNG.integers(0, lcfg.vocab, (4, 8)).astype(np.int32)
    lbatch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    _, lg = tsteps.make_grad_fn(lcfg)(ltree, {k: torch.from_numpy(v)
                                              for k, v in lbatch.items()})
    out["lm_one"] = _torch_ranks._np_tree(lg)
    # the reference's fused serving encode of TOKENS on one device, on
    # the cache of the plain params
    fcfg = dict(matmul_backend="photonic_pallas", attn_backend="flash",
                ffn_backend="fused")
    jcfg = _jcfg(**fcfg)
    cache = prepare_params(bridge.from_jax_params(
        jstates["plain"]["params"], "cpu"), bits=8)
    out["fused_ref"] = np.asarray(jvit.encode_tokens(
        _jcache(cache), jnp.asarray(TOKENS), jcfg,
        JPolicy.from_cfg(jcfg, training=False)))
    ckpt = str(tmp_path_factory.mktemp("vit_mesh_ckpt"))
    out["ranks"] = spawn_ranks(
        _torch_ranks.vit_mesh_suite, 4, states,
        {name: _tcfg(**kw) for name, kw in CASES.items()}, batch, RP_CASES,
        (lcfg, ltree, lbatch), ckpt, TOKENS, device="cpu",
        timeout_s=SPAWN_TIMEOUT_S)
    out["ckpt"] = ckpt
    return out


# local shapes a rank holds under each table: (wq, wo, w1, w2, the patch
# embed's w, the head, its images)
LOCAL = {"data": {"wq": (2, 64, 64), "wo": (2, 64, 64), "w1": (2, 64, 128),
                  "w2": (2, 128, 64), "patch_w": (192, 64),
                  "head": (64, 1000), "images": (2, 32, 32, 3)},
         "model": {"wq": (2, 64, 32), "wo": (2, 64, 64), "w1": (2, 64, 64),
                   "w2": (2, 64, 64), "patch_w": (192, 64),
                   "head": (64, 1000), "images": (4, 32, 32, 3)}}
LOCAL["default"] = LOCAL["multipod"] = {
    "wq": (2, 32, 32), "wo": (2, 64, 32), "w1": (2, 32, 64),
    "w2": (2, 64, 32), "patch_w": (192, 32), "head": (32, 1000),
    "images": (4, 32, 32, 3)}


@pytest.mark.parametrize("table", TABLES)
def test_ranks_hold_their_blocks(env, table):
    for r in env["ranks"]:
        assert not r["jax_loaded"] and not r["repro_loaded"]
        for name in CASES:
            assert r["steps"][(table, name)]["local"] == LOCAL[table]


def _check_step(got, want, tol):
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert abs(got["gnorm"] - want["gnorm"]) <= tol * want["gnorm"]
    paths = jax.tree_util.tree_flatten_with_path(want["m"])[0]
    leaves = tree_leaves(got["m"])
    assert len(paths) == len(leaves)
    for (path, wm), gm in zip(paths, leaves):
        name = jax.tree_util.keystr(path)
        if "mgnet" in name:
            assert not wm.any() and not gm.any(), name
            continue
        assert _rel_l2(gm, np.asarray(wm)) <= tol, (name,
                                                    _rel_l2(gm, wm))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("table", TABLES)
def test_mesh_step_matches_reference(env, table, case):
    """Every rank reports the same global loss and logical state. Held
    to the reference at ``ref_tol`` (twice the reference's one-ulp
    control without pruning: ~6.2e-3 at this draw); the 1e-5 class holds
    through the port's unsharded step
    (``test_mesh_step_matches_unsharded_step``, and
    ``test_torch_train.py::test_train_step_matches_reference``)."""
    r0 = env["ranks"][0]["steps"][(table, case)]
    for r in env["ranks"][1:]:
        assert r["steps"][(table, case)]["loss"] == r0["loss"]
    _check_step(r0, env["ref"][case], env["ref_tol"][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("table", TABLES)
def test_mesh_step_matches_unsharded_step(env, table, case):
    _check_step(env["ranks"][0]["steps"][(table, case)], env["one"][case],
                env["one_tol"][case])


@pytest.mark.parametrize("table", ["data", "model", "default"])
def test_planted_fault_misses_the_gradient_bound(env, table):
    """The check that holds the sound step to 1e-5 a leaf must fail each
    planted fault by 10x: the silent faults train on, their losses look
    plausible, only the gradient against the unsharded step shows them."""
    got = env["ranks"][0]["planted"][table]
    worst = max(_rel_l2(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(env["one"]["plain"]["m"])))
    assert worst > 10 * STEP_TOL["plain"], (_torch_ranks.VIT_FAULTS[table],
                                            worst)


def test_remat_on_the_mesh_leaves_the_step_unchanged(env):
    """``cfg.remat`` checkpoints each layer; its recompute re-enters the
    context and the absmax scope (``sharding.bound``), so the step is
    bitwise the one without remat."""
    got = env["ranks"][0]["remat"]
    want = env["ranks"][0]["steps"][("model", "plain")]
    assert got["loss"] == want["loss"] and got["gnorm"] == want["gnorm"]
    for a, b in zip(tree_leaves(got["m"]), tree_leaves(want["m"])):
        np.testing.assert_array_equal(a, b)


def _unsharded_entry(x, w, kw, dt):
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    if dt == "bf16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    p = ExecPolicy(**kw)
    with torch.no_grad():
        return p.matmul_fn(x, w, p).float().numpy()


def test_photonic_sim_row_parallel_is_bitwise(env):
    got = env["ranks"][0]["row_parallel"][0]
    np.testing.assert_array_equal(got, _unsharded_entry(*RP_CASES[0]))


def test_qat_row_parallel_within_1e_6(env):
    got = env["ranks"][0]["row_parallel"][1]
    assert _rel_l2(got, _unsharded_entry(*RP_CASES[1])) <= 1e-6


def test_lm_qat_row_parallel_matches_reference(env):
    """The LM's w_down projection in bf16 on qat under MODEL_RULES: within
    one bf16 ulp of the reference's unsharded ``_qat_matmul`` and of the
    port's; the scales equal, only the f32 sum's order differs."""
    got = env["ranks"][0]["row_parallel"][2]
    for want in (env["lm_ref"], _unsharded_entry(*RP_CASES[2])):
        ulp = np.abs(want) * 2.0 ** -7
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
        assert _rel_l2(got, want) < 1e-2


def test_lm_qat_gradient_under_model_rules(env):
    loss, grads = env["ranks"][0]["lm_qat"]
    for r in env["ranks"]:
        assert r["lm_qat"][0] == loss
    assert _rel_l2(np.concatenate([g.ravel() for g in tree_leaves(grads)]),
                   np.concatenate([g.ravel() for g in tree_leaves(
                       env["lm_one"])])) < LM_GRAD_REL


def test_checkpoint_restores_on_one_device_and_on_the_mesh(env):
    r0 = env["ranks"][0]
    for r in env["ranks"]:
        assert r["restored"] == (2, True)
        assert r["losses"] == r0["losses"]
    like = ttrain.init_state(_tcfg(), 0, "cpu")
    back, step = restore(f"{env['ckpt']}/step_2", like)
    assert step == 2
    for a, b in zip(tree_leaves(_torch_ranks._np_tree(back)),
                    tree_leaves(r0["final"])):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# no ranks: the streams' rows, the placement axes, what still raises
# --------------------------------------------------------------------------

def _fake_ctx(rules, **shape):
    coords = {ax: n - 1 for ax, n in shape.items()}
    mesh = types.SimpleNamespace(
        axis_names=tuple(shape), shape=shape, world=int(np.prod(
            list(shape.values()))), coord=lambda ax: coords[ax],
        group=lambda axes: None)
    return sharding.ShardingCtx(mesh, rules)


@pytest.mark.parametrize("table,shape,rows", [
    ("data", dict(data=4), slice(6, 8)),
    ("model", dict(data=2, model=2), slice(4, 8)),
    ("multipod", dict(pod=2, data=1, model=2), slice(4, 8))])
def test_image_stream_rows_are_the_global_batch_rows(table, shape, rows):
    rules = {"data": sharding.DATA_RULES, "model": sharding.MODEL_RULES,
             "multipod": sharding.MULTIPOD_RULES}[table]
    whole = ImageStream(32, B, n_classes=8, patch=8, seed=3).batch_at(5)
    mine = ImageStream(32, B, n_classes=8, patch=8, seed=3,
                       ctx=_fake_ctx(rules, **shape)).batch_at(5)
    assert mine.keys() == whole.keys()
    for k in whole:
        np.testing.assert_array_equal(mine[k], whole[k][rows])


def test_vit_placement_axes_drop_what_cannot_split():
    """A model axis that divides wq's columns but not the heads leaves
    them whole; the FSDP table keeps "p_embed" where it divides d_model."""
    cfg = _tcfg()
    with sharding._installed(_fake_ctx(sharding.DEFAULT_RULES, data=2,
                                       model=3)):
        ax = tvit.vit_placement_axes(cfg)
    assert ax["blocks"]["attn"]["wq"] == ("p_layers", "p_embed", None)
    assert ax["blocks"]["ffn"]["w2"] == ("p_layers", None, "p_embed")
    assert ax["patch_embed"]["w"] == (None, "p_embed")
    with sharding._installed(_fake_ctx(sharding.MODEL_RULES, data=1,
                                       model=2)):
        ax = tvit.vit_placement_axes(cfg)
    assert ax["blocks"]["attn"]["wq"] == ("p_layers", None, "p_heads")
    assert ax["head"] == (None, None)


def test_fused_serving_and_noise_on_a_mesh_raise(env):
    """The ViT's fused serving encode runs under the FSDP tables, inside
    the context it trains in: under DEFAULT_RULES on (2, 2) the
    model-sharded encode (each rank 2 of the 4 heads' wq columns), under
    MULTIPOD_RULES on (2, 1, 2) the data-split encode over ("pod",
    "data") on the whole cache, each on a cache its ranks gathered from
    their blocks and prepared. Its logits are bitwise the port's
    one-device encode of the same cache and in the reference's
    end-to-end class (corr > 0.999, equal top-1); the pod mesh's absmax
    scope left local to the rank breaks the equality. What still raises:
    noisy training on a mesh, naming queue A, item 1 (the reference's own
    "no noise scope" refusal where no scope is installed)."""
    want = env["fused_ref"]
    for table, wq in (("default", (2, 64, 32)), ("multipod", (2, 64, 64))):
        for r in env["ranks"]:
            f = r["fused"][table]
            np.testing.assert_array_equal(f["mesh"], f["one"])
            assert f["wq"] == wq
            assert (f["sharded"], f["split"]) == (
                (2, 0) if table == "default" else (0, 2))
            assert np.corrcoef(f["mesh"].ravel(), want.ravel())[0, 1] > 0.999
            assert (f["mesh"].argmax(-1) == want.argmax(-1)).all()
            if table == "multipod":
                assert not np.array_equal(f["planted"], f["one"])
    cfg = _tcfg()
    noisy = cfg.with_(noise=NoiseSpec())
    params = ttrain.init_state(cfg, 0, "cpu")["params"]
    with sharding._installed(_fake_ctx(sharding.DATA_RULES, data=2)):
        with pytest.raises(NotImplementedError, match="queue A, item 1"):
            tsteps.make_train_fn(noisy)
        with pytest.raises(RuntimeError, match="no noise scope"):
            tvit.forward_vit(params, torch.zeros(2, 32, 32, 3), cfg,
                             ExecPolicy.from_cfg(noisy), device="cpu")
        with tnoise.noise_scope(tnoise.DriftState.init(0)):
            with pytest.raises(NotImplementedError, match="queue A, item 1"):
                tvit.forward_vit(params, torch.zeros(2, 32, 32, 3), cfg,
                                 ExecPolicy.from_cfg(noisy), device="cpu")


def test_microbatched_quantizing_step_over_batch_ranks_raises():
    """A microbatched quantizing step builds on batch ranks (it was
    refused before ranks dealt their rows by microbatch): each rank's
    rows are its share of every global microbatch, so local microbatch i
    is its rows of the reference's microbatch i; a batch kD does not
    divide raises with the shapes (the ranks' steps:
    tests/test_torch_serve_mesh.py)."""
    ctx = _fake_ctx(sharding.DATA_RULES, data=2)       # this rank: d = 1
    batch = {"labels": np.arange(8, dtype=np.int32)}
    with sharding._installed(ctx):
        tsteps.make_train_fn(_tcfg(microbatch_steps=2))
    assert tpipe._rank_rows(batch, ctx, 2)["labels"].tolist() == [2, 3, 6, 7]
    assert tpipe._rank_rows(batch, ctx, 1)["labels"].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="multiple of 4"):
        tpipe._rank_rows({"labels": np.arange(6, dtype=np.int32)}, ctx, 2)
