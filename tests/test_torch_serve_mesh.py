"""Every ViT serving policy on the serving meshes, and microbatched
quantizing steps over batch ranks, on the CPU.

One spawn of 2 gloo CPU ranks (``launch.mesh.spawn_ranks``; the body is
``_torch_ranks.serve_mesh_suite``, which imports neither JAX nor the
reference) serves the reference's smoke config under calibrated device
noise with drift, wander and a recalibration bound (cut to 2 layers,
two streams of 4 frames), on two composed policies (photonic_sim + flash
+ xla; photonic_pallas + xla + xla with the ADC requant), each on the 1-D
data mesh ("data" 2) and on one rank alone (``mesh="off"``), the second
also on the model_shards mesh (1, 2); and runs
one k = 2 microbatched quantizing step of the ViT and of the dense LM
under DATA_RULES on ("data",) 2. The reference runs in this process.

Tolerances, and why:

  * the data mesh's serve against one rank's: predictions, flush log,
    every flush's DriftState and logits bitwise. A rank encodes its rows
    of a flush under the whole flush's activation and ADC scales (MAX
    over "data", exact) and draws its block of each readout's shot draw
    (``core/noise.py::readout_noise``: the rows are one contiguous range
    of the draw's flat index), and on the CPU every op is row-local. The
    same serve with every readout drawn at offset 0 (a planted fault)
    must not be bitwise;
  * the model_shards mesh's noisy serve: bitwise one rank's (its "data"
    axis has one rank, so each rank encodes the whole flush at offset 0
    on whole weights, replicated over "model");
  * the data mesh's first flush against the reference's noisy encode at
    that flush's DriftState: corr > 0.999 and the distance under a
    quarter of the reference's own frame-to-frame distance (the class
    of ``test_torch_noise.py``: XLA's erf_inv's log1p differs by ~5e-7);
  * the k = 2 steps: every microbatch's activation scales bitwise the
    one-device k = 2 step's (each is the global microbatch's absmax,
    MAX over the ranks); the ViT's new first moment within the STE class
    (1e-5 relative L2 a leaf without pruning, or twice a measured
    control: the port's own summation order, the reference against
    itself one ulp up) of the port's one-device k = 2 step and of the
    reference's k = 2 ``make_train_fn`` under ``jax.jit`` outside a mesh;
    the dense LM (the reference's qwen2-1.5b smoke init, 2 layers) with
    its bf16 weights cast to f32: its gradient within the STE class
    (1e-5 relative L2, or twice the port's own summation-order control)
    of the port's one-device k = 2 one; with its bf16 weights: within one
    bf16 ulp (2^-8 relative L2; measured 2.5e-3) of it, as each rank's
    bf16 partial gradient is rounded before the mean over "data" where
    one device rounds the whole microbatch's once, and the mesh's loss
    and gradient norm against the reference's k = 2 ``make_train_fn``
    within ``test_torch_lm_train.py``'s 2e-4 and 2% (the classes of two
    bf16 forwards). The previous row layout (each rank microbatching its
    own block, a planted fault) must break the scales.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.core import backend as jbackend
from repro.core import noise as jnoise
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import vit as jvit
from repro.serving.engine import _smoke_cfg
from repro_torch import bridge
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backend as tbackend
from repro_torch.core import quant as tquant
from repro_torch.core.noise import NoiseSpec
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serving import server as tserver

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from qat_grad_gap import _qat_split  # noqa: E402

SPAWN_TIMEOUT_S = 300.0
N_STREAMS, N_FRAMES, PHASE = 2, 4, 2
N_LAYERS = 2
SPEC = dict(drift_rate_nm=0.01, wander_sigma_nm=0.01, recal_bound_nm=0.05)
POLICIES = {"sim": ("photonic_sim", "flash", "xla", {}),
            "pallas": ("photonic_pallas", "xla", "xla",
                       {"adc_quantize_output": True})}
STEP = dict(lr_warmup=4, lr_total=200, use_fp32_master=True,
            microbatch_steps=2)
STEP_TOL = 1e-5
CONTROL_FACTOR = 2
LM_BF16_REL = 2.0 ** -8
LM_LOSS_REL = 2e-4
LM_NORM_REL = 2e-2
B = 8


def _noisy_cfg(tag):
    mm, attn, ffn, kw = POLICIES[tag]
    return tserver.smoke_cfg().with_(
        n_layers=N_LAYERS, matmul_backend=mm, attn_backend=attn,
        ffn_backend=ffn, noise=NoiseSpec(**SPEC, **kw))


def _jcfg(**kw):
    return jsmoke(jget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _tcfg(**kw):
    return tsmoke(tget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _jcache(tree):
    if isinstance(tree, dict):
        return {k: _jcache(v) for k, v in tree.items()}
    if isinstance(tree, tbackend.QuantizedWeight):
        return jbackend.QuantizedWeight(jnp.asarray(tree.wq.numpy()),
                                        jnp.asarray(tree.scale.numpy()),
                                        tree.bits)
    return jnp.asarray(tree.numpy())


def _train_state(params: dict) -> dict:
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return np.zeros_like(t, dtype=np.float32)
    return {"params": params,
            "opt": {"m": zeros(params), "v": zeros(params),
                    "count": np.zeros((), np.int32)},
            "step": np.zeros((), np.int32)}


def _rel_l2(a, b):
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n > 0 else np.linalg.norm(a)


def _worst(got, want) -> float:
    return max(_rel_l2(np.asarray(a), np.asarray(b)) for a, b in zip(
        tree_leaves(got), tree_leaves(want)) if np.asarray(b).any())


def _flat(tree):
    return np.concatenate([np.ravel(g) for g in tree_leaves(tree)])


def _one_device_lm(cfg, tree, batch):
    """The port's LM k = 2 gradient outside a mesh: (gradient, the
    activation scales in call order)."""
    rec = []
    with _torch_ranks.patched(tquant, "fake_quant_ste",
                              _torch_ranks.scale_recorder(rec)):
        _, g = tsteps.make_grad_fn(cfg)(tree, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    return _torch_ranks._np_tree(g), rec


def _one_device_step(cfg, state, batch):
    """The port's k = 2 step outside a mesh: (new first moment, the
    activation scales in call order)."""
    rec = []
    with _torch_ranks.patched(tquant, "fake_quant_ste",
                              _torch_ranks.scale_recorder(rec)):
        new, _ = tsteps.make_train_fn(cfg)(state, batch)
    return _torch_ranks._np_tree(new["opt"]["m"]), rec


@pytest.fixture(scope="module")
def env():
    """The ranks' suite, the reference's noisy encode of the data mesh's
    first flush at its state and the next frame's, the reference's and
    the port's one-device k = 2 steps, once."""
    raw = bridge.init_vit(0, _noisy_cfg("sim"), 10)
    vcfg = _tcfg()
    params = bridge.init_vit(0, vcfg, 1000)
    state = _train_state(params)
    b = jpipe.ImageStream(32, B, n_classes=8, patch=8, seed=0).batch_at(0)
    batch = {k: np.array(b[k]) for k in ("images", "labels")}
    lm_kw = dict(n_layers=2, quant_bits=8, microbatch_steps=2)
    lcfg = tsmoke(tget("qwen2-1.5b")).with_(**lm_kw)
    jlcfg = jsmoke(jget("qwen2-1.5b")).with_(**lm_kw)
    jlstate = jtrain.init_state(jlcfg, 0)
    ltree = bridge.from_jax_state(jlstate, "cpu")["params"]
    lm = {"bf16": ltree, "f32": tree_map(lambda t: t.float(), ltree)}
    toks = np.random.default_rng(29).integers(0, lcfg.vocab, (8, 8)).astype(
        np.int32)
    lbatch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out = {"ranks": spawn_ranks(
        _torch_ranks.serve_mesh_suite, 2, raw,
        {tag: _noisy_cfg(tag) for tag in POLICIES}, N_STREAMS, N_FRAMES,
        PHASE, {"plain": (vcfg, bridge.from_jax_state(state, "cpu"), batch)},
        {k: (lcfg, t, lbatch) for k, t in lm.items()},
        device="cpu", timeout_s=SPAWN_TIMEOUT_S)}
    # the reference's noisy encode of the data mesh's first flush
    first = out["ranks"][0]["sim"]["data"]
    key = next(iter(first["logits"]))
    words = first["states"][key]
    frame, drift = int(words[2]), words[3:4].view(np.float32)[0]
    mm, attn, ffn, kw = POLICIES["sim"]
    jcfg = _smoke_cfg(mm, attn, ffn).with_(
        n_layers=N_LAYERS, noise=jnoise.NoiseSpec(**SPEC, **kw))
    jpol = jbackend.ExecPolicy.from_cfg(jcfg, training=False)
    cache = _jcache(tbackend.prepare_params(
        bridge.from_jax_params(raw, "cpu"), bits=8))
    enc = jax.jit(lambda p, t, ns: jnoise.scoped(
        ns, lambda: jvit.forward_vit_tokens(p, t, jcfg, jpol)[0]))
    tokens = jnp.asarray(first["tokens"][key])
    out["ref_flush"] = [np.asarray(enc(cache, tokens, jnoise.DriftState(
        jax.random.PRNGKey(0), jnp.int32(f), jnp.float32(drift))))
        for f in (frame, frame + 1)]
    out["flush_key"] = key
    # the k = 2 steps: the reference's (and against itself one ulp up),
    # the port's with its summation-order control
    ref_step = jax.jit(jsteps.make_train_fn(_jcfg()))
    ref_m = {}
    for tag, images in (("ref", batch["images"]),
                        ("ulp", np.nextafter(batch["images"],
                                             np.float32(np.inf)))):
        new, _ = ref_step(state, dict(batch, images=images))
        ref_m[tag] = jax.tree_util.tree_map(np.asarray, new["opt"]["m"])
    out["ref_m"] = ref_m["ref"]
    tstate = bridge.from_jax_state(state, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["one_m"], out["one_scales"] = _one_device_step(vcfg, tstate, tb)
    saved = tbackend.BACKENDS["qat"]
    tbackend.BACKENDS["qat"] = _qat_split
    try:
        order_m, _ = _one_device_step(vcfg, tstate, tb)
    finally:
        tbackend.BACKENDS["qat"] = saved
    out["one_tol"] = max(STEP_TOL, CONTROL_FACTOR * _worst(order_m,
                                                           out["one_m"]))
    out["ref_tol"] = max(out["one_tol"], CONTROL_FACTOR * _worst(
        ref_m["ulp"], ref_m["ref"]))
    # the LM: the port's one-device k = 2 gradients, the f32 one's
    # summation-order control, the reference's k = 2 step
    out["lm_one"] = {k: _one_device_lm(lcfg, t, lbatch)
                     for k, t in lm.items()}
    tbackend.BACKENDS["qat"] = _qat_split
    try:
        order_g, _ = _one_device_lm(lcfg, lm["f32"], lbatch)
    finally:
        tbackend.BACKENDS["qat"] = saved
    want = _flat(out["lm_one"]["f32"][0])
    out["lm_f32_tol"] = max(STEP_TOL, CONTROL_FACTOR * _rel_l2(
        _flat(order_g), want))
    _, metrics = jax.jit(jsteps.make_train_fn(jlcfg))(jlstate, lbatch)
    out["lm_ref"] = {k: float(v) for k, v in metrics.items()}
    return out


def test_ranks_import_neither_jax_nor_the_reference(env):
    for r in env["ranks"]:
        assert "jax" not in r["modules"]
        assert "repro" not in r["modules"]


def _same_serve(got, want):
    assert got["predictions"] == want["predictions"]
    assert got["flush_log"] == want["flush_log"]
    assert got["logits"].keys() == want["logits"].keys()
    for k in want["logits"]:
        np.testing.assert_array_equal(got["states"][k], want["states"][k])
        np.testing.assert_array_equal(got["logits"][k], want["logits"][k])
    assert got["recalibrations"] == want["recalibrations"] > 0
    np.testing.assert_array_equal(got["final"], want["final"])


@pytest.mark.parametrize("tag", list(POLICIES))
def test_noisy_data_mesh_serve_is_the_one_device_serve(env, tag):
    """Both ranks on ("data",) 2 serve every flush split in two, each at
    its rows' offset of the shot draws, under the whole flush's scales:
    bitwise one rank's serve, DriftStates and recalibrations included."""
    for r in env["ranks"]:
        assert r[tag]["data"]["mesh"] == {"data": 2}
        _same_serve(r[tag]["data"], r[tag]["off"])


def test_noisy_model_shards_serve_is_the_one_device_serve(env):
    """``model_shards=2`` under a NoiseSpec serves (it raised before): the
    whole cache on both ranks, the encode split over its one "data" rank,
    bitwise one rank's serve."""
    for r in env["ranks"]:
        assert r["pallas"]["model"]["mesh"] == {"data": 1, "model": 2}
        _same_serve(r["pallas"]["model"], r["pallas"]["off"])


def test_readouts_at_offset_zero_break_the_equality(env):
    """Each rank drawing its readouts at offset 0 (the whole launch's
    first rows' noise on every rank): some flush's logits differ."""
    for r in env["ranks"]:
        got, want = r["offset0"]["logits"], r["sim"]["off"]["logits"]
        assert [k for k in want if not np.array_equal(got[k], want[k])]


def test_noisy_data_mesh_flush_matches_reference_at_its_state(env):
    """The data mesh's first flush against the reference's noisy encode of
    the same tokens at the flush's DriftState (``test_torch_noise.py``'s
    class; a wrong offset or key draws unrelated noise and lands at the
    frame-to-frame distance)."""
    port = env["ranks"][0]["sim"]["data"]["logits"][env["flush_key"]]
    ref_f, ref_next = env["ref_flush"]
    assert np.corrcoef(np.ravel(ref_f), np.ravel(port))[0, 1] > 0.999
    assert (np.abs(ref_f - port).max()
            < np.abs(ref_f - ref_next).max() / 4)


def test_microbatch_scales_are_the_one_device_steps(env):
    """Every activation scale of the k = 2 mesh step, on every rank, is
    bitwise the one-device k = 2 step's in the same call: the global
    microbatch's absmax. Each rank holds 4 rows, 2 of each microbatch."""
    want = env["one_scales"]
    for r in env["ranks"]:
        got = r["steps"]["plain"]
        assert got["rows"] == (4,)
        assert len(got["scales"]) == len(want) > 0
        for g, w in zip(got["scales"], want):
            np.testing.assert_array_equal(g, w)


def test_rank_local_row_split_breaks_the_scales(env):
    """The previous layout (each rank microbatching its own block of the
    batch) quantizes microbatch i over other rows: the scale check must
    fail."""
    want = env["one_scales"]
    got = env["ranks"][0]["steps"]["planted"]["scales"]
    assert len(got) == len(want)
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))


def test_microbatch_step_matches_one_device_and_reference(env):
    """The mesh's k = 2 step: the ranks' losses equal, its first moment
    within the STE class of the port's one-device k = 2 step and of the
    reference's k = 2 ``make_train_fn``."""
    r0 = env["ranks"][0]["steps"]["plain"]
    assert env["ranks"][1]["steps"]["plain"]["loss"] == r0["loss"]
    assert _worst(r0["m"], env["one_m"]) <= env["one_tol"]
    assert _worst(r0["m"], env["ref_m"]) <= env["ref_tol"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_microbatched_qat_step_over_batch_ranks(env, dtype):
    """The dense LM's k = 2 qat step on ("data",) 2 runs (it was refused):
    its activation scales bitwise the one-device k = 2 step's, the ranks'
    losses equal, its gradient within the STE class of the one-device
    one in f32, and within one bf16 ulp of it in bf16."""
    grads, scales = env["lm_one"][dtype]
    r0 = env["ranks"][0]["steps"]["lm"][dtype]
    assert env["ranks"][1]["steps"]["lm"][dtype]["loss"] == r0["loss"]
    assert len(r0["scales"]) == len(scales) > 0
    for g, w in zip(r0["scales"], scales):
        np.testing.assert_array_equal(g, w)
    tol = env["lm_f32_tol"] if dtype == "f32" else LM_BF16_REL
    assert _rel_l2(_flat(r0["grads"]), _flat(grads)) <= tol


def test_lm_microbatched_step_matches_reference(env):
    """The mesh's bf16 k = 2 step against the reference's k = 2
    ``make_train_fn`` on the whole batch outside a mesh: the loss within
    2e-4 relative, the gradient's global norm within 2%."""
    r0 = env["ranks"][0]["steps"]["lm"]["bf16"]
    ref = env["lm_ref"]
    assert abs(r0["loss"] - ref["loss"]) <= LM_LOSS_REL * abs(ref["loss"])
    assert abs(r0["gnorm"] - ref["grad_norm"]) <= LM_NORM_REL * ref[
        "grad_norm"]


def test_uneven_microbatch_split_raises(env):
    assert env["ranks"][0]["steps"]["uneven"] == (
        "labels (6,): a batch of 6 rows in 2 microbatches over 2 batch "
        "ranks needs rows a multiple of 4")
