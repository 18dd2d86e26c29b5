"""ViT training in the port (``repro_torch.optim``, ``launch/steps.py``,
``launch/train.py``, the straight-through ``quant.fake_quant_ste``,
``mgnet.bce_loss``, ``data/pipeline.py::ImageStream``) held against the
reference on equal numpy inputs, at the tolerances each test states.

Classes of agreement:
  * the STE's values and gradient, ``ImageStream`` / ``quadrant_labels``,
    AdamW, SGD and the schedule during warmup are bitwise (the reference
    run op by op, as it computes them outside a jit); the cosine branch of
    the schedule within 1 ulp (XLA's and PyTorch's f32 cos differ);
  * one train step (the reference's ``make_train_fn`` under ``jax.jit``,
    outside any mesh) agrees to ~1e-6 in the gradients without MGNet
    pruning. With pruning the STE's gradient is discontinuous where an
    activation's x / s sits exactly on the clip bound (0.5 there, 1 an
    ulp inside): the reference against itself with its images one ulp up
    moves ``ln1_g``'s gradient by 7.8e-3 in relative L2 at smoke size, and
    the port sits in that class (<= 2e-2). The AdamW step is +-lr for any
    gradient well above eps, so an ulp-noise gradient can move a
    parameter the other way: new params agree within 2 lr;
  * a short loss curve: both fall, within a stated tolerance;
  * within the port, a run resumed from a checkpoint, or after an
    injected fault, is bitwise the straight run.

Every reference run is served from the module fixture ``ref``.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.core import mgnet as jmgnet
from repro.core import quant as jquant
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models.layers import ExecPolicy as JPolicy
from repro.optim import adamw as jadamw

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import mgnet as tmgnet
from repro_torch.core import quant as tquant
from repro_torch.core.backend import ExecPolicy, prepare_params
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models.vit import forward_vit
from repro_torch.optim import adamw as tadamw

MG = dict(mgnet=True, mgnet_keep_ratio=0.5, mgnet_embed=32, mgnet_heads=2)
CASES = {"plain": {}, "mgnet": MG, "microbatch": dict(microbatch_steps=2)}
# every step comparison: a short warmup, so the loss curve's 12 steps
# train at all, and f32 moments, so the first step's m = 0.1 x the
# clipped gradient carries every gradient leaf in f32 (the bf16 moments
# are held bitwise by test_adamw_update_bitwise and within the port by
# the resume tests)
STEP = dict(lr_warmup=4, lr_total=200, use_fp32_master=True)
CURVE_STEPS = 12


def _jcfg(**kw):
    return jsmoke(jget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _tcfg(**kw):
    return tsmoke(tget("opto-vit-tiny")).with_(n_layers=2, **{**STEP, **kw})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jbatch(step, seed=0):
    b = jpipe.ImageStream(32, 4, n_classes=8, patch=8, seed=seed).batch_at(step)
    return {k: b[k] for k in ("images", "labels")}


def _tbatch(step, seed=0):
    b = tpipe.ImageStream(32, 4, n_classes=8, patch=8, seed=seed,
                          device="cpu").batch_at(step)
    return {k: b[k] for k in ("images", "labels")}


@pytest.fixture(scope="module")
def ref():
    """Every reference run of this file, once."""
    out = {}
    jcfg = _jcfg()
    state0 = jtrain.init_state(jcfg, 0)
    out["state0"] = _np(state0)
    batch = _jbatch(0)
    fns = {}
    for name, kw in CASES.items():
        cfg = _jcfg(**kw)
        st = state0 if not kw.get("mgnet") else jtrain.init_state(cfg, 0)
        fns[name] = jax.jit(jsteps.make_train_fn(cfg))
        new, m = fns[name](st, batch)
        out[name] = {"state0": _np(st), "new": _np(new),
                     "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])}
    # the loss curve: the reference's step under jit, outside any mesh
    st, losses = state0, []
    for i in range(CURVE_STEPS):
        st, m = fns["plain"](st, _jbatch(i))
        losses.append(float(m["loss"]))
    out["curve"] = losses
    return out


# --------------------------------------------------------------------------
# the straight-through estimator
# --------------------------------------------------------------------------

def _on_bound_input(bits, axis, seed):
    """A tensor whose absmax element lands exactly on the clip bound
    (x / s == qmax) in at least one reduction group."""
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    for _ in range(200):
        x = rng.standard_normal((6, 10)).astype(np.float32)
        s = np.asarray(jquant.absmax_scale(jnp.asarray(x), bits, axis))
        if np.any(np.abs(x / s) == qmax):
            return x
    raise AssertionError("no on-bound draw")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [None, 0])
def test_ste_values_and_gradient_match_jax(bits, axis):
    """Forward bitwise and gradient bitwise against ``jax.grad`` of the
    reference's ``fake_quant_ste``, with the absmax element on the bound:
    there the gradient is 0.5 (``jnp.clip``'s VJP), where
    ``torch.clamp``'s would be 1."""
    x = _on_bound_input(bits, axis, seed=bits)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jy = np.asarray(jquant.fake_quant_ste(jnp.asarray(x), bits, axis))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(
        jquant.fake_quant_ste(v, bits, axis) * r))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tquant.fake_quant_ste(xt, bits, axis)
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), jy)
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    # the on-bound elements took half the cotangent
    on = np.abs(x / np.asarray(jquant.absmax_scale(jnp.asarray(x), bits,
                                                   axis))) == 2 ** (bits - 1) - 1
    assert on.any()
    np.testing.assert_array_equal(xt.grad.numpy()[on], 0.5 * r[on])
    # values equal the inference form's, with and without autograd
    np.testing.assert_array_equal(
        tquant.fake_quant(torch.from_numpy(x), bits, axis).numpy(), jy)
    np.testing.assert_array_equal(
        tquant.fake_quant_ste(torch.from_numpy(x), bits, axis).numpy(), jy)


def test_qat_entry_switches_on_training():
    """The ``qat`` entry's gradient under a training policy is the STE's
    (the reference's); under ``training=False`` the inference fake quant's
    round passes no gradient, so x and w get one only through their
    absmax scales; values are equal either way."""
    from repro.core.backend import linear as jlinear
    from repro_torch.core.backend import linear as tlinear
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    jp = JPolicy(quant_bits=8, training=True)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jlinear(a, b, policy=jp) ** 2),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    outs = {}
    for training in (True, False):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y = tlinear(xt, wt, policy=ExecPolicy(quant_bits=8,
                                              training=training))
        (y ** 2).sum().backward()
        outs[training] = (y.detach(), xt.grad, wt.grad)
    assert torch.equal(outs[True][0], outs[False][0])
    # f32 matmul backward: the two libraries' accumulation orders differ
    np.testing.assert_allclose(outs[True][1].numpy(), np.asarray(jgx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[True][2].numpy(), np.asarray(jgw),
                               rtol=1e-5, atol=1e-5)
    # the inference form's round has a zero gradient: only the absmax
    # elements (the scale's argmax, per tensor / per output channel) get one
    assert int((outs[False][1] != 0).sum()) <= 1
    assert int((outs[False][2] != 0).sum()) <= w.shape[1]


# --------------------------------------------------------------------------
# optimizer and schedule
# --------------------------------------------------------------------------

def _tree_np(seed):
    """A small nested param-like tree (keys out of sorted order)."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return {"w": f(6, 5), "b": f(5), "a": {"z": f(3, 4), "y": f(2)}}


def _to_t(tree):
    return tadamw.tree_map(lambda a: bridge._to_tensor(a), tree)


def _eq(t_tree, j_tree):
    for a, b in zip(tadamw.tree_leaves(t_tree),
                    jax.tree_util.tree_leaves(j_tree)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            a, b = a.float().numpy(), b.astype(np.float32)
        else:
            a = a.numpy()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("low_mem", [False, True])
def test_adamw_update_bitwise(low_mem):
    """Three updates from equal params, grads and lr multipliers, f32 and
    bf16 moments: params, m, v and count bitwise (the reference op by op:
    each jnp op is its own XLA computation, as torch's)."""
    jc = jadamw.AdamWConfig(low_mem=low_mem)
    tc = tadamw.AdamWConfig(low_mem=low_mem)
    p = _tree_np(0)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = jadamw.adamw_init(jp, jc)
    tp = _to_t(p)
    ts = tadamw.adamw_init(tp, tc)
    for i, scale in enumerate((0.01, 0.5, 1.0)):
        g = _tree_np(10 + i)
        jp, js = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                     js, jp, jc, jnp.float32(scale))
        tp, ts = tadamw.adamw_update(_to_t(g), ts, tp, tc,
                                     torch.tensor(scale))
        _eq(tp, jp)
        _eq(ts["m"], js["m"])
        _eq(ts["v"], js["v"])
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32
    if low_mem:
        assert tadamw.tree_leaves(ts["m"])[0].dtype == torch.bfloat16


def test_sgd_update_bitwise():
    p, g = _tree_np(1), _tree_np(2)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = jadamw.sgd_init(jp)
    tp, ts = _to_t(p), tadamw.sgd_init(_to_t(p))
    for _ in range(3):
        jp, js = jadamw.sgd_update(jax.tree_util.tree_map(jnp.asarray, g),
                                   js, jp, 0.05)
        tp, ts = tadamw.sgd_update(_to_t(g), ts, tp, 0.05)
    _eq(tp, jp)
    _eq(ts["mom"], js["mom"])


def test_warmup_cosine():
    """Bitwise in the warmup; within 1 ulp on the cosine branch (XLA's and
    PyTorch's f32 cos differ by an ulp at ~2.5% of arguments)."""
    for step in (0, 1, 7, 50, 99):
        a = float(tadamw.warmup_cosine(step + 1 if step == 99 else step))
        b = float(jadamw.warmup_cosine(step + 1 if step == 99 else step))
        assert np.float32(a) == np.float32(b)
    steps = np.array([100, 101, 777, 5000, 9999, 10000, 20000])
    for s in steps:
        a = np.float32(float(tadamw.warmup_cosine(torch.tensor(int(s)))))
        b = np.float32(float(jadamw.warmup_cosine(int(s))))
        assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 1, s
    a = tadamw.warmup_cosine(3, warmup=4, total=20, floor=0.2,
                             peak_lr_scale=2.0)
    b = jadamw.warmup_cosine(3, warmup=4, total=20, floor=0.2,
                             peak_lr_scale=2.0)
    assert np.float32(float(a)) == np.float32(float(b))


@pytest.mark.parametrize("big", [False, True])
def test_clip_by_global_norm(big):
    """The norm sums the leaves in the reference's order (keys sorted):
    bitwise at small leaves; at a 4096-element leaf within 2 ulps, where
    XLA's and PyTorch's in-leaf reduction orders differ. The clipped
    leaves carry the same scale."""
    if big:
        tree = {"w": np.random.default_rng(4).standard_normal(
            (64, 64)).astype(np.float32) * 3,
            "b": np.random.default_rng(5).standard_normal(64).astype(
                np.float32)}
    else:
        tree = _tree_np(3)
    jg, jn = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    tg, tn = tadamw.clip_by_global_norm(_to_t(tree), 1.0)
    a, b = np.float32(tn.item()), np.float32(np.asarray(jn))
    assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= (2 if big
                                                                   else 0)
    if a == b:
        _eq(tg, jg)
    # a tree already inside the norm is returned as it is
    small = tadamw.tree_map(lambda t: t * 1e-3, _to_t(tree))
    out, _ = tadamw.clip_by_global_norm(small)
    for x, y in zip(tadamw.tree_leaves(out), tadamw.tree_leaves(small)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# data, MGNet's loss and the top-k gather
# --------------------------------------------------------------------------

@pytest.mark.parametrize("img,batch,patch,step", [(32, 8, 8, 0), (32, 8, 8, 7),
                                                  (224, 2, 16, 3)])
def test_image_stream_and_quadrant_labels_bitwise(img, batch, patch, step):
    jb = jpipe.ImageStream(img, batch, n_classes=8, patch=patch,
                           seed=5).batch_at(step)
    tb = tpipe.ImageStream(img, batch, n_classes=8, patch=patch,
                           seed=5).batch_at(step)
    for k in ("images", "labels", "patch_mask"):
        assert tb[k].dtype == np.asarray(jb[k]).dtype
        np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
    tq = tpipe.ImageStream(img, batch, n_classes=8, patch=patch, seed=5,
                           device="cpu").batch_at(step)
    assert torch.equal(tq["labels"], torch.from_numpy(tb["labels"]))
    jl = np.asarray(jpipe.quadrant_labels(jb["patch_mask"]))
    np.testing.assert_array_equal(tpipe.quadrant_labels(tb["patch_mask"]), jl)
    np.testing.assert_array_equal(
        tpipe.quadrant_labels(torch.from_numpy(tb["patch_mask"])).numpy(), jl)


def test_bce_loss_and_gradient():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((4, 16)) * 4).astype(np.float32)
    labels = (rng.random((4, 16)) > 0.5).astype(np.float32)
    jl, jg = jax.value_and_grad(jmgnet.bce_loss)(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = tmgnet.bce_loss(lt, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("bits", [0, 8])
def test_mgnet_bce_gradient_matches_reference(bits):
    """MGNet's BCE gradient through ``mgnet_scores`` against the
    reference's ``jax.grad``, each leaf in relative L2: in float (bits 0)
    within 1e-5; under the qat training policy (the STE) within twice
    what one ulp of input (up or down) does to the reference itself (its
    rounding and clip-bound discontinuities: 1.7e-2 one ulp down here)."""
    from repro.core.backend import ExecPolicy as JP
    mcfg = jmgnet.MGNetConfig(patch=8, embed=32, heads=2, img_size=32)
    tcfg = tmgnet.MGNetConfig(patch=8, embed=32, heads=2, img_size=32)
    jp = jmgnet.init_mgnet(jax.random.PRNGKey(3), mcfg)
    b = jpipe.ImageStream(32, 8, patch=8, seed=3).batch_at(0)
    jpol = JP(quant_bits=bits, training=True)

    grad = jax.jit(jax.grad(lambda p, images: jmgnet.bce_loss(
        jmgnet.mgnet_scores(p, images, mcfg, jpol), b["patch_mask"])))

    def jgrads(images):
        return _np(grad(jp, images))

    jg = jax.tree_util.tree_leaves(jgrads(b["images"]))
    tol = 1e-5
    if bits:
        for to in (np.inf, -np.inf):
            ju = jax.tree_util.tree_leaves(jgrads(jnp.asarray(np.nextafter(
                np.asarray(b["images"]), np.float32(to)))))
            tol = max(tol, 2 * max(_rel_l2(u, a) for u, a in zip(ju, jg)))
    live = tadamw.tree_map(lambda t: t.detach().requires_grad_(True),
                           bridge.from_jax_params(_np(jp), "cpu"))
    tmgnet.bce_loss(tmgnet.mgnet_scores(
        live, torch.from_numpy(np.asarray(b["images"])), tcfg,
        ExecPolicy(quant_bits=bits, training=True)),
        torch.from_numpy(np.asarray(b["patch_mask"]))).backward()
    for a, t in zip(jg, tadamw.tree_leaves(live)):
        assert _rel_l2(t.grad.numpy(), a) <= tol, (_rel_l2(t.grad.numpy(),
                                                           a), tol)


def test_topk_gather_routes_gradients_to_tokens_only():
    """As the reference's ``take_along_axis``: the kept tokens' cotangents
    land on their rows, the dropped rows get 0, the scores none."""
    rng = np.random.default_rng(7)
    s = rng.standard_normal((2, 9)).astype(np.float32)
    tok = rng.standard_normal((2, 9, 4)).astype(np.float32)
    r = rng.standard_normal((2, 4, 4)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jmgnet.select_topk_patches(
        jnp.asarray(s), t, 4)[0] * r))(jnp.asarray(tok))
    st = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(tok).requires_grad_(True)
    pruned, _ = tmgnet.select_topk_patches(st, tt, 4)
    (pruned * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jg))
    assert st.grad is None


# --------------------------------------------------------------------------
# the train step against the reference's make_train_fn
# --------------------------------------------------------------------------

def _rel_l2(a, b):
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n > 0 else np.linalg.norm(a)


# the per-leaf gradient relative L2 a case is held to; the MGNet case's
# class is the reference's own one-ulp sensitivity
STEP_TOL = {"plain": (1e-5,), "mgnet": (2e-2,), "microbatch": (1e-5,)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(ref, case):
    """One step from the reference's own ``init_state`` on equal batches:
    loss, grad_norm, every gradient leaf (through the first moment, m =
    0.1 x the clipped gradient, in f32) and the new state (params within 2
    lr of the first step, v in relative L2, count and step bitwise).
    MGNet's leaves get zero gradients in both (top-k indices carry none)
    and move by weight decay only."""
    r = ref[case]
    cfg = _tcfg(**CASES[case])
    state = bridge.from_jax_state(r["state0"], "cpu")
    new, m = tsteps.make_train_fn(cfg)(state, _tbatch(0))
    tol = STEP_TOL[case][0]
    assert abs(m["loss"].item() - r["loss"]) <= 1e-6 * abs(r["loss"])
    assert abs(m["grad_norm"].item() - r["grad_norm"]) <= \
        tol * r["grad_norm"]
    paths = jax.tree_util.tree_flatten_with_path(r["new"]["opt"]["m"])[0]
    for (path, jm), tm in zip(paths, tadamw.tree_leaves(new["opt"]["m"])):
        name = jax.tree_util.keystr(path)
        assert tm.dtype == torch.float32
        if "mgnet" in name:
            assert not jm.any() and not tm.any(), name
            continue
        assert _rel_l2(tm.numpy(), jm) <= tol, (name, _rel_l2(tm.numpy(), jm))
    for tv, jv in zip(tadamw.tree_leaves(new["opt"]["v"]),
                      jax.tree_util.tree_leaves(r["new"]["opt"]["v"])):
        assert _rel_l2(tv.numpy(), jv) <= 2 * tol
    lr1 = 1e-3 * float(jadamw.warmup_cosine(1, warmup=cfg.lr_warmup,
                                            total=cfg.lr_total))
    for a, b in zip(tadamw.tree_leaves(new["params"]),
                    jax.tree_util.tree_leaves(r["new"]["params"])):
        assert np.abs(a.numpy() - b).max() <= 2 * lr1 * 1.01
    assert int(new["opt"]["count"]) == int(r["new"]["opt"]["count"]) == 1
    assert int(new["step"]) == int(r["new"]["step"]) == 1
    assert new["step"].dtype == torch.int32


def test_loss_curve_class(ref):
    """12 steps with a 4-step warmup from the reference's init state: both
    curves fall (the last 4 steps' mean below the first 4's) and agree step
    by step within 2% (the params part by sign flips of ulp-noise
    gradients, 2 lr a step, so only the curves are compared)."""
    cfg = _tcfg()
    step = tsteps.make_train_fn(cfg)
    state = bridge.from_jax_state(ref["state0"], "cpu")
    losses = []
    for i in range(CURVE_STEPS):
        state, m = step(state, _tbatch(i))
        losses.append(m["loss"].item())
    jl = np.array(ref["curve"])
    tl = np.array(losses)
    assert tl[-4:].mean() < tl[:4].mean() and jl[-4:].mean() < jl[:4].mean()
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


# --------------------------------------------------------------------------
# the loop: resume and faults, bitwise within the port
# --------------------------------------------------------------------------

SHAPE = ShapeConfig("t", 0, 4, "train")


def _loop(cfg, n, state0, **kw):
    return ttrain.train_loop(cfg, SHAPE, n, device="cpu",
                             state=tadamw.tree_map(torch.clone, state0),
                             log_every=100, **kw)


@pytest.fixture(scope="module")
def straight(ref):
    """6 straight steps with MGNet pruning and bf16 moments (the default)
    from the reference's params."""
    cfg = _tcfg(use_fp32_master=False, **MG)
    params = bridge.from_jax_params(ref["mgnet"]["state0"]["params"], "cpu")
    state0 = {"params": params,
              "opt": tadamw.adamw_init(params,
                                       tadamw.AdamWConfig(low_mem=True)),
              "step": torch.zeros((), dtype=torch.int32)}
    final, losses, _ = _loop(cfg, 6, state0)
    return cfg, state0, final, losses


def _same_state(a, b):
    for x, y in zip(tadamw.tree_leaves(a), tadamw.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume_from_checkpoint_is_bitwise(straight, tmp_path):
    cfg, state0, final, losses = straight
    mgr = tckpt.CheckpointManager(str(tmp_path), every=3)
    _, first, _ = _loop(cfg, 3, state0, ckpt=mgr)
    resumed, rest, _ = _loop(cfg, 6, state0,
                             ckpt=tckpt.CheckpointManager(str(tmp_path),
                                                          every=3))
    assert first + rest == losses
    _same_state(resumed, final)


def test_resume_after_injected_fault_is_bitwise(straight, tmp_path):
    cfg, state0, final, losses = straight
    mgr = tckpt.CheckpointManager(str(tmp_path), every=2)
    with pytest.raises(RuntimeError, match="injected fault"):
        _loop(cfg, 6, state0, ckpt=mgr, inject_fault_at=3)
    assert tckpt.latest_step(str(tmp_path)) == 2
    resumed, rest, _ = _loop(cfg, 6, state0,
                             ckpt=tckpt.CheckpointManager(str(tmp_path),
                                                          every=2))
    assert rest == losses[2:]
    _same_state(resumed, final)


def test_train_state_crosses_checkpoints_both_ways(ref, tmp_path):
    """A train state the reference's ``checkpoint.save`` writes (bf16
    moments included) is read by the port's ``restore`` bitwise, and the
    port's written state by the reference's."""
    jstate = _bf16_moments(ref["state0"])
    jckpt.save(str(tmp_path / "j"), jstate, step=5)
    like = bridge.from_jax_state(_np(jstate), "cpu")
    got, step = tckpt.restore(str(tmp_path / "j"), ttrain.init_state(
        _tcfg(use_fp32_master=False), 1, "cpu"))
    assert step == 5
    _same_state(got, like)
    tckpt.save(str(tmp_path / "t"), like, step=6)
    back, step = jckpt.restore(str(tmp_path / "t"), jstate)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


def _bf16_moments(state):
    """A copy of a reference state with its moments in bf16, as the
    reference stores them without ``use_fp32_master``."""
    st = jax.tree_util.tree_map(jnp.asarray, state)
    for k in ("m", "v"):
        st["opt"][k] = jax.tree_util.tree_map(
            lambda p: (p * 0.5 + 0.25).astype(jnp.bfloat16), st["params"])
    return st


def test_from_jax_state_keeps_dtypes_and_bits(ref):
    js = _bf16_moments(ref["state0"])
    st = bridge.from_jax_state(_np(js), "cpu")
    for a, b in zip(tadamw.tree_leaves(st["opt"]["v"]),
                    jax.tree_util.tree_leaves(js["opt"]["v"])):
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(), np.asarray(b).view(np.int16))
    assert st["step"].dtype == torch.int32 and st["step"].ndim == 0
    assert st["opt"]["count"].dtype == torch.int32
    m = tadamw.tree_leaves(st["opt"]["m"])
    assert all(t.dtype == torch.bfloat16 for t in m)
    with pytest.raises(ValueError, match="not a train state"):
        bridge.from_jax_state({"params": {}}, "cpu")


# --------------------------------------------------------------------------
# policies, remat, the CLI
# --------------------------------------------------------------------------

def _kernel_calls():
    """Each hand-written kernel's dispatch with operands that need a
    gradient: the photonic matmul, flash attention, the fused attention
    branch and the fused FFN."""
    from repro_torch.core import backend
    from repro_torch.core.decomposed_attention import mhsa_standard
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 16, generator=g)
    q = torch.randn(2, 2, 5, 8, generator=g, requires_grad=True)
    w1, w2 = (prepare_params({"w": torch.randn(*s, generator=g)})["w"]
              for s in ((16, 32), (32, 16)))
    attn = prepare_params({n: torch.randn(16, 16, generator=g) for n in
                           ("wq", "wk", "wv", "wo")})
    return {
        "photonic matmul": lambda p: backend.linear(x, w, policy=p),
        "flash attention": lambda p: backend.attend(q, q, q, p),
        "fused attention": lambda p: mhsa_standard(x, attn, 2, p),
        "fused FFN": lambda p: backend.ffn(x, w1, torch.zeros(32), w2,
                                           torch.zeros(16), p)}


KERNEL_POLICY = {"photonic matmul": ("photonic_pallas", "", ""),
                 "flash attention": ("qat", "flash", ""),
                 "fused attention": ("photonic_pallas", "flash", ""),
                 "fused FFN": ("photonic_pallas", "", "fused")}


@pytest.mark.parametrize("entry", list(KERNEL_POLICY))
def test_training_policy_on_a_kernel_raises(entry):
    """A training policy that names a hand-written kernel raises with the
    reason once an operand needs a gradient (none has a backward); the
    same call under ``no_grad`` runs the plain version on the CPU, and
    ``training=False`` gives bitwise the same values."""
    mm, at, ff = KERNEL_POLICY[entry]
    pol = ExecPolicy(quant_bits=8, backend=mm, attn_backend=at,
                     ffn_backend=ff)
    call = _kernel_calls()[entry]
    with pytest.raises(ValueError, match=f"{entry} kernel, which has no "
                                         f"backward"):
        call(pol)
    with torch.no_grad():
        a = call(pol)
    b = call(ExecPolicy(quant_bits=8, backend=mm, attn_backend=at,
                        ffn_backend=ff, training=False))
    assert torch.equal(a, b.detach())


def test_serving_config_refuses_training():
    """The fused serving point's config, trained on: the train step
    raises naming a kernel with no backward."""
    cfg = _tcfg(matmul_backend="photonic_pallas", attn_backend="flash",
                ffn_backend="fused")
    state = ttrain.init_state(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="no backward"):
        tsteps.make_train_fn(cfg)(state, _tbatch(0))


def test_quantized_weight_in_a_training_tree_raises():
    cfg = _tcfg(quant_bits=8)
    params = prepare_params(tapi.init_model(0, cfg, "cpu", n_classes=8))
    with pytest.raises(ValueError, match="QuantizedWeight"):
        tapi.loss_fn(params, _tbatch(0), cfg,
                     ExecPolicy.from_cfg(cfg, training=True))
    raw = tapi.init_model(0, cfg, "cpu", n_classes=8)
    raw["blocks"]["attn"]["wq"] = prepare_params(
        {"blocks": {"wq": raw["blocks"]["attn"]["wq"]}})["blocks"]["wq"]
    live = tadamw.tree_map(lambda p: p.detach().requires_grad_(True)
                           if isinstance(p, torch.Tensor) else p, raw)
    with pytest.raises(ValueError, match="training forward"):
        forward_vit(live, _tbatch(0)["images"], cfg,
                    ExecPolicy.from_cfg(cfg), device="cpu")


def test_remat_leaves_values_and_gradients_unchanged(ref):
    cfg = _tcfg(**MG)
    state = bridge.from_jax_state(ref["mgnet"]["state0"], "cpu")
    outs = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        new, m = tsteps.make_train_fn(c)(state, _tbatch(0))
        outs.append((m["loss"], m["grad_norm"], new))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    _same_state(outs[0][2], outs[1][2])


def test_train_loop_refuses_a_sharding_context():
    """The ViT trains under every table (tests/test_torch_vit_mesh.py), but
    not under calibrated device noise: a noisy train step under a context
    of more than one rank raises before any collective, naming the mesh's
    remaining item."""
    from repro_torch.core.noise import NoiseSpec
    from repro_torch.distributed import sharding

    class _Mesh:
        shape = {"data": 2}
        axis_names = ("data",)
        world = 2

    with sharding._installed(sharding.ShardingCtx(_Mesh(),
                                                  sharding.DATA_RULES)):
        with pytest.raises(NotImplementedError, match="queue A, item 1"):
            ttrain.train_loop(_tcfg(noise=NoiseSpec()), SHAPE, 1,
                              device="cpu")


def test_mains_parse_the_same_argv(monkeypatch):
    """Both packages' ``main`` read the same argv into the same config,
    shape, steps, seed and checkpoint settings (the loops stubbed; the
    reference's ``use_sharding`` refuses its own host mesh)."""
    argv = ["--arch", "opto-vit-tiny", "--smoke", "--steps", "3",
            "--batch", "4", "--seq", "16", "--seed", "2", "--layers", "2",
            "--ckpt-dir", "/nonexistent/ck", "--ckpt-every", "7"]
    got = {}

    def stub(tag):
        def loop(cfg, shape, n_steps, seed=0, ckpt=None, **kw):
            got[tag] = (cfg, shape, n_steps, seed, ckpt.root, ckpt.every)
            return None, [1.0], []
        return loop

    monkeypatch.setattr(jtrain, "train_loop", stub("ref"))
    monkeypatch.setattr(jtrain, "use_sharding",
                        lambda mesh: contextlib.nullcontext())
    monkeypatch.setattr(jtrain, "CheckpointManager",
                        lambda root, every: type("M", (), {
                            "root": root, "every": every})())
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    monkeypatch.setattr(ttrain, "train_loop", stub("port"))
    monkeypatch.setattr(ttrain, "CheckpointManager",
                        lambda root, every: type("M", (), {
                            "root": root, "every": every})())
    ttrain.main(argv)
    (jc, js, jn, jseed, jroot, jev), (tc, ts, tn, tseed, troot, tev) = \
        got["ref"], got["port"]
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "d_ff",
              "img_size", "patch", "quant_bits", "remat", "microbatch_steps",
              "use_fp32_master", "lr_warmup", "lr_total", "grad_accum_dtype",
              "mgnet", "mgnet_keep_ratio"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert (ts.name, ts.seq_len, ts.global_batch, ts.kind) == \
        (js.name, js.seq_len, js.global_batch, js.kind)
    assert (tn, tseed, troot, tev) == (jn, jseed, jroot, jev)
    # the ViT trains on a mesh too; a batch the data axis does not split
    # is refused before any rank starts
    for bad, match in ((["--arch", "opto-vit-tiny", "--data-par", "3"],
                        "does not split over --data-par 3"),
                       (["--arch", "opto-vit-tiny", "--batch", "2",
                         "--data-par", "4", "--model-par", "2"],
                        "does not split over --data-par 4")):
        with pytest.raises(ValueError, match=match):
            ttrain.main(bad)


def test_train_cli_runs_on_the_cpu(capsys):
    ttrain.main(["--arch", "opto-vit-tiny", "--smoke", "--layers", "1",
                 "--steps", "2", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] 2 steps in" in out and "straggler flags: 0" in out
