"""Parity of the port's ViT + MGNet serving path with the JAX reference on
the serving smoke config (4 layers, d=64, 32x32 frames, MGNet 32/2), on the
fused serving point (photonic_pallas + flash + fused).

The reference's own params are bridged into the port (``jax.random``
draws cannot be replayed), frames come from ``VideoStream``, and the
reference runs as its CPU path runs it (Pallas matmul in interpret mode,
XLA twins for attention and FFN). The class is end-to-end logits
correlation > 0.999 with top-1 agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import mgnet as jmgnet
from repro.data.pipeline import VideoStream as JVideoStream
from repro.models import vit as jvit
from repro.serving.engine import _smoke_cfg
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core import backend as tbackend
from repro_torch.core import mgnet as tmgnet
from repro_torch.data.pipeline import VideoStream
from repro_torch.models import vit as tvit
from repro_torch.serving.server import smoke_cfg


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    raw = jvit.init_vit(jax.random.PRNGKey(0), jcfg, 10)
    jp = jbackend.prepare_params(raw, bits=8)
    tcfg = smoke_cfg()
    tp = tbackend.prepare_params(from_jax_params(_np_tree(raw), "cpu"), bits=8)
    jpol = jbackend.ExecPolicy.from_cfg(jcfg, training=False)
    return jcfg, jp, jpol, tcfg, tp, tbackend.ExecPolicy.from_cfg(tcfg)


@pytest.fixture(scope="module")
def frames():
    fr = VideoStream(img_size=32, patch=8, cut_every=8).frames_at(0, 8)
    return fr["frames"]


def _close(j, t):
    j, t = np.asarray(j, np.float64).ravel(), np.asarray(t, np.float64).ravel()
    assert np.corrcoef(j, t)[0, 1] > 0.999


def test_configs_match_reference(models):
    jcfg, _, _, tcfg, _, _ = models
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "img_size", "patch",
              "mgnet", "mgnet_keep_ratio", "mgnet_embed", "mgnet_heads",
              "quant_bits", "matmul_backend", "attn_backend", "ffn_backend",
              "norm_eps"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    from repro.configs.opto_vit import get_config as jget
    from repro_torch.configs.opto_vit import get_config as tget
    assert (jvit.vit_matmul_shapes(jget("base"), 98, include_mgnet=True)
            == tvit.vit_matmul_shapes(tget("base"), 98, include_mgnet=True))


def test_mgnet_scores_and_budgets(models, frames):
    jcfg, jp, jpol, tcfg, tp, tpol = models
    jmc = jmgnet.MGNetConfig(patch=8, img_size=32, embed=32, heads=2)
    js = np.asarray(jmgnet.mgnet_scores(jp["mgnet"], jnp.asarray(frames), jmc,
                                        jpol))
    ts = tmgnet.mgnet_scores(tp["mgnet"], torch.from_numpy(frames),
                             tvit.mgnet_config(tcfg), tpol).numpy()
    _close(js, ts)
    np.testing.assert_array_equal(jmgnet.mask_budget(js),
                                  tmgnet.mask_budget(ts))
    jo = np.asarray(jnp.argsort(jnp.asarray(js), axis=-1, stable=True,
                                descending=True))
    to = torch.argsort(torch.from_numpy(js), dim=-1, descending=True,
                       stable=True).numpy()
    np.testing.assert_array_equal(jo, to)       # same tie order on equal input


def test_embed_patches(models, frames):
    jcfg, jp, jpol, tcfg, tp, tpol = models
    j = jvit.embed_patches(jp, jnp.asarray(frames), jcfg, jpol)
    t = tvit.embed_patches(tp, torch.from_numpy(frames), tcfg, tpol)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["gathered", "kv_len", "patch_mask"])
def test_encode_tokens(models, frames, mode):
    jcfg, jp, jpol, tcfg, tp, tpol = models
    toks = np.asarray(jvit.embed_patches(jp, jnp.asarray(frames), jcfg, jpol))
    jkw, tkw = {}, {}
    if mode == "gathered":
        toks = toks[:, :10]
    elif mode == "kv_len":
        jkw = tkw = {"kv_len": 7}
    else:
        m = (np.random.default_rng(0).random(toks.shape[:2]) > 0.5
             ).astype(np.float32)
        jkw, tkw = {"patch_mask": jnp.asarray(m)}, {
            "patch_mask": torch.from_numpy(m)}
    j = np.asarray(jvit.encode_tokens(jp, jnp.asarray(toks), jcfg, jpol, **jkw))
    t = tvit.encode_tokens(tp, torch.from_numpy(toks), tcfg, tpol,
                           device="cpu", **tkw).numpy()
    _close(j, t)
    np.testing.assert_array_equal(j.argmax(-1), t.argmax(-1))


def test_forward_vit_top1_on_video_frames(models):
    jcfg, jp, jpol, tcfg, tp, tpol = models
    fr = JVideoStream(img_size=32, patch=8, seed=5, cut_every=4).frames_at(
        0, 16)["frames"]
    jl, jk = jvit.forward_vit(jp, jnp.asarray(fr), jcfg, jpol)
    tl, tk = tvit.forward_vit(tp, torch.from_numpy(fr), tcfg, tpol,
                              device="cpu")
    assert jk == tk == int(tcfg.mgnet_keep_ratio * 16)
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(np.asarray(jl).argmax(-1),
                                  tl.numpy().argmax(-1))


def test_forward_vit_tokens_kept_count(models, frames):
    jcfg, jp, jpol, tcfg, tp, tpol = models
    toks = tvit.embed_patches(tp, torch.from_numpy(frames), tcfg, tpol)
    logits, kept = tvit.forward_vit_tokens(tp, toks[:, :5], tcfg, tpol,
                                           device="cpu")
    assert kept == 5 and tuple(logits.shape) == (8, 10)


def test_encoder_needs_the_fused_serving_point(models, frames):
    _, _, _, tcfg, tp, _ = models
    toks = torch.zeros(2, 4, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="fused serving triple"):
        tvit.encode_tokens(tp, toks, tcfg.with_(ffn_backend="xla"),
                           device="cpu")
    raw = from_jax_params(init_vit(0, tcfg, 10), "cpu")   # not prepared
    with pytest.raises(NotImplementedError, match="prepare_params"):
        tvit.encode_tokens(raw, toks, tcfg, device="cpu")


def test_entry_points_refuse_the_cpu_without_asking(models, monkeypatch):
    """No card and no explicit CPU request: the entry points raise instead
    of running quietly on the CPU."""
    _, _, _, tcfg, tp, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.encode_tokens(tp, torch.zeros(1, 4, tcfg.d_model), tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.forward_vit(tp, torch.zeros(1, 32, 32, 3), tcfg)


def test_init_vit_shapes_match_reference():
    jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jvit.init_vit(jax.random.PRNGKey(0), jcfg, 7))
    tp = init_vit(0, smoke_cfg(), 7)

    def walk(j, t):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                walk(j[k], t[k])
        else:
            assert j == t.shape and t.dtype == np.float32
    walk(jshapes, tp)
