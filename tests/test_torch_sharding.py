"""Parity of the port's model-sharded serving path with the JAX reference
on the CPU: the dequant epilogue's plain version (B4), the exact
collectives, the sharded FFN, ``place_params``, the sharded encoder at
mesh (1, 2) and (2, 2), the sharded ``StreamServer`` and the mesh's and
the encoder's refusals, on the serving smoke config (4 layers, d=64).

The reference runs in this process, as its own tests run it (Pallas in
interpret mode). The port runs in gloo ranks started by
``launch.mesh.spawn_ranks``; their bodies are in ``_torch_ranks.py``,
which imports no JAX. Inputs are made from numpy seeds and the reference's
own params are bridged into the port. Each spawn has its own timeout, so
a hung rank fails its tests instead of stalling the run.

Parity classes:

  * bitwise: B4's plain version against the reference's
    ``_dequant_epilogue``; the int8 linear twin against the reference's
    ``_int8_linear_xla``; the replicated absmax scale of 2 ranks, each
    holding half of a tensor, against the reference's ``absmax_scale`` of
    the whole; and every sharded result against the port's own unsharded
    result on the same inputs (``fused_ffn_sharded`` vs ``fused_ffn_xla``
    on the whole operands, the sharded encode vs ``encode_tokens``, the
    sharded server vs the unsharded one). That is the construction of the
    sharded path: MAX and int32 SUM are exact and every float op is row-
    or column-local, with fewer heads or fewer batch rows alike.
  * against the reference's float results, the class the port's
    unsharded path already holds (``test_torch_kernels.py``,
    ``test_torch_vit.py``): PyTorch's and XLA's CPU tanh-GELU, LayerNorm
    and softmax attention differ in the last ulp
    (``test_cpu_float_ops_differ_from_xla_by_ulps``), so the FFN is held
    to one quant step and the logits to correlation > 0.999 with equal
    argmax. The served predictions are equal.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import quant as jquant
from repro.data.pipeline import video_fleet as jfleet
from repro.kernels import fused_ffn as jffn
from repro.models import sharded_encoder as jsharded
from repro.models import vit as jvit
from repro.serving.engine import _smoke_cfg
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import StreamServer as JServer
from repro_torch.bridge import from_jax_params
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.core import backend as tbackend
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import MODEL_RULES, ShardingCtx
from repro_torch.kernels import _build, ref
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks
from repro_torch.models import sharded_encoder as tsharded
from repro_torch.models import vit as tvit
from repro_torch.models.layers import layernorm as tlayernorm
from repro_torch.serving import server as tserver
from repro_torch.serving.session import ServingConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ranks  # noqa: E402

SPAWN_TIMEOUT_S = 120.0
N_STREAMS, N_FRAMES, PHASE = 2, 16, 8
FFN_CASES = [(8, None), (8, 5), ((8, 6), None), ((8, 6), 5)]
ENCODE_MODES = ["gathered", "kv_len", "patch_mask", "batch_not_divisible"]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def _qweight(rng, k, n, bits):
    w = rng.standard_normal((k, n)).astype(np.float32) * np.float32(
        np.sqrt(2.0 / k))
    s = jquant.absmax_scale(jnp.asarray(w), bits=bits, axis=-2)
    return (np.asarray(jquant.quantize(jnp.asarray(w), s, bits=bits)),
            np.asarray(s).reshape(-1))


def _ffn_operands(seed, bits):
    b1, b2 = bits if isinstance(bits, tuple) else (bits, bits)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    w1q, sw1 = _qweight(rng, 64, 128, b1)
    w2q, sw2 = _qweight(rng, 128, 64, b2)
    bias1 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    bias2 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, w1q, sw1, bias1, w2q, sw2, bias2


def _assert_quant_step_close(a, b):
    """One hidden quant step through w2: within 1e-2 and corr > 0.9999."""
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999


def _corr(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


@pytest.fixture(scope="module")
def reference():
    """The reference's smoke serving run (2 streams x 16 frames, stream 1
    from frame 8), its raw params and its fused-point model."""
    jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    jsrv = JServer(jcfg, JServerConfig(microbatch=4, chunk=8, mesh="off",
                                       warm_start=False), n_classes=10,
                   seed=0)
    ss = [jsrv.add_session(st, n_frames=N_FRAMES, start=PHASE * i)
          for i, st in enumerate(jfleet(N_STREAMS, 32, 8, cut_every=16))]
    res = jsrv.serve()
    raw = jsrv._raw_params
    jp = jbackend.prepare_params(raw, bits=8)
    jpol = jbackend.ExecPolicy.from_cfg(jcfg, training=False)
    return SimpleNamespace(
        cfg=jcfg, params=jp, policy=jpol, raw=_np_tree(raw),
        predictions=[res[s.sid].predictions for s in ss],
        flush_log=[(k, n) for _, k, n in jsrv.flush_log])


@pytest.fixture(scope="module")
def port(reference):
    cfg = tserver.smoke_cfg()
    params = tbackend.prepare_params(from_jax_params(reference.raw, "cpu"),
                                     bits=8)
    return SimpleNamespace(cfg=cfg, params=params,
                           policy=tbackend.ExecPolicy.from_cfg(cfg))


@pytest.fixture(scope="module")
def requests(port):
    """Encode requests (tokens, kv_len, patch_mask), one per ENCODE_MODES."""
    fr = VideoStream(img_size=32, patch=8, cut_every=8).frames_at(0, 8)
    toks = tvit.embed_patches(port.params, torch.from_numpy(fr["frames"]),
                              port.cfg, port.policy).numpy()
    mask = (np.random.default_rng(0).random((4, 16)) > 0.5).astype(
        np.float32)
    return [(toks[:4, :10], None, None), (toks[:4], 7, None),
            (toks[:4], None, mask), (toks[:3, :12], None, None)]


@pytest.fixture(scope="module")
def two_ranks(reference, port, requests):
    """One spawn of 2 gloo ranks, mesh (1, 2): every 2-rank result."""
    x = np.random.default_rng(3).standard_normal((10, 24)).astype(np.float32)
    cases = [_ffn_operands(i, bits) + (bits, live)
             for i, (bits, live) in enumerate(FFN_CASES)]
    out = spawn_ranks(_torch_ranks.suite, 2, x, cases, reference.raw,
                      port.cfg, requests, N_STREAMS, N_FRAMES, PHASE,
                      device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return SimpleNamespace(x=x, cases=cases, out=out)


@pytest.fixture(scope="module")
def four_ranks(reference, port, requests):
    """One spawn of 4 gloo ranks, mesh (2, 2): the encode with the batch
    split over "data"."""
    return spawn_ranks(_torch_ranks.encode_sharded, 4, reference.raw,
                       port.cfg, requests, device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S)


# --------------------------------------------------------------------------
# B4 and the twin's int8 linear, in this process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(17, 64), (37, 1003), (1, 8), (788, 256)])
def test_dequant_epilogue_plain_matches_reference(m, n):
    rng = np.random.default_rng(m * n)
    acc = rng.integers(-2 ** 30, 2 ** 30, (m, n)).astype(np.int32)
    sx = np.float32(rng.random() * 1e-3)
    sw = rng.random(n).astype(np.float32)
    want = np.asarray(jffn._dequant_epilogue(jnp.asarray(acc),
                                             jnp.asarray(sx),
                                             jnp.asarray(sw)))
    got = tffn.dequant_epilogue(torch.from_numpy(acc), torch.tensor(sx),
                                torch.from_numpy(sw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.dequant_epilogue_ref(torch.from_numpy(acc), torch.tensor(sx),
                                 torch.from_numpy(sw)).numpy(), want)


def test_dequant_epilogue_wrapper_checks_inputs():
    acc = torch.zeros(4, 8, dtype=torch.int32)
    before = _build.LAUNCHES["dequant_epilogue"]
    assert tuple(tffn.dequant_epilogue(acc, torch.ones(()),
                                       torch.ones(8)).shape) == (4, 8)
    assert _build.LAUNCHES["dequant_epilogue"] == before   # plain on the CPU
    with pytest.raises(TypeError, match="int32"):
        tffn.dequant_epilogue(acc.float(), torch.ones(()), torch.ones(8))
    with pytest.raises(ValueError, match="shapes"):
        tffn.dequant_epilogue(acc, torch.ones(()), torch.ones(7))


@pytest.mark.parametrize("bits", [8, 6])
def test_int8_linear_xla_matches_reference_bitwise(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((37, 64)).astype(np.float32)
    wq, sw = _qweight(rng, 64, 96, bits)
    want = np.asarray(jffn._int8_linear_xla(jnp.asarray(x), jnp.asarray(wq),
                                            jnp.asarray(sw), bits=bits))
    got = tffn.int8_linear_xla(torch.from_numpy(x), torch.from_numpy(wq),
                               torch.from_numpy(sw), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,live", FFN_CASES)
def test_fused_ffn_xla_matches_reference(bits, live):
    ops = _ffn_operands(11, bits)
    want = np.asarray(jffn.fused_ffn_xla(*map(jnp.asarray, ops), bits=bits,
                                         live_rows=live))
    t_ops = [torch.from_numpy(a) for a in ops]
    got = tffn.fused_ffn_xla(*t_ops, bits=bits, live_rows=live).numpy()
    _assert_quant_step_close(got, want)
    # the twin and the fused kernel's plain version are the same numbers
    np.testing.assert_array_equal(got, ref.fused_ffn_ref(
        *t_ops, bits=tffn.bits_pair(bits), live_rows=live).numpy())


def test_cpu_float_ops_differ_from_xla_by_ulps():
    """Why the port holds float results to a class and not bitwise against
    the reference: the same elementwise/row-local op on the same f32 input
    differs in the last ulp between PyTorch's and XLA's CPU kernels (tanh
    in GELU, the mean/variance reduction in LayerNorm, exp and the sums of
    softmax attention), within 1e-6 relative."""
    from repro.kernels.flash_attention import fused_masked_attention
    from repro.models.layers import layernorm as jlayernorm
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 17, 64)) * 3).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    pairs = [
        (jax.nn.gelu(jnp.asarray(x)), ref.gelu_tanh(torch.from_numpy(x))),
        (jlayernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-6),
         tlayernorm(*map(torch.from_numpy, (x, g, b)), 1e-6)),
    ]
    q, k, v = (rng.standard_normal((4, 4, 17, 16)).astype(np.float32)
               for _ in range(3))
    pairs.append((fused_masked_attention(q, k, v, None, kv_len=None,
                                         interpret=True),
                  ref.flash_attention_masked_ref(
                      *map(torch.from_numpy, (q, k, v)))))
    for j, t in pairs:
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6,
                                   atol=1e-6 * np.abs(j).max())


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_replicated_absmax_scale_over_two_ranks(two_ranks, bits):
    want = np.asarray(jquant.absmax_scale(jnp.asarray(two_ranks.x),
                                          bits=bits))
    for r in two_ranks.out:
        np.testing.assert_array_equal(r["absmax"][bits], want)


def test_ranks_import_neither_jax_nor_the_reference(two_ranks):
    for r in two_ranks.out:
        assert "repro_torch" in r["modules"]
        assert "jax" not in r["modules"] and "repro" not in r["modules"]


def test_exact_int_psum_rejects_floats():
    with pytest.raises(TypeError, match="integer dtype"):
        collectives.exact_int_psum(torch.ones(3), None)


# --------------------------------------------------------------------------
# the sharded FFN over 2 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(FFN_CASES)))
def test_fused_ffn_sharded_over_two_ranks(two_ranks, case):
    *ops, bits, live = two_ranks.cases[case]
    whole = tffn.fused_ffn_xla(*map(torch.from_numpy, ops), bits=bits,
                               live_rows=live).numpy()
    for r in two_ranks.out:                  # bitwise: the construction
        np.testing.assert_array_equal(r["ffn"][case], whole)
    want = np.asarray(jffn.fused_ffn_xla(*map(jnp.asarray, ops), bits=bits,
                                         live_rows=live))
    _assert_quant_step_close(two_ranks.out[0]["ffn"][case], want)
    if live is not None:
        assert np.all(two_ranks.out[0]["ffn"][case][:, live:] == 0.0)


# --------------------------------------------------------------------------
# place_params and the sharded encode at (1, 2) and (2, 2)
# --------------------------------------------------------------------------

def test_place_params_keeps_this_ranks_shard(two_ranks, port):
    cfg = port.cfg
    for r in two_ranks.out:
        e = r["encode"]
        assert e["wq_cols"] == (cfg.n_layers, cfg.d_model, cfg.d_model // 2)
        assert e["w2_rows"] == (cfg.n_layers, cfg.d_ff // 2, cfg.d_model)


def test_place_params_slices_columns_rows_and_scales(port):
    """Rank (d, m) = (0, 1) of a (1, 2) mesh keeps the second half of the
    head / d_ff columns and rows; everything else stays whole."""
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": 2},
                           coord=lambda ax: {"data": 0, "model": 1}[ax])
    ctx = ShardingCtx(mesh, MODEL_RULES)
    placed = tbackend.place_params(port.params,
                                   tvit.vit_logical_axes(port.cfg), ctx)
    p, q = port.params["blocks"], placed["blocks"]
    h = port.cfg.d_model // 2
    f = port.cfg.d_ff // 2
    assert torch.equal(q["attn"]["wk"].wq, p["attn"]["wk"].wq[..., h:])
    assert torch.equal(q["attn"]["wk"].scale, p["attn"]["wk"].scale[..., h:])
    assert q["attn"]["wk"].bits == p["attn"]["wk"].bits
    assert torch.equal(q["attn"]["wo"].wq, p["attn"]["wo"].wq)
    assert torch.equal(q["ffn"]["w1"].wq, p["ffn"]["w1"].wq[..., f:])
    assert torch.equal(q["ffn"]["b1"], p["ffn"]["b1"][..., f:])
    assert torch.equal(q["ffn"]["w2"].wq, p["ffn"]["w2"].wq[:, f:])
    assert torch.equal(q["ffn"]["w2"].scale, p["ffn"]["w2"].scale)
    assert torch.equal(q["ffn"]["b2"], p["ffn"]["b2"])
    assert placed["head"].wq is port.params["head"].wq
    assert placed["mgnet"]["block"]["wqkv"].wq is \
        port.params["mgnet"]["block"]["wqkv"].wq


@pytest.mark.parametrize("mesh_shape", ["1x2", "2x2"])
@pytest.mark.parametrize("mode", range(len(ENCODE_MODES)),
                         ids=ENCODE_MODES)
def test_sharded_encode_matches_unsharded(two_ranks, four_ranks, reference,
                                          port, requests, mesh_shape, mode):
    outs = ([r["encode"] for r in two_ranks.out] if mesh_shape == "1x2"
            else four_ranks)
    toks, kv_len, mask = requests[mode]
    t_mask = None if mask is None else torch.from_numpy(mask)
    whole = tvit.encode_tokens(port.params, torch.from_numpy(toks), port.cfg,
                               port.policy, kv_len=kv_len, patch_mask=t_mask,
                               device="cpu").numpy()
    for r in outs:                       # bitwise: the construction
        np.testing.assert_array_equal(r["logits"][mode], whole)
        assert r["calls"] == len(ENCODE_MODES)
    j_mask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jvit.encode_tokens(
        reference.params, jnp.asarray(toks), reference.cfg, reference.policy,
        patch_mask=j_mask, kv_len=kv_len))
    got = outs[0]["logits"][mode]
    assert _corr(got, want) > 0.999
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# --------------------------------------------------------------------------
# the sharded server
# --------------------------------------------------------------------------

def test_sharded_server_predicts_as_unsharded_and_reference(two_ranks,
                                                            reference):
    srv = tserver.StreamServer(
        tserver.smoke_cfg(), ServingConfig(microbatch=4, chunk=8),
        params=from_jax_params(reference.raw, "cpu"), device="cpu")
    ss = [srv.add_session(st, n_frames=N_FRAMES, start=PHASE * i)
          for i, st in enumerate(video_fleet(N_STREAMS, 32, 8,
                                             cut_every=16))]
    res = srv.serve()
    unsharded = [res[s.sid].predictions for s in ss]
    for r in two_ranks.out:
        served = r["serve"]
        assert served["predictions"] == unsharded
        assert served["predictions"] == reference.predictions
        assert served["flush_log"] == reference.flush_log
        assert served["calls"] == len(served["flush_log"]) > 0
    assert all(len(p) == N_FRAMES for p in unsharded)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_serving_mesh_refuses_what_the_world_cannot_host(two_ranks,
                                                         four_ranks):
    assert make_serving_mesh(model=1) is None          # no process group
    with pytest.raises(ValueError, match="need at least 2 devices, have 1"):
        make_serving_mesh(model=2)
    for r in two_ranks.out:
        assert r["encode"]["too_many"] == (
            "model=3 shards need at least 3 devices, have 2")
    for r in four_ranks:
        assert r["too_many"] == (
            "model=5 shards need at least 5 devices, have 4")
        assert r["not_dividing"] == (
            "device count 4 is not divisible by model=3")


def _fake_ctx(axes=("data", "model"), **shape):
    return SimpleNamespace(mesh=SimpleNamespace(axis_names=axes,
                                                shape=shape))


@pytest.mark.parametrize("ctx,cfg_kw", [
    (None, {}),
    (_fake_ctx(("data",), data=2), {}),
    (_fake_ctx(data=2, model=1), {}),
    (_fake_ctx(data=1, model=3), {}),                    # 4 heads
    (_fake_ctx(data=1, model=2), {"d_ff": 129}),
    (_fake_ctx(data=2, model=2), {}),                    # eligible
])
def test_ineligible_reasons_match_reference(reference, port, ctx, cfg_kw):
    want = jsharded.sharded_encode_ineligible_reason(
        reference.params, dataclasses.replace(reference.cfg, **cfg_kw),
        reference.policy, ctx)
    got = tsharded.sharded_encode_ineligible_reason(
        port.params, port.cfg.with_(**cfg_kw), port.policy, ctx)
    assert got == want


def test_model_shards_on_an_ineligible_config_raises(two_ranks):
    for r in two_ranks.out:
        assert r["serve"]["ineligible"] == (
            "model_shards=2 asks for the model-sharded encode, which cannot "
            "run: n_heads=1 not divisible by the model axis (2) — heads "
            "cannot split evenly")


def test_server_without_model_shards_on_many_ranks_raises(two_ranks,
                                                          reference):
    """No quiet replica per rank: a world of 2 ranks with no model shards
    serves on the 1-D data mesh, whose predictions are the reference's
    (and the port's unsharded ones, which the model-sharded test holds
    to it), and raises with the reason under a policy the data-split
    encode cannot take (the xla FFN)."""
    for r in two_ranks.out:
        assert r["serve"]["unsharded"] == reference.predictions
        assert r["serve"]["unsharded_ineligible"] == (
            "mesh='auto' on 2 ranks asks for the data-split encode, which "
            "cannot run: backends ('photonic_pallas', 'flash', 'xla') are "
            "not the fused serving triple ('photonic_pallas', 'flash', "
            "'fused')")
