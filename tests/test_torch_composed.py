"""The port's composed execution against the JAX reference, on the CPU: the
``qat`` / ``photonic_sim`` matmul entries, the ``xla`` attention and FFN
entries, the integer-accumulate primitives, Eq. 2 decomposed attention,
the composed and mask-mode dense encoders and ``run_dense``.

Inputs are drawn once with numpy and handed to both packages (weights from
``bridge.init_vit``, a numpy draw of the reference's shapes). The port's
``photonic_pallas`` on the CPU runs the plain version of its kernel, which
is held against the reference's ``photonic_sim``: the reference holds that
bitwise to its own Pallas path, so no test here needs interpret mode
beyond two small calls.

Tolerances, and why:

- quantization codes, fake-quant values and int32 accumulates: bitwise
  (the same divisions, roundings and exact integer sums);
- a ``photonic_sim`` linear: bitwise (exact accumulate, the same dequant
  products in the same order); a ``qat`` linear: its fake-quantized
  operands bitwise, the f32 product within 1e-6 of the largest output (a
  summation order);
- the ``xla`` attention against the ``flash`` entry: rtol = atol = 2e-4
  (materialized softmax against the streaming one), rows with no live key
  exactly 0; against the reference's ``xla``: 1e-5;
- the ``xla`` FFN against the ``fused`` one in the port: bitwise (the same
  elementwise ops around the same int8 linears);
- Eq. 2 against the standard dataflow: corr > 0.99, the reference's own
  class (``test_backend_parity.py``: the association order and where the
  quantization applies differ); encodes and attention blocks against the
  reference: corr > 0.999 and equal argmax (PyTorch's and XLA's GELU,
  LayerNorm and softmax differ by ulps, and a requantization can flip a
  code);
- serving against the reference: frames, prediction keys, gating counts
  exact; modeled energy 1e-12 relative.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.opto_vit import get_config as jget_config
from repro.core import backend as jbackend
from repro.core import decomposed_attention as jdecomp
from repro.core import mgnet as jmgnet
from repro.core import quant as jquant
from repro.data.pipeline import VideoStream as JVideoStream
from repro.kernels import ops as jops
from repro.models import vit as jvit
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import _smoke_cfg
from repro.serving.session import ServingConfig as JServingConfig
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.configs.opto_vit import get_config as tget_config
from repro_torch.core import backend as tbackend
from repro_torch.core import decomposed_attention as tdecomp
from repro_torch.core import mgnet as tmgnet
from repro_torch.core import quant as tquant
from repro_torch.data.pipeline import VideoStream
from repro_torch.kernels import ops as tops
from repro_torch.models import vit as tvit
from repro_torch.serving import engine as tengine
from repro_torch.serving import server as tserver
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.session import ServingConfig

N_CLASSES = 10


def _close(j, t, limit=0.999):
    j, t = np.asarray(j, np.float64).ravel(), np.asarray(t, np.float64).ravel()
    c = np.corrcoef(j, t)[0, 1]
    assert c > limit, c


def _jtree(tree):
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _tcfg(backend, attn, ffn, impl="standard"):
    return tserver.smoke_cfg().with_(matmul_backend=backend,
                                     attn_backend=attn, ffn_backend=ffn,
                                     attn_impl=impl)


def _jcfg(backend, attn, ffn, impl="standard"):
    return _smoke_cfg(backend, attn, ffn).with_(attn_impl=impl)


def _jcache(tree):
    """The port's cache as the reference's (its codes and scales are
    bitwise the reference's ``prepare_params``: test_linear_* holds
    ``quantize_weight`` so)."""
    if isinstance(tree, dict):
        return {k: _jcache(v) for k, v in tree.items()}
    if isinstance(tree, tbackend.QuantizedWeight):
        return jbackend.QuantizedWeight(jnp.asarray(tree.wq.numpy()),
                                        jnp.asarray(tree.scale.numpy()),
                                        tree.bits)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def weights():
    """One numpy draw of the smoke config's params, raw and cached, in
    both packages."""
    raw = init_vit(0, tserver.smoke_cfg(), N_CLASSES)
    traw = from_jax_params(raw, "cpu")
    tprep = tbackend.prepare_params(traw, bits=8)
    return {"jraw": _jtree(raw), "traw": traw, "jprep": _jcache(tprep),
            "tprep": tprep}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).standard_normal((3, 10, 64)).astype(
        np.float32)


# -- quantization and the integer accumulate ---------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_and_quantize_params_match_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3.0
    for axis in (None, (0,)):
        for jf, tf in ((jquant.fake_quant, tquant.fake_quant),
                       (jquant.fake_quant_ste, tquant.fake_quant_ste)):
            j = np.asarray(jf(jnp.asarray(x), bits=bits, axis=axis))
            t = tf(torch.from_numpy(x), bits=bits, axis=axis).numpy()
            np.testing.assert_array_equal(t, j)
    tree = {"w": rng.standard_normal((20, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "blk": {"w1": rng.standard_normal((3, 16, 8)).astype(np.float32),
                    "tiny": rng.standard_normal((4, 4)).astype(np.float32)}}
    j = jquant.quantize_params(_jtree(tree), bits=bits)
    t = tquant.quantize_params(from_jax_params(tree, "cpu"), bits=bits)
    for path in (("w",), ("b",), ("blk", "w1"), ("blk", "tiny")):
        jl, tl = j, t
        for k in path:
            jl, tl = jl[k], tl[k]
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(t["b"].numpy(), tree["b"])


def test_int_accumulate_primitives_are_bitwise():
    """exact, the 32-wide chunk walk and B1 with unit scales (its plain
    version here) against the reference's three, the Pallas one in
    interpret mode, at a ragged (M, K, N)."""
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (5, 70)).astype(np.int8)
    wq = rng.integers(-127, 128, (70, 9)).astype(np.int8)
    want = np.asarray(jbackend.int_accumulate_exact(jnp.asarray(xq),
                                                    jnp.asarray(wq)))
    np.testing.assert_array_equal(
        np.asarray(jbackend.int_accumulate_sim(jnp.asarray(xq),
                                               jnp.asarray(wq))), want)
    np.testing.assert_array_equal(
        np.asarray(jbackend.int_accumulate_pallas(
            jnp.asarray(xq), jnp.asarray(wq), interpret=True)), want)
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq)
    for fn in (tbackend.int_accumulate_exact, tbackend.int_accumulate_sim,
               tbackend.int_accumulate_pallas):
        got = fn(tx, tw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("backend", ["qat", "photonic_sim"])
def test_linear_composed_matmul_backends(backend, cached):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 20)) * 0.2).astype(np.float32)
    b = rng.standard_normal((20,)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if cached:
        jw, tw = jbackend.quantize_weight(jw), tbackend.quantize_weight(tw)
        np.testing.assert_array_equal(tw.wq.numpy(), np.asarray(jw.wq))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    jpol = jbackend.ExecPolicy(quant_bits=8, backend=backend, training=False)
    tpol = tbackend.ExecPolicy(quant_bits=8, backend=backend)
    j = np.asarray(jbackend.linear(jnp.asarray(x), jw, jnp.asarray(b), jpol))
    t = tbackend.linear(torch.from_numpy(x), tw, torch.from_numpy(b),
                        tpol).numpy()
    if backend == "photonic_sim":
        np.testing.assert_array_equal(t, j)
        pal = tbackend.linear(torch.from_numpy(x), tw, torch.from_numpy(b),
                              tbackend.ExecPolicy(backend="photonic_pallas"))
        np.testing.assert_array_equal(t, pal.numpy())
    else:
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(
            tquant.fake_quant(xt, 8).numpy(),
            np.asarray(jquant.fake_quant(jnp.asarray(x), 8)))
        assert np.abs(t - j).max() <= 1e-6 * np.abs(j).max()


def test_policy_resolution_and_registries_match_reference():
    P, J = tbackend.ExecPolicy, jbackend.ExecPolicy
    assert P(photonic=True).backend == J(photonic=True).resolve_backend() \
        == "photonic_sim"
    assert P(quant_bits=8).backend == J(quant_bits=8).resolve_backend() \
        == "qat"
    assert P().backend == "bf16" and not P().is_photonic()
    assert P(photonic=True, backend="photonic_pallas").is_photonic()
    # the model config's own default: quant_bits 8, no backend -> qat + xla
    cfg = tget_config("base")
    pol = P.from_cfg(cfg)
    jpol = J.from_cfg(jget_config("base"))
    assert (pol.backend, pol.resolve_attn_backend(),
            pol.resolve_ffn_backend()) == (
        jpol.resolve_backend(), jpol.resolve_attn_backend(),
        jpol.resolve_ffn_backend()) == ("qat", "xla", "xla")
    assert P.from_cfg(cfg.with_(photonic=True)).backend == "photonic_sim"
    assert tbackend.available_backends() == jbackend.available_backends()
    assert (tbackend.available_attention_backends()
            == jbackend.available_attention_backends())
    assert (tbackend.available_ffn_backends()
            == jbackend.available_ffn_backends())


# -- attention and FFN cores -------------------------------------------------

@pytest.mark.parametrize("mode", ["mask", "kv_len"])
def test_attend_xla(mode):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 12)).astype(np.float32)
    jkw, tkw = {}, {}
    if mode == "mask":
        m = (rng.random((2, 9)) > 0.4).astype(np.float32)
        m[1] = 0.0                                  # a batch row, no live key
        jkw, tkw = {"mask": jnp.asarray(m)}, {"mask": torch.from_numpy(m)}
    else:
        jkw = tkw = {"kv_len": 5}
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    xla = tbackend.attend(tq, tk, tv, tbackend.ExecPolicy(attn_backend="xla"),
                          **tkw)
    flash = tbackend.attend(tq, tk, tv,
                            tbackend.ExecPolicy(attn_backend="flash"), **tkw)
    torch.testing.assert_close(xla, flash, rtol=2e-4, atol=2e-4)
    if mode == "mask":
        assert bool((xla[1] == 0).all())
    j = jbackend.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jbackend.ExecPolicy(attn_backend="xla"), **jkw)
    np.testing.assert_allclose(xla.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def test_ffn_xla_is_bitwise_the_fused_ffn_on_the_cpu():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w1 = (rng.standard_normal((32, 64)) * 0.25).astype(np.float32)
    w2 = (rng.standard_normal((64, 32)) * 0.18).astype(np.float32)
    b1, b2 = (rng.standard_normal((n,)).astype(np.float32) * 0.1
              for n in (64, 32))
    tx = torch.from_numpy(x)
    tw1, tw2 = (tbackend.quantize_weight(torch.from_numpy(w)) for w in (w1, w2))
    tb1, tb2 = torch.from_numpy(b1), torch.from_numpy(b2)
    P = tbackend.ExecPolicy
    xla = tbackend.ffn(tx, tw1, tb1, tw2, tb2,
                       P(backend="photonic_pallas", ffn_backend="xla"))
    fused = tbackend.ffn(tx, tw1, tb1, tw2, tb2,
                         P(backend="photonic_pallas", ffn_backend="fused"))
    assert torch.equal(xla, fused)
    jw1, jw2 = (jbackend.quantize_weight(jnp.asarray(w)) for w in (w1, w2))
    j = jbackend.ffn(jnp.asarray(x), jw1, jnp.asarray(b1), jw2,
                     jnp.asarray(b2),
                     jbackend.ExecPolicy(backend="photonic_sim",
                                         ffn_backend="xla"))
    _close(j, xla.numpy(), 0.9999)
    # bf16 (raw weights) composes without any int8 kernel
    bf = tbackend.ffn(tx, torch.from_numpy(w1), tb1, torch.from_numpy(w2),
                      tb2, P(ffn_backend="xla"))
    jbf = jbackend.ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                       jnp.asarray(w2), jnp.asarray(b2),
                       jbackend.ExecPolicy(ffn_backend="xla"))
    np.testing.assert_allclose(bf.numpy(), np.asarray(jbf), rtol=1e-5,
                               atol=1e-5)


def test_a_fused_block_asked_for_raises_without_cached_weights():
    """The reference warns once and composes; the port names the reason."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    w1, w2 = torch.randn(32, 64), torch.randn(64, 32)
    with pytest.raises(ValueError, match="prepare_params"):
        tbackend.ffn(x, w1, torch.zeros(64), w2, torch.zeros(32),
                     tbackend.ExecPolicy(backend="photonic_pallas",
                                         ffn_backend="fused"))
    raw = {n: torch.randn(32, 32) for n in ("wq", "wk", "wv", "wo")}
    with pytest.raises(ValueError, match="prepare_params"):
        tdecomp.mhsa_standard(x, raw, 4, tbackend.ExecPolicy(
            backend="photonic_pallas", attn_backend="flash"))


# -- Eq. 2 ---------------------------------------------------------------------

def _mhsa_inputs(seed=7, dm=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, dm)).astype(np.float32)
    p = {n: (rng.standard_normal((dm, dm)) * (2.0 / dm) ** 0.5).astype(
        np.float32) for n in ("wq", "wk", "wv", "wo")}
    return x, p


@pytest.mark.parametrize("backend,attn", [("bf16", "xla"),
                                          ("photonic_pallas", "xla"),
                                          ("photonic_pallas", "flash")])
def test_mhsa_decomposed(backend, attn):
    """Eq. 2 against the standard dataflow (corr > 0.99), and against the
    reference's own ``mhsa_decomposed`` (its photonic_sim for the port's
    photonic_pallas; under flash the core is B2 at D = dm with one shared
    key head)."""
    x, p = _mhsa_inputs()
    m = (np.random.default_rng(8).random((2, 9)) > 0.3).astype(np.float32)
    tpol = tbackend.ExecPolicy(quant_bits=8, backend=backend,
                               attn_backend=attn)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if backend != "bf16":           # cached Q/V/O, as the serving path has
        tp = {k: tbackend.quantize_weight(v) for k, v in tp.items()}
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    dec = tdecomp.mhsa_decomposed(tx, tp, 4, tpol, tm)
    std_pol = tbackend.ExecPolicy(quant_bits=8, backend=backend,
                                  attn_backend="xla")
    std = tdecomp.mhsa_standard(tx, tp, 4, std_pol, tm)
    _close(std.numpy(), dec.numpy(), 0.99)
    jbk = "bf16" if backend == "bf16" else "photonic_sim"
    jpol = jbackend.ExecPolicy(quant_bits=8, backend=jbk, attn_backend=attn,
                               training=False)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if backend != "bf16":
        jp = {k: jbackend.quantize_weight(v) for k, v in jp.items()}
    j = jdecomp.mhsa_decomposed(jnp.asarray(x), jp, 4, jpol, jnp.asarray(m))
    _close(j, dec.numpy())
    if backend == "bf16":
        np.testing.assert_allclose(dec.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_score_dataflows_and_flops_match_reference():
    x, p = _mhsa_inputs(9)
    for jf, tf in ((jdecomp.attention_scores_standard,
                    tdecomp.attention_scores_standard),
                   (jdecomp.attention_scores_decomposed,
                    tdecomp.attention_scores_decomposed)):
        j = jf(jnp.asarray(x), jnp.asarray(p["wq"]), jnp.asarray(p["wk"]),
               0.25)
        t = tf(torch.from_numpy(x), torch.from_numpy(p["wq"]),
               torch.from_numpy(p["wk"]), 0.25)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    assert (tdecomp.decomposition_flops(197, 768, 64)
            == jdecomp.decomposition_flops(197, 768, 64))
    assert tdecomp._inv_sqrt(64) == 0.125 and tdecomp._inv_sqrt(16) == 0.25
    assert tdecomp._inv_sqrt(48) == float(np.asarray(1.0 / jnp.sqrt(48)))


# -- encoders ------------------------------------------------------------------

COMPOSED = [("photonic_pallas", "xla", "xla", "standard"),
            ("bf16", "xla", "xla", "standard"),
            ("qat", "xla", "xla", "standard"),
            ("photonic_sim", "xla", "xla", "standard"),
            ("photonic_pallas", "flash", "xla", "decomposed")]


@pytest.mark.parametrize("policy", COMPOSED, ids=lambda p: "-".join(p))
def test_composed_encode_tokens_matches_reference(weights, tokens, policy):
    backend, attn, ffn, impl = policy
    photonic = backend.startswith("photonic")
    tcfg = _tcfg(backend, attn, ffn, impl)
    jbk = "photonic_sim" if backend == "photonic_pallas" else backend
    jcfg = _jcfg(jbk, attn, ffn, impl)
    jp = weights["jprep"] if photonic else weights["jraw"]
    tp = weights["tprep"] if photonic else weights["traw"]
    j = np.asarray(jvit.encode_tokens(
        jp, jnp.asarray(tokens), jcfg,
        jbackend.ExecPolicy.from_cfg(jcfg, training=False)))
    t = tvit.encode_tokens(tp, torch.from_numpy(tokens), tcfg,
                           device="cpu").numpy()
    _close(j, t)
    np.testing.assert_array_equal(j.argmax(-1), t.argmax(-1))


def test_forward_vit_masked_matches_reference(weights):
    """The dense baseline's forward on the fused point against the
    reference's on its composed photonic_sim twin, with a random mask."""
    frames = JVideoStream(img_size=32, patch=8, cut_every=8).frames_at(
        0, 4)["frames"]
    m = (np.random.default_rng(10).random((4, 16)) > 0.5).astype(np.float32)
    jcfg = _jcfg("photonic_sim", "flash", "xla")
    jl, jn = jvit.forward_vit_masked(
        weights["jprep"], jnp.asarray(frames), jnp.asarray(m), jcfg,
        jbackend.ExecPolicy.from_cfg(jcfg, training=False))
    tcfg = tserver.smoke_cfg()
    tl, tn = tvit.forward_vit_masked(weights["tprep"], torch.from_numpy(frames),
                                     torch.from_numpy(m), tcfg, device="cpu")
    assert jn == tn == 16
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(np.asarray(jl).argmax(-1),
                                  tl.numpy().argmax(-1))
    # the composed port encode of the same masked tokens: the same numbers
    composed = tvit.forward_vit_masked(
        weights["tprep"], torch.from_numpy(frames), torch.from_numpy(m),
        tcfg.with_(ffn_backend="xla"), device="cpu")[0]
    assert torch.equal(composed, tl)


def test_mgnet_mask_and_mask_iou_match_reference(weights):
    frames = JVideoStream(img_size=32, patch=8, cut_every=8).frames_at(
        0, 4)["frames"]
    mc = jmgnet.MGNetConfig(patch=8, img_size=32, embed=32, heads=2)
    j = np.asarray(jmgnet.mgnet_mask(weights["jraw"]["mgnet"],
                                     jnp.asarray(frames), mc,
                                     jbackend.ExecPolicy()))
    t = tmgnet.mgnet_mask(weights["traw"]["mgnet"], torch.from_numpy(frames),
                          tvit.mgnet_config(tserver.smoke_cfg()),
                          tbackend.ExecPolicy()).numpy()
    assert set(np.unique(t)) <= {0.0, 1.0}
    np.testing.assert_array_equal(t, j)
    g = (np.random.default_rng(11).random(t.shape) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(tmgnet.mask_iou(torch.from_numpy(t), torch.from_numpy(g))),
        float(jmgnet.mask_iou(jnp.asarray(t), jnp.asarray(g))), rtol=1e-6)


# -- serving -------------------------------------------------------------------

def test_run_dense_matches_the_reference_engine(weights):
    """The reference's ``test_engine_dense_baseline_covers_stream`` contract
    on both packages (bf16, the same weights), and the two against each
    other: frames, prediction keys and gating exact, energy 1e-12."""
    sc = dict(microbatch=4, chunk=8, mask_refresh=8)
    jeng = JEngine(_jcfg("bf16", "", ""), JServingConfig(**sc),
                   params=weights["jraw"], n_classes=N_CLASSES)
    teng = ServingEngine(_tcfg("bf16", "", ""), ServingConfig(**sc),
                         params=weights["traw"], device="cpu")
    out = {}
    for tag, eng, vs in (("j", jeng, JVideoStream), ("t", teng, VideoStream)):
        stream = vs(img_size=32, patch=8, cut_every=16)
        out[tag] = (eng.run(stream, n_frames=13),
                    eng.run_dense(stream, n_frames=13))
    for b, d in out.values():
        assert b.frames == d.frames == 13
        assert sorted(b.predictions) == sorted(d.predictions) == list(
            range(13))
        assert b.scored_frames == d.scored_frames
        assert b.mean_frame_uj < d.mean_frame_uj
        assert d.bucket_hits == {16: 13}
    for jr, tr in zip(out["j"], out["t"]):
        assert (tr.frames, tr.scored_frames, tr.reused_frames,
                tr.bucket_hits) == (jr.frames, jr.scored_frames,
                                    jr.reused_frames, jr.bucket_hits)
        assert abs(tr.mean_frame_uj - jr.mean_frame_uj) <= (
            1e-12 * jr.mean_frame_uj)
        agree = sum(tr.predictions[i] == jr.predictions[i] for i in range(13))
        assert agree >= 12


@pytest.mark.parametrize("backend", ["bf16", "qat", "photonic_pallas"])
def test_server_serves_raw_weights_unless_photonic(weights, backend):
    """The quantize-once cache is made only under a photonic policy, as the
    reference makes it: a bf16 or qat server reads the raw weights."""
    cfg = _tcfg(backend, "xla", "xla")
    srv = tserver.StreamServer(cfg, tserver.ServerConfig(warm_start=False),
                               params=weights["traw"], device="cpu")
    wq = srv.params["blocks"]["attn"]["wq"]
    if backend == "photonic_pallas":
        assert isinstance(wq, tbackend.QuantizedWeight)
    else:
        assert torch.equal(wq, weights["traw"]["blocks"]["attn"]["wq"])
        with pytest.raises(ValueError, match="photonic"):
            srv.calibrate_bits(6.0)
    res = srv.run_dense(VideoStream(img_size=32, patch=8, cut_every=16),
                        n_frames=8)
    assert sorted(res.predictions) == list(range(8))


def test_cli_backend_flags_on_cpu(tmp_path, capsys):
    res = tserver.main(["--smoke", "--device", "cpu", "--streams", "1",
                        "--frames", "8", "--attn-backend", "flash",
                        "--ffn-backend", "xla", "--attn-impl", "decomposed",
                        "--no-warm-start"])
    assert sorted(len(r.predictions) for r in res.values()) == [8]
    out = capsys.readouterr().out
    assert "attn='flash'" in out and "ffn='xla'" in out
    assert "attn_impl=decomposed" in out
    path = tmp_path / "r.json"
    res = tengine.main(["--smoke", "--device", "cpu", "--frames", "8",
                        "--backend", "qat", "--compare-dense", "--json",
                        str(path)])
    out = capsys.readouterr().out
    assert "backend='qat', attn='xla', ffn='xla'" in out
    assert "dense baseline" in out and "bucketed speedup" in out
    assert json.loads(path.read_text())["frames"] == 8 == res.frames


def test_photonic_matmul_float_api_and_pad_to_match_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    j = np.asarray(jops.photonic_matmul(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
    t = tops.photonic_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(t.numpy(), j)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            tops.pad_to(torch.from_numpy(x), 16, axis).numpy(),
            np.asarray(jops.pad_to(jnp.asarray(x), 16, axis)))
