"""Parity of the PyTorch port's quantization and quantize-once cache with the
JAX reference (src/repro/core/quant.py, core/backend.py).

Inputs are made with numpy from a seed; the same arrays go through both
packages. Codes, scales and cached weights must match bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import quant as jquant
from repro.models import vit as jvit
from repro.serving.engine import _smoke_cfg
from repro_torch.bridge import from_jax_params
from repro_torch.core import backend as tbackend
from repro_torch.core import quant as tquant


def _np_tree(tree):
    """Reference param pytree -> nested dicts of numpy, cached weights as
    (wq, scale, bits) triples (the bridge's input format)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


@pytest.mark.parametrize("bits", [2, 4, 8, 12])
def test_quant_range_matches(bits):
    assert tquant.quant_range(bits) == jquant.quant_range(bits)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [None, -2])
def test_absmax_scale_and_codes_bitwise(bits, axis):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 37, 24)) * 3.0).astype(np.float32)
    js = jquant.absmax_scale(jnp.asarray(x), bits=bits, axis=axis)
    ts = tquant.absmax_scale(torch.from_numpy(x), bits=bits, axis=axis)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jq = jquant.quantize(jnp.asarray(x), js, bits=bits)
    tq = tquant.quantize(torch.from_numpy(x), ts, bits=bits)
    assert str(tq.dtype) == f"torch.{np.asarray(jq).dtype}"
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize(jq, js)),
        tquant.dequantize(tq, ts).numpy())


@pytest.mark.parametrize("bits", [8, 12])
def test_quantize_half_ties_round_to_even(bits):
    """x / scale lands exactly on .5 for every element: both packages round
    half to even and clip to +-qmax (-128 never appears)."""
    qmax = jquant.quant_range(bits)[1]
    x = (np.arange(-2 * qmax - 7, 2 * qmax + 8) * 0.125).astype(np.float32)
    scale = np.float32(0.25)
    jq = np.asarray(jquant.quantize(jnp.asarray(x), jnp.asarray(scale), bits))
    tq = tquant.quantize(torch.from_numpy(x), torch.tensor(scale), bits).numpy()
    np.testing.assert_array_equal(jq, tq)
    assert tq.min() == -qmax and tq.max() == qmax
    halves = np.abs(x / scale - np.round(x / scale)) == 0.5
    assert halves.any()
    assert np.all(tq[halves & (np.abs(x / scale) < qmax)] % 2 == 0)


def test_prepare_params_matches_reference_bitwise():
    """The port's quantize-once cache over bridged raw params caches the
    same leaves (MGNet's included) with identical codes and scales."""
    cfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    raw = jvit.init_vit(jax.random.PRNGKey(3), cfg, 10)
    jp = jbackend.prepare_params(raw, bits=8)
    tp = tbackend.prepare_params(from_jax_params(_np_tree(raw), "cpu"), bits=8)
    n_cached = 0

    def cmp(a, b, path):
        nonlocal n_cached
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                cmp(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, jbackend.QuantizedWeight):
            assert isinstance(b, tbackend.QuantizedWeight), path
            assert b.bits == a.bits
            np.testing.assert_array_equal(np.asarray(a.wq), b.wq.numpy(), path)
            np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy(),
                                          path)
            n_cached += 1
        else:
            assert not isinstance(b, tbackend.QuantizedWeight), path
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), path)

    cmp(jp, tp, "")
    # patch embed + 6 block banks + head + 8 MGNet banks
    assert n_cached == 16


def test_bridge_takes_cached_weights_and_keeps_stacked_layers():
    cfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    jp = jbackend.prepare_params(
        jvit.init_vit(jax.random.PRNGKey(0), cfg, 10), bits=8)
    tp = from_jax_params(_np_tree(jp), "cpu")
    wq = tp["blocks"]["attn"]["wq"]
    assert isinstance(wq, tbackend.QuantizedWeight)
    assert tuple(wq.wq.shape) == (cfg.n_layers, cfg.d_model, cfg.d_model)
    assert tuple(wq.layer(1).scale.shape) == (1, cfg.d_model)
    np.testing.assert_array_equal(
        np.asarray(jp["blocks"]["attn"]["wq"].wq[1]), wq.layer(1).wq.numpy())


def test_weight_bits_rejects_stale_cache():
    w = tbackend.quantize_weight(torch.randn(16, 8), bits=8)
    x = torch.randn(3, 16)
    pol = tbackend.ExecPolicy(quant_bits=4, backend="photonic_pallas")
    with pytest.raises(ValueError, match="disagrees"):
        tbackend.linear(x, w, policy=pol)
    ok = tbackend.ExecPolicy(quant_bits=0, backend="photonic_pallas")
    assert tuple(tbackend.linear(x, w, policy=ok).shape) == (3, 8)


def test_policy_names_its_matmul_backend():
    """An unnamed matmul backend resolves as the reference's legacy flags
    do: bf16 by default, quant_bits -> qat (fake-quant in float)."""
    x, w = torch.randn(3, 16), torch.randn(16, 8)
    assert tbackend.ExecPolicy().backend == "bf16"
    torch.testing.assert_close(tbackend.linear(x, w), x @ w)
    qat = tbackend.linear(x, w, policy=tbackend.ExecPolicy(quant_bits=8))
    want = tquant.fake_quant(x, 8) @ tquant.fake_quant(w, 8, axis=(0,))
    torch.testing.assert_close(qat, want)
    assert tbackend.ExecPolicy(quant_bits=8, backend="qat").backend == "qat"
    pol = tbackend.ExecPolicy(backend="photonic_pallas")
    assert pol.backend == "photonic_pallas"
    assert tuple(tbackend.linear(x, w, policy=pol).shape) == (3, 8)


@pytest.mark.parametrize("kind,name", [("matmul", "bf16"), ("matmul", "qat"),
                                       ("matmul", "photonic_sim"),
                                       ("attention", "xla"), ("ffn", "xla")])
def test_unported_backends_raise(kind, name):
    """Every registry entry of the reference is ported now and resolves to
    its entry; only an unknown name raises."""
    get = {"matmul": tbackend.get_backend,
           "attention": tbackend.get_attention_backend,
           "ffn": tbackend.get_ffn_backend}[kind]
    registry = {"matmul": tbackend.BACKENDS,
                "attention": tbackend.ATTN_BACKENDS,
                "ffn": tbackend.FFN_BACKENDS}[kind]
    assert get(name) is registry[name]
    with pytest.raises(KeyError):
        get("no-such-backend")
