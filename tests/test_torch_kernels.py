"""Parity of the port's three kernels with the JAX reference.

On the CPU every wrapper takes its plain PyTorch version (kernels/ref.py);
these tests hold those plain versions, through the wrappers the serving
path calls, against the reference as its own tests run it: the Pallas
kernels in interpret mode and their XLA twins. Inputs are numpy arrays
from a seed, handed to both packages. Tolerances:

  * photonic matmul: int32 accumulate bitwise, dequantized output <= 1e-6;
  * masked flash attention: rtol = atol = 2e-5 (f32 reassociation);
  * fused FFN: one hidden quant step (tests/test_fused_ffn.py's class).

tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.backend import int_accumulate_pallas
from repro.kernels.flash_attention import (flash_attention_masked,
                                           flash_attention_masked_xla)
from repro.kernels.fused_ffn import fused_ffn_int8, fused_ffn_xla
from repro.kernels.ops import fused_roi_attention_prequant as j_roi_attn
from repro.kernels.ops import photonic_matmul_prequant as j_prequant
from repro_torch.core import quant as tquant
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import \
    flash_attention_masked as t_flash
from repro_torch.kernels.fused_ffn import fused_ffn as t_fused_ffn
from repro_torch.kernels.ops import fused_roi_attention_prequant as t_roi_attn
from repro_torch.kernels.ops import photonic_matmul_prequant as t_prequant
from repro_torch.kernels.photonic_matmul import photonic_matmul_int8


def _cached_weight(rng, k, n, bits=8):
    w = (rng.standard_normal((k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    s = jquant.absmax_scale(jnp.asarray(w), bits=bits, axis=-2)
    return (np.asarray(jquant.quantize(jnp.asarray(w), s, bits=bits)),
            np.asarray(s).reshape(-1))


def _assert_quant_step_close(a, b, err_msg=""):
    """tests/test_fused_ffn.py's kernel-vs-twin class: 1e-2 and corr > 0.9999."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2, err_msg=err_msg)
    if a.size > 1 and np.abs(a).max() > 1e-6:
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999, err_msg


# --------------------------------------------------------------------------
# B1: photonic int8 matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(37, 768, 192), (4, 192, 10), (200, 64, 64)])
def test_photonic_matmul_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, sw = _cached_weight(rng, k, n)
    # the activation codes and the int32 accumulate are bitwise equal
    js = jquant.absmax_scale(jnp.asarray(x), bits=8)
    jxq = jquant.quantize(jnp.asarray(x), js, bits=8)
    ts = tquant.absmax_scale(torch.from_numpy(x), bits=8)
    txq = tquant.quantize(torch.from_numpy(x), ts, bits=8)
    np.testing.assert_array_equal(np.asarray(jxq), txq.numpy())
    jacc = np.asarray(int_accumulate_pallas(jxq, jnp.asarray(wq),
                                            interpret=True))
    tacc = photonic_matmul_int8(txq, torch.from_numpy(wq),
                                torch.ones(()), torch.ones(n))
    np.testing.assert_array_equal(jacc, ref.int_accumulate_ref(
        txq, torch.from_numpy(wq)).numpy())
    np.testing.assert_array_equal(jacc.astype(np.float32), tacc.numpy())
    # the dequantized output agrees to 1e-6
    jy = np.asarray(j_prequant(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(sw), interpret=True))
    ty = t_prequant(torch.from_numpy(x), torch.from_numpy(wq),
                    torch.from_numpy(sw)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6 * np.abs(jy).max())


def test_photonic_matmul_wrapper_checks_inputs():
    xq = torch.zeros((4, 8), dtype=torch.int8)
    wq = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        photonic_matmul_int8(xq.float(), wq, torch.ones(()), torch.ones(3))
    with pytest.raises(ValueError):
        photonic_matmul_int8(xq, wq[:7], torch.ones(()), torch.ones(3))
    with pytest.raises(ValueError):
        photonic_matmul_int8(xq, wq, torch.ones(()), torch.ones(4))


# --------------------------------------------------------------------------
# B2: RoI-masked flash attention
# --------------------------------------------------------------------------

def _attn_case(seed, b, h, hk, hv, s, d, dv, mode):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hv, s, dv)).astype(np.float32)
    kw = {}
    if mode in ("mask", "dead"):
        m = (rng.random((b, s)) > 0.4).astype(np.float32)
        if mode == "dead":
            m[-1] = 0.0
        kw["key_mask"] = m
    elif mode == "kv_len":
        kw["kv_len"] = s // 2 + 1
    return q, k, v, kw


@pytest.mark.parametrize("b,h,hk,hv,s,d,dv,mode,scale", [
    (2, 4, 4, 4, 50, 16, 16, "ones", None),
    (2, 4, 4, 4, 37, 16, 16, "mask", None),
    (3, 4, 4, 4, 29, 16, 16, "kv_len", None),
    (2, 4, 4, 4, 33, 16, 16, "dead", None),
    (2, 4, 1, 4, 21, 32, 8, "mask", 1.0),      # Eq. 2: Hk=1, D != Dv
    (1, 6, 2, 3, 40, 8, 12, "mask", None),     # independent GQA groups
])
def test_flash_attention_matches_reference(b, h, hk, hv, s, d, dv, mode,
                                           scale):
    q, k, v, kw = _attn_case(b * 100 + s, b, h, hk, hv, s, d, dv, mode)
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    jpal = np.asarray(flash_attention_masked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        interpret=True, **jkw))
    jxla = np.asarray(flash_attention_masked_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, **jkw))
    tkw = {k_: torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    got = t_flash(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), scale=scale, **tkw).numpy()
    np.testing.assert_allclose(got, jpal, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jxla, rtol=2e-5, atol=2e-5)
    if mode == "dead":
        assert np.all(got[-1] == 0.0) and np.all(jpal[-1] == 0.0)


@pytest.mark.parametrize("bits,mode", [(8, "ones"), (8, "mask"),
                                       ((8, 6, 4), "kv_len")])
def test_fused_roi_attention_prequant_matches_reference(bits, mode):
    """The MHSA hot path: int8 QKV projections (one activation quantization
    shared by all three at uniform widths, one per width otherwise) feeding
    the masked flash attention, at the flash attention's tolerance."""
    rng = np.random.default_rng(11)
    b, n, dm, heads = 2, 37, 48, 4
    x = rng.standard_normal((b, n, dm)).astype(np.float32)
    widths = bits if isinstance(bits, tuple) else (bits,) * 3
    ws = [_cached_weight(rng, dm, dm, w) for w in widths]
    jkw, tkw = {}, {}
    if mode == "mask":
        m = (rng.random((b, n)) > 0.4).astype(np.float32)
        jkw, tkw = {"key_mask": jnp.asarray(m)}, {"key_mask": torch.from_numpy(m)}
    elif mode == "kv_len":
        jkw = tkw = {"kv_len": 20}
    want = np.asarray(j_roi_attn(
        jnp.asarray(x), *(jnp.asarray(a) for w in ws for a in w), heads=heads,
        bits=bits, interpret=True, **jkw))
    got = t_roi_attn(torch.from_numpy(x),
                     *(torch.from_numpy(a) for w in ws for a in w),
                     heads=heads, bits=bits, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_rejects_mask_and_kv_len():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="not both"):
        t_flash(q, q, q, torch.ones(1, 4), kv_len=2)


# --------------------------------------------------------------------------
# B3: fused int8 FFN
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,d,dff,bits,live", [
    ((2, 37, 48), 48, 160, (8, 8), None),
    ((1, 300, 48), 48, 160, (8, 8), None),      # several reference row blocks
    ((2, 37, 64), 64, 128, (8, 4), None),       # mixed widths
    ((3, 17, 64), 64, 128, (8, 8), 9),          # packed live rows
])
def test_fused_ffn_matches_reference(shape, d, dff, bits, live):
    rng = np.random.default_rng(d + dff + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    w1q, sw1 = _cached_weight(rng, d, dff, bits[0])
    w2q, sw2 = _cached_weight(rng, dff, d, bits[1])
    b1 = (rng.standard_normal(dff) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    args = (w1q, sw1, b1, w2q, sw2, b2)
    jargs = tuple(jnp.asarray(a) for a in args)
    twin = np.asarray(fused_ffn_xla(jnp.asarray(x), *jargs, bits=bits,
                                    live_rows=live))
    kern = np.asarray(fused_ffn_int8(jnp.asarray(x), *jargs, bits=bits,
                                     live_rows=live, interpret=True))
    got = t_fused_ffn(torch.from_numpy(x),
                      *(torch.from_numpy(a) for a in args), bits=bits,
                      live_rows=live).numpy()
    _assert_quant_step_close(got, twin, "vs fused_ffn_xla")
    _assert_quant_step_close(got, kern, "vs fused_ffn_int8(interpret=True)")
    if live is not None:
        assert np.all(got[:, live:] == 0.0)
