"""Parity of the port's LM attention cores with the JAX reference.

On the CPU the wrappers of the causal flash attention kernel and the flash
decode kernel take their plain PyTorch versions (kernels/ref.py); these
tests hold them, and the model-level functions around them, against the
reference as its own tests run it: the Pallas kernels in interpret mode,
``models/attention.py::full_attention`` and ``decode_attention``. Inputs
are numpy arrays from a seed, handed to both packages. Tolerances:

  * f32: rtol = atol = 2e-5 (streaming-softmax reassociation, the
    reference's kernel-vs-oracle class);
  * bf16 outputs: within 1 bf16 ulp of the largest |o| (both sides compute
    in f32 and round once; a 1-ulp f32 difference can move a rounding).

tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.ops import fused_attention as j_fused
from repro.models.attention import decode_attention as j_decode_attn
from repro.models.attention import full_attention as j_full
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.flash_decode import flash_decode as t_decode
from repro_torch.models import attention as tattn

BF16 = ml_dtypes.bfloat16


def _t(a):
    """numpy (incl. ml_dtypes bfloat16) -> CPU tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "bf16":
        # 1 bf16 ulp of the largest |o|: 2^(floor(log2 max) - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _qkv(seed, b, h, hkv, sq, skv, d, dtype, layout="bhsd"):
    rng = np.random.default_rng(seed)
    npd = BF16 if dtype == "bf16" else np.float32
    if layout == "bhsd":
        shapes = ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    else:
        shapes = ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))
    return tuple(rng.standard_normal(s).astype(np.float32).astype(npd)
                 for s in shapes)


# --------------------------------------------------------------------------
# B5: causal / local-window GQA flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_attention_matches_pallas_interpret(g, window, dtype):
    q, k, v = _qkv(g * 10 + window, 1, 4, 4 // g, 32, 32, 16, dtype)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=window, bq=16, bkv=16, interpret=True)
    got = t_flash(_t(q), _t(k), _t(v), causal=True, window=window)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_blockwise_attention_matches_full_attention(g, window, dtype):
    """The model-level call in the (B, S, H, D) layout, and the kernel's
    plain version, against the reference's materialized-score attention
    (which divides q by sqrt(D) where the kernel multiplies by 1/sqrt(D):
    inside the stated class)."""
    q, k, v = _qkv(g + window, 2, 4, 4 // g, 24, 24, 16, dtype, "bshd")
    want = j_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=window)
    _assert_close(got, want, dtype)
    plain = ref.flash_attention_ref(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                                    causal=True, window=window)
    _assert_close(plain.transpose(1, 2), want, dtype)


def test_flash_attention_non_causal_and_ragged():
    """causal=False (Sq != Skv) and Sq, Skv that are not tile multiples:
    the plain version masks, never pads."""
    q, k, v = _qkv(5, 1, 2, 2, 32, 64, 16, "f32")
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, bq=16, bkv=32, interpret=True)
    _assert_close(t_flash(_t(q), _t(k), _t(v), causal=False), want, "f32")
    q, k, v = _qkv(6, 1, 4, 2, 19, 19, 16, "f32")
    want = ref.flash_attention_ref(_t(q.astype(np.float64)),
                                   _t(k.astype(np.float64)),
                                   _t(v.astype(np.float64)))
    _assert_close(t_flash(_t(q), _t(k), _t(v)), want, "f32")


def test_flash_attention_rows_without_visible_keys_are_zero():
    """Non-causal with a window: rows whose window holds no key return 0,
    as the reference oracle's zero-row guard does."""
    q, k, v = _qkv(7, 1, 2, 2, 16, 4, 8, "f32")
    got = t_flash(_t(q), _t(k), _t(v), causal=False, window=2)
    assert bool((got[:, :, 5:] == 0).all())
    assert bool((got[:, :, :5].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_attention_layout(dtype):
    """blockwise_attention takes the models' (B, S, H, D) layout as the
    reference's ops.fused_attention does, and the output is that layout
    too."""
    q, k, v = _qkv(11, 2, 4, 2, 32, 32, 16, dtype, "bshd")
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, bq=16, bkv=16, interpret=True)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=True)
    assert tuple(got.shape) == q.shape
    _assert_close(got, want, dtype)


# --------------------------------------------------------------------------
# B6: flash decode
# --------------------------------------------------------------------------

def _decode_inputs(seed, b, s, h, hkv, d, cache_dtype=np.float32,
                   q_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32).astype(q_dtype)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32).astype(
        cache_dtype)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32).astype(
        cache_dtype)
    return q, kc, vc


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (8, 1), (12, 2)])
@pytest.mark.parametrize("length", [1, 37, 64])
def test_flash_decode_matches_pallas_and_decode_attention(h, hkv, length):
    q, kc, vc = _decode_inputs(h + length, 2, 64, h, hkv, 16)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), length)
    got = t_decode(_t(q), _t(kc), _t(vc), length)
    _assert_close(got, j_decode(*jargs, bs=32, interpret=True), "f32")
    _assert_close(got, j_decode_attn(*jargs), "f32")
    _assert_close(tattn.decode_attention(_t(q), _t(kc), _t(vc), length),
                  j_decode_attn(*jargs), "f32")


def test_flash_decode_bf16_cache():
    """The LM path's types: bf16 q and bf16 cache, f32 inside, bf16 out."""
    q, kc, vc = _decode_inputs(2, 2, 64, 12, 2, 32, BF16, BF16)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 50)
    got = t_decode(_t(q), _t(kc), _t(vc), 50)
    assert got.dtype == torch.bfloat16
    _assert_close(got, j_decode_attn(*jargs), "bf16")
    _assert_close(got, j_decode(*jargs, bs=32, interpret=True), "bf16")


def test_flash_decode_ragged_cache_length():
    """S not a multiple of any tile: the port masks (the Pallas wrapper
    asserts S % bs == 0, so the reference here is decode_attention)."""
    q, kc, vc = _decode_inputs(3, 1, 45, 4, 2, 16)
    for length in (1, 33, 45):
        want = j_decode_attn(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), length)
        _assert_close(t_decode(_t(q), _t(kc), _t(vc), length), want, "f32")


def test_flash_decode_equals_causal_row():
    """flash_decode(q_t, cache filled to t) == row t of causal attention
    (tests/test_kernels_decode.py's case, on the port's functions)."""
    rng = np.random.default_rng(3)
    b, s, h, hkv, d = 1, 64, 4, 2, 16
    q_all = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k_all = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_all = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    full = j_full(jnp.asarray(q_all), jnp.asarray(k_all), jnp.asarray(v_all),
                  causal=True)
    t = 41
    got = t_decode(_t(q_all[:, t:t + 1]), _t(k_all), _t(v_all), t + 1)
    _assert_close(got[:, 0], np.asarray(full)[:, t], "f32")
    mine = tattn.blockwise_attention(_t(q_all), _t(k_all), _t(v_all))
    _assert_close(got[:, 0], mine[:, t], "f32")


def _merged_over_halves(monkeypatch, q, kc, vc, length, window):
    """``decode_attention(window=, seq=)`` as the two ranks of a cache
    split in halves along its sequence run it, in one process: each half
    called with its ``Split``, the partials' all-gather served from the
    halves' own (``collectives.all_gather_cat`` patched: a first pass
    records each half's partial, the second returns both in rank order).
    Returns rank 0's output (both ranks' are the same merge)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import Split

    rows = kc.shape[1] // 2
    mine = {}

    def gather(x, group, dim, name="all_gather", direct=False):
        mine[group] = x
        return torch.cat([mine.get(r, x) for r in range(2)], dim)

    monkeypatch.setattr(collectives, "all_gather_cat", gather)
    for r in (1, 0):
        out = tattn.decode_attention(q, kc[:, r * rows:(r + 1) * rows],
                                     vc[:, r * rows:(r + 1) * rows], length,
                                     window=window, seq=Split(2, r, r))
    return out


def test_flash_decode_rejects_device_length_and_window(monkeypatch):
    q, kc, vc = _decode_inputs(4, 1, 32, 4, 2, 16)
    with pytest.raises(TypeError, match="host int"):
        t_decode(_t(q), _t(kc), _t(vc), torch.tensor(5))
    with pytest.raises(ValueError, match="outside"):
        t_decode(_t(q), _t(kc), _t(vc), 33)
    # a window over a linear cache is ported (the hybrid family's): the
    # reference's windowed decode_attention, on the whole cache and on its
    # two halves of a sequence split merged (the window inside rank 0's
    # rows, straddling both ranks', and past every row of rank 0)
    for length, window in ((5, 4), (20, 8), (30, 4), (32, 32)):
        want = j_decode_attn(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), length, window=window)
        got = tattn.decode_attention(_t(q), _t(kc), _t(vc), length,
                                     window=window)
        _assert_close(got, want, "f32")
        got = _merged_over_halves(monkeypatch, _t(q), _t(kc), _t(vc),
                                  length, window)
        _assert_close(got, want, "f32")


def test_update_kv_cache_writes_in_place():
    kc, vc = torch.zeros(2, 8, 2, 4), torch.zeros(2, 8, 2, 4)
    kn, vn = torch.ones(2, 1, 2, 4), torch.full((2, 1, 2, 4), 2.0)
    k2, v2 = tattn.update_kv_cache(kc, vc, kn, vn, 3)
    assert k2 is kc and v2 is vc
    assert bool((kc[:, 3] == 1).all()) and bool((vc[:, 3] == 2).all())
    assert float(kc.sum()) == 16.0
