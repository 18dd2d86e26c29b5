"""The Hopper designs of the LM attention kernels, emulated on the CPU and
held against the JAX reference.

``kernels/ref.py`` holds two plain emulations that no path calls:

  * ``flash_attention_tc_ref``: B5's bf16 tensor-core numerics (64-key
    tiles, the scale after the bf16 x bf16 -> f32 product, P split into
    bf16 hi + lo for the PV product);
  * ``flash_decode_split_ref``: B6's split of the cache rows over a cluster
    (per-split max, sum and accumulator, splits with no row included) and
    its merge in split order.

Each is held, from numpy inputs made from a seed, against the reference's
Pallas kernel in interpret mode and against its plain attention
(``models/attention.py::full_attention`` for B5, ``decode_attention`` for
B6). Tolerances, the card checks' own: f32 rtol = atol = 2e-5; bf16 within
1 bf16 ulp of the largest |o|. Widths: B 2, H 4, Hkv 2, D 64 and 128.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.models.attention import decode_attention as j_decode_attn
from repro.models.attention import full_attention as j_full
from repro_torch.kernels import ref

# jitted once per shape, so the lengths and splits of a width share a trace
_j_decode = jax.jit(functools.partial(j_decode, bs=32, interpret=True))
_j_decode_attn = jax.jit(j_decode_attn)
_j_flash = jax.jit(functools.partial(j_flash, causal=True, interpret=True),
                   static_argnames=("window", "bq", "bkv"))
_j_full = jax.jit(functools.partial(j_full, causal=True),
                  static_argnames=("window",))

BF16 = ml_dtypes.bfloat16
B, H, HKV = 2, 4, 2
CACHE = 96                       # cache rows: a multiple of the Pallas block
DECODE_LENGTHS = (1, 7, 8, 9, 20, 21, 63, 64, 65, CACHE)
SPLITS = (1, 8, 16)


def _t(a):
    """numpy (incl. ml_dtypes bfloat16) -> CPU tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_close(got, want, dtype):
    f32 = [x.float().numpy() if isinstance(x, torch.Tensor)
           else np.asarray(x, np.float32) for x in (got, want)]
    got, want = f32
    if dtype == "bf16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _normal(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(BF16) if dtype == "bf16" else x


# --------------------------------------------------------------------------
# B6: the cache split over a cluster, and its merge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", DECODE_LENGTHS)
def test_flash_decode_split_matches_reference(length, d, dtype):
    """Every split count, including more splits than rows (splits with no
    row keep m = NEG_INF, l = 0 and drop out of the merge)."""
    rng = np.random.default_rng(1000 * d + length)
    q = _normal(rng, (B, 1, H, d), dtype)
    kc, vc = (_normal(rng, (B, CACHE, HKV, d), dtype) for _ in range(2))
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), length)
    pallas = _j_decode(*jargs)
    plain = _j_decode_attn(*jargs)
    for splits in SPLITS:
        got = ref.flash_decode_split_ref(_t(q), _t(kc), _t(vc), length, splits)
        assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                             else torch.float32)
        _assert_close(got, pallas, dtype)
        _assert_close(got, plain, dtype)


def test_flash_decode_split_empty_splits_change_nothing():
    """length < splits: the splits past the last row are empty, and the
    merge gives what one split over the same rows gives."""
    rng = np.random.default_rng(5)
    q, kc, vc = (_t(_normal(rng, s, "f32")) for s in
                 ((B, 1, H, 64), (B, 16, HKV, 64), (B, 16, HKV, 64)))
    for length in (1, 5, 7):
        one = ref.flash_decode_split_ref(q, kc, vc, length, 1)
        many = ref.flash_decode_split_ref(q, kc, vc, length, 8)
        torch.testing.assert_close(many, one, rtol=2e-6, atol=2e-6)


# --------------------------------------------------------------------------
# B5: bf16 tensor-core numerics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,dtype", [(64, "bf16"), (128, "bf16"),
                                     (128, "f32")])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("s", [1, 45, 64, 65, 128])
def test_flash_attention_tc_matches_reference(s, window, d, dtype):
    """Sq = Skv = s, causal, against the materialized-score attention and,
    for bf16 (the tensor-core kernel's type) at the path's head dim 128,
    the Pallas kernel (blocks of 64 where they divide s, else one block)."""
    rng = np.random.default_rng(10 * s + window + d)
    q = _normal(rng, (B, H, s, d), dtype)
    k, v = (_normal(rng, (B, HKV, s, d), dtype) for _ in range(2))
    got = ref.flash_attention_tc_ref(_t(q), _t(k), _t(v), causal=True,
                                     window=window)
    if dtype == "bf16" and d == 128:
        blk = 64 if s % 64 == 0 else s
        pallas = _j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=window, bq=blk, bkv=blk)
        _assert_close(got, pallas, dtype)
    full = _j_full(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
                   window=window)
    _assert_close(got, np.asarray(full, np.float32).transpose(0, 2, 1, 3),
                  dtype)


def test_flash_attention_tc_hi_lo_split_is_f32_class():
    """P as bf16 hi + lo carries p to ~2^-18 relative: the PV product of
    the emulation stays within 2e-5 of an f64 oracle on bf16 inputs, where
    P rounded once to bf16 does not."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(_normal(rng, (1, 2, 128, 128), "bf16")) for _ in range(3))
    want = ref.flash_attention_ref(q.double(), k.double(), v.double())
    got = ref.flash_attention_tc_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-5)
    s = (q.double() @ k.double().transpose(-1, -2)) / 128 ** 0.5
    s = s.masked_fill(torch.ones(128, 128).triu(1).bool(), float("-inf"))
    p = torch.softmax(s, -1)
    hi_only = p.bfloat16().double() @ v.double()
    assert (hi_only - want).abs().max().item() > 2e-5


def test_flash_attention_tc_rows_without_visible_keys_are_zero():
    """Non-causal with a window and Skv < Sq: rows whose window holds no
    key return exactly 0, as the kernel's o * (1 / max(l, 1e-30)) gives."""
    rng = np.random.default_rng(7)
    q = _t(_normal(rng, (1, 2, 16, 64), "bf16"))
    k, v = (_t(_normal(rng, (1, 2, 4, 64), "bf16")) for _ in range(2))
    got = ref.flash_attention_tc_ref(q, k, v, causal=False, window=2)
    assert bool((got[:, :, 5:] == 0).all())
    _assert_close(got, ref.flash_attention_ref(q, k, v, causal=False,
                                               window=2), "bf16")
