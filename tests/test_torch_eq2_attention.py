"""Eq. 2's attention core on B2's wide tensor-core entry, emulated on the
CPU and held against the JAX reference.

Eq. 2 hands B2 q = Q_h W_K^T / sqrt(dh) at the model width, the one
shared key head X, and per-head V: (D, Dv) = (d_model, 64), Hk = 1,
scale 1.0. On the card those shapes take the wide entry
(``csrc/flash_attention.cu::wide``), which streams Q and K in
``WIDE_D_CHUNK``-wide D-chunks and sums S chunk by chunk in f32, each
chunk's three TF32 passes in turn. ``kernels/ref.py::
flash_attention_masked_tc_ref(d_chunk=)`` emulates that order; it is held
to rtol = atol = 2e-5 (the card check's limit) against the reference's
Pallas kernel in interpret mode and against the port's plain version, and
one TF32 pass must miss that limit at D = 768.

Inputs are made with numpy from a seed; widths B 2, H 3 (ViT-Tiny's
heads), D 192 (its width) and 768.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_masked as j_masked
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (WIDE_D_CHUNK,
                                                 flash_attention_masked,
                                                 masked_entry_for)

B, H = 2, 3
MODES = ("ones", "mask", "dead", "kv_len")

_j_masked = jax.jit(functools.partial(j_masked, interpret=True),
                    static_argnames=("kv_len", "scale"))


def _operands(s: int, d: int, mode: str, seed: int):
    """Eq. 2's q (B, H, s, D) at unit-scale scores, k (B, 1, s, D), v
    (B, H, s, 64) and the mask keyword of ``mode``, as numpy."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, s, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((B, 1, s, d)).astype(np.float32)
    v = rng.standard_normal((B, H, s, 64)).astype(np.float32)
    kw = {}
    if mode in ("mask", "dead"):
        m = (rng.random((B, s)) > 0.5).astype(np.float32)
        if mode == "dead":
            m[-1] = 0.0
        kw["key_mask"] = m
    elif mode == "kv_len":
        kw["kv_len"] = s // 2 + 1
    return q, k, v, kw


def _torch(q, k, v, kw):
    return ((torch.from_numpy(a) for a in (q, k, v)),
            {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for n, a in kw.items()})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", [1, 33, 50])
def test_wide_emulation_matches_reference_at_eq2_shapes(s, mode):
    """The wide entry's numerics (D-chunks of WIDE_D_CHUNK, 32-key tiles)
    at Eq. 2's ViT-Tiny shapes against the reference's Pallas kernel in
    interpret mode and the port's plain version; a dead batch row is
    exactly 0."""
    q, k, v, kw = _operands(s, 192, mode, seed=s + len(mode))
    (tq, tk, tv), tkw = _torch(q, k, v, kw)
    got = ref.flash_attention_masked_tc_ref(tq, tk, tv, scale=1.0,
                                            d_chunk=WIDE_D_CHUNK, **tkw)
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    pallas = np.asarray(_j_masked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=1.0, **jkw))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    plain = ref.flash_attention_masked_ref(tq, tk, tv, scale=1.0, **tkw)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("mode", ["ones", "mask"])
def test_wide_emulation_at_vit_base_width(mode):
    """ViT-Base's (768, 64): the chunked emulation within 2e-5 of the
    plain version, which the CPU wrapper runs."""
    q, k, v, kw = _operands(37, 768, mode, seed=3)
    (tq, tk, tv), tkw = _torch(q, k, v, kw)
    got = ref.flash_attention_masked_tc_ref(tq, tk, tv, scale=1.0,
                                            d_chunk=WIDE_D_CHUNK, **tkw)
    plain = flash_attention_masked(tq, tk, tv, scale=1.0, **tkw)
    assert torch.equal(plain, ref.flash_attention_masked_ref(
        tq, tk, tv, scale=1.0, **tkw))
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)


def test_one_tf32_pass_misses_the_f32_class_at_d768():
    """hi.hi alone over 768-wide dot products is far outside the 2e-5
    limit that three passes hold: the lo terms are needed."""
    q, k, v, kw = _operands(37, 768, "mask", seed=9)
    (tq, tk, tv), tkw = _torch(q, k, v, kw)
    want = ref.flash_attention_masked_ref(tq, tk, tv, scale=1.0, **tkw)
    one, three = (ref.flash_attention_masked_tc_ref(
        tq, tk, tv, scale=1.0, d_chunk=WIDE_D_CHUNK, passes=p, **tkw)
        for p in (1, 3))
    excess = ((one - want).abs() - 2e-5 * want.abs()).max().item()
    assert excess > 5 * 2e-5
    assert torch.allclose(three, want, rtol=2e-5, atol=2e-5)


def test_d_chunk_must_divide_d():
    q, k, v, _ = _operands(5, 96, "ones", seed=0)
    (tq, tk, tv), _ = _torch(q, k, v, {})
    with pytest.raises(ValueError, match="d_chunk"):
        ref.flash_attention_masked_tc_ref(tq, tk, tv, d_chunk=64)


@pytest.mark.parametrize("d,dv,entry", [
    (192, 64, "wide"), (768, 64, "wide"), (1024, 64, "wide"),
    (96, 64, "wide"), (64, 64, "tc"), (32, 48, "simt"), (768, 48, "simt"),
    (760, 64, "simt"), (80, 64, "simt"), (32, 64, "simt")])
def test_entry_is_chosen_by_shape_only(d, dv, entry):
    """Dv = 64 with D > 64 a multiple of the chunk takes the wide entry,
    (64, 64) the (64, 64) tensor-core entry, every other pair SIMT."""
    assert masked_entry_for(d, dv) == entry
