"""Draws at a flat-index offset, on the CPU: ``core/threefry.py``'s
``random_bits`` / ``uniform`` / ``normal`` and the noise-draw kernel's
plain shot draw (``kernels/ref.py::readout_shot_ref``, which
``kernels/noise_draw.py::readout_shot`` runs for CPU tensors) yield the
elements [offset, offset + n) of a larger draw under the same key: what
GSPMD's partitioned ``jax.random`` computes for a rank's block of rows,
and what a rank of the data-split noisy encode draws.

Tolerances: bitwise (the same counters through the same arithmetic),
against slices of the whole draw, of ``jax.random.bits``, and past 2^32
against the counter words (i >> 32, i & 0xFFFFFFFF) of the threefry
block itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import noise as tnoise
from repro_torch.core import threefry
from repro_torch.kernels.noise_draw import readout_shot
from repro_torch.kernels.ref import readout_shot_ref

KEY = threefry.prng_key(7)
SHAPE = (6, 37)                                  # rows of 37
OFFSETS = [0, 1, 37, 2 * 37 + 5]                 # a row boundary, past it


@pytest.mark.parametrize("offset", OFFSETS)
def test_random_bits_at_an_offset_are_a_slice_of_the_whole_draw(offset):
    n = 37
    whole = threefry.random_bits(KEY, (240,)).numpy()
    ref = np.asarray(jax.random.bits(jax.random.PRNGKey(7), (240,),
                                     jnp.uint32)).astype(np.int64)
    got = threefry.random_bits(KEY, (1, n), offset=offset).numpy().ravel()
    np.testing.assert_array_equal(got, whole[offset:offset + n])
    np.testing.assert_array_equal(got, ref[offset:offset + n])
    u = threefry.uniform(KEY, (n,), -0.5, 0.5, offset=offset).numpy()
    np.testing.assert_array_equal(u, threefry.uniform(
        KEY, (240,), -0.5, 0.5).numpy()[offset:offset + n])
    z = threefry.normal(KEY, (n,), offset=offset).numpy()
    np.testing.assert_array_equal(z, threefry.normal(
        KEY, (240,)).numpy()[offset:offset + n])


def test_random_bits_past_two_to_the_32():
    offset = 2 ** 32 + 3
    got = threefry.random_bits(KEY, (4,), offset=offset).numpy()
    want = []
    for i in range(offset, offset + 4):
        y0, y1 = threefry.threefry2x32(KEY[0], KEY[1], i >> 32,
                                       i & threefry.MASK32)
        want.append(y0 ^ y1)
    np.testing.assert_array_equal(got, np.array(want, np.int64))


@pytest.mark.parametrize("offset", OFFSETS)
def test_readout_shot_at_an_offset_is_its_rows_of_the_whole_draw(offset):
    """A rank's rows of a readout (the rows [r, r + 2) of a (6, 37)
    output: offset r x 37) drawn at their offset: bitwise those rows of
    the whole readout's shot noise; at offset 0 they are not (unless the
    rows are the first)."""
    state = tnoise.DriftState(threefry.prng_key(3), 11,
                              np.float32(0.02)).to_tensor()
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        SHAPE).astype(np.float32))
    whole = readout_shot_ref(y, state, (2, 5), 4, 0.005).reshape(-1)
    part = y.reshape(-1)[offset:offset + 74].clone()
    got = readout_shot_ref(part, state, (2, 5), 4, 0.005, offset)
    np.testing.assert_array_equal(got.numpy(),
                                  whole[offset:offset + 74].numpy())
    if offset:
        assert not torch.equal(readout_shot_ref(part, state, (2, 5), 4,
                                                0.005),
                               whole[offset:offset + 74])


def test_readout_shot_wrapper_takes_the_offset_on_the_cpu():
    state = tnoise.DriftState(threefry.prng_key(3), 11, np.float32(0.02))
    with tnoise.noise_scope(state):
        call = tnoise.next_call_keys(tnoise.NoiseSpec())
    y = torch.ones(2, 37)
    got = readout_shot(y.clone(), call, 0.005, 37)
    want = readout_shot_ref(torch.ones(3, 37), state.to_tensor(),
                            call.salts, call.counter, 0.005)[1:]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
