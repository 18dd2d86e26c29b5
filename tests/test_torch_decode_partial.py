"""B6's partial entry for a decode cache split along its sequence
(``DEFAULT_RULES``' "kv_seq" over "model"), on the CPU with no ranks:
``kernels/ref.py::flash_decode_partial_ref`` over R = 2-4 row ranges,
merged by ``models/attention.py::merge_partials``, against the
reference's ``decode_attention`` (f32, outside any mesh) on the whole
cache, within 1e-6 absolute; at lengths 1 (every range but the first
empty), a range boundary (the first range full, the next empty), the
boundary + 1 (one valid row in the second range) and S. A range with no
valid row gives o = 0, lse = NEG_INF and a merge weight of exactly 0,
with no NaN. ``update_kv_cache`` under the split writes the row on its
owner only. The card's kernel against this plain version is in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as jdecode

from repro_torch.distributed.sharding import Split
from repro_torch.kernels.flash_decode import flash_decode_partial
from repro_torch.kernels.ref import NEG_INF, flash_decode_partial_ref
from repro_torch.models.attention import merge_partials, update_kv_cache

B, S, H, HKV, D = 2, 24, 8, 2, 32


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, HKV, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _partials(q, k, v, ranges: int, length: int):
    rows = S // ranges
    parts = [flash_decode_partial_ref(
        torch.from_numpy(q), torch.from_numpy(k[:, r * rows:(r + 1) * rows]),
        torch.from_numpy(v[:, r * rows:(r + 1) * rows]), r * rows, length)
        for r in range(ranges)]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([lse for _, lse in parts]))


@pytest.mark.parametrize("ranges", [2, 3, 4])
@pytest.mark.parametrize("where", ["1", "boundary", "boundary + 1", "S"])
def test_merged_partials_equal_the_reference_decode(ranges, where):
    rows = S // ranges
    length = {"1": 1, "boundary": rows, "boundary + 1": rows + 1,
              "S": S}[where]
    q, k, v = _inputs(ranges * 7 + length)
    o, lse = _partials(q, k, v, ranges, length)
    got = merge_partials(o, lse)
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              length))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the ranges past the valid rows are empty: o = 0, lse = NEG_INF
    for r in range(ranges):
        if r * rows >= length:
            assert torch.equal(o[r], torch.zeros_like(o[r]))
            assert bool((lse[r] == NEG_INF).all())


def test_an_empty_range_weighs_exactly_zero_and_gives_no_nan():
    q, k, v = _inputs(1)
    o, lse = _partials(q, k, v, 2, 3)
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    # the empty range's o replaced by garbage must not move the merge
    junk = o.clone()
    junk[1] = 1e30
    assert torch.equal(merge_partials(junk, lse), merge_partials(o, lse))
    # every range empty but one: that range's output, to the ulp
    np.testing.assert_allclose(merge_partials(o, lse).numpy(), o[0].numpy(),
                               rtol=0, atol=1e-6)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2))
    got = flash_decode_partial(q, k[:, 8:16], v[:, 8:16], 8, 11)
    want = flash_decode_partial_ref(q, k[:, 8:16], v[:, 8:16], 8, 11)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    o, lse = flash_decode_partial(q, k[:, 16:], v[:, 16:], 16, 11)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse == NEG_INF).all())
    with pytest.raises(TypeError, match="host int"):
        flash_decode_partial(q, k, v, torch.tensor(0), 3)


def test_update_kv_cache_writes_on_the_owning_rank_only():
    rows, n = 4, 3
    new = torch.ones(B, 1, HKV, D)
    for pos in (0, 3, 4, 11):
        for r in range(n):
            kc, vc = torch.zeros(B, rows, HKV, D), torch.zeros(B, rows, HKV,
                                                                 D)
            update_kv_cache(kc, vc, new, 2 * new, pos, Split(n, r, None))
            owner = pos // rows == r
            assert bool((kc != 0).any()) == owner
            if owner:
                assert bool((kc[:, pos % rows] == 1).all())
                assert bool((vc[:, pos % rows] == 2).all())
    with pytest.raises(IndexError):
        update_kv_cache(kc, vc, new, new, rows * n, Split(n, 0, None))
