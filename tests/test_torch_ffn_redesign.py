"""B3's Hopper design, the fused int8 FFN on a K-major main loop, from the
CPU side, held against the JAX reference; and the padded int32 accumulate.

* ``kernels/fused_ffn.py::ffn_entry_for`` picks the entry by widths only:
  ``kmajor`` (both GEMMs read the weights' K-major copies ``w1t`` / ``w2t``,
  ``QuantizedWeight.wt``) when d_in and d_ff are multiples of 16, the
  first design otherwise.
* On the CPU the wrapper checks the copies and runs the plain version,
  bitwise the same with and without them; ``core/backend.py::_ffn_fused``
  hands it the cache's own copies (a layer's copy a view of the stacked
  one, never a new transpose).
* The port's ``fused_ffn`` with the copies is within one hidden quant step
  (rtol = atol = 1e-2, corr > 0.9999: tests/test_fused_ffn.py's class) of
  the reference's ``fused_ffn_xla`` and of its Pallas kernel
  ``fused_ffn_int8`` in interpret mode.
* ``padded_int_mm`` zero-pads the codes to what ``torch._int_mm`` takes
  and slices the result back: bitwise the plain accumulate at ragged
  (M, K, N).

Inputs are made with numpy from a seed; widths d_in 64, d_ff 256.
tests/test_torch_gpu.py holds the CUDA entries against each other and
the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.fused_ffn import fused_ffn_int8, fused_ffn_xla
from repro_torch.core import backend as tbackend
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ref

D, DFF = 64, 256


def _cached_weight(rng, k, n, bits=8):
    w = (rng.standard_normal((k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    s = jquant.absmax_scale(jnp.asarray(w), bits=bits, axis=-2)
    return (np.asarray(jquant.quantize(jnp.asarray(w), s, bits=bits)),
            np.asarray(s).reshape(-1))


def _ffn_operands(seed, shape=(2, 37, D), bits=(8, 8)):
    """x and (w1q, sw1, b1, w2q, sw2, b2) as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w1q, sw1 = _cached_weight(rng, D, DFF, bits[0])
    w2q, sw2 = _cached_weight(rng, DFF, D, bits[1])
    b1 = (rng.standard_normal(DFF) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return x, (w1q, sw1, b1, w2q, sw2, b2)


def _copies(w1q, w2q):
    return {"w1t": w1q.t().contiguous(), "w2t": w2q.t().contiguous()}


def _assert_quant_step_close(a, b, err_msg=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2, err_msg=err_msg)
    if a.size > 1 and np.abs(a).max() > 1e-6:
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9999, err_msg


def test_ffn_entry_is_chosen_by_widths_only():
    assert tffn.ffn_entry_for(768, 3072) == "kmajor"      # base
    assert tffn.ffn_entry_for(192, 768) == "kmajor"       # tiny
    assert tffn.ffn_entry_for(1024, 2048) == "kmajor"     # large, 2 ranks
    assert tffn.ffn_entry_for(100, 3072) == "nmajor"
    assert tffn.ffn_entry_for(768, 3000) == "nmajor"
    assert tffn.ffn_entry_for(D, DFF) == "kmajor"


def test_cpu_wrapper_checks_the_copies_and_ignores_them():
    """The plain version runs on w1q / w2q whether or not the K-major
    copies come along (bitwise); a copy of the wrong shape or dtype
    raises."""
    x, ops = _ffn_operands(1)
    tx, t_ops = torch.from_numpy(x), tuple(map(torch.from_numpy, ops))
    w1q, w2q = t_ops[0], t_ops[3]
    want = tffn.fused_ffn(tx, *t_ops)
    assert torch.equal(tffn.fused_ffn(tx, *t_ops, **_copies(w1q, w2q)), want)
    assert torch.equal(tffn.fused_ffn_nmajor(tx, *t_ops), want)
    assert torch.equal(want, ref.fused_ffn_ref(tx, *t_ops))
    for bad in ({"w1t": w1q}, {"w2t": w2q},
                {"w1t": w1q.t().contiguous().to(torch.int32)},
                {"w2t": w2q.t().contiguous()[:, :-1]}):
        with pytest.raises(ValueError, match="K-major copy"):
            tffn.fused_ffn(tx, *t_ops, **bad)


def test_ffn_fused_hands_over_the_cache_copies(monkeypatch):
    """``_ffn_fused`` passes layer i's K-major copies from the stacked
    cache entry: views into ``w.wt``'s storage at ``w.wt[i]``."""
    rng = np.random.default_rng(2)
    w1 = tbackend.quantize_weight(torch.from_numpy(
        rng.standard_normal((3, D, DFF)).astype(np.float32)))
    w2 = tbackend.quantize_weight(torch.from_numpy(
        rng.standard_normal((3, DFF, D)).astype(np.float32)))
    seen, real = {}, tffn.fused_ffn

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)
    monkeypatch.setattr(tffn, "fused_ffn", spy)
    x = torch.from_numpy(rng.standard_normal((2, 9, D)).astype(np.float32))
    b1, b2 = torch.zeros(DFF), torch.zeros(D)
    got = tbackend._ffn_fused(x, w1.layer(1), b1, w2.layer(1), b2, None, 5)
    for name, w in (("w1t", w1), ("w2t", w2)):
        wt = seen[name]
        assert wt.untyped_storage().data_ptr() == \
            w.wt.untyped_storage().data_ptr()
        assert wt.data_ptr() == w.wt[1].data_ptr()
        assert wt.is_contiguous()
        assert torch.equal(wt, w.wq[1].t())
    assert seen["live_rows"] == 5 and seen["bits"] == (8, 8)
    assert bool((got[:, 5:] == 0).all())


@pytest.mark.parametrize("live", [None, 20])
@pytest.mark.parametrize("bits", [(8, 8), (8, 4)])
def test_fused_ffn_with_copies_matches_reference(bits, live):
    x, ops = _ffn_operands(3 + bits[1] + (live or 0), bits=bits)
    jops = tuple(map(jnp.asarray, ops))
    twin = np.asarray(fused_ffn_xla(jnp.asarray(x), *jops, bits=bits,
                                    live_rows=live))
    kern = np.asarray(fused_ffn_int8(jnp.asarray(x), *jops, bits=bits,
                                     live_rows=live, interpret=True))
    t_ops = tuple(map(torch.from_numpy, ops))
    got = tffn.fused_ffn(torch.from_numpy(x), *t_ops, bits=bits,
                         live_rows=live,
                         **_copies(t_ops[0], t_ops[3])).numpy()
    _assert_quant_step_close(got, twin, "vs fused_ffn_xla")
    _assert_quant_step_close(got, kern, "vs fused_ffn_int8(interpret=True)")
    if live is not None:
        assert np.all(got[:, live:] == 0.0)


@pytest.mark.parametrize("m,k,n", [(5, 37, 1003), (37, 196, 13), (1, 9, 7),
                                   (788, 64, 1024), (33, 120, 40),
                                   (40, 128, 64)])
def test_padded_int_mm_is_exact(m, k, n):
    """The operands ``padded_int_mm`` hands ``torch._int_mm`` meet its
    limits (M > 16, K and N multiples of 8, M a multiple of 32 below K =
    128), and the sliced result is the plain accumulate bitwise."""
    rng = np.random.default_rng(m + k + n)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    shapes = []

    def mm(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return ref.int_accumulate_ref(a, b)
    got = tffn.padded_int_mm(xq, wq, mm)
    ((mp, kp), (kp2, np_)), = shapes
    assert kp == kp2 and mp > 16 and kp % 8 == 0 and np_ % 8 == 0
    assert kp >= 128 or mp % 32 == 0
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, ref.int_accumulate_ref(xq, wq))
    assert torch.equal(tffn.int_accumulate(xq, wq), got)
