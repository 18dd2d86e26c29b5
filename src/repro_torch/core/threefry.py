"""JAX's default PRNG, threefry2x32, in its partitionable layout, so the
port draws exactly the random bits the reference draws from the same key.

The reference draws every device-noise sample with ``jax.random``
(src/repro/core/noise.py) under ``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True``:

  * ``PRNGKey(s)`` is the key ``(s >> 32, s & 0xFFFFFFFF)`` (``(0, s)`` for
    a 32-bit seed);
  * ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  * ``random_bits(k, shape)`` is the xor of the two words of
    ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))`` at each flat row-major
    index ``i``;
  * ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2),
    subtracts 1, then scales ``f * (hi - lo) + lo`` and clips below at lo;
    XLA on the CPU contracts the scaling into one fused multiply-add;
  * ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
    XLA's f32 ``erf_inv``: M. Giles' single-precision approximation (two
    degree-8 polynomials in w = -log1p(-x^2) or sqrt(w), Horner steps
    contracted to fused multiply-adds).

The integer functions work on Python ints and on int64 tensors alike (32-bit
words kept masked, so no signed overflow), on any device: the host derives
keys with ints, the plain versions of ``kernels/noise_draw.py`` draw with
tensors. Keys are pairs ``(k0, k1)`` of either. ``fma`` rounds a*b + c once
to f32 through float64 (exact for f32 a and b), as the CUDA kernel's
``fmaf`` does. The bits and the uniforms are the reference's bitwise;
``normal`` differs from it where ``log1p`` does (PyTorch's against XLA's),
an f32 ulp of w, ~5e-7 at most at |n| ~ 4.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["MASK32", "threefry2x32", "prng_key", "fold_in", "random_bits",
           "bits_to_unit", "fma", "uniform", "erfinv_f32", "normal",
           "NORMAL_LO", "SQRT2", "ERFINV_LT5", "ERFINV_GE5"]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# normal's uniform range and scale, as f32 (jax.random._normal_real)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(math.sqrt(2.0)))
# XLA's ErfInv32 coefficients (w < 5, and w >= 5 on sqrt(w)), highest first
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block of JAX's ``threefry2x32_p``: key
    words (k0, k1), counter words (x0, x1), each a 32-bit value held in a
    Python int or an int64 tensor (broadcast). Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & MASK32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two ints."""
    seed = int(seed)
    if seed < 0:
        return 0, seed & MASK32
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``data`` an int (taken mod 2^32)
    or an int64 tensor of a 32-bit word."""
    return threefry2x32(key[0], key[1], 0, data & MASK32)


def _threefry_tensors(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` over int64 counter tensors, updated in place (the
    same arithmetic, without a new tensor per operation)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK32)
    x1 = (x1 + ks[1]).bitwise_and_(MASK32)
    low = torch.empty_like(x1)
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_right_shift(x1, 32 - r, out=low)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK32)
            x1.bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(step + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(step + 2) % 3] + step + 1).bitwise_and_(MASK32)
    return x0, x1


# counters drawn at once on the CPU: the working set stays in cache
_CPU_CHUNK = 1 << 18


def random_bits(key, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor of
    32-bit values; a tensor key keeps its device. With ``offset`` the
    elements [offset, offset + prod(shape)) of the flat index of a larger
    draw under the same key (the block a rank holds of a draw partitioned
    along its leading dim, as GSPMD's partitioned ``jax.random`` computes
    it)."""
    if isinstance(key[0], torch.Tensor):
        device = key[0].device
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    step = _CPU_CHUNK if out.device.type == "cpu" else max(n, 1)
    for c0 in range(0, n, step):
        idx = torch.arange(offset + c0, offset + min(n, c0 + step),
                           dtype=torch.int64, device=device)
        y0, y1 = _threefry_tensors(key[0], key[1], idx >> 32,
                                   idx & MASK32)
        out[c0:c0 + step] = y0.bitwise_xor_(y1)
    return out.reshape(tuple(shape))


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1 (exact)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once (float64 holds the f32 product exactly;
    ``b`` and ``c`` are f32 tensors or f32-representable floats)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, f32, minval, maxval)``: f * (hi -
    lo) + lo as one fused multiply-add (hi - lo rounded to f32 first),
    clipped below at lo. ``offset`` as ``random_bits``'s."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    f = bits_to_unit(random_bits(key, shape, device, offset))
    return torch.clamp_min(fma(f, span, float(lo)), float(lo))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles): w = -log1p(-x^2); for w < 5 a
    polynomial in w - 2.5, else in sqrt(w) - 3; times x; +-1 -> +-max."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(ERFINV_LT5, ERFINV_GE5):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = c if p is None else fma(p, w, c)
    r = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, r)


def normal(key, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32)`` (at ``offset``: as
    ``random_bits``)."""
    return SQRT2 * erfinv_f32(uniform(key, shape, NORMAL_LO, 1.0, device,
                                      offset))
