"""Microring-resonator (MR) device model and calibrated device noise (the
reference's src/repro/core/noise.py).

The paper's §IV "MR Resolution Analysis":

    phi(i, j) = delta^2 / ((lambda_i - lambda_j)^2 + delta^2)
    delta     = lambda / (2 * Q_factor)
    P_noise   = sum_j phi(i, j) * P_in[j]          (j != i)
    Resolution (levels) = 1 / max_i |P_noise(i)|

and its claim that >= 8-bit resolution needs Q ~= 5000 on the 32-channel
WDM grid (4.8 nm spacing around 1550 nm, the reference's calibration).
``transmission_error`` draws the multiplicative weight error the photonic
matmul simulator and the noisy dispatch (core/backend.py) apply: the
crosstalk floor as a uniform bound, fabrication-process variation (FPV)
and, under a drift, the Lorentzian detune of every ring plus its wander.

``NoiseSpec`` is the operating point; ``DriftState`` the device's time
state (key lineage, frame, accumulated drift), kept as host numpy scalars
(uint32[2], int32, float32) so ``advance`` accumulates drift in f32 as the
reference does on its device. ``DriftState.write`` puts it into a device
state tensor (int32[4]: key words, frame, drift's f32 bits), which the
noise-draw kernel reads, so a CUDA graph captured over that tensor draws
what an eager call at the state written last draws.

The noise scope threads the state through the dispatch as the reference's
does: ``noise_scope(state, tensor)`` installs it for the calling thread,
``scope_salt`` folds a salt (a layer index) into later keys, and every
noisy dispatch takes ``next_call_keys(spec)``, whose per-scope counter
numbers the call sites. A call's draw key is
``fold_in(... fold_in(fold_in(key, frame), salt_1) ..., counter)``; it is
derived where it is drawn (inside the kernel, from the state tensor), so
only the salts, the counter and the FPV key (the spec's seed folded with
the same salts and counter, a property of the chip, not of time) travel
as launch arguments. Draws use JAX's threefry2x32 (core/threefry.py), so
the port's noise is the reference's at equal state, not only in
distribution.
"""

from __future__ import annotations

import functools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import threefry

__all__ = ["MRConfig", "wavelength_grid", "crosstalk_matrix", "noise_power",
           "resolution_bits", "required_q_factor", "transmission_error",
           "mr_detune_gain", "detune_delta2", "drifted_noise_floor",
           "NoiseSpec",
           "DriftState", "NoiseCall", "noise_scope", "scoped", "scope_salt",
           "current_scope", "next_call_keys", "shot_key", "readout_noise",
           "state_draw_key", "state_drift"]


@dataclass(frozen=True)
class MRConfig:
    """Photonic device constants (paper §IV: Q=5000, 32 channels, C-band)."""

    n_channels: int = 32          # WDM wavelength channels (= VCSEL count)
    q_factor: float = 5000.0      # MR quality factor
    center_nm: float = 1550.0     # C-band centre
    spacing_nm: float = 4.8       # calibrated: Q=5000 <-> 8-bit resolution
    # geometry (paper: 400nm input wg, 760nm ring wg, 5um radius) — recorded
    # for documentation; the behavioural model depends only on Q and the grid.
    ring_radius_um: float = 5.0
    input_wg_nm: float = 400.0
    ring_wg_nm: float = 760.0


def wavelength_grid(cfg: MRConfig, device=None) -> torch.Tensor:
    """Channel wavelengths lambda_i (nm, f32), centred on cfg.center_nm."""
    n = cfg.n_channels
    offsets = ((torch.arange(n, device=device).float() - (n - 1) / 2.0)
               * cfg.spacing_nm)
    return cfg.center_nm + offsets


def crosstalk_matrix(cfg: MRConfig, drift_nm=0.0, device=None
                     ) -> torch.Tensor:
    """phi[i, j]: fraction of channel j's power leaking into channel i,
    delta^2 / ((l_i + drift - l_j)^2 + delta^2), delta = lambda_i / (2Q);
    the diagonal is zeroed. ``drift_nm`` (a float or an f32 tensor) shifts
    every ring against the fixed laser grid (0: the static matrix)."""
    lam = wavelength_grid(cfg, device)
    delta = lam / (2.0 * cfg.q_factor)
    diff2 = (lam[:, None] + drift_nm - lam[None, :]) ** 2
    phi = (delta[:, None] ** 2) / (diff2 + delta[:, None] ** 2)
    return phi * (1.0 - torch.eye(cfg.n_channels, device=device))


def noise_power(cfg: MRConfig, p_in: torch.Tensor | None = None
                ) -> torch.Tensor:
    """P_noise[i] = sum_j phi(i,j) * P_in[j] (the paper evaluates at
    P_in = 1, every channel at full power)."""
    phi = crosstalk_matrix(cfg)
    if p_in is None:
        p_in = torch.ones(cfg.n_channels)
    return phi @ p_in


@functools.lru_cache(maxsize=None)
def resolution_bits(cfg: MRConfig) -> float:
    """Achievable bit resolution = log2(1 / max|P_noise|), on the host in
    f32 numpy as the reference computes it (a static constant)."""
    n = cfg.n_channels
    lam = (cfg.center_nm
           + (np.arange(n, dtype=np.float32) - (n - 1) / 2.0)
           * np.float32(cfg.spacing_nm))
    delta = lam / np.float32(2.0 * cfg.q_factor)
    diff2 = (lam[:, None] - lam[None, :]) ** 2
    phi = (delta[:, None] ** 2) / (diff2 + delta[:, None] ** 2)
    phi = phi * (1.0 - np.eye(n, dtype=np.float32))
    levels = 1.0 / float(np.abs(phi.sum(axis=1)).max())
    return math.log2(levels)


def required_q_factor(target_bits: float = 8.0, cfg: MRConfig | None = None,
                      q_lo: float = 100.0, q_hi: float = 1e6) -> float:
    """Bisect the minimum Q-factor achieving ``target_bits`` resolution on
    ``cfg``'s grid (the paper's 8 bits need Q just under 5000 on the
    default grid)."""
    base = cfg or MRConfig()

    def bits_at(q):
        return resolution_bits(MRConfig(
            n_channels=base.n_channels, q_factor=q,
            center_nm=base.center_nm, spacing_nm=base.spacing_nm))

    lo, hi = q_lo, q_hi
    if bits_at(hi) < target_bits:
        raise ValueError("target resolution unreachable within q_hi")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if bits_at(mid) >= target_bits:
            hi = mid
        else:
            lo = mid
    return hi


# Fold constants deriving the independent per-component subkeys from one
# call key (fold_in, so the crosstalk uniform keeps the call key itself)
_FPV_FOLD = 0x46505601    # "FPV"
_WANDER_FOLD = 0x574E4401  # "WND"
_SHOT_FOLD = 0x53484F01    # "SHO"


def detune_delta2(cfg: MRConfig) -> float:
    """delta^2 of the Lorentzian detune gain, delta = center / (2Q), taken
    in float64 and rounded to f32 as the reference's weak-typed constant."""
    delta = cfg.center_nm / (2.0 * cfg.q_factor)
    return float(np.float32(delta * delta))


def mr_detune_gain(cfg: MRConfig, detune_nm) -> torch.Tensor:
    """Lorentzian through-transmission of an MR bank detuned by
    ``detune_nm``: delta^2 / (d^2 + delta^2), unity on resonance. The
    denominator is one fused multiply-add, as XLA contracts it."""
    d2 = detune_delta2(cfg)
    d = torch.as_tensor(detune_nm, dtype=torch.float32)
    return d2 / threefry.fma(d, d, d2)


def drifted_noise_floor(cfg: MRConfig, drift_nm) -> torch.Tensor:
    """Worst-channel crosstalk power when every ring drifts by
    ``drift_nm`` (f32): max_i sum_j phi(i, j) of the drifted matrix; equal
    to 2^-resolution_bits at drift 0."""
    drift = torch.as_tensor(drift_nm, dtype=torch.float32)
    phi = crosstalk_matrix(cfg, drift, device=drift.device)
    return (phi @ torch.ones(cfg.n_channels, device=drift.device)).max()


def transmission_error(key, shape, cfg: MRConfig | None = None,
                       fpv_sigma: float = 0.0, *, fpv_key=None,
                       drift_nm=None, wander_sigma_nm: float = 0.0,
                       device=None) -> torch.Tensor:
    """Multiplicative weight-transmission error M (apply as w * M), drawn
    from ``key`` (a threefry key pair, core/threefry.py) as the reference
    draws it:

      * ``drift_nm`` None: the static floor 2^-resolution_bits as a uniform
        bound, M = 1 + U(-floor, floor);
      * else the drifted floor, M = (1 + (2u - 1) floor) * gain(drift +
        wander_sigma_nm * n_w), n_w drawn from fold_in(key, WANDER), u from
        ``key``;
      * then FPV: M *= 1 + fpv_sigma * n, n from ``fpv_key`` (else
        fold_in(key, FPV)).

    The noise-draw kernel (kernels/noise_draw.py) computes the drifted
    branch on the card; this is its plain version."""
    cfg = cfg or MRConfig()
    if isinstance(key[0], torch.Tensor):
        device = key[0].device
    if drift_nm is None:
        floor = float(np.float32(2.0 ** (-resolution_bits(cfg))))
        m = 1.0 + threefry.uniform(key, shape, -floor, floor, device)
    else:
        drift = torch.as_tensor(drift_nm, dtype=torch.float32, device=device)
        floor = drifted_noise_floor(cfg, drift)
        u = threefry.uniform(key, shape, device=device)
        m = threefry.fma(2.0 * u - 1.0, floor, 1.0)
        detune = drift.expand(tuple(shape))
        if wander_sigma_nm > 0.0:
            wn = threefry.normal(threefry.fold_in(key, _WANDER_FOLD), shape,
                                 device)
            detune = threefry.fma(wn, float(np.float32(wander_sigma_nm)),
                                  detune)
        m = m * mr_detune_gain(cfg, detune)
    if fpv_sigma > 0.0:
        if fpv_key is None:
            fpv_key = threefry.fold_in(key, _FPV_FOLD)
        n = threefry.normal(fpv_key, shape, device)
        m = m * threefry.fma(n, float(np.float32(fpv_sigma)), 1.0)
    return m


# ---------------------------------------------------------------------------
# Calibrated noise-injection layer: NoiseSpec + time-indexed DriftState
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoiseSpec:
    """Calibrated device-noise operating point (hashable).

    The defaults are the paper's Q = 5000 / 8-bit point: the crosstalk floor
    of the calibrated 4.8 nm grid, ~1% fabrication-process variation, and
    0.5% shot noise on the balanced-photodetector readout. Drift, wander and
    recalibration are off unless set — they define the *time-varying* part of
    the model that ``DriftState`` evolves per frame.
    """

    q_factor: float = 5000.0       # MR quality factor (crosstalk floor)
    fpv_sigma: float = 0.01        # device-static fabrication variation
    shot_sigma: float = 0.005      # per-readout shot noise on the BPD
    drift_rate_nm: float = 0.0     # common-mode thermal drift per frame
    wander_sigma_nm: float = 0.0   # per-element fast resonance wander
    recal_bound_nm: float = 0.0    # drift bound triggering MR re-tuning (0=off)
    adc_quantize_output: bool = False  # range-limited ADC on the readout
    noisy_gate: bool = False       # also perturb the MGNet RoI gate matmuls
    seed: int = 0                  # FPV pattern seed (a property of the chip)

    def mr(self) -> MRConfig:
        return MRConfig(q_factor=self.q_factor)


class DriftState:
    """Time-indexed device state: PRNG lineage + accumulated thermal drift,
    host numpy scalars. ``frame`` indexes time (every draw folds it into
    the key, so successive frames see fresh noise while a pinned state
    reproduces bitwise); ``drift_nm`` is the accumulated common-mode
    resonance shift, grown by ``advance`` at the spec's rate and reset by
    recalibration."""

    __slots__ = ("key", "frame", "drift_nm")

    def __init__(self, key, frame, drift_nm):
        self.key = np.asarray(key, dtype=np.uint32).reshape(2)
        self.frame = np.int32(frame)
        self.drift_nm = np.float32(drift_nm)

    @classmethod
    def init(cls, seed: int = 0) -> "DriftState":
        return cls(threefry.prng_key(seed), 0, 0.0)

    def advance(self, spec: NoiseSpec, frames: int = 1) -> "DriftState":
        with np.errstate(over="ignore"):
            frame = self.frame + np.int32(frames)
        return DriftState(self.key, frame,
                          self.drift_nm
                          + np.float32(frames * spec.drift_rate_nm))

    def with_drift(self, nm) -> "DriftState":
        return DriftState(self.key, self.frame, np.float32(nm))

    def reset_drift(self) -> "DriftState":
        return self.with_drift(0.0)

    def words(self) -> np.ndarray:
        """int32[4]: the two key words, the frame and the drift's f32 bits
        (the device state tensor's layout)."""
        return np.array([self.key[0], self.key[1],
                         np.uint32(np.int64(self.frame) & threefry.MASK32),
                         np.float32(self.drift_nm).view(np.uint32)],
                        dtype=np.uint32).view(np.int32)

    def to_tensor(self, device=None) -> torch.Tensor:
        return torch.from_numpy(self.words()).to(device)

    def write(self, tensor: torch.Tensor) -> None:
        """Copy this state into a device state tensor (int32[4]), in stream
        order: a launch queued before reads the old state."""
        tensor.copy_(torch.from_numpy(self.words()))

    def __eq__(self, other) -> bool:
        return (isinstance(other, DriftState)
                and bool((self.words() == other.words()).all()))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DriftState(frame={self.frame}, drift_nm={self.drift_nm})"


def state_draw_key(state: torch.Tensor, salts=(), counter: int = 0):
    """A call's draw key from a state tensor (int32[4], any device), as
    int64 0-dim tensors: fold_in(... fold_in(fold_in(key, frame),
    salt_1) ..., counter)."""
    w = state.to(torch.int64) & threefry.MASK32
    k = threefry.fold_in((w[0], w[1]), w[2])
    for s in salts:
        k = threefry.fold_in(k, int(s))
    return threefry.fold_in(k, int(counter))


def state_drift(state: torch.Tensor) -> torch.Tensor:
    """The drift (f32, 0-dim) a state tensor holds."""
    return state[3:4].view(torch.float32)[0]


# ---------------------------------------------------------------------------
# Noise scope: per-call-site key threading for the backend dispatch
# ---------------------------------------------------------------------------
#
# The backend dispatch (core/backend.py) has no key parameter; a
# thread-local scope carries the DriftState (and the device state tensor
# the kernels read). Each noisy dispatch asks ``next_call_keys`` for its
# call: the scope's salts and the next value of its counter. A scope is
# installed per entry call (the serving entry points do), so the counter
# restarts at 0 and equal (params, inputs, DriftState) draw equal noise.

_scope_tls = threading.local()


class _NoiseScope:
    __slots__ = ("state", "salts", "counter", "tensor")

    def __init__(self, state: DriftState, tensor: torch.Tensor | None):
        self.state = state
        self.salts: tuple = ()
        self.counter = 0
        self.tensor = tensor

    def state_tensor(self, device) -> torch.Tensor:
        """The state tensor on ``device``: the one the scope was given (the
        server's, which a graph reads), else one written from ``state`` on
        first use."""
        dev = torch.device(device)
        t = self.tensor
        if t is None or t.device.type != dev.type:
            t = self.tensor = self.state.to_tensor(dev)
        return t


@functools.lru_cache(maxsize=4096)
def _fpv_key(seed: int, salts: tuple, counter: int) -> tuple[int, int]:
    k = threefry.prng_key(seed)
    for s in salts:
        k = threefry.fold_in(k, s)
    return threefry.fold_in(k, counter)


class NoiseCall:
    """The keys of one noisy dispatch (``next_call_keys``): the scope it
    was taken under (its state and state tensor), the salts and counter
    that number the call site, and the FPV key (host ints, derived from
    the spec's seed with the same salts and counter). The draw key itself
    is derived from the state tensor where it is drawn."""

    __slots__ = ("scope", "state", "salts", "counter", "fpv_key")

    def __init__(self, scope: _NoiseScope, salts: tuple, counter: int,
                 fpv_key: tuple[int, int]):
        self.scope = scope
        self.state = scope.state
        self.salts = salts
        self.counter = counter
        self.fpv_key = fpv_key

    @property
    def drift_nm(self) -> np.float32:
        return self.state.drift_nm

    def state_tensor(self, device) -> torch.Tensor:
        return self.scope.state_tensor(device)

    def draw_key(self) -> tuple[int, int]:
        """The draw key on the host (Python ints), from the scope's state."""
        k = threefry.fold_in((int(self.state.key[0]), int(self.state.key[1])),
                             int(self.state.frame))
        for s in self.salts:
            k = threefry.fold_in(k, s)
        return threefry.fold_in(k, self.counter)


@contextmanager
def noise_scope(state: DriftState, tensor: torch.Tensor | None = None):
    """Install ``state`` as the active noise scope for the calling thread.
    ``tensor`` is the device state tensor the kernels read (holding
    ``state``: the caller wrote it); None makes one from ``state`` on first
    use."""
    prev = getattr(_scope_tls, "scope", None)
    _scope_tls.scope = _NoiseScope(state, tensor)
    try:
        yield _scope_tls.scope
    finally:
        _scope_tls.scope = prev


def scoped(state: DriftState, fn, tensor: torch.Tensor | None = None):
    """Run ``fn()`` under a fresh noise scope."""
    with noise_scope(state, tensor):
        return fn()


def current_scope() -> _NoiseScope | None:
    return getattr(_scope_tls, "scope", None)


@contextmanager
def scope_salt(salt: int):
    """Fold an extra salt (e.g. a layer index) into subsequent keys; no-op
    when no scope is active, so clean paths share the code."""
    sc = current_scope()
    if sc is None:
        yield
        return
    prev = sc.salts
    sc.salts = prev + (int(salt),)
    try:
        yield
    finally:
        sc.salts = prev


def next_call_keys(spec: NoiseSpec) -> NoiseCall:
    """Keys for one noisy matmul dispatch. The draw key is unique per
    (frame, salt chain, call site): time-varying noise. The FPV key folds
    the same salts and counter into the spec seed's lineage instead, so
    the fabrication pattern of each call site is fixed across frames."""
    sc = current_scope()
    if sc is None:
        raise RuntimeError(
            "ExecPolicy.noise is set but no noise scope is active. Noisy "
            "dispatch draws its keys from a DriftState installed via "
            "repro_torch.core.noise.noise_scope(state) / scoped(state, fn) "
            "— the serving entry points do this; direct forward calls must "
            "wrap themselves.")
    n = sc.counter
    sc.counter += 1
    return NoiseCall(sc, sc.salts, n, _fpv_key(int(spec.seed), sc.salts, n))


def shot_key(key):
    """Readout-noise subkey folded out of a call's draw key."""
    return threefry.fold_in(key, _SHOT_FOLD)


def readout_noise(y: torch.Tensor, spec: NoiseSpec, call: NoiseCall,
                  bits: int = 8) -> torch.Tensor:
    """Shot noise on the BPD accumulate (y * (1 + shot_sigma * n), n drawn
    from the call's shot key by the noise-draw kernel, in place on y when
    it is a contiguous f32 tensor: the callers pass their fresh readout)
    and an optional range-limited ADC requant.

    Inside a data split (``sharding.absmax_scope(group, block)``: the
    launch's rows split evenly over the group in rank order, y this rank's
    rows with the batch leading) n is this rank's block of the whole
    launch's draw (``sharding.draw_offset``), as GSPMD partitions
    ``jax.random``, and the ADC's absmax is the whole launch's
    (``collectives.scoped_absmax_scale``). Every noisy output of the
    encode is such a readout: the transmission error is drawn on the
    weight, whole on every rank, and the analog walk draws nothing."""
    if spec.shot_sigma > 0.0:
        from repro_torch.distributed.sharding import draw_offset
        from repro_torch.kernels.noise_draw import readout_shot
        y = y.float().contiguous()
        y = readout_shot(y, call, spec.shot_sigma, draw_offset(y.numel()))
    if spec.adc_quantize_output:
        from repro_torch.core import quant
        from repro_torch.distributed.collectives import scoped_absmax_scale
        s = scoped_absmax_scale(y, bits)
        y = quant.dequantize(quant.quantize(y, s, bits=bits), s)
    return y
