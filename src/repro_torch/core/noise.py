"""Microring-resonator (MR) device constants (the reference's
src/repro/core/noise.py, the part the energy model reads).

Only ``MRConfig`` is ported: ``core/photonic.py::OpticalCoreConfig``
carries one. The crosstalk, resolution and transmission-error model, the
``NoiseSpec`` / ``DriftState`` device noise and its scopes come with the
noise slice of the port (ROADMAP.md queue A11).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MRConfig"]


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
