"""Geometry and event counts of the Opto-ViT optical processing core (the
reference's src/repro/core/photonic.py, the part the energy model reads).

Architecture (paper Fig. 3b / Fig. 4 / Fig. 6): 32 VCSELs drive 32 WDM
wavelength channels (one 32-element input chunk per cycle); 64 waveguide
arms each hold a bank of 32 MRs tuned to one column chunk of the weight
(a 32 x 64 weight tile per core); one balanced photodetector per arm sums
the 32 products; the EPU accumulates chunk partial sums and 8-bit ADCs
read the outputs.

``matmul_stats`` counts the events of one (M, K) x (K, N) matmul on that
tile grid, which ``core/energy.py`` prices. The behavioural simulator
(``analog_accumulate``, ``photonic_matmul_sim``, ``photonic_matmul_exact``)
comes with the noise slice of the port (ROADMAP.md queue A11).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.noise import MRConfig

__all__ = ["OpticalCoreConfig", "PhotonicOpStats", "matmul_stats"]


@dataclass(frozen=True)
class OpticalCoreConfig:
    """Geometry of one optical processing core + array-level parallelism."""

    n_wavelengths: int = 32       # K-chunk: inputs applied per cycle (VCSELs)
    n_arms: int = 64              # N-chunk: output columns per cycle (= d_k)
    n_cores: int = 5              # cores in the optical processing block
    bits: int = 8                 # MR/ADC/DAC resolution
    mr: MRConfig = field(default_factory=MRConfig)
    apply_noise: bool = False     # inject crosstalk/FPV transmission error
    fpv_sigma: float = 0.0
    adc_quantize_output: bool = False   # re-quantize the accumulated output
    #                                     to ``bits`` over its own range
    #                                     (models a range-limited ADC; off =
    #                                     ideal ADC, integer-exact readout)


@dataclass
class PhotonicOpStats:
    """Event counts for the energy/latency model (core/energy.py)."""

    mr_tunings: int = 0           # MR tuning events (weight loads)
    vcsel_cycles: int = 0         # VCSEL drive events (input chunk emissions)
    bpd_reads: int = 0            # BPD accumulation events
    adc_conversions: int = 0      # ADC conversions (outputs to digital)
    dac_conversions: int = 0      # DAC conversions (weight tuning + VCSEL drive)
    electronic_adds: int = 0      # partial-sum accumulations in the EPU
    sram_reads: int = 0
    sram_writes: int = 0
    cycles: int = 0               # optical core cycles (chunk steps)

    def __iadd__(self, other: "PhotonicOpStats") -> "PhotonicOpStats":
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self


def matmul_stats(m: int, k: int, n: int,
                 cfg: OpticalCoreConfig) -> PhotonicOpStats:
    """Analytic event counts for an (M,K)x(K,N) MatMul on the optical block.

    Follows Fig. 6: the weight is split into ceil(K/32) x ceil(N/64) tiles;
    each tile is tuned once (32*64 MR tunings) and every row of X streams
    through it (one VCSEL cycle + 64 BPD reads per row per K-chunk).
    """
    kc = -(-k // cfg.n_wavelengths)       # ceil
    nc = -(-n // cfg.n_arms)
    arms = cfg.n_arms
    waves = cfg.n_wavelengths
    s = PhotonicOpStats()
    s.mr_tunings = kc * nc * arms * waves
    s.dac_conversions = s.mr_tunings + m * kc * waves   # tuning DACs + VCSEL DACs
    s.vcsel_cycles = m * kc * nc * waves
    s.bpd_reads = m * kc * nc * arms
    s.adc_conversions = m * nc * arms                    # one conversion per output elem
    s.electronic_adds = m * (kc - 1) * nc * arms if kc > 1 else 0
    s.sram_writes = m * nc * arms
    s.sram_reads = kc * nc * arms * waves + m * kc * waves
    # cycle count with n_cores-way tile parallelism across the optical block
    s.cycles = -(-(m * kc * nc) // cfg.n_cores)
    return s
