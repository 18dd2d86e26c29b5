"""Cross-layer energy/latency model of the Opto-ViT accelerator (the
reference's src/repro/core/energy.py, whole).

Reproduces the paper's §IV "Performance Estimation" methodology: event counts
from the optical-core mapping (core/photonic.py: matmul_stats) x per-event
energy constants -> energy breakdown (Tuning, VCSEL, BPD, ADC, DAC, memory,
EPU) and latency breakdown (optical incl. ADC/DAC, EPU, memory) per model
variant and image size — Figs 8-11 and the Table IV KFPS/W headline.

Constants are 45 nm-class values from the cited literature (ROBIN [26],
CrossLight [28], Lightator [36] era), chosen so that the paper's two
qualitative anchors reproduce:
  * ADC is the dominant energy component (Fig. 8 pie, Tiny-96x96),
  * the headline efficiency lands at ~100.4 KFPS/W for the reference config.
KFPS/W for a pipelined accelerator equals frames-per-joule/1000, so the
headline pins E_frame ~= 9.96 uJ for the reference (Tiny, 96x96) workload.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from repro_torch.core.photonic import OpticalCoreConfig, PhotonicOpStats, matmul_stats

__all__ = ["EnergyConstants", "LatencyConstants", "EnergyReport",
           "energy_of_stats", "latency_of_stats", "accumulate_matmuls",
           "kfps_per_watt", "aggregate_reports", "scale_for_bits"]


@dataclass(frozen=True)
class EnergyConstants:
    """Per-event energies in picojoules (45 nm node).

    Calibrated within the cited literature ranges (ROBIN [26], CrossLight
    [28], Lightator [36], LightBulb [34], SAR-ADC surveys) to the paper's
    two quantitative anchors for the Tiny-96x96 reference workload:
      * ADC is the dominant energy component (Fig. 8 pie), and
      * the headline lands at ~100.4 KFPS/W (E_frame ~= 9.96 uJ).
    With the Tiny-96 event counts (5.75M tunings, 3.32M VCSEL symbols,
    6.65M BPD reads, 0.888M ADC conversions, 6.66M DAC conversions,
    7.55M SRAM accesses, 5.76M EPU adds + 0.39M nonlins) these values give
    E_frame = 9.99 uJ with a 30% ADC share.
    """

    mr_tuning_pj: float = 0.26     # electro-optic MR tuning event [26], [28]
    vcsel_pj: float = 0.21         # VCSEL drive per symbol [36]
    bpd_pj: float = 0.12           # BPD + TIA read [26]
    adc_pj: float = 3.37           # 8-bit SAR ADC conversion [23], [34]
    dac_pj: float = 0.21           # 8-bit DAC conversion [26]
    sram_rd_pj: float = 0.25       # 8-bit SRAM read, 45 nm
    sram_wr_pj: float = 0.30       # 8-bit SRAM write, 45 nm
    epu_add_pj: float = 0.05       # 32-bit electronic accumulate
    epu_nonlin_pj: float = 1.0     # softmax/GELU unit per element [38]


@dataclass(frozen=True)
class LatencyConstants:
    """Stage latencies in nanoseconds.

    Calibrated to the paper's Fig. 9 qualitative ordering for Tiny-96:
    optical (incl. ADC/DAC) > memory > EPU. 8-bit SAR ADC at 500 MS/s
    (2 ns/conversion, 64-lane bank) makes the conversion wall part of the
    "optical processing delay" exactly as the paper groups it.
    """

    optical_cycle_ns: float = 0.2   # 5 GHz symbol rate (modulator bound)
    tuning_ns: float = 2.0          # MR bank tuning per tile (hidden when pipelined)
    adc_ns: float = 2.0             # 8-bit SAR conversion (500 MS/s)
    adc_lanes: int = 64             # one ADC per arm
    sram_ns: float = 1.0            # per access, 256-lane banked array
    sram_lanes: int = 256
    epu_elem_ns: float = 0.05       # nonlinear op per element (vectorized)


@dataclass
class EnergyReport:
    """Per-component energy (uJ) + latency (us) for one forward frame."""

    tuning_uj: float = 0.0
    vcsel_uj: float = 0.0
    bpd_uj: float = 0.0
    adc_uj: float = 0.0
    dac_uj: float = 0.0
    memory_uj: float = 0.0
    epu_uj: float = 0.0
    optical_us: float = 0.0
    epu_us: float = 0.0
    memory_us: float = 0.0

    @property
    def total_uj(self) -> float:
        return (self.tuning_uj + self.vcsel_uj + self.bpd_uj + self.adc_uj
                + self.dac_uj + self.memory_uj + self.epu_uj)

    @property
    def total_us(self) -> float:
        return self.optical_us + self.epu_us + self.memory_us

    def breakdown(self) -> dict:
        t = self.total_uj
        return {k: getattr(self, k) / t for k in
                ("tuning_uj", "vcsel_uj", "bpd_uj", "adc_uj", "dac_uj",
                 "memory_uj", "epu_uj")} if t > 0 else {}

    # -- streaming aggregation (serving engine accounting) -----------------
    @property
    def _FIELDS(self) -> tuple:
        # derived, not hand-listed: a future component field joins the
        # aggregation automatically instead of being silently dropped
        return tuple(f.name for f in fields(self))

    def __add__(self, other: "EnergyReport") -> "EnergyReport":
        return EnergyReport(**{f: getattr(self, f) + getattr(other, f)
                               for f in self._FIELDS})

    def __iadd__(self, other: "EnergyReport") -> "EnergyReport":
        for f in self._FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def scaled(self, n: float) -> "EnergyReport":
        """Report for ``n`` identical frames (per-batch accounting)."""
        return EnergyReport(**{f: getattr(self, f) * n for f in self._FIELDS})


def energy_of_stats(stats: PhotonicOpStats, nonlin_elems: int = 0,
                    c: EnergyConstants | None = None) -> EnergyReport:
    c = c or EnergyConstants()
    r = EnergyReport()
    pj = 1e-6  # pJ -> uJ
    r.tuning_uj = stats.mr_tunings * c.mr_tuning_pj * pj
    r.vcsel_uj = stats.vcsel_cycles * c.vcsel_pj * pj
    r.bpd_uj = stats.bpd_reads * c.bpd_pj * pj
    r.adc_uj = stats.adc_conversions * c.adc_pj * pj
    r.dac_uj = stats.dac_conversions * c.dac_pj * pj
    r.memory_uj = (stats.sram_reads * c.sram_rd_pj + stats.sram_writes * c.sram_wr_pj) * pj
    r.epu_uj = (stats.electronic_adds * c.epu_add_pj + nonlin_elems * c.epu_nonlin_pj) * pj
    return r


def latency_of_stats(stats: PhotonicOpStats, nonlin_elems: int = 0,
                     lc: LatencyConstants | None = None,
                     pipelined_tuning: bool = True,
                     n_tiles: int = 0,
                     bits: float = 8.0, ref_bits: int = 8,
                     exposed_tunings: int | None = None) -> EnergyReport:
    """Fill the latency fields of an EnergyReport (us).

    With the Eq. 2 decomposition + Fig. 5 pipeline, tuning overlaps compute
    (``pipelined_tuning=True``): only the *first* tile's tuning is exposed.
    Without it, every tile tuning serializes — this is exactly the latency
    delta the decomposition buys.

    ``bits`` scales the width-sensitive stage times: an n-bit SAR
    conversion is n compare cycles and the SRAM code traffic shrinks with
    the stored width, so the ADC wall and the memory stage pay
    ``bits/ref_bits`` of the 8-bit constants. The optical symbol rate and
    the EPU are width-independent. This is the latency view of
    ``scale_for_bits`` — a mixed-precision plan now buys wall time too,
    not just energy (the serving cost model needs width-aware latency to
    rank bit plans honestly).

    ``exposed_tunings`` overrides the pipelined-tuning count — callers
    summing *partial* stats of one pipelined pass (per-layer width-aware
    accounting) pass 0 for all but one part, so the sum stays bit-exact
    to the aggregate call.
    """
    lc = lc or LatencyConstants()
    r = EnergyReport()
    ns = 1e-3  # ns -> us
    w = float(bits) / float(ref_bits)
    optical = stats.cycles * lc.optical_cycle_ns
    if exposed_tunings is None:
        exposed_tunings = 1 if pipelined_tuning else max(n_tiles, 1)
    optical += exposed_tunings * lc.tuning_ns
    optical += stats.adc_conversions * lc.adc_ns * w / lc.adc_lanes
    r.optical_us = optical * ns
    r.epu_us = nonlin_elems * lc.epu_elem_ns * ns
    r.memory_us = ((stats.sram_reads + stats.sram_writes) * w
                   / lc.sram_lanes * lc.sram_ns * ns)
    return r


def accumulate_matmuls(shapes: list[tuple[int, int, int]],
                       cfg: OpticalCoreConfig | None = None) -> tuple[PhotonicOpStats, int]:
    """Sum optical-core event stats over a list of (M, K, N) matmuls.

    Returns (stats, n_tiles_total) where n_tiles is used for the
    non-pipelined latency comparison.
    """
    cfg = cfg or OpticalCoreConfig()
    total = PhotonicOpStats()
    tiles = 0
    for (m, k, n) in shapes:
        total += matmul_stats(m, k, n, cfg)
        tiles += (-(-k // cfg.n_wavelengths)) * (-(-n // cfg.n_arms))
    return total, tiles


def scale_for_bits(rep: EnergyReport, bits: float,
                   ref_bits: int = 8) -> EnergyReport:
    """Energy report for a weight-stationary matmul run at ``bits`` width.

    The width-sensitive events are the ones a SAR-ADC/DAC/SRAM/MR-tuning
    datapath pays per *bit*: an n-bit SAR conversion is n compare cycles,
    the DAC drive and the MR tuning resolution scale with the code width,
    and the int8 SRAM traffic shrinks with the stored code — so
    ``tuning_uj``/``adc_uj``/``dac_uj``/``memory_uj`` scale by
    ``bits/ref_bits`` (the first-order model ENLighten and the LightBulb
    ADC analysis both use; constants above are calibrated at 8 bits).
    VCSEL symbols, BPD reads and EPU adds are per-event, not per-bit.

    Of the latency fields only ``memory_us`` scales here (SRAM code
    traffic is per-bit): ``optical_us`` mixes width-scaled ADC time with
    width-independent symbol cycles and cannot be decomposed after the
    fact — width-aware optical latency comes from
    ``latency_of_stats(..., bits=...)``, which is what the serving
    accounting and the control-plane cost model use.
    """
    s = float(bits) / float(ref_bits)
    out = EnergyReport(**{f: getattr(rep, f) for f in rep._FIELDS})
    out.tuning_uj *= s
    out.adc_uj *= s
    out.dac_uj *= s
    out.memory_uj *= s
    out.memory_us *= s
    return out


def kfps_per_watt(report: EnergyReport) -> float:
    """KFPS/W = frames-per-joule / 1000 = 1 / (E_frame[mJ])."""
    e_mj = report.total_uj / 1000.0
    return 1.0 / e_mj if e_mj > 0 else float("inf")


def aggregate_reports(reports) -> EnergyReport:
    """Sum an iterable of EnergyReports into one aggregate report.

    ``kfps_per_watt(aggregate.scaled(1 / n_frames))`` is then the stream's
    Table-4 metric: KFPS/W of a pipelined accelerator depends only on the
    mean energy per frame, not on host wall time.
    """
    total = EnergyReport()
    for r in reports:
        total += r
    return total
