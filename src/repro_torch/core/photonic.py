"""Geometry and event counts of the Opto-ViT optical processing core (the
reference's src/repro/core/photonic.py, the part the energy model reads).

Architecture (paper Fig. 3b / Fig. 4 / Fig. 6): 32 VCSELs drive 32 WDM
wavelength channels (one 32-element input chunk per cycle); 64 waveguide
arms each hold a bank of 32 MRs tuned to one column chunk of the weight
(a 32 x 64 weight tile per core); one balanced photodetector per arm sums
the 32 products; the EPU accumulates chunk partial sums and 8-bit ADCs
read the outputs.

``matmul_stats`` counts the events of one (M, K) x (K, N) matmul on that
tile grid, which ``core/energy.py`` prices. ``photonic_matmul_sim`` walks
a matmul over the grid as Fig. 6 schedules it: K in 32-wide wavelength
chunks, every arm at once; it is the w8a8 integer contract
(``photonic_matmul_exact``) unless ``apply_noise`` perturbs the tuned
weights, which then walk as float codes (``analog_accumulate``: sub-LSB
noise cannot ride through int8 codes). The noisy branch draws with the
plain ``transmission_error`` from an explicit key; the serving dispatch
draws on the card (core/backend.py, kernels/noise_draw.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import quant
from repro_torch.core.noise import MRConfig, transmission_error

__all__ = ["OpticalCoreConfig", "PhotonicOpStats", "matmul_stats",
           "photonic_matmul_exact", "analog_accumulate",
           "photonic_matmul_sim"]


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


def photonic_matmul_exact(x: torch.Tensor, w: torch.Tensor,
                          cfg: OpticalCoreConfig | None = None
                          ) -> torch.Tensor:
    """w8a8 integer-exact photonic matmul (no analog noise): x per tensor
    and w per output channel quantized to ``cfg.bits``, one exact int32
    accumulate, then acc * sx * sw."""
    from repro_torch.core.backend import int_accumulate_exact

    cfg = cfg or OpticalCoreConfig()
    sx = quant.absmax_scale(x, bits=cfg.bits)                   # scalar
    sw = quant.absmax_scale(w, bits=cfg.bits, axis=0)           # (1, N)
    xq = quant.quantize(x, sx, bits=cfg.bits)
    wq = quant.quantize(w, sw, bits=cfg.bits)
    return int_accumulate_exact(xq, wq).float() * sx * sw


def analog_accumulate(xq: torch.Tensor, wqf: torch.Tensor,
                      chunk: int = 32) -> torch.Tensor:
    """Float-code walk of the Fig. 6 schedule over perturbed weights:
    xq (M, K) activation codes, wqf (K, N) float weight codes (integer
    codes times the analog transmission multiplier). K is zero-padded to
    whole ``chunk``-wide wavelength chunks; each chunk's (M, chunk) x
    (chunk, N) product is one f32 product (all chunks in one batched
    matmul, outside any kernel of the port, as the reference leaves them
    to XLA; TF32 must be off on the card: ``device.full_precision_matmuls``),
    and the partial sums are added in chunk order in f32, as the
    reference's scan adds them. A loop of ``addmm_`` over the chunks sums
    the same numbers without the partials but fills few SMs a K = 32
    product, and is slower on the card (``scripts/noise_walk_ab.py``)."""
    m, k = xq.shape
    n = wqf.shape[1]
    rem = (-k) % chunk
    xf = torch.nn.functional.pad(xq.float(), (0, rem))
    wf = torch.nn.functional.pad(wqf.float(), (0, 0, 0, rem))
    nk = (k + rem) // chunk
    parts = torch.bmm(xf.reshape(m, nk, chunk).transpose(0, 1),
                      wf.reshape(nk, chunk, n))
    acc = parts[0].clone()
    for c in range(1, nk):
        acc += parts[c]
    return acc


def photonic_matmul_sim(x: torch.Tensor, w: torch.Tensor,
                        cfg: OpticalCoreConfig | None = None,
                        noise_key=None, drift_nm=None,
                        wander_sigma_nm: float = 0.0) -> torch.Tensor:
    """Tile-walking simulator of the optical core: x (M, K), w (K, N) ->
    (M, N) f32. Clean, it is the int32 accumulate over 32-wide chunks
    (``int_accumulate_sim``) and the dequant. With ``cfg.apply_noise`` the
    MR transmission error (crosstalk floor + FPV, plus the Lorentzian
    drift / wander when ``drift_nm`` is given) multiplies the tuned codes,
    drawn from ``noise_key`` (a threefry key pair, core/threefry.py),
    which is then required: a missing key raises, as the reference's does
    (a fixed default key would freeze the pattern). With
    ``adc_quantize_output`` the readout is requantized over its own
    range."""
    cfg = cfg or OpticalCoreConfig()
    m, k = x.shape
    k2, n = w.shape
    assert k == k2, (x.shape, w.shape)
    sx = quant.absmax_scale(x, bits=cfg.bits)
    sw = quant.absmax_scale(w, bits=cfg.bits, axis=0)
    xq = quant.quantize(x, sx, bits=cfg.bits)
    wq = quant.quantize(w, sw, bits=cfg.bits)
    if cfg.apply_noise:
        if noise_key is None:
            raise ValueError(
                "photonic_matmul_sim(apply_noise=True) requires an explicit "
                "noise_key: pass one derived from a DriftState/frame counter "
                "(repro_torch.core.noise) so successive calls draw fresh "
                "error patterns.")
        wqf = wq.float() * transmission_error(
            noise_key, tuple(wq.shape), cfg.mr, cfg.fpv_sigma,
            drift_nm=drift_nm, wander_sigma_nm=wander_sigma_nm,
            device=x.device)
        acc = analog_accumulate(xq, wqf, chunk=cfg.n_wavelengths)
    else:
        from repro_torch.core.backend import int_accumulate_sim
        acc = int_accumulate_sim(xq, wq, chunk=cfg.n_wavelengths).float()
    out = acc * sx * sw
    if cfg.adc_quantize_output:
        s_out = quant.absmax_scale(out, bits=cfg.bits)
        out = quant.dequantize(quant.quantize(out, s_out, bits=cfg.bits),
                               s_out)
    return out
