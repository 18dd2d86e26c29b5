"""Streaming KFPS/W accounting over the cross-layer accelerator model (the
reference's src/repro/serving/accounting.py).

Every encode flush of bucket k adds ``n_real`` frames' worth of the
``vit_matmul_shapes(kept_patches=k)`` event counts; every MGNet invocation
adds the mask generator's own shapes (frames that reused a cached mask pay
nothing). The aggregate divides out to the paper's Table-4 metric: KFPS/W
of a pipelined accelerator is frames-per-joule / 1000, i.e. 1 / mean
E_frame[mJ], independent of host wall time (reported apart as frames/s).

``summary()`` also gives per-bucket hit and launch counts and warns on dead
buckets: ladder entries no frame routed to, each of which still costs a
warmed encode (on the card, a captured CUDA graph).

Under a mixed-precision bit plan (``layer_bits``, one width per encoder
layer) each layer's weight-stationary matmuls pay their width's share of
the 8-bit constants (``_mixed_bits_report``).

A drift-triggered recalibration (device noise, core/noise.py) bills one
full-model MR re-tuning pass (``retune_report``) to every live stream
(``add_recalibration``, counted in ``recal_events``).

A server that times its flushes (the control plane's ``autotune``, the
``watchdog``) bills each flush's measured wall seconds to every owning
stream (``add_flush_wall``); ``measured_flush_s`` is their mean per
bucket, and ``summary()`` prints it beside the modeled latency.

``state_dict`` / ``load_state`` carry every accumulated counter through a
checkpoint or a migration (the per-bucket reports rebuild from the
config).
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import fields as _dc_fields
from typing import Iterable

from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import (EnergyReport, accumulate_matmuls,
                                     energy_of_stats, kfps_per_watt,
                                     latency_of_stats, scale_for_bits)
from repro_torch.core.photonic import PhotonicOpStats
from repro_torch.models.vit import vit_matmul_shapes

__all__ = ["StreamAccounting", "bucket_report", "mgnet_report",
           "retune_report"]


def _nonlin_elems(cfg: ArchConfig, n_tokens: int) -> int:
    """Softmax (H * n^2) + GELU (n * d_ff) element count per frame."""
    return cfg.n_layers * (cfg.n_heads * n_tokens * n_tokens
                           + n_tokens * cfg.d_ff)


# index layout of one layer's chunk in vit_matmul_shapes: q, k, v,
# scores, attn@v, out-proj, mlp w1, mlp w2
_WEIGHT_IDX = (0, 1, 2, 5, 6, 7)
_ACT_IDX = (3, 4)


def _mixed_bits_report(cfg: ArchConfig, shapes: list, nl: int,
                       layer_bits: tuple) -> EnergyReport:
    """Energy and latency with each layer's weight-stationary matmuls
    (q/k/v, out-projection, both MLP matmuls) at its planned width: their
    MR tuning, ADC/DAC conversion and SRAM code traffic pay ``bits/8`` of
    the 8-bit constants, in energy (``scale_for_bits``) and in the ADC and
    SRAM stage latencies (``latency_of_stats(bits=...)``). The score and
    PV matmuls and the patch embed stay at 8 bits. One pipelined tuning
    exposure is counted for the whole frame, and the parts are summed in
    the reference's order, so a uniform-8 plan gives the unplanned
    report."""
    embed_stats, _ = accumulate_matmuls(shapes[:1])
    rep = energy_of_stats(embed_stats, nl)
    lat = latency_of_stats(embed_stats, nl, exposed_tunings=1)
    for li, bits in enumerate(layer_bits):
        chunk = shapes[1 + 8 * li: 1 + 8 * (li + 1)]
        w_stats, _ = accumulate_matmuls([chunk[i] for i in _WEIGHT_IDX])
        a_stats, _ = accumulate_matmuls([chunk[i] for i in _ACT_IDX])
        rep += scale_for_bits(energy_of_stats(w_stats), bits)
        rep += energy_of_stats(a_stats)
        lat += latency_of_stats(w_stats, bits=bits, exposed_tunings=0)
        lat += latency_of_stats(a_stats, exposed_tunings=0)
    rep.optical_us, rep.epu_us, rep.memory_us = (
        lat.optical_us, lat.epu_us, lat.memory_us)
    return rep


def bucket_report(cfg: ArchConfig, bucket: int,
                  layer_bits: Iterable[int] | None = None) -> EnergyReport:
    """Per-frame accelerator-model report for one k-patch encode (backbone
    only): energy components + optical/EPU/memory latency. ``layer_bits``
    (one width per encoder layer, ``core.bitalloc.plan_layer_bits``)
    bills each layer at its width."""
    n_patches = (cfg.img_size // cfg.patch) ** 2
    kept = None if bucket >= n_patches else bucket
    shapes = vit_matmul_shapes(cfg, kept_patches=kept)
    stats, tiles = accumulate_matmuls(shapes)
    nl = _nonlin_elems(cfg, bucket + 1)
    lb = tuple(int(b) for b in layer_bits) if layer_bits is not None else None
    if lb is not None and len(shapes) == 1 + 8 * cfg.n_layers:
        return _mixed_bits_report(cfg, shapes, nl, lb)
    rep = energy_of_stats(stats, nl)
    lat = latency_of_stats(stats, nl, n_tiles=tiles)
    rep.optical_us, rep.epu_us, rep.memory_us = (
        lat.optical_us, lat.epu_us, lat.memory_us)
    return rep


def mgnet_report(cfg: ArchConfig) -> EnergyReport:
    """Per-invocation MGNet report (the shapes ``include_mgnet`` appends
    after the backbone's)."""
    base = vit_matmul_shapes(cfg)
    full = vit_matmul_shapes(cfg, include_mgnet=True)
    stats, tiles = accumulate_matmuls(full[len(base):])
    rep = energy_of_stats(stats)
    lat = latency_of_stats(stats, n_tiles=tiles)
    rep.optical_us, rep.epu_us, rep.memory_us = (
        lat.optical_us, lat.epu_us, lat.memory_us)
    return rep


def retune_report(cfg: ArchConfig,
                  layer_bits: Iterable[int] | None = None) -> EnergyReport:
    """Energy of one full-model MR re-tuning pass (drift-triggered online
    recalibration): every weight-stationary bank's codes are re-driven once
    (one tuning event and one tuning-DAC conversion per MR) at the dense
    tile grid. The score and PV matmuls are tuned every cycle anyway and pay
    nothing extra. ``layer_bits`` scales each layer's tuning energy to its
    planned width, as ``_mixed_bits_report`` does."""
    shapes = vit_matmul_shapes(cfg)

    def tune_only(sel_shapes):
        stats, _ = accumulate_matmuls(sel_shapes)
        t = stats.mr_tunings
        return energy_of_stats(PhotonicOpStats(mr_tunings=t,
                                               dac_conversions=t))

    rep = tune_only(shapes[:1])            # patch embed bank
    lb = (tuple(int(b) for b in layer_bits)
          if layer_bits is not None else None)
    per_layer = len(shapes) == 1 + 8 * cfg.n_layers
    if per_layer:
        for li in range(cfg.n_layers):
            chunk = shapes[1 + 8 * li: 1 + 8 * (li + 1)]
            layer = tune_only([chunk[i] for i in _WEIGHT_IDX])
            rep += layer if lb is None else scale_for_bits(layer, lb[li])
    else:                                   # non-standard shape list
        rep += tune_only(shapes[1:])
    return rep


class StreamAccounting:
    """Accumulates per-frame EnergyReports bucket by bucket, one stream."""

    def __init__(self, cfg: ArchConfig,
                 ladder_sizes: Iterable[int] | None = None,
                 layer_bits: Iterable[int] | None = None):
        self.cfg = cfg
        self.total = EnergyReport()
        self.frames = 0
        self.scored_frames = 0
        self.ladder_sizes = (tuple(int(k) for k in ladder_sizes)
                             if ladder_sizes is not None else None)
        self.layer_bits = (tuple(int(b) for b in layer_bits)
                           if layer_bits is not None else None)
        if (self.layer_bits is not None
                and len(self.layer_bits) != cfg.n_layers):
            raise ValueError(f"layer_bits has {len(self.layer_bits)} "
                             f"entries for {cfg.n_layers} layers")
        self.bucket_frames: Counter = Counter()
        self.bucket_launches: Counter = Counter()
        # measured wall seconds a flush (sum + count per bucket): the
        # observed numbers the cost model's calibration fits against
        self.flush_wall_s: dict[int, float] = {}
        self.flush_wall_n: Counter = Counter()
        self._per_bucket: dict[int, EnergyReport] = {}
        self._mgnet: EnergyReport | None = None
        self._retune: EnergyReport | None = None
        self.recal_events = 0

    def _bucket_report(self, k: int) -> EnergyReport:
        """Per-frame report for a k-patch encode, computed once a bucket."""
        rep = self._per_bucket.get(k)
        if rep is None:
            rep = self._per_bucket[k] = bucket_report(self.cfg, k,
                                                      self.layer_bits)
        return rep

    def _mgnet_report(self) -> EnergyReport:
        if self._mgnet is None:
            self._mgnet = mgnet_report(self.cfg)
        return self._mgnet

    def add_encode(self, bucket: int, n_frames: int) -> None:
        self.total += self._bucket_report(bucket).scaled(n_frames)
        self.frames += n_frames
        self.bucket_frames[int(bucket)] += n_frames
        self.bucket_launches[int(bucket)] += 1

    def add_mgnet(self, n_invocations: int) -> None:
        self.total += self._mgnet_report().scaled(n_invocations)
        self.scored_frames += n_invocations

    def add_recalibration(self) -> None:
        """Bill one drift-triggered MR re-tuning pass (``retune_report``)
        to this stream's running energy total."""
        if self._retune is None:
            self._retune = retune_report(self.cfg, self.layer_bits)
        self.total += self._retune
        self.recal_events += 1

    def add_flush_wall(self, bucket: int, wall_s: float) -> None:
        """Record one flush's measured host wall seconds at this bucket (a
        ``mix_streams`` flush is billed in full to every owning stream: the
        mean then reads as the seconds of the launches this stream's frames
        rode in, not exclusive time)."""
        k = int(bucket)
        self.flush_wall_s[k] = self.flush_wall_s.get(k, 0.0) + float(wall_s)
        self.flush_wall_n[k] += 1

    def measured_flush_s(self, bucket: int) -> float | None:
        """Mean measured wall seconds a flush at this bucket (None before
        any timed flush landed there)."""
        k = int(bucket)
        n = self.flush_wall_n[k]
        return self.flush_wall_s[k] / n if n else None

    # -- checkpoint / migration ---------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the accumulated accounting: everything a
        restored session needs to keep billing where it left off (the
        per-bucket report caches rebuild from the config). Counter keys
        become strings (JSON keys are strings); ``load_state`` turns them
        back into ints."""
        return {
            "total": {f.name: getattr(self.total, f.name)
                      for f in _dc_fields(self.total)},
            "frames": self.frames,
            "scored_frames": self.scored_frames,
            "bucket_frames": {str(k): v
                              for k, v in self.bucket_frames.items()},
            "bucket_launches": {str(k): v
                                for k, v in self.bucket_launches.items()},
            "flush_wall_s": {str(k): v
                             for k, v in self.flush_wall_s.items()},
            "flush_wall_n": {str(k): v
                             for k, v in self.flush_wall_n.items()},
            "recal_events": self.recal_events,
        }

    def load_state(self, state: dict) -> None:
        """Load ``state_dict()`` output into this (fresh) accounting; the
        config, ladder and bit plan are the caller's to match (the
        server's checkpoint compatibility check)."""
        self.total = EnergyReport(**{k: float(v)
                                     for k, v in state["total"].items()})
        self.frames = int(state["frames"])
        self.scored_frames = int(state["scored_frames"])
        self.bucket_frames = Counter(
            {int(k): int(v) for k, v in state["bucket_frames"].items()})
        self.bucket_launches = Counter(
            {int(k): int(v) for k, v in state["bucket_launches"].items()})
        self.flush_wall_s = {int(k): float(v)
                             for k, v in state["flush_wall_s"].items()}
        self.flush_wall_n = Counter(
            {int(k): int(v) for k, v in state["flush_wall_n"].items()})
        self.recal_events = int(state["recal_events"])

    def dead_buckets(self) -> tuple[int, ...]:
        """Ladder entries no frame was ever routed to (empty when no
        ladder was registered)."""
        if self.ladder_sizes is None:
            return ()
        return tuple(k for k in self.ladder_sizes
                     if self.bucket_frames[k] == 0)

    def summary(self, warn: bool = True) -> str:
        """Per-bucket hit/launch counts (and, where the server timed its
        flushes, the measured ms a flush beside the modeled accelerator's
        us a frame), warning on dead buckets (``warn`` False keeps the
        ``[dead: ...]`` text without the UserWarning)."""
        sizes = (self.ladder_sizes if self.ladder_sizes is not None
                 else tuple(sorted(self.bucket_frames)))
        parts = []
        for k in sizes:
            part = (f"k={k}: {self.bucket_frames[k]} hits/"
                    f"{self.bucket_launches[k]} launches")
            meas = self.measured_flush_s(k)
            if meas is not None:
                part += (f" ({meas * 1e3:.1f}ms/flush measured, "
                         f"{self._bucket_report(k).total_us:.2f}us/frame "
                         f"modeled)")
            parts.append(part)
        dead = self.dead_buckets()
        if dead and warn:
            warnings.warn(
                f"dead ladder buckets {list(dead)}: no frame routed to "
                f"them in {self.frames} frames — every ladder entry costs "
                f"a warmed encode, retune the bucket fractions "
                f"(README 'Bucket-ladder tuning')", stacklevel=2)
        line = " | ".join(parts) if parts else "no encodes"
        if dead:
            line += f"  [dead: {', '.join(f'k={k}' for k in dead)}]"
        return f"buckets: {line}"

    @property
    def mean_frame(self) -> EnergyReport:
        return self.total.scaled(1.0 / self.frames if self.frames else 0.0)

    @property
    def kfps_per_watt(self) -> float:
        return kfps_per_watt(self.mean_frame) if self.frames else 0.0

    def dense_baseline_kfps_per_watt(self, with_mgnet: bool = True) -> float:
        """KFPS/W if every frame were encoded dense (and scored, if
        ``with_mgnet``): the no-gating reference for the energy saved."""
        n = (self.cfg.img_size // self.cfg.patch) ** 2
        rep = self._bucket_report(n)
        if with_mgnet:
            rep = rep + self._mgnet_report()
        return kfps_per_watt(rep)
