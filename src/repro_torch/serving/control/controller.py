"""Online serving controller: calibrate the cost model, then close the loop
(the reference's src/repro/serving/control/controller.py, operation for
operation: equal inputs give equal fits, knobs and reports).

Two phases, both driven from ``StreamServer``'s scheduling loop:

**Calibration.** The cost model's predicted per-flush seconds are the
card's roofline bound; a flush's observed seconds also hold the host's
launch, copy-in and synchronization time, which no roofline sees. What
*does* transfer is the ranking and the rough linearity of "more
FLOPs/bytes -> more wall time", so the controller fits

    observed_s  ~=  a * predicted_s + b

over per-bucket *medians* of the telemetry window (medians, because the
first flush of a bucket the probe did not price is a CUDA-graph capture, an
outlier, and a
mean would drag the fit toward it; a configurable ``burn_in`` additionally
drops each bucket's leading observations). Buckets with at least
``min_samples`` observations get a further per-bucket multiplicative
correction on top of the global fit. ``median_rel_error`` scores the fit
on *held-out* observations — only flushes recorded after the fit was cut —
so the acceptance number is honest, not training error.

**Re-tuning.** Every ``retune_every`` frames the controller recommends new
values for the re-timing knobs — ``max_wait_chunks`` (deadline pad-flush),
``interleave_depth`` (ready-flush launches per session per round) and a
per-bucket ``flush_threshold`` (pad-flush a queue that reached this many
rows without waiting for the deadline) — from the fitted per-flush cost
plus live queue depths. Three guard rails make a mispredicting model
strictly safe:

  * **hysteresis** — a recommendation is applied only after it has been
    produced ``hysteresis`` times in a row; a flapping signal changes
    nothing;
  * **clamp** — every applied knob is clamped into a static bound box
    around the defaults (``max_wait_bound``, ``interleave_bound``,
    ``min_flush_fraction``); ``clamp_violations`` counts any applied knob
    found outside the box, and CI asserts it stays 0;
  * **fps watchdog** — the first ``step`` pins the fps observed under the
    default knobs as the baseline; if windowed fps later drops below
    ``(1 - safety_margin) x`` that baseline while tuned knobs are live,
    the controller reverts to the defaults and freezes. The tuned server
    can therefore never do persistently worse than the static defaults.

The controller deliberately never re-routes frames or trims the ladder
online: routing changes alter which encode shape a frame hits and would
break the per-stream bitwise-reproducibility contract mid-stream. Ladder
trimming happens once, before serving, in ``autotune_prepare`` (and only
when provably route-invariant).
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field

from repro_torch.serving.control.costmodel import EncodeCostModel
from repro_torch.serving.control.telemetry import FlushTelemetry

__all__ = ["ControllerConfig", "TunedKnobs", "Controller"]


@dataclass(frozen=True)
class ControllerConfig:
    """Guard-rail and cadence knobs of the controller itself."""

    retune_every: int = 32        # frames between step() evaluations
    hysteresis: int = 2           # identical consecutive recommendations
    #                               required before one is applied
    min_samples: int = 4          # per-bucket obs before a bucket-specific
    #                               fit correction is trusted
    burn_in: int = 1              # leading obs per bucket dropped from the
    #                               fit (first flush = capture outlier)
    max_wait_bound: int = 8       # clamp: 0 <= max_wait_chunks <= bound
    interleave_bound: int = 4     # clamp: 1 <= interleave_depth <= bound
    min_flush_fraction: float = 0.5   # clamp: flush_threshold >= this
    #                                   fraction of the micro-batch
    safety_margin: float = 0.25   # watchdog: revert + freeze when fps <
    #                               (1 - margin) * default-knob baseline


@dataclass
class TunedKnobs:
    """The mutable knob set the serving loop reads every round."""

    max_wait_chunks: int = 0
    interleave_depth: int = 1
    flush_threshold: dict = field(default_factory=dict)  # bucket -> rows

    def key(self) -> tuple:
        """Hashable identity for hysteresis comparison."""
        return (self.max_wait_chunks, self.interleave_depth,
                tuple(sorted(self.flush_threshold.items())))

    def copy(self) -> "TunedKnobs":
        return TunedKnobs(self.max_wait_chunks, self.interleave_depth,
                          dict(self.flush_threshold))

    def set_to(self, other: "TunedKnobs") -> None:
        """In-place adoption — the serving loop holds a reference to this
        object, so knob changes must mutate, never rebind."""
        self.max_wait_chunks = other.max_wait_chunks
        self.interleave_depth = other.interleave_depth
        self.flush_threshold = dict(other.flush_threshold)


class Controller:
    """Calibrating, self-clamping knob tuner for one ``StreamServer``."""

    def __init__(self, cost_model: EncodeCostModel,
                 telemetry: FlushTelemetry, defaults: TunedKnobs,
                 cc: ControllerConfig | None = None):
        self.cost_model = cost_model
        self.telemetry = telemetry
        self.cc = cc or ControllerConfig()
        self.defaults = defaults.copy()
        self.knobs = defaults.copy()       # the live object the loop reads
        self.clamp_violations = 0          # applied knobs outside the box
        self.clamp_engaged = 0             # recommendations the clamp fixed
        self.frozen = False                # watchdog tripped: defaults, hold
        self.applied_retunes = 0
        self._fit: tuple[float, float] | None = None   # (a, b)
        self._fit_seq = 0                  # telemetry seq at fit time
        self._bucket_scale: dict[int, float] = {}
        self._pending_key: tuple | None = None
        self._pending: TunedKnobs | None = None
        self._pending_count = 0
        self._stable_steps = 0             # consecutive steps rec == live
        self._ever_stable = False          # reached a fixed point at least
        #                                    once (late signal drift — e.g.
        #                                    end-of-stream drain partials —
        #                                    does not un-converge a
        #                                    controller that settled)
        self._baseline_fps: float | None = None
        self._win_frames = 0
        self._win_t = 0.0
        self._backlog_ema = 0.0

    # -- ingest ------------------------------------------------------------

    def record_flush(self, bucket: int, n_real: int, n_streams: int,
                     wall_s: float, rnd: int = 0) -> None:
        self.telemetry.record(bucket, n_real, self.cost_model.microbatch,
                              n_streams, wall_s, rnd)

    # -- calibration -------------------------------------------------------

    def _bucket_medians(self) -> dict[int, tuple[float, int]]:
        """bucket -> (median observed seconds, sample count), burn-in
        dropped per bucket."""
        out = {}
        for k, obs in self.telemetry.by_bucket().items():
            lat = [o.wall_s for o in obs[self.cc.burn_in:]]
            if lat:
                out[k] = (statistics.median(lat), len(lat))
        return out

    def calibrate(self) -> bool:
        """Fit observed = a * predicted + b over per-bucket medians
        (count-weighted); single-bucket telemetry fits through the origin.
        Buckets with >= ``min_samples`` get a multiplicative residual
        correction. Returns True when a fit was (re)cut."""
        meds = self._bucket_medians()
        pts = [(self.cost_model.predicted_flush_s(k), m, n)
               for k, (m, n) in meds.items() if k in self.cost_model.costs
               or k in self.cost_model._builders]
        pts = [(p, m, n) for p, m, n in pts if p > 0]
        if not pts:
            return False
        if len(pts) == 1:
            a, b = pts[0][1] / pts[0][0], 0.0
        else:
            w = sum(n for _, _, n in pts)
            mx = sum(p * n for p, _, n in pts) / w
            my = sum(m * n for _, m, n in pts) / w
            sxx = sum(n * (p - mx) ** 2 for p, _, n in pts)
            sxy = sum(n * (p - mx) * (m - my) for p, m, n in pts)
            if sxx <= 0:
                a, b = my / mx if mx > 0 else 1.0, 0.0
            else:
                a = sxy / sxx
                b = my - a * mx
                if a <= 0:        # degenerate (noise-dominated): fall back
                    a, b = my / mx if mx > 0 else 1.0, 0.0
        self._fit = (a, b)
        self._fit_seq = self.telemetry.seq
        self._bucket_scale = {}
        for k, (m, n) in meds.items():
            if n >= self.cc.min_samples:
                base = a * self.cost_model.predicted_flush_s(k) + b
                if base > 0:
                    self._bucket_scale[k] = m / base
        return True

    @property
    def calibrated(self) -> bool:
        return self._fit is not None

    def predict_flush_s(self, bucket: int) -> float:
        """Calibrated wall-seconds prediction for one flush of ``bucket``
        (raw roofline seconds before any fit exists)."""
        raw = self.cost_model.predicted_flush_s(bucket)
        if self._fit is None:
            return raw
        a, b = self._fit
        return max((a * raw + b), 0.0) * self._bucket_scale.get(bucket, 1.0)

    def median_rel_error(self, holdout: bool = True) -> float | None:
        """Median |predicted - observed| / observed over flushes recorded
        *after* the current fit (``holdout=False``: the whole window).
        None without a fit or matching observations."""
        if self._fit is None:
            return None
        min_seq = self._fit_seq if holdout else 0
        errs = []
        for o in self.telemetry:
            if o.seq < min_seq or o.wall_s <= 0:
                continue
            errs.append(abs(self.predict_flush_s(o.bucket) - o.wall_s)
                        / o.wall_s)
        return statistics.median(errs) if errs else None

    # -- re-tuning ---------------------------------------------------------

    def _clamp(self, rec: TunedKnobs) -> TunedKnobs:
        """Force a recommendation into the safety box; counts engagements."""
        cc, mb = self.cc, self.cost_model.microbatch
        out = rec.copy()
        engaged = False
        if not 0 <= out.max_wait_chunks <= cc.max_wait_bound:
            out.max_wait_chunks = min(max(out.max_wait_chunks, 0),
                                      cc.max_wait_bound)
            engaged = True
        if not 1 <= out.interleave_depth <= cc.interleave_bound:
            out.interleave_depth = min(max(out.interleave_depth, 1),
                                       cc.interleave_bound)
            engaged = True
        floor = max(1, math.ceil(cc.min_flush_fraction * mb))
        for k, thr in list(out.flush_threshold.items()):
            if not floor <= thr <= mb:
                out.flush_threshold[k] = min(max(thr, floor), mb)
                engaged = True
        if engaged:
            self.clamp_engaged += 1
        return out

    def _in_bounds(self, kn: TunedKnobs) -> bool:
        cc, mb = self.cc, self.cost_model.microbatch
        floor = max(1, math.ceil(cc.min_flush_fraction * mb))
        return (0 <= kn.max_wait_chunks <= cc.max_wait_bound
                and 1 <= kn.interleave_depth <= cc.interleave_bound
                and all(floor <= t <= mb
                        for t in kn.flush_threshold.values()))

    def _recommend(self, queue_stats: dict) -> TunedKnobs:
        """Knob recommendation from the fitted model + live queue depths.

        The shape of the policy: when flushes are *cheap* relative to how
        long partial queues sit (low observed occupancy), waiting for a
        full micro-batch buys little — pull the pad-flush deadline in and
        let chronically partial buckets flush at their observed fill. When
        queues fill naturally (occupancy ~1), leave the defaults alone.
        Interleave depth follows the ready backlog: more queued rows than
        one launch per session per round can drain -> go deeper.
        """
        cc, mb = self.cc, self.cost_model.microbatch
        rec = self.defaults.copy()
        # occupancies are quantized to one decimal so the recommendation
        # reaches a fixed point as the windowed estimate converges,
        # instead of flapping on every new observation (hysteresis then
        # has something stable to latch onto)
        occ = round(self.telemetry.occupancy(), 1)
        if occ <= 0:
            return rec
        if occ < 0.95:
            # rounds to fill ~= mb / rows-arriving-per-round; observed
            # occupancy is the fill a queue reaches before being flushed,
            # so ~2x that in rounds is a deadline that lets organic fills
            # finish but stops long waits
            rec.max_wait_chunks = max(1, min(cc.max_wait_bound,
                                             round(2 * occ * mb)))
            for k in self.cost_model.costs:
                bocc = round(self.telemetry.occupancy(k), 1)
                if 0 < bocc < 0.95:
                    thr = max(math.ceil(cc.min_flush_fraction * mb),
                              math.ceil(bocc * mb))
                    if thr < mb:
                        rec.flush_threshold[k] = thr
        # interleave depth follows the *smoothed* ready backlog (EMA, fed
        # in step()): deepen when it exceeds 2 micro-batches per stream,
        # otherwise hold whatever depth is live. The knob ratchets within
        # a run — dropping back when the backlog drains buys nothing
        # (interleaving an empty backlog is free) and would only flap the
        # recommendation out of its fixed point every time ingest pauses
        n_streams = max(1, round(self.telemetry.mean_streams()))
        if self._backlog_ema > 2 * mb * n_streams:
            rec.interleave_depth = min(cc.interleave_bound,
                                       max(2, self.knobs.interleave_depth))
        else:
            rec.interleave_depth = self.knobs.interleave_depth
        return self._clamp(rec)

    def step(self, queue_stats: dict, frames_done: int,
             elapsed_s: float) -> bool:
        """One control evaluation (the server calls this every
        ``retune_every`` frames). Returns True when knobs changed."""
        # windowed fps since the previous step
        dt = elapsed_s - self._win_t
        df = frames_done - self._win_frames
        fps = df / dt if dt > 0 else 0.0
        self._win_t, self._win_frames = elapsed_s, frames_done
        if self.frozen:
            return False
        if self._baseline_fps is None:
            # first step runs under the default knobs: this window IS the
            # static-default performance the watchdog protects
            if fps > 0:
                self._baseline_fps = fps
        elif (self.knobs.key() != self.defaults.key() and fps > 0
                and fps < (1.0 - self.cc.safety_margin) * self._baseline_fps):
            self.knobs.set_to(self.defaults)
            self.frozen = True
            return True
        if not self.calibrated or self.telemetry.seq > self._fit_seq:
            self.calibrate()
        backlog = sum(rows for rows, _ in queue_stats.values())
        self._backlog_ema = 0.7 * self._backlog_ema + 0.3 * backlog
        rec = self._recommend(queue_stats)
        if rec.key() == self.knobs.key():
            self._pending_key, self._pending_count = None, 0
            self._stable_steps += 1
            self._ever_stable = True
            return False
        self._stable_steps = 0
        if rec.key() == self._pending_key:
            self._pending_count += 1
        else:
            self._pending_key, self._pending = rec.key(), rec
            self._pending_count = 1
        if self._pending_count >= self.cc.hysteresis:
            self.knobs.set_to(self._pending)
            self._pending_key, self._pending_count = None, 0
            self.applied_retunes += 1
            # the latest recommendation is now live — that IS the fixed
            # point until the signal moves again
            self._stable_steps = 1
            self._ever_stable = True
            if not self._in_bounds(self.knobs):
                # should be unreachable (_clamp runs on every rec); counted
                # so CI can assert the invariant held
                self.clamp_violations += 1
                self.knobs.set_to(self._clamp(self.knobs))
            return True
        return False

    @property
    def converged(self) -> bool:
        """Calibrated, never watchdog-frozen, and the knob state reached a
        fixed point at least once (a recommendation matched the live
        knobs, or an applied retune made them match). Late signal drift —
        the draining tail of a finite run — does not revoke convergence;
        a watchdog freeze does."""
        return self.calibrated and not self.frozen and self._ever_stable

    def report(self) -> str:
        fit = (f"obs = {self._fit[0]:.3g} * pred + {self._fit[1]:.3g}"
               if self._fit else "uncalibrated")
        err = self.median_rel_error()
        which = "holdout"
        if err is None:            # fit cut on the newest obs: no holdout
            err, which = self.median_rel_error(holdout=False), "in-window"
        err_s = f"{err:.1%}" if err is not None else "n/a"
        kn = self.knobs
        return (f"controller: {fit} | {which} medrelerr {err_s} | "
                f"knobs max_wait={kn.max_wait_chunks} "
                f"depth={kn.interleave_depth} "
                f"thresholds={dict(sorted(kn.flush_threshold.items()))} | "
                f"{self.applied_retunes} retunes, "
                f"{self.clamp_engaged} clamped, "
                f"{self.clamp_violations} violations"
                f"{' [FROZEN: watchdog]' if self.frozen else ''}"
                f"{' [converged]' if self.converged else ''}")
