"""Observed per-flush telemetry: a bounded ring buffer of wall timings (the
reference's src/repro/serving/control/telemetry.py).

Every timed encode flush lands here as one immutable ``FlushObs`` tagged
by bucket, batch fill and owning-stream count — the *measured* side the
controller's calibration fits against the cost model's *predicted* side.
The buffer is a fixed-size deque: a long-lived server never grows its
telemetry without bound, and the windowed view doubles as the controller's
recency horizon (stale observations from before a knob change age out on
their own).

Each observation also carries a monotonically increasing ``seq`` stamped
at record time, so the controller can tell observations recorded *after*
its last calibration from the ones the fit was trained on — the honest
held-out split behind ``Controller.median_rel_error``.

With a ``StragglerDetector`` attached (the server's ``watchdog`` knob),
the ring doubles as a flush watchdog: every recorded observation feeds
the detector's robust median+MAD estimate, and flushes that run
anomalously long (a stalling device, an injected stall fault) land in
``straggler_flags`` — graceful degradation's detection half.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass

from repro_torch.distributed.fault_tolerance import StragglerDetector

__all__ = ["FlushObs", "FlushTelemetry"]


@dataclass(frozen=True)
class FlushObs:
    """One timed encode flush."""

    bucket: int        # kept-patch count k
    n_real: int        # live rows in the flush (rest was zero padding)
    microbatch: int    # flush batch size (n_real <= microbatch)
    n_streams: int     # sessions whose frames rode in this launch
    wall_s: float      # host wall seconds, launch to synchronized result
    round: int         # scheduling round the flush executed in
    seq: int           # global record order (calibration holdout split)

    @property
    def occupancy(self) -> float:
        return self.n_real / self.microbatch if self.microbatch else 0.0


class FlushTelemetry:
    """Ring buffer of ``FlushObs`` with per-bucket views."""

    def __init__(self, window: int = 256,
                 straggler: StragglerDetector | None = None):
        if window < 1:
            raise ValueError("telemetry window must be >= 1")
        self.window = window
        self._buf: deque = deque(maxlen=window)
        self._seq = 0
        self.total_recorded = 0
        self.straggler = straggler
        self.straggler_flags: list[FlushObs] = []

    def record(self, bucket: int, n_real: int, microbatch: int,
               n_streams: int, wall_s: float, rnd: int = 0) -> FlushObs:
        obs = FlushObs(int(bucket), int(n_real), int(microbatch),
                       int(n_streams), float(wall_s), int(rnd), self._seq)
        self._seq += 1
        self.total_recorded += 1
        self._buf.append(obs)
        if self.straggler is not None and self.straggler.record(obs.seq,
                                                                obs.wall_s):
            self.straggler_flags.append(obs)
        return obs

    # -- views -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    @property
    def seq(self) -> int:
        """Next sequence number (== observations recorded so far)."""
        return self._seq

    def by_bucket(self) -> dict[int, list]:
        out: dict[int, list] = {}
        for o in self._buf:
            out.setdefault(o.bucket, []).append(o)
        return out

    def latencies(self, bucket: int, min_seq: int = 0) -> list[float]:
        """Wall seconds of this bucket's flushes (record order), optionally
        only those recorded at or after ``min_seq``."""
        return [o.wall_s for o in self._buf
                if o.bucket == bucket and o.seq >= min_seq]

    def occupancy(self, bucket: int | None = None) -> float:
        """Mean batch fill (1.0 = every flush full), windowed; 0 when no
        matching observation exists."""
        occ = [o.occupancy for o in self._buf
               if bucket is None or o.bucket == bucket]
        return sum(occ) / len(occ) if occ else 0.0

    def mean_streams(self) -> float:
        ns = [o.n_streams for o in self._buf]
        return sum(ns) / len(ns) if ns else 0.0

    def median_latency(self, bucket: int, min_seq: int = 0) -> float | None:
        lat = self.latencies(bucket, min_seq)
        return statistics.median(lat) if lat else None

    def mean_latency(self, bucket: int, min_seq: int = 0) -> float | None:
        lat = self.latencies(bucket, min_seq)
        return sum(lat) / len(lat) if lat else None
