"""Straggler detection (the reference's
src/repro/distributed/fault_tolerance.py, ``StragglerDetector`` only).

``StragglerDetector`` flags slow steps from a robust running estimate
(median + MAD over a window of recent durations). The serving control
plane's telemetry ring carries one under the server's ``watchdog`` knob,
so every timed encode flush feeds it and anomalously slow flushes land in
``StreamServer.straggler_flags``.

Not ported yet (ROADMAP.md queue A): ``run_with_restarts``, the
checkpoint-restore step loop, which comes with checkpoints (A13).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["StragglerDetector"]


@dataclass
class StragglerDetector:
    """Robust slow-step detector: flag when duration > median + k * MAD."""

    k: float = 5.0
    window: int = 50
    _durations: list = field(default_factory=list)
    flags: list = field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        ds = self._durations
        flagged = False
        if len(ds) >= 10:
            srt = sorted(ds)
            med = srt[len(srt) // 2]
            mad = sorted(abs(d - med) for d in srt)[len(srt) // 2]
            if duration_s > med + self.k * max(mad, 1e-6):
                flagged = True
                self.flags.append((step, duration_s, med))
        ds.append(duration_s)
        # only the newest ``window`` samples: a long-lived server's flush
        # watchdog records forever
        if len(ds) > self.window:
            del ds[: len(ds) - self.window]
        return flagged

    class timer:
        """``with StragglerDetector.timer(det, step): ...`` records the
        block's wall seconds as ``step``'s duration."""

        def __init__(self, det: "StragglerDetector", step: int):
            self.det, self.step = det, step

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.det.record(self.step, time.perf_counter() - self.t0)
