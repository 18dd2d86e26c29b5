"""Fault tolerance: the restartable step loop and straggler detection (the
reference's src/repro/distributed/fault_tolerance.py).

``run_with_restarts`` wraps a step loop with checkpoint / restore
(``checkpoint.CheckpointManager``), so any exception (a preemption, a
device lost; simulated in tests by injected faults) resumes from the last
checkpoint. A step loop whose data is a pure function of (seed, step)
then ends in the fault-free state.

``StragglerDetector`` flags slow steps from a robust running estimate
(median + MAD over a window of recent durations). The serving control
plane's telemetry ring carries one under the server's ``watchdog`` knob,
so every timed encode flush feeds it and anomalously slow flushes land in
``StreamServer.straggler_flags``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["run_with_restarts", "StragglerDetector"]


def run_with_restarts(step_fn: Callable[[Any, int], Any], init_state: Any,
                      n_steps: int, manager: CheckpointManager,
                      like: Any | None = None, max_restarts: int = 10,
                      on_restart: Callable[[int], None] | None = None):
    """Run ``state = step_fn(state, step)`` for ``n_steps`` steps,
    restarting on any exception from the newest checkpoint (or from
    ``init_state`` when there is none). ``manager`` checkpoints
    periodically, and a final checkpoint is always written; ``like`` (by
    default ``init_state``) gives a restore its structure, devices and
    dtypes. Returns (state, restarts used)."""
    restarts = 0
    state = init_state
    step = 0
    template = like if like is not None else init_state
    restored, s0 = manager.restore_latest(template)
    if restored is not None:
        state, step = restored, s0
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            manager.maybe_save(step, state)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(step)
            restored, s0 = manager.restore_latest(template)
            if restored is None:
                state, step = init_state, 0
            else:
                state, step = restored, s0
    manager.maybe_save(step, state, force=True)
    manager.wait()
    return state, restarts


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
