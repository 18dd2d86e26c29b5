"""Deterministic fault injection for the serving line (the reference's
src/repro/serving/faults.py, numpy only; the port keeps its own copy).

A long-lived server multiplexing many camera streams meets faults as a
matter of routine: transient device errors mid-flush, sensors hiccuping
mid-ingest, checkpoint volumes going away, thermal stalls, whole-process
preemptions. This module produces those faults under control, so the
server's isolation, retry and migration paths can be tested.

  * ``FaultSpec`` is a frozen, seeded, hashable operating point. No spec
    means no injector at all: the serving loop's fault seams are
    ``if injector is not None`` checks, so a fault-free server runs the
    instruction stream it runs without this module.
  * Every decision is a pure function of ``(seed, site)``, where the site
    names the logical event (bucket + first frame of a flush, session +
    chunk of an ingest, checkpoint step, scheduling round), never wall
    time or call order. Two runs with one spec inject the same faults at
    the same frames, and a retried attempt of a site replays its own fate:
    a transient site fails its first ``transient_failures`` attempts, then
    succeeds. The port decides every fault at the sites the reference
    does (``_tok`` hashes strings with crc32, as the reference's).

Fault classes:

  ``TransientFault``   retryable device or ingest error: the server retries
                       the same work with bounded exponential backoff;
  ``FatalFault``       unrecoverable for the owning session(s) only;
  ``CheckpointFault``  checkpoint I/O failure: serving continues on the
                       last good snapshot;
  ``ServerCrash``      whole-process loss (preemption): the trigger of
                       ``serve_with_restarts``' restore path.
"""

from __future__ import annotations

import gc
import zlib
from collections import Counter
from dataclasses import dataclass

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault", "TransientFault",
           "FatalFault", "CheckpointFault", "ServerCrash", "SessionFailure",
           "ServeError", "serve_with_restarts"]


class InjectedFault(RuntimeError):
    """Base of every injector-raised failure (all are ``RuntimeError``\\ s,
    so code that knows nothing of injection treats them as real faults)."""


class TransientFault(InjectedFault):
    """Retryable: the same work succeeds on a later attempt."""


class FatalFault(InjectedFault):
    """Unrecoverable for the session(s) that own the failing work."""


class CheckpointFault(InjectedFault):
    """Checkpoint I/O failed; the previous snapshot is still good."""


class ServerCrash(InjectedFault):
    """The whole serve loop dies (a simulated preemption or process loss)."""


class SessionFailure(RuntimeError):
    """Internal control flow: ``sids`` must be terminated for ``reason``
    while every other session keeps serving (raised by the flush path,
    handled by the scheduling loop; never escapes ``serve()``)."""

    def __init__(self, sids: tuple, reason: str):
        super().__init__(f"session(s) {list(sids)}: {reason}")
        self.sids = tuple(sids)
        self.reason = reason


class ServeError(RuntimeError):
    """An attributed mid-serve failure: the failing session ids, bucket and
    round in ``context``, and in ``partial_results`` the ``StreamResult``
    of every session that had fully drained when the loop died."""

    def __init__(self, message: str, context: dict | None = None,
                 partial_results: dict | None = None):
        super().__init__(message)
        self.context = dict(context or {})
        self.partial_results = dict(partial_results or {})


@dataclass(frozen=True)
class FaultSpec:
    """Seeded, replayable fault operating point (all rates in [0, 1])."""

    flush_fault_rate: float = 0.0    # transient device error per flush site
    flush_fatal_rate: float = 0.0    # unrecoverable device error per flush
    ingest_fault_rate: float = 0.0   # transient sensor error per chunk
    checkpoint_fault_rate: float = 0.0  # checkpoint I/O failure per save
    stall_rate: float = 0.0          # slow flush (straggler) per flush site
    stall_s: float = 0.05            # seconds a stalled flush hangs
    transient_failures: int = 1      # attempts a transient site fails
    #                                  before it clears (a retry succeeds)
    hard_fail_session: int = -1      # >= 0: this sid hard-fails...
    hard_fail_at_chunk: int = 0      # ...at this ingest chunk (FatalFault)
    crash_at_round: int = -1         # >= 0: ServerCrash once at this
    #                                  scheduling round (kill and restore)
    seed: int = 0


def _tok(x) -> int:
    if isinstance(x, str):
        return zlib.crc32(x.encode())
    return int(x) & 0xFFFFFFFF


class FaultInjector:
    """Raises the spec's faults at the serving seams, deterministically.

    Each decision hashes ``(seed, site)`` through its own
    ``np.random.SeedSequence``: no shared RNG stream is consumed, so the
    injections do not depend on call order, and a zero-rate spec draws
    nothing (``FaultSpec()`` serving is bitwise the serving without one)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.injected: Counter = Counter()
        self._crashed = False

    def _u01(self, *site) -> float:
        ss = np.random.SeedSequence([_tok(self.spec.seed)]
                                    + [_tok(t) for t in site])
        return float(np.random.default_rng(ss).random())

    def _hit(self, rate: float, *site) -> bool:
        return rate > 0.0 and self._u01(*site) < rate

    # -- seams ---------------------------------------------------------------

    def ingest(self, sid: int, chunk: int, attempt: int = 0) -> None:
        """Before a session pulls ingest chunk ``chunk``."""
        sp = self.spec
        if sp.hard_fail_session == sid and chunk >= sp.hard_fail_at_chunk:
            self.injected["ingest_fatal"] += 1
            raise FatalFault(f"injected hard sensor failure (session {sid},"
                             f" chunk {chunk})")
        if (attempt < sp.transient_failures
                and self._hit(sp.ingest_fault_rate, "ingest", sid, chunk)):
            self.injected["ingest_transient"] += 1
            raise TransientFault(f"injected transient ingest error "
                                 f"(session {sid}, chunk {chunk}, "
                                 f"attempt {attempt})")

    def flush(self, bucket: int, tag: tuple, attempt: int = 0) -> None:
        """Before a flush's encode launches; ``tag`` is the flush's first
        ``(sid, frame_idx)`` pair, the site a retry of the flush replays."""
        sp = self.spec
        sid, fidx = int(tag[0]), int(tag[1])
        if self._hit(sp.flush_fatal_rate, "flush_fatal", bucket, sid, fidx):
            self.injected["flush_fatal"] += 1
            raise FatalFault(f"injected fatal device error (bucket "
                             f"k={bucket}, frame {sid}:{fidx})")
        if (attempt < sp.transient_failures
                and self._hit(sp.flush_fault_rate, "flush", bucket, sid,
                              fidx)):
            self.injected["flush_transient"] += 1
            raise TransientFault(f"injected transient device error (bucket "
                                 f"k={bucket}, frame {sid}:{fidx}, attempt "
                                 f"{attempt})")

    def stall_s(self, bucket: int, tag: tuple) -> float:
        """Seconds this flush should hang (0.0: no stall), the slow-device
        case the straggler watchdog must flag."""
        sp = self.spec
        if self._hit(sp.stall_rate, "stall", bucket, int(tag[0]),
                     int(tag[1])):
            self.injected["stall"] += 1
            return sp.stall_s
        return 0.0

    def checkpoint_io(self, step: int) -> None:
        """Before a checkpoint write."""
        if self._hit(self.spec.checkpoint_fault_rate, "ckpt", step):
            self.injected["checkpoint"] += 1
            raise CheckpointFault(f"injected checkpoint I/O failure "
                                  f"(step {step})")

    def round_tick(self, rnd: int) -> None:
        """End of every scheduling round; fires the one-shot crash."""
        sp = self.spec
        if sp.crash_at_round >= 0 and rnd >= sp.crash_at_round \
                and not self._crashed:
            self._crashed = True
            self.injected["crash"] += 1
            raise ServerCrash(f"injected server crash (round {rnd})")

    def report(self) -> str:
        if not self.injected:
            return "no faults injected"
        return ", ".join(f"{k}={v}" for k, v in sorted(self.injected.items()))


# ---------------------------------------------------------------------------
# serving-side run_with_restarts
# ---------------------------------------------------------------------------

def serve_with_restarts(make_server, register, root: str,
                        max_restarts: int = 3, streams: dict | None = None,
                        verbose: bool = False, on_restart=None):
    """Serve to completion across server crashes, the serving counterpart
    of ``distributed.fault_tolerance.run_with_restarts``.

    ``make_server(attempt)`` builds a fresh ``StreamServer`` whose
    ``ServerConfig`` checkpoints into ``root`` (``checkpoint_dir`` /
    ``checkpoint_every``); ``register(server)`` registers the sessions for
    a cold start. On every attempt: if ``root`` holds a checkpoint, the
    live sessions are restored from the newest snapshot (``register`` is
    not called: the snapshot carries each stream's spec, or pass
    ``streams={sid: stream}``); otherwise ``register`` seeds them. A crash
    restarts from the last snapshot with the ingest cursor, mask caches,
    accounting, queued micro-batch rows and DriftState restored, so the
    final predictions equal an uninterrupted run's.

    One server is built per attempt. A dead server's CUDA graphs and their
    memory pools go before the next is built: its reference is dropped
    and the collector runs here, outside any capture. Returns
    ``(results, restarts, server)``."""
    from repro_torch.checkpoint.checkpoint import latest_step

    restarts = 0
    while True:
        server = make_server(restarts)
        if latest_step(root) is None:
            register(server)
        else:
            server.restore_checkpoint(root, streams=streams)
        try:
            return server.serve(verbose=verbose), restarts, server
        except ServeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts)
        server = None
        gc.collect()
