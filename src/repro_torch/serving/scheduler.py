"""Micro-batch scheduler: group same-bucket frames into one encode launch
(the reference's src/repro/serving/scheduler.py).

Frames routed to the same bucket are queued until ``microbatch`` rows
wait, then flushed as one (microbatch, k, d) encode. Frames arrive as
groups (all same-bucket frames of one ingest chunk) and the queue stores
groups, so a flush is at most one concatenate; single frames (``push``)
are stored as bare rows and expanded to group rank only at flush time.
End-of-stream partials are zero-padded to the micro-batch size, so the
encode shapes stay exactly the ladder's; padded rows are never predicted.

Queue keys are opaque: the server keys ``(bucket, session)`` so every
launch holds one stream's frames (its activation absmax scope is one
stream), or the bare bucket under ``mix_streams``. ``push``/``push_many``
stamp each entry with a ``now`` tick (the server's scheduling round), and
``flush_stale(deadline)`` pad-flushes every queue whose oldest entry was
queued at or before the deadline: the server's ``max_wait_chunks`` bound.
The control plane's per-bucket flush thresholds pad-flush through
``flush_filled``, and its re-tuning reads the live queue depths through
``queue_stats``. Quarantine drops a failed session's queues unflushed
(``discard``); checkpoints and migration read the queued entries without
flushing them (``export``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Hashable

import torch

__all__ = ["FrameBatch", "MicroBatcher"]


@dataclass
class FrameBatch:
    """One flushed encode workload: ``tokens[:n_real]`` are live frames."""

    bucket: Hashable            # queue key
    tokens: torch.Tensor        # (microbatch, k, d), zero-padded past n_real
    frame_idx: list             # len n_real: the server's (sid, idx) pairs
    n_real: int


class MicroBatcher:
    """Per-key group queues with flush-at-``microbatch`` semantics."""

    def __init__(self, microbatch: int = 4):
        if microbatch < 1:
            raise ValueError("microbatch must be >= 1")
        self.microbatch = microbatch
        # key -> [(tokens, [frame_idx], now, is_row)]: tokens is a (m, k, d)
        # group (is_row False) or a bare (k, d) row (is_row True)
        self._queues: dict[Hashable, list] = {}

    def push(self, bucket: Hashable, tokens: torch.Tensor, frame_idx,
             now: int = 0) -> list[FrameBatch]:
        """Queue a single (k, d) frame, stored as a bare row."""
        self._queues.setdefault(bucket, []).append(
            (tokens, [frame_idx], now, True))
        return self._collect(bucket)

    def push_many(self, bucket: Hashable, tokens: torch.Tensor,
                  frame_idx: list, now: int = 0) -> list[FrameBatch]:
        """Queue a (m, k, d) group; returns every batch that became ready."""
        if tokens.shape[0] != len(frame_idx):
            raise ValueError("tokens/frame_idx length mismatch")
        self._queues.setdefault(bucket, []).append(
            (tokens, list(frame_idx), now, False))
        return self._collect(bucket)

    def _collect(self, bucket: Hashable) -> list[FrameBatch]:
        out = []
        while self.rows(bucket) >= self.microbatch:
            out.append(self._take(bucket))
        return out

    def rows(self, key: Hashable) -> int:
        """Rows currently queued under ``key`` (0 for unknown keys)."""
        return sum(len(it[1]) for it in self._queues.get(key, ()))

    def _take(self, bucket: Hashable, pad: bool = False) -> FrameBatch:
        """Pop exactly ``microbatch`` rows (an oversized group is split back
        onto the queue); with ``pad`` a short tail is zero-filled."""
        q = self._queues[bucket]
        items, idxs, rows = [], [], 0
        while q and rows < self.microbatch:
            t, ix, now, is_row = q.pop(0)
            if is_row:
                t = t[None]                      # row -> group, at flush time
            need = self.microbatch - rows
            if t.shape[0] > need:
                q.insert(0, (t[need:], ix[need:], now, False))
                t, ix = t[:need], ix[:need]
            items.append(t)
            idxs.extend(ix)
            rows += t.shape[0]
        if not q:
            self._queues.pop(bucket)
        n_real = rows
        if pad and rows < self.microbatch:
            items.append(items[0].new_zeros((self.microbatch - rows,)
                                            + tuple(items[0].shape[1:])))
        toks = items[0] if len(items) == 1 else torch.cat(items, dim=0)
        return FrameBatch(bucket, toks, idxs, n_real)

    def drain(self, select: Callable[[Hashable], bool] | None = None
              ) -> list[FrameBatch]:
        """Flush every partial queue (zero-padded); ``select`` restricts the
        sweep to matching keys (one finished session's queues)."""
        keys = [k for k in sorted(self._queues)
                if select is None or select(k)]
        return [self._take(k, pad=True) for k in keys]

    def flush_stale(self, deadline: int) -> list[FrameBatch]:
        """Pad-flush every queue whose oldest entry was pushed at or before
        ``deadline`` (the ``now`` tick of ``push``/``push_many``), oldest
        queue first, ties by ``str(key)``: the server's max-wait bound."""
        stale = [(q[0][2], k) for k, q in self._queues.items()
                 if q and q[0][2] <= deadline]
        return [self._take(k, pad=True) for _, k in sorted(
            stale, key=lambda e: (e[0], str(e[1])))]

    def flush_filled(self, threshold_of: Callable[[Hashable], int]
                     ) -> list[FrameBatch]:
        """Pad-flush every queue holding at least ``threshold_of(key)``
        rows, in ``str(key)`` order (thresholds at or above the micro-batch
        never fire here: full queues already flushed in ``_collect``). The
        control plane's per-bucket flush-threshold knob: a chronically
        partial bucket stops waiting for a fill that never comes."""
        out = []
        for k in sorted(self._queues, key=str):
            thr = threshold_of(k)
            if thr < self.microbatch and self.rows(k) >= thr:
                out.append(self._take(k, pad=True))
        return out

    def discard(self, select: Callable[[Hashable], bool]) -> int:
        """Drop every queue whose key matches ``select`` without flushing
        it (quarantine: a hard-failed session's queued frames must never
        reach the device, where their launches would be billed and their
        padding would waste flush slots). Returns the rows dropped."""
        doomed = [k for k in self._queues if select(k)]
        dropped = 0
        for k in doomed:
            dropped += self.rows(k)
            del self._queues[k]
        return dropped

    def export(self, select: Callable[[Hashable], bool] | None = None
               ) -> list:
        """The queued entries as ``(key, tokens, frame_idx, now, is_row)``
        tuples, keys in ``str(key)`` order and each queue in its order,
        without changing the queues (the checkpoint and migration
        surface). Pushing the entries back into an empty batcher in this
        order rebuilds the same groups with the same ``now`` ticks, so a
        restored serve's launches keep their activation absmax scopes (a
        pad-flush at checkpoint time would change them)."""
        out = []
        for k in sorted(self._queues, key=str):
            if select is not None and not select(k):
                continue
            for t, ix, now, is_row in self._queues[k]:
                out.append((k, t, list(ix), now, is_row))
        return out

    def queue_stats(self) -> dict:
        """key -> (queued rows, oldest entry's ``now`` tick) for every
        non-empty queue: the live depth view the controller's re-tuning
        reads."""
        return {k: (self.rows(k), q[0][2])
                for k, q in self._queues.items() if q}

    def pending_keys(self) -> tuple:
        """Keys of queues currently holding frames."""
        return tuple(sorted(self._queues, key=str))

    @property
    def pending(self) -> int:
        return sum(self.rows(k) for k in self._queues)
