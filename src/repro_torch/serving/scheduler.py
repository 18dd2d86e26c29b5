"""Micro-batch scheduler: group same-bucket frames into one encode launch
(the reference's src/repro/serving/scheduler.py, serving subset).

Frames routed to the same bucket are queued as groups until ``microbatch``
rows wait, then flushed as one (microbatch, k, d) encode. End-of-stream
partials are zero-padded to the micro-batch size, so the encode shapes
stay exactly the ladder's; padded rows are never predicted. Queue keys are
opaque: the server keys ``(bucket, session)`` so every launch holds one
stream's frames (its activation absmax scope is one stream).
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
        self._queues: dict[Hashable, list] = {}   # key -> [(tokens, [idx])]

    def push_many(self, bucket: Hashable, tokens: torch.Tensor,
                  frame_idx: list) -> list[FrameBatch]:
        """Queue a (m, k, d) group; returns every batch that became ready."""
        if tokens.shape[0] != len(frame_idx):
            raise ValueError("tokens/frame_idx length mismatch")
        self._queues.setdefault(bucket, []).append((tokens, list(frame_idx)))
        out = []
        while self._rows(bucket) >= self.microbatch:
            out.append(self._take(bucket))
        return out

    def _rows(self, bucket: Hashable) -> int:
        return sum(len(ix) for _, ix in self._queues.get(bucket, ()))

    def _take(self, bucket: Hashable, pad: bool = False) -> FrameBatch:
        """Pop exactly ``microbatch`` rows (an oversized group is split back
        onto the queue); with ``pad`` a short tail is zero-filled."""
        q = self._queues[bucket]
        items, idxs, rows = [], [], 0
        while q and rows < self.microbatch:
            t, ix = q.pop(0)
            need = self.microbatch - rows
            if t.shape[0] > need:
                q.insert(0, (t[need:], ix[need:]))
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

    @property
    def pending(self) -> int:
        return sum(self._rows(k) for k in self._queues)
