"""Token-budget bucket ladder (the reference's src/repro/serving/buckets.py).

MGNet gives every frame a different kept-patch count; the ladder quantizes
it into a few fixed bucket sizes (e.g. 25/50/75/100% of N). Each frame is
routed to the smallest bucket that covers its budget, top-k gathered to
exactly that size and micro-batched with other frames of that bucket, so
the encoder only ever sees the ladder's shapes (one warmed encode, on the
card one CUDA graph, per size).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

__all__ = ["BucketLadder", "BucketHistogram"]


@dataclass(frozen=True)
class BucketLadder:
    """Ascending kept-patch budgets; the last entry is the dense fallback."""

    sizes: tuple[int, ...]

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("empty bucket ladder")
        if list(self.sizes) != sorted(set(self.sizes)):
            raise ValueError(f"ladder must be strictly ascending: {self.sizes}")

    @staticmethod
    def from_fractions(n_patches: int,
                       fractions: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
                       ) -> "BucketLadder":
        sizes = sorted({min(n_patches, max(1, int(round(f * n_patches))))
                        for f in fractions})
        return BucketLadder(tuple(sizes))

    @property
    def cap(self) -> int:
        return self.sizes[-1]

    def route(self, budget: int) -> int:
        """Smallest bucket >= budget (clipped to the ladder cap)."""
        for s in self.sizes:
            if s >= budget:
                return s
        return self.cap

    def route_many(self, budgets) -> np.ndarray:
        """Vectorized ``route`` over an int array of budgets."""
        arr = np.asarray(self.sizes)
        pos = np.searchsorted(arr, np.asarray(budgets), side="left")
        return arr[np.minimum(pos, len(arr) - 1)]

    def trim(self, dead, keep_cap: bool = True) -> "BucketLadder":
        """New ladder without the ``dead`` sizes (``StreamAccounting.
        dead_buckets()``'s output): every dropped entry is one encode the
        warm start no longer warms (on the card, one CUDA graph fewer).
        Budgets that would have routed to a dropped size route up to the
        next surviving bucket. With ``keep_cap`` (default) the ladder cap
        survives even when flagged dead: dropping it would down-route
        over-cap budgets, i.e. discard tokens a live frame asked for.
        Unknown sizes in ``dead`` are ignored; trimming every bucket away
        raises."""
        dead = set(int(k) for k in dead)
        if keep_cap:
            dead.discard(self.cap)
        kept = tuple(k for k in self.sizes if k not in dead)
        if not kept:
            raise ValueError(f"trim({sorted(dead)}) would empty the "
                             f"ladder {self.sizes}")
        return BucketLadder(kept)


class BucketHistogram:
    """Frames-per-bucket counter."""

    def __init__(self, ladder: BucketLadder):
        self.ladder = ladder
        self._hits: Counter = Counter({k: 0 for k in ladder.sizes})

    def add(self, bucket: int, n: int = 1) -> None:
        self._hits[bucket] += n

    def as_dict(self) -> dict[int, int]:
        return {int(k): int(self._hits[k]) for k in self.ladder.sizes}
