"""Temporal RoI-mask reuse (the reference's src/repro/serving/mask_cache.py).

Consecutive frames are highly correlated, so MGNet re-scores a frame only
when ``refresh`` frames have passed since the last scoring or the mean
|frame - last scored frame| exceeds ``delta_threshold``; otherwise the
cached region scores are reused. The decision walk is host numpy; the
frames that need scoring go to MGNet in one call per chunk, padded to the
chunk size so the score call has one shape.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.mgnet import frame_delta

__all__ = ["TemporalMaskCache"]


class TemporalMaskCache:
    """Per-stream cached MGNet scores + the frame they were computed on."""

    def __init__(self, refresh: int = 8, delta_threshold: float = 0.15):
        if refresh < 1:
            raise ValueError("refresh must be >= 1")
        self.refresh = refresh
        self.delta_threshold = delta_threshold
        self._ref_frame: np.ndarray | None = None    # last scored frame
        self._ref_scores: np.ndarray | None = None   # its region scores (N,)
        self._ref_idx: int = -(1 << 30)
        self.scored_frames = 0
        self.reused_frames = 0

    def _needs_refresh(self, frame: np.ndarray, idx: int,
                       ref: np.ndarray | None, ref_idx: int) -> bool:
        if ref is None or idx - ref_idx >= self.refresh:
            return True
        delta = float(frame_delta(frame[None], ref)[0])
        return delta > self.delta_threshold

    def gate(self, frames, frame_idx, score_fn,
             eligible=None) -> tuple[np.ndarray, int]:
        """RoI-gate one chunk of consecutive frames.

        frames (C, H, W, 3) numpy; frame_idx (C,) absolute positions;
        score_fn: (C, H, W, 3) numpy -> (C, N) numpy region scores;
        eligible: optional (C,) bool, False frames are never scored and never
        update the reference. Returns (scores (C, N) f32, n_scored).
        """
        frames = np.asarray(frames)
        frame_idx = [int(i) for i in np.asarray(frame_idx)]
        c = frames.shape[0]
        eligible = (np.ones(c, bool) if eligible is None
                    else np.asarray(eligible, bool))

        flags = np.zeros(c, bool)
        ref, ref_idx = self._ref_frame, self._ref_idx
        for i in range(c):
            if eligible[i] and self._needs_refresh(frames[i], frame_idx[i],
                                                   ref, ref_idx):
                flags[i] = True
                ref, ref_idx = frames[i], frame_idx[i]

        n_scored = int(flags.sum())
        if n_scored:
            sub = np.zeros_like(frames)
            sub[:n_scored] = frames[flags]
            fresh = np.asarray(score_fn(sub), np.float32)[:n_scored]
        out = []
        cached = self._ref_scores
        j = 0
        for i in range(c):
            if flags[i]:
                cached = fresh[j]
                j += 1
            if cached is None:
                raise ValueError("mask cache is empty and no eligible frame "
                                 "was scored — nothing to reuse")
            out.append(cached)
        scores = np.stack(out).astype(np.float32)

        if n_scored:
            last = int(np.flatnonzero(flags)[-1])
            self._ref_frame = frames[last]
            self._ref_scores = fresh[-1]
            self._ref_idx = frame_idx[last]
        self.scored_frames += n_scored
        self.reused_frames += int(eligible.sum()) - n_scored
        return scores, n_scored

    @property
    def reuse_rate(self) -> float:
        tot = self.scored_frames + self.reused_frames
        return self.reused_frames / tot if tot else 0.0
