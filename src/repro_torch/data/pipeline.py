"""Synthetic video for near-sensor serving (the reference's
src/repro/data/pipeline.py::VideoStream / video_fleet).

Pure numpy: every frame is a pure function of (seed, frame_idx), drawn
with the same generator calls as the reference, so both packages serve
bit-identical frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["VideoStream", "video_fleet"]


def _host_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclass
class VideoStream:
    """Temporally coherent synthetic video: one bright object drifting over
    a dark background, with a hard scene cut (new object, new trajectory)
    every ``cut_every`` frames. Consecutive frames are highly correlated
    (MGNet's RoI mask can be reused) while cuts force a re-score.

    ``frames_at(start, count)`` returns host numpy arrays
    {"frames": (count, H, W, 3) f32, "patch_mask": (count, N) f32 box-derived
    ground truth, "frame_idx": (count,) int32}.
    """

    img_size: int
    patch: int = 16
    seed: int = 0
    cut_every: int = 32
    noise: float = 0.05
    speed: float = 1.5          # pixels / frame box drift

    def _segment(self, seg: int):
        rng = _host_rng(self.seed, seg)
        h = self.img_size
        bw = int(rng.integers(h // 4, h // 2))
        bh = int(rng.integers(h // 4, h // 2))
        y0 = float(rng.integers(0, h - bh))
        x0 = float(rng.integers(0, h - bw))
        ang = float(rng.uniform(0, 2 * np.pi))
        vy, vx = self.speed * np.sin(ang), self.speed * np.cos(ang)
        tex = float(rng.integers(0, 5))
        return bw, bh, y0, x0, vy, vx, tex

    def frame_at(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(frame (H, W, 3) f32, gt patch mask (N,) f32) for one frame."""
        h, p = self.img_size, self.patch
        g = h // p
        seg, off = divmod(idx, self.cut_every)
        bw, bh, y0, x0, vy, vx, tex = self._segment(seg)
        # drift with reflection off the borders (box stays in frame)
        span_y, span_x = max(h - bh, 1), max(h - bw, 1)
        y = int(abs((y0 + vy * off + span_y) % (2 * span_y) - span_y))
        x = int(abs((x0 + vx * off + span_x) % (2 * span_x) - span_x))
        rng = _host_rng(self.seed, idx + (1 << 20))   # per-frame sensor noise
        img = rng.normal(0.0, self.noise, size=(h, h, 3)).astype(np.float32)
        img[y:y + bh, x:x + bw] += 1.0 + 0.2 * tex
        mask2 = np.zeros((g, g), np.float32)
        mask2[y // p:(y + bh - 1) // p + 1, x // p:(x + bw - 1) // p + 1] = 1.0
        return img, mask2.reshape(-1)

    def frames_at(self, start: int, count: int) -> dict:
        frames = np.empty((count, self.img_size, self.img_size, 3), np.float32)
        g = self.img_size // self.patch
        masks = np.empty((count, g * g), np.float32)
        for i in range(count):
            frames[i], masks[i] = self.frame_at(start + i)
        return {"frames": frames, "patch_mask": masks,
                "frame_idx": np.arange(start, start + count, dtype=np.int32)}

    def chunks(self, chunk: int, start: int = 0) -> Iterator[dict]:
        while True:
            yield self.frames_at(start, chunk)
            start += chunk


def video_fleet(n_streams: int, img_size: int, patch: int = 16,
                seed: int = 0, cut_every: int = 32, noise: float = 0.05,
                speed: float = 1.5) -> list[VideoStream]:
    """``n_streams`` independent cameras; stream i draws from ``seed + i``."""
    if n_streams < 1:
        raise ValueError("n_streams must be >= 1")
    return [VideoStream(img_size=img_size, patch=patch, seed=seed + i,
                        cut_every=cut_every, noise=noise, speed=speed)
            for i in range(n_streams)]
