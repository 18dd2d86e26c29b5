"""Per-stream session state (the reference's src/repro/serving/session.py,
serving subset).

A session owns everything whose lifetime is one stream: the temporal mask
cache, the bucket histogram, the per-bucket launch counts and the deferred
predictions. The server pulls its ingest chunks, gates them through its
cache, encodes on the shared parameters and records flush outcomes back.
Energy accounting, checkpoints and fault bookkeeping are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from repro_torch.data.pipeline import VideoStream
from repro_torch.serving.buckets import BucketHistogram, BucketLadder
from repro_torch.serving.mask_cache import TemporalMaskCache

__all__ = ["ServingConfig", "StreamResult", "StreamSession"]


@dataclass(frozen=True)
class ServingConfig:
    """Serving knobs (the ladder fractions are quantized to patch counts)."""

    bucket_fractions: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
    microbatch: int = 4
    chunk: int = 8               # frames per ingest chunk
    mask_refresh: int = 8        # re-score MGNet at least every k frames
    delta_threshold: float = 0.15


@dataclass
class StreamResult:
    """What one stream served."""

    frames: int = 0
    wall_s: float = 0.0
    scored_frames: int = 0
    reused_frames: int = 0
    bucket_hits: dict = field(default_factory=dict)      # k -> frames routed
    bucket_launches: dict = field(default_factory=dict)  # k -> encode flushes
    predictions: dict = field(default_factory=dict)      # frame_idx -> class

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> str:
        hist = " ".join(f"k={k}:{v}" for k, v in self.bucket_hits.items())
        return (f"{self.frames} frames in {self.wall_s:.3f}s -> "
                f"{self.fps:.1f} frames/s | mgnet scored "
                f"{self.scored_frames}/{self.frames} | buckets: {hist}")


class StreamSession:
    """One stream's serving state, multiplexed by ``StreamServer``."""

    def __init__(self, sid: int, stream: VideoStream, n_frames: int,
                 start: int, serve_cfg: ServingConfig, ladder: BucketLadder):
        self.sid = sid
        self.stream = stream
        self.n_frames = n_frames
        self.start = start
        self.limit = start + n_frames
        self.serve_cfg = serve_cfg
        self.cache = TemporalMaskCache(serve_cfg.mask_refresh,
                                       serve_cfg.delta_threshold)
        self.hist = BucketHistogram(ladder)
        self.launches: Counter = Counter()   # bucket -> flushes
        self.frames_encoded = 0
        self.deferred: list = []     # (frame_idx list, argmax tensor)
        self.ingest_done = False
        self.drained = False
        self.finished = False
        self._chunks_left = 0
        self._it = None

    def open(self) -> None:
        """Start the chunked ingest: ceil(n_frames / chunk) full chunks; the
        tail of the last chunk past ``n_frames`` is gated but never routed,
        encoded or predicted (the server's ``valid`` mask)."""
        sc = self.serve_cfg
        self._chunks_left = (self.n_frames + sc.chunk - 1) // sc.chunk
        self._it = self.stream.chunks(sc.chunk, self.start)

    def next_batch(self) -> dict | None:
        """Next host chunk, or None once the frame budget is consumed
        (``ingest_done`` flips on the last chunk)."""
        if self._it is None:
            self.open()
        if self._chunks_left == 0:
            self.ingest_done = True
            return None
        batch = next(self._it)
        self._chunks_left -= 1
        if self._chunks_left == 0:
            self.ingest_done = True
        return batch

    def record_route(self, bucket: int, n: int) -> None:
        self.hist.add(bucket, n)

    def record_flush(self, bucket: int, n_real: int) -> None:
        self.launches[bucket] += 1
        self.frames_encoded += n_real

    def add_deferred(self, frame_idx: list, preds) -> None:
        self.deferred.append((frame_idx, preds))

    def finish(self, wall_s: float) -> StreamResult:
        """Materialize the deferred predictions into the StreamResult."""
        res = StreamResult()
        for fidx, preds in self.deferred:
            for fi, p in zip(fidx, preds.cpu().numpy()):
                if int(fi) < self.limit:
                    res.predictions[int(fi)] = int(p)
        res.wall_s = wall_s
        res.frames = self.frames_encoded
        res.scored_frames = self.cache.scored_frames
        res.reused_frames = self.cache.reused_frames
        res.bucket_hits = self.hist.as_dict()
        res.bucket_launches = {int(k): int(v)
                               for k, v in sorted(self.launches.items())}
        self.finished = True
        return res
