"""Per-stream session state (the reference's src/repro/serving/session.py).

A session owns everything whose lifetime is one stream: the temporal mask
cache, the energy accounting (``StreamAccounting``) and bucket histogram,
the deferred predictions (argmax tensors on the device until the stream
ends, then read once) and the double-buffered ingest iterator
(``prefetch_to_device``) with the stream's own ``start`` phase. The server
pulls its chunks, gates them through its cache, encodes on the shared
parameters and records flush outcomes back; a session holds no parameters
and no graphs.

A server that times its flushes (the control plane's ``autotune``, the
``watchdog``) bills each flush's measured wall seconds to the sessions
whose frames rode in it; ``StreamResult.flush_wall_ms`` carries their mean
per bucket.

Not ported yet (ROADMAP.md queue A): checkpoints (``state_dict`` /
``from_state``) and fault bookkeeping (``fail``, ``shed``, retries: A13).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.data.pipeline import VideoStream, prefetch_to_device
from repro_torch.device import resolve_device
from repro_torch.serving.accounting import StreamAccounting
from repro_torch.serving.buckets import BucketHistogram, BucketLadder
from repro_torch.serving.mask_cache import TemporalMaskCache

__all__ = ["ServingConfig", "StreamResult", "StreamSession"]


@dataclass(frozen=True)
class ServingConfig:
    """Serving knobs (the ladder fractions are quantized to patch counts)."""

    bucket_fractions: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
    microbatch: int = 4
    chunk: int = 8               # frames per ingest transfer
    mask_refresh: int = 8        # re-score MGNet at least every k frames
    delta_threshold: float = 0.15
    prefetch_depth: int = 2      # ingest chunks in flight to the device
    report_every: int = 4        # live metrics cadence (scheduling rounds)
    force_bucket: float = 0.0    # > 0: pin every frame's budget to this
    #                              fraction of N (the paper's fixed
    #                              keep-ratio inference)
    one_shape: bool = False      # fixed-sensor-buffer mode: every encode is
    #                              (microbatch, ladder.cap, d) with the
    #                              score-ordered tokens and a static packed
    #                              kept-count (kv_len) per bucket: one token
    #                              shape; the flash kernel skips the pruned
    #                              tail's key tiles, the fused FFN its rows


@dataclass
class StreamResult:
    """What one stream served, measured two ways: host wall clock (frames/s
    of the serve) and the accelerator model (KFPS/W)."""

    frames: int = 0
    wall_s: float = 0.0
    scored_frames: int = 0
    reused_frames: int = 0
    bucket_hits: dict = field(default_factory=dict)      # k -> frames routed
    bucket_launches: dict = field(default_factory=dict)  # k -> encode flushes
    kfps_per_watt: float = 0.0
    mean_frame_uj: float = 0.0
    dense_kfps_per_watt: float = 0.0
    mean_bits: float = 0.0       # mean planned layer width (8.0: uniform)
    flush_wall_ms: dict = field(default_factory=dict)  # bucket -> mean
    #                              measured host ms a flush (only when the
    #                              server timed its flushes: autotune or
    #                              watchdog), beside the modeled latency
    recalibrations: int = 0      # drift-triggered MR re-tunes billed to
    #                              this stream (device noise with
    #                              recal_bound_nm > 0)
    predictions: dict = field(default_factory=dict)      # frame_idx -> class

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def energy_saved(self) -> float:
        if self.dense_kfps_per_watt <= 0 or self.kfps_per_watt <= 0:
            return 0.0
        return 1.0 - self.dense_kfps_per_watt / self.kfps_per_watt

    def summary(self) -> str:
        hist = " ".join(f"k={k}:{v}" for k, v in self.bucket_hits.items())
        return (f"{self.frames} frames in {self.wall_s:.3f}s -> "
                f"{self.fps:.1f} frames/s | model {self.kfps_per_watt:.1f} "
                f"KFPS/W ({self.mean_frame_uj:.2f} uJ/frame, "
                f"{self.energy_saved:+.1%} vs dense) | mgnet scored "
                f"{self.scored_frames}/{self.frames} | buckets: {hist}")


class StreamSession:
    """One stream's serving state, multiplexed by ``StreamServer``.

    Passive: the server pulls its next chunk and records outcomes back, so
    per-stream numbers aggregate exactly as a solo run of the same stream
    would; interleaving changes when launches happen, never what each
    stream computes. ``device`` is where the ingest ships the frames
    (default: the card; ``"cpu"`` must be asked for). ``layer_bits`` are
    the server's per-layer widths under a bit plan (None: uniform), which
    the accounting bills each layer at."""

    def __init__(self, sid: int, stream: VideoStream, n_frames: int,
                 start: int, serve_cfg: ServingConfig, cfg,
                 ladder: BucketLadder | None = None, device=None,
                 layer_bits: tuple | None = None):
        self.sid = sid
        self.stream = stream
        self.n_frames = n_frames
        self.start = start
        self.limit = start + n_frames
        self.serve_cfg = serve_cfg
        self.device = resolve_device(device)
        self.cache = TemporalMaskCache(serve_cfg.mask_refresh,
                                       serve_cfg.delta_threshold)
        self.layer_bits = (tuple(int(b) for b in layer_bits)
                           if layer_bits is not None else None)
        self.acct = StreamAccounting(
            cfg, ladder_sizes=ladder.sizes if ladder is not None else None,
            layer_bits=self.layer_bits)
        self.hist = BucketHistogram(ladder) if ladder is not None else None
        self.deferred: list = []     # (frame_idx list, argmax tensor)
        self.frames_seen = 0         # valid frames ingested so far
        self.chunks_done = 0         # ingest chunks consumed
        self.ingest_done = False
        self.drained = False
        self.finished = False
        self._chunks_left = 0
        self._it = None

    def open(self) -> None:
        """Build the chunked, double-buffered ingest iterator:
        ceil(n_frames / chunk) full chunks from ``chunks_done`` on. Each
        batch carries ``frames`` (the device copy the embed reads) and
        ``frames_host`` (the numpy the gate walks). The tail of the last
        chunk past ``n_frames`` is gated but never routed, encoded,
        predicted or accounted (the server's ``valid`` mask)."""
        sc = self.serve_cfg
        total = (self.n_frames + sc.chunk - 1) // sc.chunk
        self._chunks_left = total - self.chunks_done
        it = self.stream.chunks(sc.chunk,
                                self.start + self.chunks_done * sc.chunk)
        gen = (next(it) for _ in range(self._chunks_left))
        self._it = prefetch_to_device(gen, depth=sc.prefetch_depth,
                                      keys=("frames",), device=self.device)

    def next_batch(self) -> dict | None:
        """Next ingest chunk, or None once the frame budget is consumed
        (``ingest_done`` flips on the last chunk, so the server drains this
        session's queues in the same scheduling round)."""
        if self._it is None:
            self.open()
        if self._chunks_left == 0:
            self.ingest_done = True
            return None
        batch = next(self._it)
        self._chunks_left -= 1
        self.chunks_done += 1
        if self._chunks_left == 0:
            self.ingest_done = True
            # release the ingest's pinned buffers with the last chunk, not
            # when the session object goes
            self._it.close()
        return batch

    def record_route(self, bucket: int, n: int) -> None:
        if self.hist is not None:
            self.hist.add(bucket, n)

    def record_flush(self, bucket: int, n_real: int) -> None:
        self.acct.add_encode(bucket, n_real)

    def add_deferred(self, frame_idx: list, preds) -> None:
        self.deferred.append((frame_idx, preds))

    def finish(self, wall_s: float) -> StreamResult:
        """Read the deferred predictions and assemble the StreamResult
        (field for field the reference's, less the fields of the items not
        ported yet)."""
        res = StreamResult()
        for fidx, preds in self.deferred:
            for fi, p in zip(fidx, preds.cpu().numpy()):
                if int(fi) < self.limit:
                    res.predictions[int(fi)] = int(p)
        res.wall_s = wall_s
        res.frames = self.acct.frames
        res.scored_frames = self.cache.scored_frames
        res.reused_frames = self.cache.reused_frames
        res.bucket_hits = (self.hist.as_dict() if self.hist is not None
                           else dict(self.acct.bucket_frames))
        res.bucket_launches = dict(self.acct.bucket_launches)
        res.flush_wall_ms = {
            int(k): self.acct.measured_flush_s(k) * 1e3
            for k in self.acct.flush_wall_n if self.acct.flush_wall_n[k]}
        res.kfps_per_watt = self.acct.kfps_per_watt
        res.mean_frame_uj = self.acct.mean_frame.total_uj
        res.dense_kfps_per_watt = self.acct.dense_baseline_kfps_per_watt()
        res.mean_bits = (sum(self.layer_bits) / len(self.layer_bits)
                         if self.layer_bits else 8.0)
        res.recalibrations = self.acct.recal_events
        self.finished = True
        return res
