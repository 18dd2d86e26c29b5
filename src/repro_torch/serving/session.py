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

Faults: the server quarantines a session whose sensor or flushes fail for
good (``fail``: its ``StreamResult`` comes back ``poisoned`` with the
reason, its predictions covering the frames flushed before), counts the
transient-fault retries its frames rode through and the chunks load
shedding dropped (``shed``). Checkpoints and migration: ``state_dict`` /
``from_state`` carry the ingest cursor, the mask cache, the accounting,
the histogram and the deferred predictions; the server adds the session's
queued micro-batch rows, which ``from_state`` keeps in
``_pending_restore`` until the next ``serve()`` pushes them back.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, is_dataclass

import numpy as np
import torch

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
    poisoned: bool = False       # ended early by an unrecoverable fault:
    #                              predictions cover only the frames
    #                              flushed before it
    failure: str = ""            # why (empty for a clean stream)
    retries: int = 0             # transient-fault retries (flush or
    #                              ingest) this stream's frames rode through
    shed_frames: int = 0         # frames load shedding dropped (never
    #                              gated, encoded or predicted)

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
        self.chunks_done = 0         # ingest chunks consumed: the resume
        #                              cursor a restored session re-opens at
        self.ingest_done = False
        self.drained = False
        self.finished = False
        self.failed_reason = ""      # non-empty: quarantined by a fault
        self.retries = 0             # transient-fault retries billed here
        self.ingest_attempts = 0     # consecutive ingest-fault retries of
        #                              the current chunk (0 after a success)
        self.shed_frames = 0         # frames dropped under overload
        self._pending_restore: list | None = None  # queued micro-batch
        #                              rows from a snapshot, pushed back by
        #                              the server when its serve() starts
        self._chunks_left = 0
        self._it = None

    def open(self) -> None:
        """Build the chunked, double-buffered ingest iterator:
        ceil(n_frames / chunk) full chunks from ``chunks_done`` on (a
        restored session re-opens where the snapshot's stream stopped: the
        stream is pure in its seed and frame index). Each
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

    # -- failure / overload (written by the server) --------------------------

    def fail(self, reason: str) -> None:
        """Quarantine: no further ingest and no further flushes; the
        predictions deferred so far survive into the poisoned result."""
        self.failed_reason = reason
        self.ingest_done = True
        self.drained = True

    def shed(self, n: int) -> None:
        """Bill ``n`` load-shed frames (pulled off the sensor and dropped
        before the gate: the overload response that bounds the queue)."""
        self.shed_frames += n

    # -- per-flush bookkeeping (written by the server) -----------------------

    def record_route(self, bucket: int, n: int) -> None:
        if self.hist is not None:
            self.hist.add(bucket, n)

    def record_flush(self, bucket: int, n_real: int) -> None:
        self.acct.add_encode(bucket, n_real)

    def add_deferred(self, frame_idx: list, preds) -> None:
        self.deferred.append((frame_idx, preds))

    def finish(self, wall_s: float) -> StreamResult:
        """Read the deferred predictions (device tensors, or host arrays
        from a snapshot) and assemble the StreamResult, field for field the
        reference's."""
        res = StreamResult()
        for fidx, preds in self.deferred:
            for fi, p in zip(fidx, _host(preds)):
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
        res.poisoned = bool(self.failed_reason)
        res.failure = self.failed_reason
        res.retries = self.retries
        res.shed_frames = self.shed_frames
        self.finished = True
        return res

    # -- checkpoint / migration ----------------------------------------------

    def state_dict(self) -> tuple[dict, dict]:
        """Everything needed to resume this stream bitwise: the ingest
        cursor, the mask cache's reference frame and scores, the
        accounting and histogram, and the deferred predictions. Returns
        ``(arrays, meta)``: host numpy leaves apart from the JSON-able
        descriptor, the split ``checkpoint`` stores. The deferred argmax
        tensors are copied to the host here: one sync of the device a
        snapshot. The server adds the queued rows under
        ``meta["pending"]`` (they live in its batcher)."""
        arrays: dict = {}
        cs = self.cache.state_dict()
        if cs["ref_frame"] is not None:
            arrays["cache_ref_frame"] = cs["ref_frame"]
            arrays["cache_ref_scores"] = cs["ref_scores"]
        didx: list = []
        for fidx, _ in self.deferred:
            didx.extend(int(i) for i in fidx)
        arrays["deferred_idx"] = np.asarray(didx, np.int64)
        arrays["deferred_pred"] = _host_cat([p for _, p in self.deferred])
        meta = {
            "sid": self.sid, "n_frames": self.n_frames, "start": self.start,
            "chunks_done": self.chunks_done,
            "frames_seen": self.frames_seen,
            "ingest_done": bool(self.ingest_done),
            "drained": bool(self.drained),
            "failed_reason": self.failed_reason,
            "retries": self.retries, "shed_frames": self.shed_frames,
            "cache": {"ref_idx": cs["ref_idx"],
                      "scored_frames": cs["scored_frames"],
                      "reused_frames": cs["reused_frames"]},
            "acct": self.acct.state_dict(),
            "hist": ({str(k): v for k, v in self.hist.as_dict().items()}
                     if self.hist is not None else None),
            "stream": (asdict(self.stream) if is_dataclass(self.stream)
                       else None),
            "pending": [],
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, serve_cfg: ServingConfig,
                   cfg, ladder: BucketLadder | None = None,
                   layer_bits: tuple | None = None,
                   stream: VideoStream | None = None,
                   device=None) -> "StreamSession":
        """Rebuild a session from ``state_dict()`` output (leaves numpy
        arrays or CPU tensors). ``stream`` overrides the snapshot's stream
        spec, and is required when the source was not a plain
        ``VideoStream`` dataclass. The queued rows stay on the host in
        ``_pending_restore``."""
        if stream is None:
            if meta.get("stream") is None:
                raise ValueError(
                    f"session {meta['sid']}'s snapshot carries no stream "
                    f"spec (non-dataclass source): pass its stream via "
                    f"``streams={{sid: stream}}``")
            stream = VideoStream(**meta["stream"])
        s = cls(int(meta["sid"]), stream, int(meta["n_frames"]),
                int(meta["start"]), serve_cfg, cfg, ladder=ladder,
                device=device, layer_bits=layer_bits)
        s.chunks_done = int(meta["chunks_done"])
        s.frames_seen = int(meta["frames_seen"])
        s.ingest_done = bool(meta["ingest_done"])
        s.drained = bool(meta["drained"])
        s.failed_reason = meta["failed_reason"]
        s.retries = int(meta["retries"])
        s.shed_frames = int(meta["shed_frames"])
        cm = meta["cache"]
        ref = arrays.get("cache_ref_frame")
        s.cache.load_state({
            "ref_frame": None if ref is None else _host(ref),
            "ref_scores": (None if ref is None
                           else _host(arrays["cache_ref_scores"])),
            "ref_idx": cm["ref_idx"],
            "scored_frames": cm["scored_frames"],
            "reused_frames": cm["reused_frames"]})
        s.acct.load_state(meta["acct"])
        if s.hist is not None and meta.get("hist"):
            for k, v in meta["hist"].items():
                s.hist.add(int(k), int(v))
        didx = _host(arrays["deferred_idx"])
        if len(didx):
            s.deferred.append(([int(i) for i in didx],
                               _host(arrays["deferred_pred"])))
        pend = []
        for j, p in enumerate(meta.get("pending", ())):
            toks = p.get("tokens")
            if toks is None:
                toks = arrays[f"pend{j}"]
            pend.append((int(p["bucket"]), toks,
                         [int(f) for f in p["fidx"]], int(p["now"]),
                         bool(p["is_row"])))
        s._pending_restore = pend
        return s


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_cat(preds: list) -> np.ndarray:
    """Deferred predictions (device tensors and host arrays) concatenated
    on the host as int32, the reference's dtype; the device tensors come
    over in one copy."""
    if not preds:
        return np.zeros(0, np.int32)
    dev = [p for p in preds if isinstance(p, torch.Tensor)]
    moved = iter(np.split(torch.cat(dev).cpu().numpy(),
                          np.cumsum([len(p) for p in dev])[:-1])
                 if dev else ())
    return np.concatenate([next(moved) if isinstance(p, torch.Tensor)
                           else np.asarray(p) for p in preds]
                          ).astype(np.int32)
