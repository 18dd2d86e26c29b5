"""Synthetic video for near-sensor serving and its double-buffered ingest,
the synthetic RoI classification task and the synthetic LM token stream
for training (the reference's src/repro/data/pipeline.py::VideoStream /
video_fleet / prefetch_to_device / ImageStream / quadrant_labels /
TokenStream / lm_batch_specs).

Frames and batches are pure numpy: every frame is a pure function of
(seed, frame_idx), every training batch of (seed, step), drawn with the
same generator calls as the reference, so both packages see bit-identical
data and a resumed run sees the batches the straight run saw.
``prefetch_to_device`` ships frames to the card ahead of the consumer.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TokenStream", "lm_batch_specs", "ImageStream", "quadrant_labels",
           "VideoStream", "video_fleet", "prefetch_to_device"]


def _host_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _rank_rows(out: dict, ctx, microbatches: int = 1) -> dict:
    """This rank's rows of each whole batch array under the sharding
    context ``ctx``; ``out`` without one.

    One microbatch: its block along "batch"'s mesh axes, rows [j B/D,
    (j+1) B/D) for the rank at block j of D (the whole array where D does
    not divide B). ``microbatches`` = k > 1 (``cfg.microbatch_steps``):
    its share of every global microbatch, rows [i B/k + j B/(kD),
    i B/k + (j+1) B/(kD)) for i = 0..k-1, so the step's local microbatch i
    is this rank's rows of the reference's microbatch i (a slice of the
    global batch) and its scales, taken over the mesh, are that global
    microbatch's; raises where kD does not divide B."""
    if ctx is None:
        return out
    from repro_torch.distributed import sharding
    rule = ctx.rules.get("batch")
    n = sharding._axis_size(ctx.mesh, rule)
    k = max(int(microbatches), 1)
    if k == 1 or n == 1:
        return {key: sharding.named_sharding(
            v.shape, ("batch",) + (None,) * (v.ndim - 1), ctx).block(
                torch.from_numpy(v)).numpy() for key, v in out.items()}
    j = sharding._axis_coord(ctx.mesh, rule)
    res = {}
    for key, v in out.items():
        b = v.shape[0]
        if b % (k * n):
            raise ValueError(
                f"{key} {tuple(v.shape)}: a batch of {b} rows in {k} "
                f"microbatches over {n} batch ranks needs rows a multiple "
                f"of {k * n}")
        per = b // (k * n)
        res[key] = np.concatenate([v[i * (b // k) + j * per:
                                     i * (b // k) + (j + 1) * per]
                                   for i in range(k)])
    return res


@dataclass
class TokenStream:
    """Synthetic LM batches: {"tokens": (B, S) int32, "labels": (B, S)
    int32}, a random walk over the vocab (steps of 1-6 from a random
    start, so the loss can fall), labels the tokens shifted left by one
    (the last wraps). Host numpy, or tensors on ``device``.

    Under a sharding context ``ctx`` each rank gets its block of the
    global batch: rows [d B / D, (d + 1) B / D) along "batch"'s mesh axes
    (``sharding.named_sharding``), the whole batch where they do not
    divide B, as the reference's ``named_sharding(("batch", "seq"))``
    places it. Under ``MULTIPOD_RULES`` "batch" is ("pod", "data"): one
    axis of P x D ranks, block index p D + d. With ``microbatches`` = k >
    1 (the train step's ``cfg.microbatch_steps``) each rank gets its share
    of every global microbatch instead (``_rank_rows``)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ctx: object = None
    device: object = None
    microbatches: int = 1

    def batch_at(self, step: int) -> dict:
        rng = _host_rng(self.seed, step)
        b, s = self.global_batch, self.seq_len
        base = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int32)
        steps = rng.integers(1, 7, size=(b, s), dtype=np.int32)
        tokens = ((base + np.cumsum(steps, axis=1)) % self.vocab
                  ).astype(np.int32)
        out = _rank_rows({"tokens": tokens,
                          "labels": np.roll(tokens, -1, axis=1)}, self.ctx,
                         self.microbatches)
        if self.device is None:
            return out
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in out.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def lm_batch_specs(shape_cfg, dtype=torch.int32) -> dict:
    """An LM batch's shapes and dtypes as ``meta`` tensors (the reference's
    ShapeDtypeStructs)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    return {k: torch.empty((b, s), dtype=dtype, device="meta")
            for k in ("tokens", "labels")}


@dataclass
class ImageStream:
    """Synthetic image-classification batches with planted RoI structure:
    one bright box on a dark background; the label is a function of the
    box's quadrant and texture, so MGNet has real signal to learn.

    ``batch_at(step)`` returns {"images": (B, H, W, 3) f32, "labels": (B,)
    int32, "patch_mask": (B, N) f32 (1 where a patch overlaps the box)}:
    host numpy arrays, or tensors on ``device`` when one is given.

    The rows are drawn in sequence from one generator, so under a
    sharding context ``ctx`` each rank synthesizes the whole batch and
    keeps its block of rows along "batch"'s mesh axes, as
    ``TokenStream`` (with ``microbatches`` = k > 1, its share of every
    global microbatch): bitwise the global batch's rows.
    """

    img_size: int
    global_batch: int
    n_classes: int = 10
    patch: int = 16
    seed: int = 0
    device: object = None
    ctx: object = None
    microbatches: int = 1

    def batch_at(self, step: int) -> dict:
        rng = _host_rng(self.seed, step)
        b, h = self.global_batch, self.img_size
        imgs = rng.normal(0.0, 0.1, size=(b, h, h, 3)).astype(np.float32)
        g = h // self.patch
        patch_mask = np.zeros((b, g * g), np.float32)
        labels = np.zeros((b,), np.int32)
        for i in range(b):
            bw = rng.integers(h // 4, h // 2)
            bh = rng.integers(h // 4, h // 2)
            y0 = rng.integers(0, h - bh)
            x0 = rng.integers(0, h - bw)
            tex = rng.integers(0, 5)
            imgs[i, y0:y0 + bh, x0:x0 + bw] += 1.0 + 0.2 * tex
            quad = 2 * ((y0 + bh / 2) > h / 2) + ((x0 + bw / 2) > h / 2)
            labels[i] = int(quad * 2 + tex % 2)
            py0, py1 = y0 // self.patch, (y0 + bh - 1) // self.patch
            px0, px1 = x0 // self.patch, (x0 + bw - 1) // self.patch
            m2 = np.zeros((g, g), np.float32)
            m2[py0:py1 + 1, px0:px1 + 1] = 1.0
            patch_mask[i] = m2.reshape(-1)
        out = _rank_rows({"images": imgs, "labels": labels,
                          "patch_mask": patch_mask}, self.ctx,
                         self.microbatches)
        if self.device is None:
            return out
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in out.items()}


def quadrant_labels(patch_mask):
    """4-class labels from the quadrant of the box mask's centroid (B, N) ->
    (B,) int32: numpy in, numpy out; a tensor in, a tensor out."""
    t = torch.as_tensor(patch_mask)
    b, n = t.shape
    g = int(np.sqrt(n))
    m = t.reshape(b, g, g)
    ys = torch.arange(g, device=t.device)[None, :, None]
    xs = torch.arange(g, device=t.device)[None, None, :]
    tot = m.sum((1, 2)) + 1e-6
    cy = (m * ys).sum((1, 2)) / tot
    cx = (m * xs).sum((1, 2)) / tot
    mid = (g - 1) / 2.0
    out = ((cy > mid).int() * 2 + (cx > mid).int())
    return out.numpy() if isinstance(patch_mask, np.ndarray) else out


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


def prefetch_to_device(it: Iterator[dict], depth: int = 2,
                       keys: tuple[str, ...] = ("frames",),
                       device=None) -> Iterator[dict]:
    """Double-buffered host -> device ingest: ``depth`` host batches in
    flight, yielded in order. Each entry under ``keys`` becomes a tensor on
    ``device``, and its host array stays beside it as ``<key>_host`` (the
    serving gate walks the frames on the host); other entries pass as they
    are.

    On the card every batch is staged in a pinned host buffer and copied
    with ``non_blocking=True`` on the device's ingest copy stream (one a
    device, shared by every iterator, so the allocator reuses the device
    blocks the copies land in), so the upload of batch t+1 overlaps the
    consumer's work on batch t. The
    consumer's stream waits on the copy's event when the batch is yielded,
    and the device tensor is recorded on that stream so the allocator
    never hands its memory to the copy stream early. The pinned buffers
    form a ring of ``depth + 1`` per key; a slot is refilled only after the
    event of the copy that last read it has completed. On the CPU (which
    ``device="cpu"`` asks for; the default is the card) the batches pass
    through in order (``<key>`` a tensor view of the host array).
    """
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    dev = resolve_device(device)
    if dev.type != "cuda":
        for item in it:
            out = dict(item)
            for k in keys:
                out[k + "_host"] = item[k]
                out[k] = torch.from_numpy(item[k])
            yield out
        return
    copy_stream = _copy_stream(dev)
    ring: dict[str, list] = {}            # key -> depth + 1 pinned buffers
    done: list = [None] * (depth + 1)     # slot -> event of its last copy
    inflight: deque = deque()
    slot = 0
    for item in it:
        if done[slot] is not None:
            done[slot].synchronize()
        out = dict(item)
        with torch.cuda.stream(copy_stream):
            for k in keys:
                host = torch.from_numpy(item[k])
                bufs = ring.setdefault(k, [])
                if len(bufs) <= slot:
                    bufs.append(torch.empty(host.shape, dtype=host.dtype,
                                            pin_memory=True))
                pinned = bufs[slot]
                pinned.copy_(host)
                out[k + "_host"] = item[k]
                out[k] = pinned.to(dev, non_blocking=True)
        done[slot] = torch.cuda.Event()
        done[slot].record(copy_stream)
        inflight.append((out, done[slot]))
        slot = (slot + 1) % (depth + 1)
        if len(inflight) >= depth:
            yield _hand_over(inflight.popleft(), keys, dev)
    while inflight:
        yield _hand_over(inflight.popleft(), keys, dev)


_COPY_STREAMS: dict = {}          # device -> the ingest's copy stream


def _copy_stream(dev: torch.device):
    if dev not in _COPY_STREAMS:
        _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
    return _COPY_STREAMS[dev]


def _hand_over(entry: tuple, keys: tuple[str, ...], dev) -> dict:
    """Order the consumer's stream after a batch's copy and tie the batch's
    device tensors to that stream."""
    out, event = entry
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(event)
    for k in keys:
        out[k].record_stream(consumer)
    return out
