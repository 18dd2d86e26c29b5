"""Checkpoints: save / restore, async, retention (the reference's
src/repro/checkpoint/checkpoint.py, on nested dicts of ``torch.Tensor``
or numpy arrays).

Layout, the reference's: a checkpoint directory holds

    meta.json            step, keys, shapes / dtypes, checksum, extra
    <key>.npy            one file per leaf, ``/`` in the key written ``__``

so a directory either package writes verifies and loads in the other.

  * A leaf's key is the path of dict keys to it, joined by ``/``.
  * bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
    not use: a bf16 leaf is written as its uint16 bits with
    ``"bfloat16"`` in ``meta["dtypes"]`` and read back by a view. The
    reference writes such a leaf through ``ml_dtypes`` (``np.load`` then
    returns a void ``V2`` array); its bits are read the same way.
  * The checksum is the reference's: sha256 over each key, ``str(shape)``,
    the dtype's name and the first 4096 bytes, keys sorted. A torn write
    from a preemption fails it at restore.
  * Saves are atomic: a unique tmp dir, then a rename.
  * ``async_save`` copies every tensor to the host now (a synchronous
    copy, no ``non_blocking``) and writes on a background thread.
  * ``restore`` with a ``ShardingCtx`` returns each leaf as this rank's
    block (``distributed.sharding.logical_spec`` + ``local_shard``): the
    counterpart of the reference's ``device_put`` under a
    ``NamedSharding``, and the elastic re-mesh path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import (ShardingCtx, local_shard,
                                              logical_spec)

__all__ = ["save", "restore", "async_save", "load_meta", "restore_flat",
           "latest_step", "CheckpointManager"]

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of nested dicts (a logical-axes tree's tuples
    are its leaves)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``leaves``."""
    if not isinstance(like, dict):
        return leaves[prefix]
    return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (host numpy array, dtype name): a copy (a tensor copied to
    the host synchronously), so a later in-place update of the leaf does
    not reach a background write; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _checksum(arrays: dict, dtypes: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        a = arrays[k]
        h.update(str(a.shape).encode())
        h.update(dtypes[k].encode())
        head = np.ascontiguousarray(a).reshape(-1)
        head = head[: -(-4096 // max(head.itemsize, 1))]
        h.update(head.tobytes()[:4096])            # prefix hash
    return h.hexdigest()


def _write(path: str, host: dict, dtypes: dict, step: int,
           extra: dict | None) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    for k, v in host.items():
        np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
    meta = {"step": int(step),
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": dict(dtypes),
            "checksum": _checksum(host, dtypes),
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    try:
        os.rename(tmp, path)
    except OSError:
        # lost the rename race to an identical concurrent save
        shutil.rmtree(tmp, ignore_errors=True)


def _snapshot(tree) -> tuple[dict, dict]:
    host, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        host[k], dtypes[k] = _host(v)
    return host, dtypes


def save(path: str, tree: Any, step: int = 0, extra: dict | None = None):
    """Atomic synchronous save (a unique tmp dir, so concurrent saves of
    the same step cannot clobber each other's writes)."""
    host, dtypes = _snapshot(tree)
    _write(path, host, dtypes, step, extra)


def _read(path: str, key: str, dtype: str) -> np.ndarray:
    """One leaf's host array; a bf16 leaf (uint16 bits from the port,
    ``V2`` from the reference's ``ml_dtypes``) as uint16."""
    a = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
    if dtype == _BF16:
        return a.view(np.uint16) if a.ndim else \
            a.reshape(1).view(np.uint16).reshape(())
    if str(a.dtype) != dtype and dtype:
        dt = np.dtype(dtype)
        a = (a.view(dt) if a.dtype.itemsize == dt.itemsize
             else a.astype(dt))
    return a


def _load(path: str, keys) -> tuple[dict, dict, dict]:
    meta = load_meta(path)
    dtypes = {k: meta["dtypes"].get(k, "") for k in keys}
    host = {k: _read(path, k, dtypes[k]) for k in keys}
    names = {k: dtypes[k] or str(host[k].dtype) for k in keys}
    if meta["checksum"] != _checksum(host, names):
        raise IOError(f"checkpoint {path} failed checksum (torn write?)")
    return host, names, meta


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def restore(path: str, like: Any, ctx: ShardingCtx | None = None,
            axes: Any | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (each leaf a tensor on the
    device and of the dtype of ``like``'s, or a numpy array of its dtype).
    With (``ctx``, ``axes``) a leaf with logical axes comes back as this
    rank's block under the ctx's rules; pass a ctx of a new mesh to
    re-shard. Returns (tree, step)."""
    flat_like = _flatten(like)
    flat_axes = _flatten(axes) if axes is not None else {}
    host, names, meta = _load(path, list(flat_like))
    leaves = {}
    for k, ref in flat_like.items():
        if isinstance(ref, torch.Tensor):
            t = _tensor(host[k], names[k]).to(device=ref.device,
                                               dtype=ref.dtype)
        else:
            t = host[k].astype(getattr(ref, "dtype", host[k].dtype))
        ax = flat_axes.get(k)
        if ctx is not None and ax is not None:
            t = local_shard(t, logical_spec(t.shape, ax, ctx), ctx.mesh)
        leaves[k] = t
    return _unflatten(like, leaves), meta["step"]


def load_meta(path: str) -> dict:
    """The checkpoint's meta.json (step, keys, shapes / dtypes, extra):
    what a snapshot holds, without loading any leaf."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def restore_flat(path: str) -> tuple[dict, int, dict]:
    """Self-describing restore: the flat ``{key: tensor}`` dict rebuilt
    from meta.json, no ``like`` needed (a serving checkpoint's session
    set, deferred counts and queued-row shapes are known only to the
    snapshot). Checksum-verified as ``restore``; leaves are CPU tensors.
    Returns ``(arrays, step, extra)``."""
    meta = load_meta(path)
    host, names, _ = _load(path, meta["keys"])
    return ({k: _tensor(a, names[k]) for k, a in host.items()},
            meta["step"], meta.get("extra", {}))


def async_save(path: str, tree: Any, step: int = 0,
               extra: dict | None = None) -> threading.Thread:
    """Copy every leaf to host memory now; write to disk in the
    background."""
    host, dtypes = _snapshot(tree)
    t = threading.Thread(target=_write,
                         args=(path, host, dtypes, step, extra),
                         daemon=True)
    t.start()
    return t


def latest_step(root: str) -> int | None:
    """Highest step among ``<root>/step_<n>`` checkpoint dirs."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if (d.startswith("step_") and d[5:].isdigit()   # skip in-flight tmp
                and os.path.exists(os.path.join(root, d, "meta.json"))):
            steps.append(int(d[5:]))
    return max(steps) if steps else None


class CheckpointManager:
    """Periodic and emergency checkpoints with retention."""

    def __init__(self, root: str, every: int = 100, keep: int = 3):
        self.root = root
        self.every = every
        self.keep = keep
        self._pending: list[threading.Thread] = []
        self._saved_steps: set[int] = set()
        os.makedirs(root, exist_ok=True)

    def maybe_save(self, step: int, tree: Any, extra: dict | None = None,
                   force: bool = False):
        if not force and (step == 0 or step % self.every):
            return
        if step in self._saved_steps:          # a forced and a periodic one
            return
        self._saved_steps.add(step)
        path = os.path.join(self.root, f"step_{step}")
        self._pending.append(async_save(path, tree, step, extra))
        self._gc()

    def emergency_save(self, step: int, tree: Any):
        """Synchronous save for SIGTERM / preemption handlers."""
        save(os.path.join(self.root, f"step_{step}"), tree, step,
             {"emergency": True})

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _gc(self):
        all_steps = sorted(int(d[5:]) for d in os.listdir(self.root)
                           if d.startswith("step_") and d[5:].isdigit())
        for s in all_steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, ctx=None, axes=None):
        self.wait()
        s = latest_step(self.root)
        if s is None:
            return None, 0
        return restore(os.path.join(self.root, f"step_{s}"), like, ctx, axes)
