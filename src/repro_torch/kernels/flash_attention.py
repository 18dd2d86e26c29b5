"""Flash attention: the RoI-masked bidirectional core of the ViT serving
path and the causal / local-window GQA core of the LM prefill.

``flash_attention_masked`` replaces
src/repro/kernels/flash_attention.py::flash_attention_masked_kernel
(wrapper ``flash_attention_masked``, host pick ``fused_masked_attention``);
its CUDA kernel is ``csrc/flash_attention.cu`` and its plain version
``kernels/ref.py::flash_attention_masked_ref``.

``flash_attention`` replaces ``flash_attention_kernel`` (wrapper
``flash_attention``); its CUDA kernels are in
``csrc/flash_attention_causal.cu`` (bf16 on the tensor cores, head dims
``TC_HEAD_DIMS``; f32 on the CUDA cores) and its plain version
``kernels/ref.py::flash_attention_ref``.

Each kernel's source note says what bounds it on an H100 and how its
design answers that. The wrappers launch the kernel for CUDA tensors and
take the plain version only for CPU tensors.

The wrapper reduces the key mask (or the packed ``kv_len``) to per-(batch,
KV tile) live-key counts once, the block-skip predicate the kernel reads,
as the reference reduces them on the XLA side before its grid.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_masked_ref,
                                     flash_attention_ref, prefix_key_mask)

__all__ = ["KV_TILE", "MAX_HEAD_DIM", "TC_HEAD_DIMS",
           "flash_attention_masked", "flash_attention"]

KV_TILE = 32          # keys per kernel tile (kBKV in csrc/flash_attention.cu)
MAX_HEAD_DIM = 256    # D and Dv bound: the per-block tiles live in shared memory
TC_HEAD_DIMS = (16, 64, 128)   # head dims the bf16 tensor-core kernel takes


def _live_counts(mask: torch.Tensor, nkv: int):
    """(B, Skv) f32 keep-mask -> (mask, (B, nkv) int32 live keys per tile)."""
    b, skv = mask.shape
    padded = torch.nn.functional.pad(mask, (0, nkv * KV_TILE - skv))
    return mask, padded.reshape(b, nkv, KV_TILE).sum(-1).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _constant_mask(kv_len: int | None, b: int, skv: int, dev: torch.device):
    """The keep-mask and live counts of an all-live (``kv_len`` None) or
    int-prefix key axis, built once per shape: the serving path's bucketed
    encode passes neither a mask nor ``kv_len`` on every layer."""
    mask = (torch.ones((b, skv), dtype=torch.float32, device=dev)
            if kv_len is None else prefix_key_mask(kv_len, b, skv, dev))
    return _live_counts(mask, -(-skv // KV_TILE))


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor | None = None, *,
                           kv_len=None,
                           scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, D); k (B, Hk, Skv, D); v (B, Hv, Skv, Dv) ->
    (B, H, Sq, Dv), H a multiple of Hk and of Hv, D and Dv may differ.

    ``key_mask`` (B, Skv) {0,1} keep-mask (any numeric dtype) or ``kv_len``
    (int or (B,) tensor: key j kept iff j < kv_len); at most one. KV tiles
    with no kept key are skipped. ``scale`` defaults to 1/sqrt(D). Rows
    with no live key return exactly 0. Sq and Skv need not be tile
    multiples.
    """
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    _, hv, skv2, dv = v.shape
    if not (h % hk == 0 and h % hv == 0 and skv == skv2
            and k.shape[0] == b and v.shape[0] == b and k.shape[3] == d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if key_mask is not None and kv_len is not None:
        raise ValueError("give key_mask or kv_len, not both")
    if key_mask is not None and tuple(key_mask.shape) != (b, skv):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(b, skv)}")
    dev = q.device
    if any(t.device != dev for t in (k, v)) or (
            key_mask is not None and key_mask.device != dev):
        raise ValueError("q, k, v and key_mask must share one device")
    if dev.type == "cpu":
        return flash_attention_masked_ref(q, k, v, key_mask, kv_len=kv_len,
                                          scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_masked runs on cuda or cpu, not {dev}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("the CUDA kernel takes f32 q, k, v")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({d}, {dv}) above {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    nkv = -(-skv // KV_TILE)
    if key_mask is None and (kv_len is None or isinstance(kv_len, int)):
        mask, nlive = _constant_mask(kv_len, b, skv, dev)
    else:
        if key_mask is None:
            key_mask = prefix_key_mask(kv_len, b, skv, dev)
        mask, nlive = _live_counts(key_mask.float().contiguous(), nkv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, h, sq, dv), dtype=torch.float32, device=dev)
    if b * h * sq == 0:
        return out
    err = _build.library().flash_attention_masked_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        nlive.data_ptr(), out.data_ptr(), b, h, hk, hv, sq, skv, d, dv, nkv,
        float(scale), _build.stream_ptr(dev))
    _build.check(err, "flash_attention_masked_f32")
    _build.LAUNCHES["flash_attention_masked"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, Hkv, Skv, D) -> (B, H, Sq, D) in q.dtype.

    Causal and/or local-window GQA attention (query head i reads KV head
    i // (H // Hkv); query row i sees key j iff (not causal or i >= j) and
    (window == 0 or i - j < window)); rows with no visible key return 0.
    ``scale`` (default 1/sqrt(D)) multiplies q. Any Sq and Skv. Inputs may
    be strided views with D contiguous (e.g. the (B, S, H, D) projection
    layout transposed): the kernel reads them by strides, and the output
    has q's memory layout. The kernel takes f32 or bf16, all one dtype;
    on the card a bf16 call needs D in ``TC_HEAD_DIMS`` and 16-byte
    aligned pointers and (batch, head, row) strides, else it raises.
    """
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if not (h % hkv == 0 and k.shape[0] == b and tuple(v.shape) == tuple(
            k.shape) and k.shape[3] == d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    if any(t.device != dev for t in (k, v)):
        raise ValueError("q, k and v must share one device")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if q.dtype not in _build.DTYPE_SUFFIX or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes q, k, v all f32 or all bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    tc = q.dtype == torch.bfloat16
    if tc and d not in TC_HEAD_DIMS:
        raise ValueError(f"the bf16 kernel takes head dims {TC_HEAD_DIMS}, "
                         f"got {d}")
    if tc and not all(_build.aligned16(t, 3) for t in (q, k, v)):
        raise ValueError("the bf16 kernel needs 16-byte aligned q, k, v "
                         "pointers and (batch, head, row) strides")
    out = torch.empty_like(q)           # q's layout, hence D contiguous
    if b * h * sq == 0:
        return out
    strides = _build.strides_arg(*(s_ for t in (q, k, v, out)
                                   for s_ in t.stride()[:3]))
    entry = "flash_attention_causal_" + _build.DTYPE_SUFFIX[q.dtype]
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, hkv, sq, skv, d, int(causal), int(window), float(scale),
        _build.stream_ptr(dev))
    _build.check(err, entry)
    _build.LAUNCHES["flash_attention_causal"] += 1
    return out
