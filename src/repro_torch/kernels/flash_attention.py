"""Flash attention: the RoI-masked bidirectional core of the ViT serving
path and the causal / local-window GQA core of the LM prefill.

``flash_attention_masked`` replaces
src/repro/kernels/flash_attention.py::flash_attention_masked_kernel
(wrapper ``flash_attention_masked``, host pick ``fused_masked_attention``);
its CUDA kernels are in ``csrc/flash_attention.cu`` (3xTF32 on the tensor
cores for head dims (D, Dv) = ``TC_MASKED_HEAD_DIMS`` and, with Q and K
streamed in ``WIDE_D_CHUNK``-wide D-chunks, for Dv = 64 and any wider D
that is a multiple of the chunk (Eq. 2's (192 | 768 | 1024, 64)); f32 on
the CUDA cores for every other pair; chosen by shape only:
``masked_entry_for``) and its plain version
``kernels/ref.py::flash_attention_masked_ref``
(``flash_attention_masked_tc_ref`` emulates both tensor-core designs).

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

__all__ = ["KV_TILE", "CAUSAL_MAX_HEAD_DIM", "TC_HEAD_DIMS",
           "TC_MASKED_HEAD_DIMS", "WIDE_D_CHUNK", "masked_entry_for",
           "simt_smem_bytes",
           "simt_smem_limit", "flash_attention_masked", "flash_attention"]

KV_TILE = 32          # keys per tile of both masked kernels (kBKV, tc::kBKV)
CAUSAL_MAX_HEAD_DIM = 256   # the causal f32 kernel's D bound (its tiles
#                             live in shared memory)
TC_HEAD_DIMS = (16, 64, 128, 160, 256)  # the bf16 tensor-core entry's D
TC_MASKED_HEAD_DIMS = (64, 64)  # (D, Dv) of the tensor-core masked kernel
WIDE_D_CHUNK = 32     # the wide entry's D-chunk (wide::kDC)


def wide_scratch_floats(b: int, hk: int, nkv: int, d: int) -> int:
    """f32 scratch of a wide-entry call: K split into TF32 hi and lo, 16 KB
    a (batch, key head, 64-key step, D-chunk)."""
    return b * hk * (nkv + 1) // 2 * (d // WIDE_D_CHUNK) * 4096


def masked_entry_for(d: int, dv: int) -> str:
    """The entry a CUDA ``flash_attention_masked`` call of head dims (D, Dv)
    launches: "tc" (3xTF32 tensor cores) at (64, 64), "wide" (3xTF32 over
    D-chunks) at Dv = 64 with D > 64 a multiple of ``WIDE_D_CHUNK``, else
    "simt"."""
    if (d, dv) == TC_MASKED_HEAD_DIMS:
        return "tc"
    if dv == 64 and d > 64 and d % WIDE_D_CHUNK == 0:
        return "wide"
    return "simt"


@functools.lru_cache(maxsize=None)
def simt_smem_bytes(d: int, dv: int) -> int:
    """Shared memory one block of the masked SIMT entry takes at head dims
    (D, Dv): its Q and K tiles (D + 1 floats a row), V, P, the accumulator
    and the row state (``smem_bytes`` in csrc/flash_attention.cu, read
    from the library so the two never drift apart)."""
    return int(_build.library().flash_attention_masked_smem(d, dv))


@functools.lru_cache(maxsize=None)
def simt_smem_limit(index: int) -> int:
    """The shared memory a block may opt into on card ``index``
    (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 bytes on an H100),
    read once per card."""
    v = int(_build.library().max_dynamic_smem(index))
    if v <= 0:
        raise RuntimeError(f"reading card {index}'s shared-memory opt-in "
                           f"limit failed: cudaError_t {-v}")
    return v


def _live_counts(mask: torch.Tensor, pad: bool):
    """(B, Skv) f32 keep-mask -> (the mask, zero-padded to whole tiles when
    ``pad``, (B, nkv) int32 live keys per KV tile)."""
    b, skv = mask.shape
    nkv = -(-skv // KV_TILE)
    padded = torch.nn.functional.pad(mask, (0, nkv * KV_TILE - skv))
    counts = padded.reshape(b, nkv, KV_TILE).sum(-1).to(torch.int32)
    return (padded if pad else mask), counts


@functools.lru_cache(maxsize=64)
def _constant_mask(kv_len: int | None, b: int, skv: int, dev: torch.device,
                   pad: bool):
    """The keep-mask and live counts of an all-live (``kv_len`` None) or
    int-prefix key axis, built once per shape: the serving path's bucketed
    encode passes neither a mask nor ``kv_len`` on every layer."""
    mask = (torch.ones((b, skv), dtype=torch.float32, device=dev)
            if kv_len is None else prefix_key_mask(kv_len, b, skv, dev))
    return _live_counts(mask, pad)


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

    On the card (D, Dv) = ``TC_MASKED_HEAD_DIMS`` takes the tensor-core
    entry, and Dv = 64 with D > 64 a multiple of ``WIDE_D_CHUNK`` (Eq. 2's
    (768, 64) at ViT-Base, (1024, 64) at ViT-Large) the wide tensor-core
    entry: q, k and v may be strided views with D contiguous (e.g. the
    (B, S, H, D) projection layout permuted), read by strides, and need
    16-byte aligned pointers and (batch, head, row) strides, else it
    raises; the output is a (B, H, Sq, Dv) view of a (B, Sq, H, Dv)
    tensor. Every other (D, Dv) takes the SIMT entry on contiguous copies,
    up to the head dims whose block fits the card's opt-in shared memory
    (``simt_smem_bytes`` against ``simt_smem_limit``); above that it
    raises.
    Each launch counts under ``flash_attention_masked`` and under
    ``flash_attention_masked.<entry>``.
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
    entry = masked_entry_for(d, dv)
    if entry == "simt":
        need = simt_smem_bytes(d, dv)
        limit = simt_smem_limit(dev.index if dev.index is not None
                                else torch.cuda.current_device())
        if need > limit:
            raise ValueError(f"head dims ({d}, {dv}) need {need} bytes of "
                             f"shared memory a block, above the card's "
                             f"{limit}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tc = entry != "simt"         # the tensor-core kernels read a padded mask
    if key_mask is None and (kv_len is None or isinstance(kv_len, int)):
        mask, nlive = _constant_mask(kv_len, b, skv, dev, tc)
    else:
        if key_mask is None:
            key_mask = prefix_key_mask(kv_len, b, skv, dev)
        mask, nlive = _live_counts(key_mask.float().contiguous(), tc)
    nkv = nlive.shape[1]
    lib = _build.library()
    if tc:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        if not all(_build.aligned16(t, 3) for t in (q, k, v)):
            raise ValueError("the tensor-core kernel needs 16-byte aligned "
                             "q, k, v pointers and (batch, head, row) "
                             "strides")
        out = torch.empty((b, sq, h, dv), dtype=torch.float32,
                          device=dev).transpose(1, 2)
        if b * h * sq == 0:
            return out
        strides = _build.strides_arg(*(s_ for t in (q, k, v, out)
                                       for s_ in t.stride()[:3]))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                nlive.data_ptr(), out.data_ptr(), strides)
        if entry == "tc":
            fn = "flash_attention_masked_tc_f32"
            err = lib.flash_attention_masked_tc_f32(
                *ptrs, b, h, hk, hv, sq, skv, nkv, float(scale),
                _build.stream_ptr(dev))
        else:
            # K split into TF32 hi / lo once a call, in the kernel's layout
            kscratch = torch.empty(wide_scratch_floats(b, hk, nkv, d),
                                   dtype=torch.float32, device=dev)
            fn = "flash_attention_masked_wide_f32"
            err = lib.flash_attention_masked_wide_f32(
                *ptrs, kscratch.data_ptr(), b, h, hk, hv, sq, skv, d, nkv,
                float(scale), _build.stream_ptr(dev))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty((b, h, sq, dv), dtype=torch.float32, device=dev)
        if b * h * sq == 0:
            return out
        fn = "flash_attention_masked_f32"
        err = lib.flash_attention_masked_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            nlive.data_ptr(), out.data_ptr(), b, h, hk, hv, sq, skv, d, dv,
            nkv, float(scale), _build.stream_ptr(dev))
    _build.check(err, fn)
    _build.LAUNCHES["flash_attention_masked"] += 1
    _build.LAUNCHES["flash_attention_masked." + entry] += 1
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
    if d > CAUSAL_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {CAUSAL_MAX_HEAD_DIM}")
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
