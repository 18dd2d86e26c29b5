"""Flash decode: one new token's GQA attention against the KV cache (the
LM decode step's attention core).

Replaces src/repro/kernels/flash_decode.py::flash_decode_kernel (wrapper
``flash_decode``). The CUDA kernel is ``csrc/flash_decode.cu`` (its source
note says what bounds it on an H100 and how its design answers that); its
plain version is ``kernels/ref.py::flash_decode_ref``, in the op order of
the reference's ``models/attention.py::decode_attention``. The wrapper
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors.

The kernel splits the cache rows across a cluster of 8 blocks per (batch,
kv head) and merges through distributed shared memory.

Unlike the TPU wrapper, which transposes the cache to (B * Hkv, S, D)
before its grid and needs S to be a multiple of its block, the kernel
reads the (B, S, Hkv, D) cache where it lies, by strides, and masks any S.
``length`` is a host int: a decode loop knows it without asking the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref

__all__ = ["MAX_GROUP", "MAX_HEAD_DIM", "flash_decode"]

MAX_HEAD_DIM = 256    # D bound: a lane holds at most two 16-byte vectors a row
MAX_GROUP = 32        # G = H / Hkv bound: query rows go 8 to a pass


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """q (B, 1, H, D); k/v_cache (B, S, Hkv, D); ``length`` (host int,
    1 <= length <= S) valid cache rows, the new token's K/V already
    written at ``length - 1``. Returns (B, 1, H, D) in q.dtype. Rows >=
    ``length`` are masked; the kernel never reads them.

    The cache may be a strided view with D contiguous (a layer's slice of
    the stacked cache is one). The kernel takes f32 or bf16, all one dtype;
    on the card D must fill whole 16-byte vectors (a multiple of 8 bf16 or
    4 f32) and the caches' pointers and (batch, row, head) strides must be
    16-byte aligned, else it raises.
    """
    b, one, h, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if not (one == 1 and h % hkv == 0 and k_cache.shape[0] == b
            and k_cache.shape[3] == d
            and tuple(v_cache.shape) == tuple(k_cache.shape)):
        raise ValueError(f"shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache "
                         f"{tuple(v_cache.shape)}")
    if isinstance(length, torch.Tensor):
        raise TypeError("length must be a host int: a device scalar would "
                        "make every decode step wait on the card")
    length = int(length)
    if not 1 <= length <= s:
        raise ValueError(f"length {length} outside [1, {s}]")
    dev = q.device
    if any(t.device != dev for t in (k_cache, v_cache)):
        raise ValueError("q and the caches must share one device")
    if dev.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, length)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {dev}")
    if q.dtype not in _build.DTYPE_SUFFIX or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes q and the caches all f32 or "
                        f"all bf16, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if d > MAX_HEAD_DIM or h // hkv > MAX_GROUP:
        raise ValueError(f"head dim {d} (max {MAX_HEAD_DIM}) or group "
                         f"{h // hkv} (max {MAX_GROUP}) too large")
    if d * q.element_size() % 16:
        raise ValueError(f"head dim {d} of {q.dtype} does not fill whole "
                         f"16-byte vectors")
    q = q.contiguous()
    k_cache, v_cache = (t if t.stride(-1) == 1 else t.contiguous()
                        for t in (k_cache, v_cache))
    if not all(_build.aligned16(t, 3) for t in (q, k_cache, v_cache)):
        raise ValueError("the kernel needs 16-byte aligned q and cache "
                         "pointers and (batch, row, head) strides")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = _build.strides_arg(*k_cache.stride()[:3], *v_cache.stride()[:3])
    entry = "flash_decode_" + _build.DTYPE_SUFFIX[q.dtype]
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        strides, b, h, hkv, d, length, float(math.sqrt(d)),
        _build.stream_ptr(dev))
    _build.check(err, entry)
    _build.LAUNCHES["flash_decode"] += 1
    return out
