"""The fused int8 photonic GELU-MLP: w1 GEMM + dequant + b1 + tanh-GELU +
requantization at the hidden absmax + w2 GEMM + dequant, then + b2.

Two constructions of the same function, as in the reference
(src/repro/kernels/fused_ffn.py):

  * ``fused_ffn`` replaces ``fused_ffn_kernel`` (wrapper ``fused_ffn_int8``,
    host pick ``fused_ffn``): ``csrc/fused_ffn.cu`` (its source note says
    why there are three launches, how d_ff is tiled, and what bounds each
    on an H100); plain version ``ref.py::fused_ffn_ref``. Two entries,
    chosen by widths only (``ffn_entry_for``): ``kmajor`` when d_in and
    d_ff are multiples of 16 (every served config), reading the weights'
    K-major copies ``w1t`` / ``w2t`` (``QuantizedWeight.wt``), and
    ``nmajor``, the first design, for the rest (``fused_ffn_nmajor`` runs
    it at any widths). Each launch counts under ``fused_ffn`` and under
    ``fused_ffn.<entry>``.
  * ``fused_ffn_xla`` is the reference's XLA twin: quantize, an int32
    accumulate outside any kernel (``int_accumulate``: ``torch._int_mm`` on
    the card, as the reference leaves its integer dot to XLA), then
    ``dequant_epilogue``, which replaces ``_dequant_epilogue_kernel`` (CUDA
    ``csrc/dequant_epilogue.cu``, plain version
    ``ref.py::dequant_epilogue_ref``). ``ffn_twin`` is its dataflow around
    the two int8 linears; the model-sharded form
    (``models/sharded_encoder.py::fused_ffn_sharded``) runs the same
    dataflow with the collectives in its linears.

Every wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. As in the reference, x is quantized at w1's
width outside the kernels, b2 is added outside, and ``live_rows``
prefix-slices the token rows before any work (dead rows come back as exact
zeros, and the absmax scopes reduce over live rows only).
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (dequant_epilogue_ref, fused_ffn_ref,
                                     gelu_tanh, int_accumulate_ref,
                                     restore_dead, slice_live)

__all__ = ["KMAJOR_MULTIPLE", "bits_pair", "ffn_entry_for", "fused_ffn",
           "fused_ffn_nmajor", "dequant_epilogue", "padded_int_mm",
           "int_accumulate", "int8_linear_xla", "ffn_twin", "fused_ffn_xla"]

KMAJOR_MULTIPLE = 16     # the K-major entry's 16-byte row copies, both GEMMs
# torch._int_mm on the card takes M > 16 rows and K, N multiples of 8; and
# below K = 128 its cuBLASLt call finds no kernel for N > 16 unless M is a
# multiple of 32 (torch 2.11 + CUDA 12.8 on an H100: CUBLAS_STATUS_NOT_
# SUPPORTED; tests/test_torch_gpu.py::test_int_accumulate_any_shape)
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8
_INT_MM_SMALL_K, _INT_MM_SMALL_K_ROWS = 128, 32


def bits_pair(bits) -> tuple[int, int]:
    """(w1 width, w2 width) from an int or a pair, each in [2, 8]."""
    if isinstance(bits, (tuple, list)):
        b1, b2 = (int(b) for b in bits)
    else:
        b1 = b2 = int(bits)
    if not (2 <= b1 <= 8 and 2 <= b2 <= 8):
        raise ValueError(f"fused FFN bit widths {bits!r} outside [2, 8]")
    return b1, b2


def ffn_entry_for(d_in: int, d_ff: int) -> str:
    """The entry a CUDA call of these widths launches: ``kmajor`` when d_in
    and d_ff (the two GEMMs' contraction depths) are multiples of 16,
    ``nmajor`` (the first design) otherwise."""
    return ("kmajor" if d_in % KMAJOR_MULTIPLE == 0
            and d_ff % KMAJOR_MULTIPLE == 0 else "nmajor")


def fused_ffn(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
              b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
              b2: torch.Tensor, *, bits=8, live_rows: int | None = None,
              w1t: torch.Tensor | None = None,
              w2t: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., n, d_in) float; w1q (d_in, d_ff) int8 + sw1 (d_ff,) f32 +
    b1 (d_ff,); w2q (d_ff, d_out) int8 + sw2 (d_out,) f32 + b2 (d_out,).
    Returns (..., n, d_out) in x.dtype. ``bits`` is an int or a (w1, w2)
    pair; ``live_rows`` keeps only the first token rows.

    ``w1t`` (d_ff, d_in) and ``w2t`` (d_out, d_ff) are the weights'
    K-major copies, contiguous, as ``QuantizedWeight.wt`` holds them. On
    the card the entry ``ffn_entry_for`` names runs: ``kmajor`` reads the
    copies and raises without them or on misaligned ones (the wrapper
    never transposes a weight), ``nmajor`` reads w1q / w2q. On the CPU the
    copies are checked, then the plain version runs."""
    return _fused_ffn(None, x, w1q, sw1, b1, w2q, sw2, b2, bits, live_rows,
                      w1t, w2t)


def fused_ffn_nmajor(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
                     b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
                     b2: torch.Tensor, *, bits=8,
                     live_rows: int | None = None) -> torch.Tensor:
    """``fused_ffn`` through the N-major entry (the first design) at any
    widths; the plain version on the CPU. The checks and scans on the card
    hold the K-major entry against it where ``fused_ffn`` takes that one."""
    return _fused_ffn("nmajor", x, w1q, sw1, b1, w2q, sw2, b2, bits,
                      live_rows, None, None)


def _check_copies(w1q, w2q, w1t, w2t) -> None:
    for name, w, wt in (("w1t", w1q, w1t), ("w2t", w2q, w2t)):
        if wt is None:
            continue
        if wt.dtype != torch.int8 or tuple(wt.shape) != tuple(w.shape)[::-1]:
            raise ValueError(f"{name} {wt.dtype} {tuple(wt.shape)} is not the "
                             f"int8 K-major copy of a {tuple(w.shape)} weight")
        if wt.device != w.device:
            raise ValueError(f"{name} on {wt.device}, the weight on {w.device}")


def _fused_ffn(entry, x, w1q, sw1, b1, w2q, sw2, b2, bits, live_rows, w1t,
               w2t) -> torch.Tensor:
    """``fused_ffn`` on ``entry``, or on the entry its widths name (None)."""
    bits1, bits2 = bits_pair(bits)
    k1, dff = w1q.shape
    dff2, dout = w2q.shape
    if x.shape[-1] != k1 or dff != dff2 or w1q.dtype != torch.int8 \
            or w2q.dtype != torch.int8:
        raise ValueError(f"shapes/dtypes x {tuple(x.shape)} w1 "
                         f"{tuple(w1q.shape)} {w1q.dtype} w2 "
                         f"{tuple(w2q.shape)} {w2q.dtype}")
    _check_copies(w1q, w2q, w1t, w2t)
    dev = x.device
    if any(t.device != dev for t in (w1q, sw1, b1, w2q, sw2, b2)):
        raise ValueError("x and the FFN weights must share one device")
    if dev.type == "cpu":
        return fused_ffn_ref(x, w1q, sw1, b1, w2q, sw2, b2,
                             bits=(bits1, bits2), live_rows=live_rows)
    if dev.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take f32 activations, got {x.dtype}")
    entry = entry or ffn_entry_for(k1, dff)
    if entry == "kmajor":
        if w1t is None or w2t is None:
            raise ValueError("the K-major entry reads the weights' K-major "
                             "copies: pass w1t (d_ff, d_in) and w2t (d_out, "
                             "d_ff), as QuantizedWeight.wt holds them")
        if not (w1t.is_contiguous() and w2t.is_contiguous()):
            raise ValueError("the K-major entry takes contiguous w1t / w2t")
        if w1t.data_ptr() % 16 or w2t.data_ptr() % 16:
            raise ValueError("the K-major entry needs 16-byte aligned w1t / "
                             "w2t")
    n_tokens = x.shape[-2]
    xl, lv = slice_live(x, live_rows)
    if lv == 0:
        return x.new_zeros(*x.shape[:-1], dout)
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, k1)
    m = x2.shape[0]
    sx = quant.absmax_scale(x2, bits=bits1)
    xq = quant.quantize(x2, sx, bits=bits1).contiguous()
    sw1, sw2 = sw1.float().contiguous(), sw2.float().contiguous()
    b1f = b1.float().contiguous()
    hidden = torch.empty((m, dff), dtype=torch.float32, device=dev)
    out = torch.empty((m, dout), dtype=torch.float32, device=dev)
    qmax, inv = quant.quant_range(bits2)[1], quant.inv_qmax(bits2)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    if entry == "kmajor":
        hq = torch.empty((m, dff), dtype=torch.int8, device=dev)
        scal = torch.zeros((2,), dtype=torch.float32, device=dev)
        _build.check(lib.fused_ffn_kmajor(
            xq.data_ptr(), w1t.data_ptr(), sx.data_ptr(), sw1.data_ptr(),
            b1f.data_ptr(), w2t.data_ptr(), sw2.data_ptr(), hidden.data_ptr(),
            hq.data_ptr(), scal.data_ptr(), out.data_ptr(), m, k1, dff, dout,
            qmax, inv, stream), "fused_ffn_kmajor")
    else:
        w1q, w2q = w1q.contiguous(), w2q.contiguous()
        amax = torch.zeros((1,), dtype=torch.float32, device=dev)
        _build.check(lib.fused_ffn_phase0(
            xq.data_ptr(), w1q.data_ptr(), sx.data_ptr(), sw1.data_ptr(),
            b1f.data_ptr(), hidden.data_ptr(), amax.data_ptr(), m, k1, dff,
            stream), "fused_ffn_phase0")
        _build.check(lib.fused_ffn_phase1(
            hidden.data_ptr(), w2q.data_ptr(), amax.data_ptr(),
            sw2.data_ptr(), out.data_ptr(), m, dff, dout, qmax, inv, stream),
            "fused_ffn_phase1")
    _build.LAUNCHES["fused_ffn"] += 1
    _build.LAUNCHES["fused_ffn." + entry] += 1
    y = out + b2
    return restore_dead(y.reshape(*lead, dout), n_tokens)


def dequant_epilogue(acc: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor) -> torch.Tensor:
    """acc (M, N) int32, sx (1 element) f32, sw (N,) f32 -> (M, N) f32 =
    (f32(acc) * sx) * sw. The B4 kernel on the card; its plain version for
    CPU tensors. Contiguous operands only."""
    if acc.dtype != torch.int32 or sx.dtype != torch.float32 \
            or sw.dtype != torch.float32:
        raise TypeError(f"dequant_epilogue takes int32 / f32 / f32, got "
                        f"{acc.dtype} / {sx.dtype} / {sw.dtype}")
    if acc.ndim != 2 or sx.numel() != 1 or sw.shape != (acc.shape[1],):
        raise ValueError(f"shapes acc {tuple(acc.shape)} sx "
                         f"{tuple(sx.shape)} sw {tuple(sw.shape)}")
    devs = {t.device for t in (acc, sx, sw)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = acc.device
    if dev.type == "cpu":
        return dequant_epilogue_ref(acc, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"dequant_epilogue runs on cuda or cpu, not {dev}")
    if not (acc.is_contiguous() and sx.is_contiguous()
            and sw.is_contiguous()):
        raise ValueError("dequant_epilogue takes contiguous operands")
    m, n = acc.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    _build.check(_build.library().dequant_epilogue_s32(
        acc.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n,
        _build.stream_ptr(dev)), "dequant_epilogue_s32")
    _build.LAUNCHES["dequant_epilogue"] += 1
    return out


def padded_int_mm(xq: torch.Tensor, wq: torch.Tensor, mm) -> torch.Tensor:
    """``mm`` of (M, K) and (K, N) int8 codes on zero-padded copies that
    ``torch._int_mm`` takes (M > 16 rows, K and N multiples of 8, and M a
    multiple of 32 where K < 128), sliced back to (M, N). Exact: zero codes
    add nothing to an int32 sum. Operands already of such a shape go
    through unpadded."""
    m, k = xq.shape
    n = wq.shape[1]
    kp, np_ = (-(-d // _INT_MM_MULTIPLE) * _INT_MM_MULTIPLE for d in (k, n))
    mp = max(m, _INT_MM_MIN_ROWS)
    if kp < _INT_MM_SMALL_K:
        mp = -(-mp // _INT_MM_SMALL_K_ROWS) * _INT_MM_SMALL_K_ROWS
    if (mp, kp) != (m, k):
        xp = xq.new_zeros((mp, kp))
        xp[:m, :k] = xq
    else:
        xp = xq.contiguous()
    if (kp, np_) != (k, n):
        wp = wq.new_zeros((kp, np_))
        wp[:k, :n] = wq
    else:
        wp = wq.contiguous()
    acc = mm(xp, wp)
    return acc if (mp, np_) == (m, n) else acc[:m, :n].contiguous()


def int_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulate of int8 codes, (M, K) . (K, N) -> (M, N),
    outside any kernel of the port (the reference's ``dot_general`` with
    ``preferred_element_type=int32``), at any shape. CPU: the float64 plain
    version. The card: ``torch._int_mm`` through ``padded_int_mm``."""
    if xq.device.type == "cpu":
        return int_accumulate_ref(xq, wq)
    return padded_int_mm(xq, wq, torch._int_mm)


def int8_linear_xla(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, *,
                    bits: int) -> torch.Tensor:
    """quantize -> int32 accumulate -> B4 dequant: the reference's
    ``_int8_linear_xla``. x2 (M, K) f32; wq (K, N) int8; sw (N,) f32."""
    sx = quant.absmax_scale(x2, bits=bits)
    xq = quant.quantize(x2, sx, bits=bits)
    return dequant_epilogue(int_accumulate(xq, wq), sx, sw.contiguous())


def ffn_twin(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
             b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
             b2: torch.Tensor, bits: tuple[int, int],
             live_rows: int | None, linear1, linear2) -> torch.Tensor:
    """The dataflow of the reference's ``fused_ffn_xla`` around its two int8
    linears ``linear1/2(x2, wq, sw, bits=)``: live-row slice, linear1 at
    bits1, cast to x.dtype, + b1, tanh-GELU in f32, cast, linear2 at bits2,
    cast, + b2, dead rows restored as exact zeros."""
    bits1, bits2 = bits
    n_tokens = x.shape[-2]
    dout = w2q.shape[1]
    xl, lv = slice_live(x, live_rows)
    if lv == 0:
        return x.new_zeros(*x.shape[:-1], dout)
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, x.shape[-1]).float()
    h = linear1(x2, w1q, sw1, bits=bits1).to(x.dtype) + b1
    g = gelu_tanh(h.float()).to(x.dtype)
    y = linear2(g.float(), w2q, sw2, bits=bits2).to(x.dtype) + b2
    return restore_dead(y.reshape(*lead, dout), n_tokens)


def fused_ffn_xla(x: torch.Tensor, w1q: torch.Tensor, sw1: torch.Tensor,
                  b1: torch.Tensor, w2q: torch.Tensor, sw2: torch.Tensor,
                  b2: torch.Tensor, *, bits=8,
                  live_rows: int | None = None) -> torch.Tensor:
    """The reference's ``fused_ffn_xla``: ``ffn_twin`` over two
    ``int8_linear_xla``; the same shapes and ``live_rows`` semantics as
    ``fused_ffn``."""
    return ffn_twin(x, w1q, sw1, b1, w2q, sw2, b2, bits_pair(bits),
                    live_rows, int8_linear_xla, int8_linear_xla)
