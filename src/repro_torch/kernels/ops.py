"""Serving entry points around the kernels (the reference's
src/repro/kernels/ops.py, serving subset).

``photonic_matmul_prequant`` quantizes the activations per tensor (PyTorch
ops, as the reference runs them under XLA outside its kernel) and feeds
the int8 photonic matmul with the quantize-once cached weight;
``photonic_matmul`` is the float API that quantizes the weight too.
``fused_roi_attention_prequant`` is the MHSA hot path: three cached-weight
int8 projections feeding the RoI-masked flash attention kernel.
``photonic_matmul_prequant_noisy`` is the noisy companion of the cached
matmul: the transmission error drawn onto the codes (the noise-draw
kernel), the analog float-code walk, shot noise and the optional ADC.

The clean entries take each per-launch activation absmax in the scope the
installed sharding context names (``collectives.scoped_absmax_scale``):
over every rank's rows where a launch's rows are split over ranks (the
1-D data mesh's encode), else over this call's rows alone.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.distributed.collectives import scoped_absmax_scale
from repro_torch.kernels.flash_attention import flash_attention_masked
from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

__all__ = ["pad_to", "photonic_matmul", "photonic_matmul_prequant",
           "photonic_matmul_prequant_noisy", "fused_roi_attention_prequant"]


def pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult`` (x itself when
    it already is one). The kernels mask ragged edges, so no path of the
    port pads for them; this is the reference's helper for callers that
    want padded operands."""
    r = (-x.shape[axis]) % mult
    if r == 0:
        return x
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis % x.ndim) + 1] = r
    return torch.nn.functional.pad(x, pad)


def photonic_matmul_prequant(x: torch.Tensor, wq: torch.Tensor,
                             sw: torch.Tensor, *, bits: int = 8,
                             wt: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K) float; wq (K, N) int8 codes; sw (N,) f32 per-out-channel
    scale; ``wt`` the codes' K-major copy (N, K), which the kernel's K-major
    entry reads on the card (``photonic_matmul_int8``). Returns (..., N)
    f32. Ragged M, K and N are masked inside the kernel, never padded."""
    lead = x.shape[:-1]
    k, n = wq.shape
    x2 = x.reshape(-1, k).float()
    sx = scoped_absmax_scale(x2, bits)
    xq = quant.quantize(x2, sx, bits=bits)
    return photonic_matmul_int8(xq, wq, sx, sw, wt=wt).reshape(*lead, n)


def photonic_matmul_prequant_noisy(x: torch.Tensor, wq: torch.Tensor,
                                   sw: torch.Tensor, call, spec, *,
                                   bits: int = 8,
                                   chunk: int = 32) -> torch.Tensor:
    """Noisy companion of ``photonic_matmul_prequant``: x (..., K) float,
    wq (K, N) codes, sw (N,) f32; ``call`` the dispatch's keys
    (``core.noise.next_call_keys``) and ``spec`` its ``NoiseSpec``. The
    int8 kernel is the clean digital contract (a sub-LSB transmission error
    cannot ride through integer codes), so the codes times the MR
    multiplier (``noise_draw.transmission_codes``: the kernel on the card,
    its plain version on the CPU) walk the wavelength chunks as floats
    (``core.photonic.analog_accumulate``), then acc * sx * sw, shot noise
    and, with ``spec.adc_quantize_output``, an ADC requant at ``bits``.
    Returns (..., N) f32."""
    from repro_torch.core.noise import readout_noise
    from repro_torch.core.photonic import analog_accumulate
    from repro_torch.kernels.noise_draw import transmission_codes

    lead = x.shape[:-1]
    k, n = wq.shape
    x2 = x.reshape(-1, k).float()
    sx = quant.absmax_scale(x2, bits=bits)
    xq = quant.quantize(x2, sx, bits=bits)
    acc = analog_accumulate(xq, transmission_codes(wq, call, spec),
                            chunk=chunk)
    y = acc * sx * sw[None, :]
    return readout_noise(y, spec, call, bits=bits).reshape(*lead, n)


def photonic_matmul(x: torch.Tensor, w: torch.Tensor, *,
                    bits: int = 8) -> torch.Tensor:
    """The float API: the weight quantized per output channel (and its
    K-major copy made) for this call, then ``photonic_matmul_prequant``.
    x (..., K) any float dtype; w (K, N). Returns (..., N) f32."""
    w32 = w.float()
    sw = quant.absmax_scale(w32, bits=bits, axis=0)
    wq = quant.quantize(w32, sw, bits=bits)
    return photonic_matmul_prequant(x, wq, sw.reshape(-1), bits=bits,
                                    wt=wq.t().contiguous())


def fused_roi_attention_prequant(x: torch.Tensor,
                                 wq: torch.Tensor, sq_: torch.Tensor,
                                 wk: torch.Tensor, sk_: torch.Tensor,
                                 wv: torch.Tensor, sv_: torch.Tensor,
                                 key_mask: torch.Tensor | None = None, *,
                                 heads: int, kv_len: int | None = None,
                                 bits=8, kmajor=(None, None, None)
                                 ) -> torch.Tensor:
    """x (B, n, dm) float; wq/wk/wv (dm, dm) int8 codes with per-out-channel
    scales (dm,) f32, and ``kmajor`` their K-major copies (the cache's
    ``wt``, which the card's photonic matmul reads); ``key_mask`` (B, n)
    keep-mask or ``kv_len`` (keys >= kv_len pruned). ``bits`` is an int or
    a (q, k, v) triple. Returns the merged head outputs (B, n, dm) in
    x.dtype; the output projection is the caller's ``linear``. The heads
    reach the attention kernel as (B, H, n, dh) views of the projections
    and its output is a (B, H, n, dh) view of a (B, n, H, dh) tensor, so
    the merge is a view too: no copy either way."""
    if isinstance(bits, (tuple, list)):
        bits_q, bits_k, bits_v = (int(b_) for b_ in bits)
    else:
        bits_q = bits_k = bits_v = int(bits)
    b, n, dm = x.shape
    dh = dm // heads
    xf = x.float()
    if bits_q == bits_k == bits_v:
        # one activation scale and one set of codes feed all three
        # projections: the same numbers as quantizing three times
        x2 = xf.reshape(-1, dm)
        sx = scoped_absmax_scale(x2, bits_q)
        xq = quant.quantize(x2, sx, bits=bits_q)
        q, k, v = (photonic_matmul_int8(xq, w, sx, s, wt=wt).reshape(b, n, dm)
                   for w, s, wt in zip((wq, wk, wv), (sq_, sk_, sv_),
                                       kmajor))
    else:
        q, k, v = (photonic_matmul_prequant(xf, w, s, bits=bt, wt=wt)
                   for w, s, bt, wt in zip((wq, wk, wv), (sq_, sk_, sv_),
                                           (bits_q, bits_k, bits_v), kmajor))

    def split(t):
        return t.to(x.dtype).reshape(b, n, heads, dh).permute(0, 2, 1, 3)

    o = flash_attention_masked(split(q), split(k), split(v), key_mask,
                               kv_len=kv_len)
    return o.permute(0, 2, 1, 3).reshape(b, n, dm)
