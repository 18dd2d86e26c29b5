"""The noise-draw kernel: the calibrated device-noise model's random draws
(JAX's threefry2x32 with its uniform and normal transforms) on the card.

No TPU kernel is replaced: the reference draws these samples with
``jax.random`` outside Pallas (src/repro/core/noise.py::transmission_error
and ::readout_noise, called by core/backend.py::_noisy_matmul and
kernels/ops.py::photonic_matmul_prequant_noisy). The CUDA kernel is in
``csrc/noise_draw.cu`` (its source note says what bounds it on an H100);
the plain versions are ``kernels/ref.py::transmission_codes_ref``,
``readout_shot_ref`` and ``draw_bits_ref``. Each wrapper launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.

Every entry reads the call's keys from a ``core.noise.NoiseCall``: the
scope's device state tensor (key words, frame, drift), from which the
kernel derives the draw key, and the salts, counter and FPV key, which
are launch arguments. A CUDA graph captured over a call therefore draws
what an eager call draws at the state the tensor holds when it replays.

  * ``transmission_codes(w, call, spec)``: f32(w) * M for a (K, N) weight
    (int8 codes or f32), M the drifted transmission multiplier;
  * ``readout_shot(y, call, sigma, offset)``: y *= 1 + sigma * n, in
    place, n the draw's elements from ``offset`` on (0 unsplit; a rank's
    block of a launch split along its batch rows: GSPMD's partitioned
    draw);
  * ``draw_bits(state, salts, counter, fold, shape)``: the generator's raw
    bits under a draw key, for holding it bitwise.

Launches count under ``noise_draw`` and ``noise_draw.<entry>`` (codes,
shot, bits).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (draw_bits_ref, readout_shot_ref,
                                     transmission_codes_ref)

__all__ = ["MAX_SALTS", "MAX_CHANNELS", "transmission_codes",
           "readout_shot", "draw_bits"]

MAX_SALTS = 4        # salts a call may carry (kMaxSalts in the source)
MAX_CHANNELS = 32    # WDM channels of the crosstalk floor (one warp)


def _check_call(salts: tuple, state: torch.Tensor, dev) -> None:
    if len(salts) > MAX_SALTS:
        raise ValueError(f"{len(salts)} salts, the noise-draw kernel takes "
                         f"at most {MAX_SALTS}")
    if (state.dtype != torch.int32 or state.shape != (4,)
            or state.device != dev):
        raise ValueError(f"state tensor {state.dtype} {tuple(state.shape)} "
                         f"on {state.device}: needs int32 (4,) on {dev}")


def _transmission_args(spec) -> tuple:
    """The f32 constants of a spec's multiplier: fpv sigma, wander sigma,
    delta^2 of the detune gain, the grid's centre and spacing, 2Q."""
    from repro_torch.core.noise import detune_delta2
    mr = spec.mr()
    f32 = lambda v: float(np.float32(v))                     # noqa: E731
    return (f32(spec.fpv_sigma), f32(spec.wander_sigma_nm),
            detune_delta2(mr), f32(mr.center_nm), f32(mr.spacing_nm),
            f32(2.0 * mr.q_factor))


def transmission_codes(w: torch.Tensor, call, spec) -> torch.Tensor:
    """w (K, N) int8 codes or f32 -> f32 (K, N): w * M, M drawn for
    ``call`` (a ``core.noise.NoiseCall``) at ``spec``'s operating point
    with the drift of the call's state."""
    if w.dtype not in (torch.int8, torch.float32) or w.ndim != 2:
        raise TypeError(f"w must be a 2-D int8 or f32 tensor, got "
                        f"{w.dtype} {tuple(w.shape)}")
    dev = w.device
    mr = spec.mr()
    if mr.n_channels > MAX_CHANNELS:
        raise ValueError(f"{mr.n_channels} WDM channels, the kernel's floor "
                         f"takes at most {MAX_CHANNELS}")
    state = call.state_tensor(dev)
    _check_call(call.salts, state, dev)
    if dev.type == "cpu":
        return transmission_codes_ref(w, state, call.salts, call.counter,
                                      call.fpv_key, mr, spec.fpv_sigma,
                                      spec.wander_sigma_nm)
    if dev.type != "cuda":
        raise ValueError(f"transmission_codes runs on cuda or cpu, not {dev}")
    w = w.contiguous()
    out = torch.empty(w.shape, dtype=torch.float32, device=dev)
    if w.numel() == 0:
        return out
    fn = ("noise_transmission_s8" if w.dtype == torch.int8
          else "noise_transmission_f32")
    err = getattr(_build.library(), fn)(
        w.data_ptr(), out.data_ptr(), w.numel(), state.data_ptr(),
        _build.words_arg(*call.salts), len(call.salts), call.counter,
        call.fpv_key[0], call.fpv_key[1], *_transmission_args(spec),
        mr.n_channels, _build.stream_ptr(dev))
    _build.check(err, fn)
    _build.LAUNCHES["noise_draw"] += 1
    _build.LAUNCHES["noise_draw.codes"] += 1
    return out


def readout_shot(y: torch.Tensor, call, sigma: float,
                 offset: int = 0) -> torch.Tensor:
    """y (any shape, f32, contiguous) *= 1 + sigma * n in place, n the
    call's shot normals over y's flat index, starting at ``offset`` of a
    larger draw's (a rank's rows of a launch split over ranks). Returns
    y."""
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise TypeError("readout_shot takes a contiguous f32 tensor")
    dev = y.device
    state = call.state_tensor(dev)
    _check_call(call.salts, state, dev)
    if dev.type == "cpu":
        return y.copy_(readout_shot_ref(y, state, call.salts, call.counter,
                                        sigma, offset))
    if dev.type != "cuda":
        raise ValueError(f"readout_shot runs on cuda or cpu, not {dev}")
    if y.numel() == 0:
        return y
    err = _build.library().noise_readout_shot(
        y.data_ptr(), y.numel(), int(offset), state.data_ptr(),
        _build.words_arg(*call.salts), len(call.salts), call.counter,
        float(np.float32(sigma)), _build.stream_ptr(dev))
    _build.check(err, "noise_readout_shot")
    _build.LAUNCHES["noise_draw"] += 1
    _build.LAUNCHES["noise_draw.shot"] += 1
    return y


def draw_bits(state: torch.Tensor, salts: tuple, counter: int, fold: int,
              shape) -> torch.Tensor:
    """The raw 32-bit draws under the draw key of (state, salts, counter),
    folded once more with ``fold`` when it is not 0, as int64 values of
    ``shape``, on the state's device."""
    dev = state.device
    _check_call(tuple(salts), state, dev)
    if dev.type == "cpu":
        return draw_bits_ref(state, tuple(salts), counter, fold, shape)
    out = torch.empty(tuple(shape), dtype=torch.int32, device=dev)
    if out.numel():
        err = _build.library().noise_draw_bits(
            out.data_ptr(), out.numel(), state.data_ptr(),
            _build.words_arg(*salts), len(salts), counter, fold,
            _build.stream_ptr(dev))
        _build.check(err, "noise_draw_bits")
        _build.LAUNCHES["noise_draw"] += 1
        _build.LAUNCHES["noise_draw.bits"] += 1
    return out.to(torch.int64) & 0xFFFFFFFF
