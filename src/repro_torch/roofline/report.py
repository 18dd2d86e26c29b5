"""The card's roofline constants (the reference's src/repro/roofline/report.py
``HW``, which pins a TPU's bf16 peak and HBM rate; here the H100's).

NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, dense published
peaks: int8 tensor cores 1,979 TOP/s, bf16 tensor cores 989 TFLOP/s,
TF32 tensor cores 495 TFLOP/s, f32 CUDA cores 67 TFLOP/s, HBM3 3.35 TB/s.
A card set below 700 W runs slower under load; the controller's fit maps
these seconds onto the ones it observes either way.

Each dtype class's operations go over that class's own peak. ``tf32x3``
is f32-class work on the tensor cores as three TF32 passes (the RoI-masked
flash attention's tensor-core entries), so its peak is a third of TF32's.

Not ported yet (ROADMAP.md queue A): ``model_flops``, ``roofline_terms``,
``make_row`` and ``render_table``, which serve the LM dry run (A15).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW"]


@dataclass(frozen=True)
class HW:
    int8_ops: float = 1979e12           # int8 tensor-core operations/s
    bf16_flops: float = 989e12          # bf16 tensor-core FLOP/s
    tf32_flops: float = 495e12          # TF32 tensor-core FLOP/s
    f32_flops: float = 67e12            # f32 CUDA-core FLOP/s
    hbm_bw: float = 3.35e12             # B/s

    def peak(self, kind: str) -> float:
        """Operations/s of one dtype class of ``roofline.cost``: int8,
        bf16, tf32x3, f32."""
        peaks = {"int8": self.int8_ops, "bf16": self.bf16_flops,
                 "tf32x3": self.tf32_flops / 3.0, "f32": self.f32_flops}
        if kind not in peaks:
            raise KeyError(f"no peak for dtype class {kind!r} "
                           f"({sorted(peaks)})")
        return peaks[kind]
