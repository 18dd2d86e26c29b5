"""Roofline per-flush cost model for the bucket ladder (the reference's
src/repro/serving/control/costmodel.py).

The reference prices each ladder bucket by compiling its encode at the
exact flush shape and parsing the optimized HLO. The port counts the same
dots from its own shapes (``roofline.cost.encode_cost``: FLOPs by dtype
class, bytes) and takes the roofline ``max(compute, memory)`` on the
H100's peaks (``roofline.report.HW``), each dtype class over its own peak.
The photonic accelerator model (``serving.accounting.bucket_report``, at
the server's ``layer_bits``) prices the same flush in uJ and
accelerator-us, so one table carries both views: the card's bound (the
number the controller calibrates against wall clock) and the modeled
accelerator's cost (the number KFPS/W is made of).

Pricing a bucket and warming it stay one act, as in the reference, where
the pricing compile is the bucket's AOT encode: ``ensure(k)`` warms bucket
k through the server's ``_warm_bucket``, which on the card (unsharded)
captures its CUDA graph into ``server.graphs``, over the noise state
tensor under noise, and elsewhere runs the eager encode once. The graphs
are the port's AOT executables: there is no ``executables`` dict. (The
predicted seconds are a lower bound that leaves out the host's launch and
copy-in time; the controller's calibration fit maps them to observed
seconds, see ``controller.py``.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.roofline.cost import Cost, encode_cost
from repro_torch.roofline.report import HW
from repro_torch.serving.accounting import bucket_report

__all__ = ["BucketCost", "EncodeCostModel"]


@dataclass(frozen=True)
class BucketCost:
    """One (bucket, micro-batch shape, bit-plan signature) price row."""

    bucket: int                 # kept-patch count k
    microbatch: int             # flush batch rows
    kv_len: int                 # token rows the encode actually sees
    #                             (== bucket, or the ladder cap in
    #                             one-shape mode with kv_len pruning)
    flops: float                # per flush, dots of the encode
    hbm_bytes: float            # per flush, weights + product activations
    int8_flops: float           # the share on int8 products
    device_s: float             # roofline max(compute, memory) per flush
    energy_uj: float            # photonic model, per flush (mb frames)
    photonic_us: float          # photonic model latency, per frame
    bits_sig: tuple | None      # per-layer bit plan the price was cut at

    @property
    def per_frame_s(self) -> float:
        return self.device_s / max(self.microbatch, 1)


def _out_features(w) -> int:
    """The head's width, raw or quantize-once cached."""
    return int(getattr(w, "wq", w).shape[-1])


class EncodeCostModel:
    """Predicted per-flush latency/energy table over the bucket ladder.

    Construction is lazy per bucket: ``from_server`` registers a builder
    for every ladder size but prices (and warms) only the ones asked for
    (``ensure``): probing showed which buckets the workload can hit, and
    warming a bucket costs its CUDA-graph capture.
    """

    def __init__(self, microbatch: int, hw: HW | None = None):
        self.microbatch = int(microbatch)
        self.hw = hw or HW()
        self.costs: dict[int, BucketCost] = {}
        self._builders: dict[int, Callable[[], tuple]] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_server(cls, server, buckets=None,
                    hw: HW | None = None) -> "EncodeCostModel":
        """Builders over a ``StreamServer``'s ladder, at its flush shape,
        policy, cache and bit plan. ``buckets`` (default: the whole ladder)
        are priced now; the rest stay lazy."""
        sc, cfg = server.serve_cfg, server.cfg
        cm = cls(sc.microbatch, hw=hw)
        n_classes = _out_features(server.params["head"])
        act = server.params["pos"].dtype
        raw = server._raw_params["pos"].dtype
        layer_bits = server.layer_bits

        def _builder(k: int):
            def build():
                kv = server.ladder.cap if sc.one_shape else k
                server._warm_bucket(k)
                return encode_cost(cfg, server.policy, sc.microbatch, k, kv,
                                   n_classes=n_classes, act_dtype=act,
                                   param_dtype=raw), kv
            return build

        for k in server.ladder.sizes:
            cm._builders[int(k)] = _builder(int(k))
        cm._cfg = cfg
        cm._layer_bits = (tuple(int(b) for b in layer_bits)
                          if layer_bits else None)
        for k in (buckets if buckets is not None else server.ladder.sizes):
            cm.ensure(int(k))
        return cm

    def ensure(self, bucket: int) -> BucketCost:
        """Price ``bucket`` (warm + count) if not already priced."""
        k = int(bucket)
        if k in self.costs:
            return self.costs[k]
        if k not in self._builders:
            raise KeyError(f"bucket {k} is not on the registered ladder "
                           f"({sorted(self._builders)})")
        cost, kv = self._builders[k]()
        self.costs[k] = self._price(k, kv, cost)
        return self.costs[k]

    def _price(self, k: int, kv: int, cost: Cost) -> BucketCost:
        hw = self.hw
        t_c = sum(f / hw.peak(kind) for kind, f in cost.by_type.items())
        t_m = cost.bytes / hw.hbm_bw
        rep = bucket_report(self._cfg, k, self._layer_bits)
        return BucketCost(
            bucket=k, microbatch=self.microbatch, kv_len=kv,
            flops=cost.flops, hbm_bytes=cost.bytes,
            int8_flops=cost.int8_flops, device_s=max(t_c, t_m),
            energy_uj=rep.total_uj * self.microbatch,
            photonic_us=rep.total_us, bits_sig=self._layer_bits)

    # -- queries -----------------------------------------------------------

    def predicted_flush_s(self, bucket: int) -> float:
        """Raw (uncalibrated) predicted seconds for one flush — the
        feature the controller's linear fit maps to observed seconds."""
        return self.ensure(bucket).device_s

    def table(self) -> dict[int, BucketCost]:
        """Every bucket priced so far, ascending."""
        return {k: self.costs[k] for k in sorted(self.costs)}

    def render(self) -> str:
        lines = [f"{'bucket':>7} {'mb':>3} {'GFLOP/flush':>12} "
                 f"{'MB/flush':>9} {'pred us':>8} {'uJ/flush':>9} "
                 f"{'acc us/frame':>13}"]
        for k, c in self.table().items():
            lines.append(
                f"{k:>7} {c.microbatch:>3} {c.flops / 1e9:>12.3f} "
                f"{c.hbm_bytes / 1e6:>9.2f} {c.device_s * 1e6:>8.2f} "
                f"{c.energy_uj:>9.2f} {c.photonic_us:>13.2f}")
        return "\n".join(lines)
