"""Self-tuning serving control plane (the reference's
src/repro/serving/control/).

Three layers, composed by ``StreamServer.autotune_prepare()``:

  * ``costmodel`` — prices every ladder bucket's encode with an analytic
    count of its FLOPs and bytes on the H100's roofline
    (``roofline.cost``), combined with the photonic accelerator model
    (``serving.accounting``); pricing a bucket captures its CUDA graph,
    so costing doubles as the warm start of the buckets it prices.
  * ``telemetry`` — ring buffer of observed per-flush wall timings and
    occupancy, tagged by (bucket, batch fill, stream count).
  * ``controller`` — calibrates predicted cost against observed seconds
    (per-bucket linear fit), then re-tunes the serving knobs every N
    frames with hysteresis and a safety clamp.
"""

from repro_torch.serving.control.controller import (Controller,
                                                    ControllerConfig,
                                                    TunedKnobs)
from repro_torch.serving.control.costmodel import (BucketCost,
                                                   EncodeCostModel)
from repro_torch.serving.control.telemetry import FlushObs, FlushTelemetry

__all__ = ["BucketCost", "EncodeCostModel", "FlushObs", "FlushTelemetry",
           "Controller", "ControllerConfig", "TunedKnobs"]
