#!/usr/bin/env python3
"""Device memory around ``StreamServer.calibrate_bits``: does replacing the
weight cache (and re-capturing the bucket graphs) leave anything behind?

    python3 scripts/bitplan_memory.py

opto-vit-base-224 + MGNet (random weights from seed 0) served graphed
under T224_PLAN; then ``calibrate_bits(6.5)`` twice and the T224_PLAN
cache installed again. After each step it prints
``torch.cuda.memory_allocated()`` and the live CUDA storages of 1 MiB or
more that Python can reach (``gc``), grouped by size, with what appeared
and what went since the step before. Needs a CUDA card (~30 s).
"""

from __future__ import annotations

import collections
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T224_PLAN = (8, 8, 8, 6, 6, 4, 6, 6, 8, 8, 8, 8)
MIB = 2 ** 20


def live_storages(torch) -> dict:
    """data_ptr -> (MiB, dtype, a shape) of every CUDA storage >= 1 MiB
    that a Python object reaches."""
    out = {}
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
            st = obj.untyped_storage()
        except Exception:           # noqa: BLE001 - half-built objects
            continue
        if st.nbytes() >= MIB:
            out.setdefault(st.data_ptr(), (st.nbytes() / MIB, obj.dtype,
                                           tuple(obj.shape)))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bridge import from_jax_params, init_vit
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.serving.server import (ServerConfig, StreamServer,
                                            serving_cfg)

    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          flush=True)
    cfg = serving_cfg("base", 224)
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    server = StreamServer(cfg, ServerConfig(bit_plan=T224_PLAN),
                          params=params)
    stream = video_fleet(1, img_size=224, patch=16)[0]
    server.add_session(stream, n_frames=8)
    prev = None

    def step(tag):
        nonlocal prev
        gc.collect()
        torch.cuda.synchronize()
        now = live_storages(torch)
        sizes = collections.Counter(round(v[0], 2) for v in now.values())
        print(f"[{tag}] allocated {torch.cuda.memory_allocated() / MIB:.1f} "
              f"MiB, reserved {torch.cuda.memory_reserved() / MIB:.1f} MiB; "
              f"{len(now)} storages >= 1 MiB reachable, "
              f"{sum(v[0] for v in now.values()):.1f} MiB: "
              f"{dict(sorted(sizes.items()))}", flush=True)
        if prev is not None:
            for what, keys in (("new", now.keys() - prev.keys()),
                               ("gone", prev.keys() - now.keys())):
                kinds = collections.Counter(
                    (round((now if what == "new" else prev)[k][0], 2),
                     str((now if what == "new" else prev)[k][1]),
                     (now if what == "new" else prev)[k][2]) for k in keys)
                print(f"[{tag}] {what}: " + "; ".join(
                    f"{n} x {mib} MiB {dt} {shape}"
                    for (mib, dt, shape), n in sorted(kinds.items())),
                    flush=True)
        prev = now

    step("warm, T224_PLAN")
    for i in (1, 2):
        plan = server.calibrate_bits(6.5)
        step(f"calibrate_bits #{i} -> {list(plan)}")
    server._install(server._prepare(T224_PLAN))
    step("T224_PLAN installed again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
