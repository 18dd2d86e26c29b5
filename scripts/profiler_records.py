#!/usr/bin/env python3
"""How many kernel records torch.profiler keeps on the card, before and
after a profiled session that records many kernels.

    python3 scripts/profiler_records.py

Profiles 50 launches of B5 (causal flash attention, the LM prefill shape)
and of B1 (the photonic matmul at (788, 768, 768)) three times each and
prints the kernel instances each pass recorded; then profiles 50 eager
opto-vit-base-224 encodes (4 x 147 tokens, ~36k kernels) and profiles
the same launches again; then captures one CUDA graph per bucket and
profiles 20 replays of the k = 147 graph (do the graph's kernels appear,
and with what device time?) before a last round. ``chip_smoke.py``'s
``device_ms`` fails a pass that recorded fewer instances than the wrapper
counted launches, so the order of its profiled phases matters. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8
    from repro_torch.models.vit import forward_vit_tokens
    from repro_torch.serving.server import (ServerConfig, StreamServer,
                                            serving_cfg)

    _build.library()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(4, 128, h, 128, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for h in (12, 2, 2))
    xq, wq = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8)
              for shape in ((788, 768), (768, 768)))
    wt, sx = wq.t().contiguous(), torch.rand((), device=dev)
    sw = torch.rand(768, device=dev)
    probes = {"B5": (lambda: flash_attention(q, k, v),
                     "flash_attention_causal"),
              "B1": (lambda: photonic_matmul_int8(xq, wq, sx, sw, wt=wt),
                     "photonic_matmul")}

    def profiled(fn, iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]

    def rounds(tag):
        for name, (fn, match) in probes.items():
            for _ in range(5):
                fn()
            kept = [sum(e.count for e in profiled(fn, 50) if match in e.key)
                    for _ in range(3)]
            print(f"[records] {tag}: {name} recorded {kept} of 50 launches "
                  f"({card})", flush=True)

    rounds("fresh process")
    cfg = serving_cfg("base", 224)
    server = StreamServer(cfg, ServerConfig(warm_start=False), seed=0)
    t = torch.randn(4, 147, cfg.d_model, device=dev)
    big = profiled(lambda: forward_vit_tokens(server.params, t, cfg,
                                              server.policy), 50)
    print(f"[records] 50 eager encodes recorded "
          f"{sum(e.count for e in big)} kernels", flush=True)
    rounds("after that session")
    server.warm_start()
    rep = profiled(lambda: server.graphs[147].replay(t), 20)
    print(f"[records] 20 replays of the k=147 graph: "
          f"{sum(e.count for e in rep)} kernels, "
          f"{sum(e.self_device_time_total for e in rep) / 1e3 / 20:.3f} ms "
          f"device a replay ({card})", flush=True)
    rounds("after the graphs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
