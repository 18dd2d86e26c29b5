#!/usr/bin/env python3
"""How far a per-layer bit plan lets the card's logits part from the CPU's,
and how much of that the numerics alone allow.

    python3 scripts/bitplan_parity.py

opto-vit-base-224 + MGNet (random weights from seed 0), one flush (4
frames of a real chunk, gathered at bucket k = 147 as the server gathers
them), under the uniform 8-bit cache and under T224_PLAN (8, 8, 8, 6, 6,
4, 6, 6, 8, 8, 8, 8). For each cache it prints:

  1. the logits' correlation, card against CPU (the plain versions);
  2. the same on one device against itself with every input token moved
     by one ulp (``torch.nextafter`` toward +inf): what a last-bit
     difference upstream does by itself, on the card and on the CPU;
  3. layer by layer, card against CPU on the same input (the CPU walk's):
     the relative RMS difference of each layer's output, and of the
     walks' outputs after each layer (the card's walk against the CPU's).

Needs a CUDA card (~1 min).
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T224_PLAN = (8, 8, 8, 6, 6, 4, 6, 6, 8, 8, 8, 8)
BUCKET = 147


def corr(torch, a, b) -> float:
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def rel_rms(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def walk(torch, params, tokens, cfg, policy):
    """Each layer's input and output along one encode (the encoder's own
    steps: the [cls] row prepended, ``layer_view`` per layer)."""
    from repro_torch.models.layers import layer_view
    from repro_torch.models.vit import encoder_layer_step

    b, _, d = tokens.shape
    cls = params["cls"].expand(b, 1, d) + params["pos"][:, :1]
    x = torch.cat([cls.to(tokens.dtype), tokens], dim=1)
    ins, outs = [], []
    for i in range(cfg.n_layers):
        ins.append(x)
        x = encoder_layer_step(x, layer_view(params["blocks"], i), cfg,
                               policy)
        outs.append(x)
    return ins, outs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from dataclasses import replace

    from repro_torch.bridge import from_jax_params, init_vit, to_device
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.models.layers import layer_view
    from repro_torch.models.vit import (embed_patches, encoder_layer_step,
                                        forward_vit_tokens)
    from repro_torch.serving.server import (ServerConfig, StreamServer,
                                            _gather_topk_rows, serving_cfg)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          flush=True)
    cfg = serving_cfg("base", 224)
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    stream = video_fleet(1, img_size=224, patch=16, cut_every=32)[0]
    frames = stream.frames_at(0, 8)["frames"]
    sc = ServerConfig(warm_start=False)
    for tag, plan in (("uniform 8", ()), ("T224_PLAN", T224_PLAN)):
        srv = StreamServer(cfg, replace(sc, bit_plan=plan), params=params)
        dev, pol = srv.device, srv.policy
        toks = embed_patches(srv.params, torch.from_numpy(frames).to(dev),
                             cfg, pol)
        order = torch.argsort(torch.from_numpy(srv._score_fn(frames)).to(
            dev), dim=-1, descending=True, stable=True)
        t = _gather_topk_rows(toks, order, BUCKET)[:4].contiguous()
        cpu_params = to_device(srv.params, "cpu")
        card = forward_vit_tokens(srv.params, t, cfg, pol)[0]
        plain = forward_vit_tokens(cpu_params, t.cpu(), cfg, pol,
                                   device="cpu")[0]
        up = torch.nextafter(t, torch.full_like(t, float("inf")))
        card_ulp = forward_vit_tokens(srv.params, up, cfg, pol)[0]
        plain_ulp = forward_vit_tokens(cpu_params, up.cpu(), cfg, pol,
                                       device="cpu")[0]
        print(f"[{tag}] k={BUCKET}: card vs CPU corr "
              f"{corr(torch, card, plain):.6f}, top-1 "
              f"{(card.cpu().argmax(-1) == plain.argmax(-1)).sum().item()}/4; "
              f"inputs one ulp up: card vs card "
              f"{corr(torch, card_ulp, card):.6f}, CPU vs CPU "
              f"{corr(torch, plain_ulp, plain):.6f}", flush=True)
        c_ins, c_outs = walk(torch, cpu_params, t.cpu(), cfg, pol)
        g_ins, g_outs = walk(torch, srv.params, t, cfg, pol)
        for i in range(cfg.n_layers):
            one = encoder_layer_step(c_ins[i].to(dev),
                                     layer_view(srv.params["blocks"], i),
                                     cfg, pol)
            print(f"[{tag}] layer {i:2d} ({srv.layer_bits[i] if srv.layer_bits else 8} "
                  f"bits): same input, card vs CPU rel RMS "
                  f"{rel_rms(torch, one, c_outs[i]):.3e}; the walks after "
                  f"it {rel_rms(torch, g_outs[i], c_outs[i]):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
