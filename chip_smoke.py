#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port still builds, agrees with its
plain PyTorch versions and serves on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. environment: the card's name and power limit (nvidia-smi), TF32 off;
     exits non-zero without a CUDA device or without the repository;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
     nvcc, printing ``-Xptxas -v`` (registers, shared memory, spills);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card at ViT-Base/16-224 and ViT-Tiny/16-224 widths and at ragged
     shapes, with the tolerance stated beside each;
  4. main path: ``StreamServer`` on opto-vit-base-224 + MGNet (random
     weights from seed 0), 2 streams x 32 frames, chunk 8, micro-batch 4,
     buckets 0.25/0.5/0.75/1.0; every frame gets a prediction, every kernel
     launches, and the newest flush re-encoded on the CPU with the plain
     versions gives logits with correlation > 0.999;
  5. numbers: frames/s, then per kernel at a main-path shape its device
     time (torch.profiler) and CUDA-event time, its bound (the larger of
     operations over peak and bytes over 3.35 TB/s), its plain version's
     time and a PyTorch library yardstick the port never calls; a
     torch.profiler breakdown of one serve;
  6. one JSON line ``{"kernels": [...]}`` with each kernel's largest
     absolute error against its plain version and the tolerance held;
  7. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): int8 tensor cores, f32 CUDA cores, HBM
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REPLACES = {
    "photonic_matmul": "src/repro/kernels/photonic_matmul.py:41",
    "flash_attention_masked": "src/repro/kernels/flash_attention.py:157",
    "fused_ffn": "src/repro/kernels/fused_ffn.py:92",
}
SYMBOLS = {
    "photonic_matmul": ("photonic_matmul_s8_kernel",),
    "flash_attention_masked": ("flash_attention_masked_kernel",),
    "fused_ffn": ("fused_ffn_phase0_kernel", "fused_ffn_phase1_kernel"),
}
TOLERANCES = {
    "photonic_matmul": "accumulate bitwise; output 1e-6 relative",
    "flash_attention_masked": "rtol = atol = 2e-5",
    "fused_ffn": "one quant step: rtol = atol = 1e-2 and corr > 0.9999",
}
SOURCES = {
    "photonic_matmul": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
    "flash_attention_masked": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "fused_ffn": "src/repro_torch/kernels/csrc/fused_ffn.cu",
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, match: tuple = (), iters: int = 50,
              warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()`` from torch.profiler:
    the summed device time of the CUDA kernels it launches, or of only
    those whose name holds one of ``match``. Unlike ``cuda_ms`` it leaves
    out the host gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and (not match or any(m in e.key for m in match)))
    if us <= 0:
        fail(f"the profiler saw no device time for kernels {match or 'any'}")
    return us / 1e3 / iters


def qweight(torch, gen, k: int, n: int, bits: int, dev):
    """He-scaled random (k, n) weight -> (int8 codes, (n,) f32 scale)."""
    from repro_torch.core import quant
    w = torch.randn(k, n, generator=gen, device=dev) * (2.0 / k) ** 0.5
    s = quant.absmax_scale(w, bits=bits, axis=-2)
    return quant.quantize(w, s, bits=bits), s.reshape(-1)


def quant_step_close(torch, a, b) -> bool:
    """The reference's kernel-vs-twin tolerance for the fused FFN: within
    1e-2 (rtol and atol) and correlation > 0.9999 (one hidden quant step
    through w2 at a requantization boundary)."""
    if not torch.allclose(a, b, rtol=1e-2, atol=1e-2):
        return False
    if a.numel() > 1 and b.abs().max() > 1e-6:
        c = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]
        return bool(c > 0.9999)
    return True


def check_kernels(torch, dev) -> dict:
    """Phase 3. Returns kernel name -> max |kernel - plain| over its checks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_masked
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {"photonic_matmul": 0.0, "flash_attention_masked": 0.0,
           "fused_ffn": 0.0}

    # B1: (M, K, N) at base-224 / tiny-224 widths and ragged shapes. The
    # int32 accumulate must be bitwise (unit scales; every |acc| < 2^24 at
    # K <= 768, so f32(acc) is exact); the dequantized output within 1e-6
    # relative to the plain version's largest output.
    b1 = [("base qkv/wo k=196", 788, 768, 768), ("base qkv/wo k=49", 200, 768, 768),
          ("base patch embed", 1568, 768, 768), ("base head", 4, 768, 10),
          ("mgnet wqkv", 1576, 192, 576), ("mgnet head_w", 8, 196, 196),
          ("tiny qkv/wo k=196", 788, 192, 192), ("tiny patch embed", 1568, 768, 192),
          ("ragged", 37, 768, 192), ("ragged", 4, 768, 10)]
    for tag, m, k, n in b1:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                                   torch.ones(n, device=dev))
        exact = ref.int_accumulate_ref(xq, wq)
        if not torch.equal(acc.to(torch.int64), exact.to(torch.int64)):
            fail(f"B1 {tag} ({m},{k},{n}): int32 accumulate not bitwise")
        sx = torch.rand((), generator=gen, device=dev) * 1e-2
        sw = torch.rand(n, generator=gen, device=dev) * 1e-2
        got = photonic_matmul_int8(xq, wq, sx, sw)
        want = ref.photonic_matmul_ref(xq, wq, sx, sw)
        e = (got - want).abs().max().item()
        rel = e / max(want.abs().max().item(), 1e-30)
        say(f"[check] B1 {tag:<20s} ({m},{k},{n}): accumulate bitwise, "
            f"max abs err {e:.3e}, rel {rel:.3e} (tol 1e-6)")
        if rel > 1e-6:
            fail(f"B1 {tag}: relative error {rel} > 1e-6")
        err["photonic_matmul"] = max(err["photonic_matmul"], e)

    # B2: f32 end to end, held to rtol = atol = 2e-5 (streaming-softmax
    # reassociation against the materialized softmax).
    def b2(tag, b, h, hk, hv, s, d, dv, mode, scale=None):
        q = torch.randn(b, h, s, d, generator=gen, device=dev)
        k = torch.randn(b, hk, s, d, generator=gen, device=dev)
        v = torch.randn(b, hv, s, dv, generator=gen, device=dev)
        kw = {"scale": scale}
        if mode in ("mask", "dead"):
            m = (torch.rand(b, s, generator=gen, device=dev) > 0.5).float()
            if mode == "dead":
                m[b - 1] = 0.0
            kw["key_mask"] = m
        elif mode == "kv_len":
            kw["kv_len"] = s // 2 + 1
        got = flash_attention_masked(q, k, v, **kw)
        want = ref.flash_attention_masked_ref(q, k, v, **kw)
        e = (got - want).abs().max().item()
        say(f"[check] B2 {tag:<24s} q{tuple(q.shape)} Hk={hk} Hv={hv} "
            f"Dv={dv} {mode}: max abs err {e:.3e} (tol 2e-5)")
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            fail(f"B2 {tag}: max abs err {e}")
        if mode == "dead" and not bool((got[b - 1] == 0).all()):
            fail(f"B2 {tag}: fully masked batch row is not exactly 0")
        err["flash_attention_masked"] = max(err["flash_attention_masked"], e)

    for s in (50, 99, 148, 197):
        b2(f"base bucket k={s - 1}", 4, 12, 12, 12, s, 64, 64, "ones")
    b2("tiny bucket k=196", 4, 3, 3, 3, 197, 64, 64, "ones")
    b2("random key mask", 4, 12, 12, 12, 197, 64, 64, "mask")
    b2("kv_len", 4, 12, 12, 12, 197, 64, 64, "kv_len")
    b2("fully masked row", 4, 12, 12, 12, 99, 64, 64, "dead")
    b2("Hk=1, D != Dv (Eq. 2)", 2, 12, 1, 12, 99, 192, 64, "mask", 1.0)
    b2("GQA Hk=4 Hv=2", 2, 8, 4, 2, 37, 32, 48, "mask")

    # B3: one quant step (quant_step_close), bits (8, 8) and (8, 4), and
    # the packed live_rows prefix.
    def b3(tag, b, n, d, dff, bits, live=None):
        x = torch.randn(b, n, d, generator=gen, device=dev)
        w1q, s1 = qweight(torch, gen, d, dff, bits[0], dev)
        w2q, s2 = qweight(torch, gen, dff, d, bits[1], dev)
        b1 = torch.randn(dff, generator=gen, device=dev) * 0.1
        b2_ = torch.randn(d, generator=gen, device=dev) * 0.1
        args = (x, w1q, s1, b1, w2q, s2, b2_)
        got = fused_ffn(*args, bits=bits, live_rows=live)
        want = ref.fused_ffn_ref(*args, bits=bits, live_rows=live)
        e = (got - want).abs().max().item()
        say(f"[check] B3 {tag:<20s} x({b},{n},{d}) d_ff={dff} bits={bits} "
            f"live_rows={live}: max abs err {e:.3e} (one quant step)")
        if not quant_step_close(torch, got, want):
            fail(f"B3 {tag}: outside one quant step (max abs err {e})")
        if live is not None and not bool((got[:, live:] == 0).all()):
            fail(f"B3 {tag}: dead rows are not exactly 0")
        err["fused_ffn"] = max(err["fused_ffn"], e)

    b3("base k=196", 4, 197, 768, 3072, (8, 8))
    b3("base k=98 (8,4)", 4, 99, 768, 3072, (8, 4))
    b3("base live_rows", 4, 99, 768, 3072, (8, 8), live=60)
    b3("tiny k=196", 4, 197, 192, 768, (8, 8))
    torch.cuda.synchronize()
    return err


def main() -> int:
    import torch

    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this test runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bridge import to_device
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_masked
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8
    from repro_torch.models.vit import (embed_patches, forward_vit_tokens,
                                        vit_matmul_shapes)
    from repro_torch.serving.server import StreamServer, serving_cfg
    from repro_torch.serving.session import ServingConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    card = smi
    say(smi)
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device 0: {name}, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for src, log in sorted(_build.ptxas_report().items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say(f"[ptxas] {src}: {line.strip()}")

    # -- 3. kernel checks --------------------------------------------------
    errs = check_kernels(torch, dev)

    # -- 4. main path ------------------------------------------------------
    cfg = serving_cfg("base", 224)
    sc = ServingConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4,
                       chunk=8)
    server = StreamServer(cfg, sc, n_classes=10, seed=0)
    say(f"[main] {cfg.name} {cfg.img_size}x{cfg.img_size} + MGNet "
        f"(embed {cfg.mgnet_embed}, {cfg.mgnet_heads} heads): "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff={cfg.d_ff}; ladder {list(server.ladder.sizes)}")
    streams = video_fleet(2, img_size=cfg.img_size, patch=cfg.patch,
                          cut_every=32)
    # warm-up (CUDA context, cuBLAS, the allocator): one chunk, not timed
    server.add_session(streams[0], n_frames=8, start=1000)
    server.serve()
    sessions = [server.add_session(st, n_frames=32, start=16 * i)
                for i, st in enumerate(streams)]
    _build.LAUNCHES.clear()
    results = server.serve()
    launches = dict(_build.LAUNCHES)
    say(f"[main] launches on the main path: {launches}")
    for name_ in REPLACES:
        if launches.get(name_, 0) <= 0:
            fail(f"kernel {name_} was never launched on the main path")
    for s in sessions:
        r = results[s.sid]
        want = set(range(s.start, s.start + 32))
        if set(r.predictions) != want or r.frames != 32:
            fail(f"session {s.sid}: {len(r.predictions)} predictions for "
                 f"32 frames")
        say(f"[main] session {s.sid}: {r.summary()} | launches "
            f"{r.bucket_launches}")
    total = sum(r.frames for r in results.values())
    wall = max(r.wall_s for r in results.values())
    fps = total / wall
    fb, logits = server.last_flush, server.last_logits
    if logits.shape != (4, 10) or not bool(torch.isfinite(logits).all()):
        fail(f"flush logits {tuple(logits.shape)} not finite (4, 10)")
    cpu_params = to_device(server.params, "cpu")
    t0 = time.perf_counter()
    plain = forward_vit_tokens(cpu_params, fb.tokens.cpu(), cfg,
                               server.policy, device="cpu")[0]
    plain_s = time.perf_counter() - t0
    a, b = logits.double().cpu().flatten(), plain.double().flatten()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top1 = float((logits.cpu().argmax(-1) == plain.argmax(-1)).float().mean())
    say(f"[main] flush k={fb.bucket[0]} re-encoded on the CPU with the plain "
        f"versions ({plain_s:.1f}s): logits corr {corr:.6f}, top-1 "
        f"agreement {top1:.2f}, max abs diff "
        f"{(a - b).abs().max().item():.3e}")
    if not corr > 0.999:
        fail(f"card vs plain logits correlation {corr} <= 0.999")

    # -- 5. numbers --------------------------------------------------------
    say(f"[numbers] card: {card}")
    for s in sessions:
        say(f"[numbers] stream {s.sid}: {results[s.sid].fps:.2f} frames/s "
            f"({card})")
    say(f"[numbers] aggregate: {total} frames in {wall:.4f}s = "
        f"{fps:.2f} frames/s, {len(server.flush_log)} encode flushes ({card})")

    # per layer of the path, on one chunk of 8 frames: the MGNet gate (host
    # frames in, host scores out), the patch embed, and one encode flush
    # (4 frames) per bucket. CUDA events on the stream, so host gaps
    # between launches count: these are the stages' steady-state spans.
    chunk = streams[0].frames_at(0, 8)["frames"]
    fdev = torch.from_numpy(chunk).to(dev)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        server._score_fn(chunk)
    gate_ms = (time.perf_counter() - t0) * 1e3 / reps
    embed_ms = cuda_ms(lambda: embed_patches(server.params, fdev, cfg,
                                             server.policy), iters=reps)
    toks = embed_patches(server.params, fdev, cfg, server.policy)[:4]
    say(f"[layers] gate (MGNet scores, 8 frames, host clock): {gate_ms:.3f} "
        f"ms; embed (8 frames): {embed_ms:.3f} ms ({card})")
    for kb in server.ladder.sizes:
        enc_ms = cuda_ms(lambda: forward_vit_tokens(
            server.params, toks[:, :kb], cfg, server.policy), iters=reps)
        # the encoder's matmul work for 4 frames (vit_matmul_shapes minus
        # the patch embed, which ran before the gather)
        ops = 4 * sum(2 * m * k * n for m, k, n in
                      vit_matmul_shapes(cfg, kept_patches=kb)[1:])
        say(f"[layers] encode flush k={kb} (4 frames): {enc_ms:.3f} ms, "
            f"{ops / 1e9:.2f} GOP of matmul work = "
            f"{ops / (enc_ms * 1e-3) / 1e12:.3f} TOP/s ({card})")

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []

    # B1 at the largest QKV/wo shape of the path: 4 frames at k=196
    m, k, n = 788, 768, 768
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    wq, sw = qweight(torch, gen, k, n, 8, dev)
    sx = torch.rand((), generator=gen, device=dev) * 1e-2
    fns = (lambda: photonic_matmul_int8(xq, wq, sx, sw),
           lambda: ref.photonic_matmul_ref(xq, wq, sx, sw),
           lambda: torch._int_mm(xq, wq).float() * sx * sw)
    ops = 2 * m * k * n
    nbytes = m * k + k * n + 4 + 4 * n + 4 * m * n
    rows.append(("photonic_matmul", f"({m},{k},{n}) int8", fns,
                 ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES,
                 "torch._int_mm + dequant"))

    # B2 at the largest bucket: (4, 12, 197, 64), all keys live
    bb, h, s, d = 4, 12, 197, 64
    q = torch.randn(bb, h, s, d, generator=gen, device=dev)
    kk = torch.randn(bb, h, s, d, generator=gen, device=dev)
    v = torch.randn(bb, h, s, d, generator=gen, device=dev)
    keep = torch.ones(bb, s, device=dev)
    bmask = (keep > 0)[:, None, None, :]
    fns = (lambda: flash_attention_masked(q, kk, v, keep),
           lambda: ref.flash_attention_masked_ref(q, kk, v, keep),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, kk, v, attn_mask=bmask))
    flops = 2 * bb * h * s * s * d * 2
    nbytes = 4 * (4 * bb * h * s * d + bb * s)
    rows.append(("flash_attention_masked", f"({bb},{h},{s},{d}) f32", fns,
                 flops / PEAK_F32_FLOPS,
                 nbytes / PEAK_BYTES, "F.scaled_dot_product_attention"))

    # B3 at the largest bucket: x (4, 197, 768), d_ff 3072, bits (8, 8)
    x = torch.randn(4, 197, 768, generator=gen, device=dev)
    w1q, s1 = qweight(torch, gen, 768, 3072, 8, dev)
    w2q, s2 = qweight(torch, gen, 3072, 768, 8, dev)
    bias1 = torch.zeros(3072, device=dev)
    bias2 = torch.zeros(768, device=dev)
    args = (x, w1q, s1, bias1, w2q, s2, bias2)
    fns = (lambda: fused_ffn(*args),
           lambda: ref.fused_ffn_ref(*args, bits=(8, 8)), None)
    m = 4 * 197
    ops = 2 * m * 768 * 3072 * 2
    nbytes = (4 * m * 768 + 768 * 3072 * 2 + 4 * (3072 * 2 + 768 * 2)
              + 4 * m * 768)
    rows.append(("fused_ffn", f"x(4,197,768) d_ff 3072 int8", fns,
                 ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES,
                 "none: no single call"))

    # ms, plain_ms and library_ms: device time per call from the profiler
    # (the kernel's own launches; every launch of the plain version and of
    # the library call); event_ms: CUDA-event time of back-to-back wrapper
    # calls, so the wrapper's host work counts where it outlasts the kernel
    kernels = []
    for (kname, shape, (fn, plain_fn, lib_fn), ops_s, bytes_s, lib) in rows:
        ms = device_ms(torch, fn, SYMBOLS[kname])
        event_ms = cuda_ms(fn)
        plain_ms = device_ms(torch, plain_fn)
        lib_ms = device_ms(torch, lib_fn) if lib_fn is not None else None
        bound_s = max(ops_s, bytes_s)
        by = "operations" if ops_s >= bytes_s else "bytes"
        lib_txt = f"{lib_ms:.4f} ms ({lib})" if lib_ms is not None else lib
        say(f"[numbers] {kname} {shape}: kernel {ms:.4f} ms device "
            f"({event_ms:.4f} ms CUDA-event, wrapper included), bound "
            f"{bound_s * 1e3:.4f} ms ({by}; ops {ops_s * 1e3:.4f} ms, bytes "
            f"{bytes_s * 1e3:.4f} ms), plain {plain_ms:.4f} ms, library "
            f"{lib_txt}, {launches.get(kname, 0)} launches on the main path "
            f"({card})")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches.get(kname, 0),
            "max_abs_err": errs[kname], "tol": TOLERANCES[kname],
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": by, "library_ms": lib_ms})

    # where a serve's device time goes, by kernel (one stream, 16 frames)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ps = server.add_session(streams[1], n_frames=16, start=2000)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pres = server.serve()[ps.sid]
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = pres.wall_s * 1e3
    say(f"[profile] 16 frames served under the profiler: wall {wall_ms:.3f} "
        f"ms, device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), "
        f"{len(events)} kernel kinds ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")

    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
