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
     card at ViT-Base/16-224, ViT-Tiny/16-224, ViT-Large/16-224 and
     qwen2-1.5b widths, at ragged shapes and, for B1, B2, B5 and B6, at
     their tiles', rings' and splits' edges (B6 also bitwise from call to
     call; B2 also in the (B, S, H, D) layout read by strides and, on
     both tensor-core entries, against its 3xTF32 emulation (the wide
     entry's in its D-chunk order); B3's K-major entry also bitwise against its
     first design), each naming the entry it took, with the tolerance
     stated beside each; and the int32 accumulate of path c's FFN twin at
     ragged (K, N), bitwise;
  4. main paths, each driven with the launch counts set to 0 just before
     it and read just after:
     a. ``StreamServer`` on opto-vit-base-224 + MGNet (random weights from
        seed 0), warm-started: one CUDA graph per bucket encode, which
        every flush replays; 2 streams x 32 frames, chunk 8, micro-batch
        4, buckets 0.25/0.5/0.75/1.0; every frame gets a prediction, B1-B3
        launch (counted on every replay), and the newest flush re-encoded
        on the CPU with the plain versions gives logits with correlation
        > 0.999; every B2 launch took the tensor-core entry, every B1
        launch at K = 768 and every B3 launch the K-major one. Then
        ``[graphs]``: at every bucket, gathered and one-shape, a replay
        gives the eager encode's logits bitwise with the same launch
        counts; the same 2 streams served through the graphs equal, per
        stream and per flush, bitwise, two solo eager ``ServingEngine``
        runs; a one-shape serve keeps the routing and modeled energy of
        the gathered one; a ``max_wait_chunks=1`` serve (micro-batch 8,
        chunk 3) pads more flushes than the same traffic without the
        deadline and keeps its routing and energy. Then ``[bitplan]``: B1
        (K-major, M = 788 and 200) and B3 (x (4, 197, 768), d_ff 3072)
        with x and weights quantized at widths 6 and 4 ((6, 6), (4, 4),
        (6, 4) for B3), each against its plain version as at 8 bits; the
        same traffic served by ``StreamServer(ServerConfig(bit_plan=
        T224_PLAN))`` (per-layer widths 8/6/4, mean 7.0): the plan in the
        cache (each layer's largest w1 code its width's qmax), every
        bucket's replay bitwise its eager encode at 49 / 12 / 12 B1 / B2 /
        B3 launches a flush, every frame predicted, frames/s and the
        modeled KFPS/W beside the uniform serve in alternating serves, a
        flush against the CPU (each layer on the same input within one
        quant step, corr > 0.9999; end to end within twice the distance
        that one ulp of input moves the logits on either device alone: a
        4-bit layer puts corr > 0.999 out of reach,
        scripts/bitplan_parity.py); then ``calibrate_bits(6.5)`` on that
        warmed, graphed server: its plan, scoring and re-capture
        wall times, every new replay bitwise the eager encode under the
        new cache, a graph kept from before the calibration that must
        replay something else (the planted fault), and the memory
        allocated before and after (within 10%);
     b. the LM serving path on qwen2-1.5b at full width (28 layers, random
        bf16 weights from seed 0): ``generate`` (batch 4, prompt 128
        prefilled by the decode step, 32 greedy tokens, cache 512) and one
        ``prefill_fn`` over the same prompt; tokens in the vocab, B6 launched
        160 x 28 times and B5 28 times, the full-prompt forward agrees with
        the decode loop at every prompt position (and the same check
        rejects a causal mask planted one key off), and the last decode
        step re-run on the CPU with the plain versions gives logits with
        correlation > 0.999;
     c. model-sharded serving: 2 ranks on the one card (gloo), mesh
        (data 1, model 2), ``StreamServer`` with ``model_shards=2`` on
        opto-vit-large-224 + MGNet (weights drawn once from seed 0 in this
        process and handed to the ranks as shared CPU tensors), the traffic
        of path a; each rank checks that every flush went through the
        sharded encode and that the dequant epilogue launched 2 x 24 times
        a flush and that B2 and B1 took the entries path a requires, and
        every flush's logits must correlate > 0.99999 with the
        same flush served unsharded on the card; the ranks warm eagerly
        and capture no graph (two planted faults, one
        that skips the int32 all-reduce and one that leaves the absmax
        scopes local to the rank, must fail that check);
     d. ``[composed]``, after the kernel table: B2's wide tensor-core
        entry at Eq. 2's (D, Dv) = (768, 64) with one shared key head and v
        a strided head view (scale 1.0, all keys live and a scattered mask
        with a dead batch row), and at ViT-Large's (1024, 64) with 16
        heads, B1 at (788, 768, 3072), (788, 3072,
        768) and (788, 64, 768), and ``int_accumulate_pallas`` bitwise,
        each against its plain version; then opto-vit-base-224 served as
        4a's traffic through the graphed server under (a) the reference
        CLI's default, photonic_pallas + xla attention + xla FFN (73 B1 a
        flush), and (b) Eq. 2, photonic_pallas + flash + xla FFN with
        ``attn_impl="decomposed"`` (205 B1 and 12 B2 on the wide entry a
        flush, none on the SIMT one): every bucket's replay bitwise its
        eager encode with equal
        launch counts, every frame predicted, B1 at K 3072 (and K 64 under
        Eq. 2) launched, the newest flush against the CPU (corr > 0.999,
        equal argmax, each layer corr > 0.9999), frames/s beside 4a's;
        (c) ``run_dense`` on 4a's server over the same streams (one CUDA
        graph a chunk: 50 B1, 12 B2, 12 B3): the same frames, prediction
        keys and MGNet scorings as 4a's bucketed serve at a higher modeled
        energy a frame, dense and bucketed frames/s and their ratio (a
        reading); the bf16, qat and photonic_sim encoders, one flush each,
        against the CPU (corr > 0.999, equal argmax);
     e. ``[noise]``, after 4d: the noise-draw kernel against its plain
        version at (768, 768), (768, 3072), (3072, 768) and (197, 50)
        (bits bitwise, the multiplier within 1e-6, codes bitwise f32(w)
        times it, the shot readout within 1e-6 relative); then
        opto-vit-base-224 served as 4a's traffic through the graphed
        server under calibrated device noise: (A) photonic_sim + flash +
        xla FFN with drift 0.01 nm a frame, wander 0.01 nm and a 0.08 nm
        recalibration bound, (B) photonic_pallas + xla + xla under the
        default NoiseSpec. Each: every bucket's replay bitwise its eager
        encode at a pinned DriftState, with equal launch counts (146
        noise_draw, 12 B2 on the tensor-core entry under (A), no B1 or
        B3 a flush) and a replay at the next frame different; every
        frame predicted, 4a's bucket hits. (A) also: a planted fault (a
        replay over a state tensor left at the old frame) must differ
        from the eager encode at the new one; at least one recalibration,
        billed (energy a frame above (B)'s), the graphs still bitwise
        eager after it; the newest flush re-encoded on the CPU at its
        state, corr > 0.999 and equal argmax. Readings: noisy vs clean
        logits, frames/s beside 4a's, a noisy flush's replay span a
        bucket;
     f. ``[control]``, after 4e: the serving control plane on 4a's model
        and traffic through the graphed server. (a) ``autotune=True,
        retune_every=8`` with natural routing: ``autotune_prepare``
        probes, prices the probed buckets on the H100 roofline and, by
        pricing them, captures their graphs (each replay bitwise its
        eager encode); the cost table, each priced bucket's replay time
        beside its roofline bound, the controller's report and its
        held-out median relative error, and frames/s beside the static 4a
        server's serve of the same traffic right after (which must record
        no flush time); every frame predicted, 49 B1, 12 B2 (64, 64) and
        12 B3 a flush, no clamp violation, the controller calibrated. (b)
        ``force_bucket=0.5``, autotuned against static: predictions and
        flush logs bitwise equal. (c) a ``watchdog=True`` server whose
        13th flush this script (not the package) delays by 50 ms: that
        flush must be among ``straggler_flags`` (the other flags are
        counted), every flush in the telemetry, predictions bitwise 4a's;
     g. ``[faults]``, after 4f: faults, checkpoints and migration on 4a's
        model, params and traffic through the graphed server, each
        sub-phase on a server of its own, held to a clean re-serve on
        4a's server. (A) ``FaultSpec(flush_fault_rate=0.10)``: every
        session completes with retries, predictions and flush log bitwise
        the clean serve's, 49 B1, 12 B2 and 12 B3 a flush, frames/s
        beside the clean serve's (a reading; the reference's gate is
        0.7x). (B) session 1 hard-fails at its chunk 2: it comes back
        poisoned with the reason, no flush after the failure carries its
        frames, session 0 bitwise its solo serve. (C) ``crash_at_round=2``
        with a checkpoint every round through ``serve_with_restarts``:
        one restart, predictions bitwise 4a's, the restored server's
        graphs bitwise its eager encode. (D) paused at round 2, session 1
        exported and adopted by a second graphed server: both bitwise.
        4a's traffic fills every queue by the end of each round (16 full
        flushes), so its snapshots carry no queued rows; the card test
        ``test_checkpoint_and_migration_on_a_graphed_server`` restores
        and migrates queued rows at smoke width. (E) under 4e (B)'s
        NoiseSpec: a checkpoint at round 2 restored into a fresh server
        holds the snapshot's DriftState in its state
        tensor at every replay, predictions bitwise the uninterrupted
        serve's; a planted restore that leaves ``_written`` stale must
        fail that check. (F) ``stall_rate`` 0.15 under ``watchdog=True``:
        every stall after the detector's 10-flush warm-up is among
        ``straggler_flags``. (A) and (F) take the first fault seed (from
        the reference's 7 and 6) whose sites, hashed on the host over the
        clean serve's flush sites, exercise the check. Readings: a
        ``checkpoint()``'s wall ms, a restore's read and re-capture s,
        the phase's seconds;
     h. ``[fleet]``, after 4g: ``serving.fleet.FleetRouter`` and the 1-D
        data mesh on opto-vit-base-224 + MGNet (seed 0). (A) 4 in-process
        workers on one shared cache, each with its own CUDA graphs over
        it, serve the reference fleet CLI's 8 streams (frames 32 x (1, 3,
        2, ...), stream i from frame 8 i, force_bucket 0.5) under cost
        placement, then rr: every job predicted and bitwise (predictions
        and each flush's logits) its solo serve on a graphed server over
        the same cache, B1-B3 launched on every worker on the entries 4a
        requires, one aggregated dead-bucket warning. (B) rr placement,
        ``rebalance``, one ``migrate`` and ``drain(1)`` through checkpoint
        / restore: every job bitwise its solo serve, the replacement's
        replays bitwise its eager encode. (C) two ``spawn=True`` workers
        on the card: each reports its launches (B1-B3 on 4a's entries) and
        its graphs, and compiled no kernel (the parent built the library);
        worker 0's jobs (seed 0) bitwise their solo serves. (D) 2 gloo
        ranks on the card on the data mesh (``mesh="auto"``, no model
        shards), 4a's traffic: every flush's logits bitwise the unsharded
        eager card serve, B1 inside the split only at half a flush's rows,
        every B3 launch through its host-split binding, and the newest
        flush re-encoded with the absmax scopes left local to the rank
        (a planted fault) not bitwise. Readings: worker walls, aggregate
        frames/s of 4 workers (cost, rr) against one server with all 8
        streams (the reference's gates, 1.5x and 1.15x, are structural and
        not applied), the data mesh's frames/s and collective ms a flush;
  5. numbers: frames/s, decode tokens/s and prefill tokens/s, then per
     kernel at a main-path shape its device time (torch.profiler) and
     CUDA-event time, its bound (the larger of operations over the peak of
     their type and bytes over 3.35 TB/s; B2 at the TF32 rate of its
     three passes and B5 at the bf16 rate, both also at the f32 rate), its
     plain version's time and a PyTorch library yardstick the port never
     calls (B3 also its first design and each of its three launches; B1
     also at path d's three shapes, B2's wide entry also at Eq. 2's
     shape with its 3xTF32 bound, both in the kernels line as
     ``ms_by_shape`` / ``wide_eq2``); the noise-draw kernel (after 4e)
     at (3072, 768) and (768, 768), bound by its integer operations,
     beside its plain version and ``torch.randn`` (another generator, a
     yardstick: ``library_ms`` null);
     per bucket one 4a flush's encode span eager and replayed (CUDA
     events) and its device time (the profiler, of the eager encode);
     B1 and B3 at each bit-plan width beside their 8-bit calls (device
     time); torch.profiler breakdowns of a 16-frame serve through the
     graphs and eagerly, and of 8 decode steps;
  6. one JSON line ``{"kernels": [...]}`` with each kernel's largest
     absolute error against its plain version and the tolerance held
     (seven kernels: B1-B6 and noise_draw);
  7. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): int8 and bf16 tensor cores, f32 CUDA
# cores, HBM
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz (the clock
# the f32 peak implies: 67e12 / (132 x 128 x 2)); f32 instructions (an FMA
# one) at half the f32 flop peak
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_F32_INSTR = PEAK_F32_FLOPS / 2

REPLACES = {
    "photonic_matmul": "src/repro/kernels/photonic_matmul.py:41",
    "flash_attention_masked": "src/repro/kernels/flash_attention.py:157",
    "fused_ffn": "src/repro/kernels/fused_ffn.py:92",
    "flash_attention_causal": "src/repro/kernels/flash_attention.py:57",
    "flash_decode": "src/repro/kernels/flash_decode.py:35",
    "dequant_epilogue": "src/repro/kernels/fused_ffn.py:236",
    # no TPU kernel: the jax.random draws of the reference's noise model
    "noise_draw": "src/repro/core/noise.py:192",
}
# B3's K-major entry (three launches) and its first design (N-major)
B3_KMAJOR = ("fused_ffn_kmajor_phase0_kernel", "fused_ffn_requant_kernel",
             "fused_ffn_kmajor_phase1_kernel")
B3_FIRST_DESIGN = ("fused_ffn_phase0_kernel", "fused_ffn_phase1_kernel")
# kernels one counted launch runs (B3's K-major entry: phase 0, requant,
# phase 1)
PER_LAUNCH = {"fused_ffn": len(B3_KMAJOR)}
SYMBOLS = {
    "photonic_matmul": ("photonic_matmul_s8_kmajor_kernel",
                        "photonic_matmul_s8_kernel"),
    "flash_attention_masked": ("flash_attention_masked_tc_kernel",
                               "flash_attention_masked_wide_kernel",
                               "flash_attention_masked_wide_split_kernel",
                               "flash_attention_masked_kernel"),
    "fused_ffn": B3_KMAJOR + B3_FIRST_DESIGN,
    "flash_attention_causal": ("flash_attention_causal_kernel",
                               "flash_attention_causal_mma_kernel"),
    "flash_decode": ("flash_decode_cluster_kernel",),
    "dequant_epilogue": ("dequant_epilogue_kernel",),
    "noise_draw": ("noise_transmission_kernel", "noise_readout_shot_kernel",
                   "noise_draw_bits_kernel"),
}
TOLERANCES = {
    "photonic_matmul": "accumulate bitwise; output 1e-6 relative",
    "flash_attention_masked": "rtol = atol = 2e-5 (the plain version in f64)",
    "fused_ffn": "one quant step: rtol = atol = 1e-2 and corr > 0.9999",
    "flash_attention_causal": "f32 rtol = atol = 2e-5; bf16 1 ulp of max |o|",
    "flash_decode": "f32 rtol = atol = 2e-5; bf16 1 ulp of max |o|",
    "dequant_epilogue": "bitwise",
    "noise_draw": ("bits bitwise; multiplier 1e-6 absolute; codes bitwise "
                   "f32(w) * multiplier; shot readout 1e-6 relative"),
}
SOURCES = {
    "photonic_matmul": "src/repro_torch/kernels/csrc/photonic_matmul.cu",
    "flash_attention_masked": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "fused_ffn": "src/repro_torch/kernels/csrc/fused_ffn.cu",
    "flash_attention_causal":
        "src/repro_torch/kernels/csrc/flash_attention_causal.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "dequant_epilogue": "src/repro_torch/kernels/csrc/dequant_epilogue.cu",
    "noise_draw": "src/repro_torch/kernels/csrc/noise_draw.cu",
}
VIT_KERNELS = ("photonic_matmul", "flash_attention_masked", "fused_ffn")
# the LM main path: qwen2-1.5b serving, batch 4, prompt 128, 32 tokens
LM_BATCH, LM_PROMPT, LM_GEN, LM_CACHE = 4, 128, 32, 512
# the sharded path: opto-vit-large over 2 ranks (mesh (1, 2)) on one card
SHARDS = 2
# every sharded flush's logits against the unsharded card serve: they
# differ by B3 against the FFN twin only (one quant step at most); a scale
# left local to a rank reads ~0.998, a missing int32 all-reduce ~0.6
FLUSH_CORR = 0.99999
# B4's shapes on that path, 4 frames x 197 tokens by d_ff / 2 (after w1's
# local columns) and by d (after w2's all-reduce), a ragged one and M = 1
B4_SHAPES = (("large w1 columns", 788, 2048), ("large w2 psum", 788, 1024),
             ("ragged", 37, 1003), ("M = 1", 1, 2048))
# the [bitplan] path: opto-vit-base-224 under the reference's mixed plan
# (benchmarks/mixed_precision_bench.py::T224_PLAN: 8-bit head and tail,
# 6-bit shoulders, one 4-bit middle layer, mean 7.0 bits), then a plan
# calibrated to this mean width on the same server
T224_PLAN = (8, 8, 8, 6, 6, 4, 6, 6, 8, 8, 8, 8)
CALIB_TARGET = 6.5
# B1 (M, bits) and B3 (w1, w2) bits at the plan's widths, each timed
# beside its 8-bit call in the same run
B1_WIDTHS = ((788, 8), (788, 6), (788, 4), (200, 8), (200, 4))
B3_WIDTHS = ((8, 8), (6, 6), (4, 4), (6, 4))
# path 4d: B2 under Eq. 2 at base-224 (q (B, H, n, d_model) against the
# one shared key head x, v (B, H, n, d_head)) and B1 at the composed
# FFN's w1 / w2 and Eq. 2's per-head W_K^T / sqrt(dh), 4 frames x 197
EQ2_SHAPE = (4, 12, 197, 768, 64)
COMPOSED_B1 = {"composed FFN w1": (788, 768, 3072),
               "composed FFN w2": (788, 3072, 768),
               "Eq. 2 W_K^T per head": (788, 64, 768)}
# path 4e: the noise-draw kernel at base-224's weight shapes and a ragged
# one; the noisy serving point's operating point (drift, wander and a
# recalibration bound the 64 frames cross)
NOISE_SHAPES = ((768, 768), (768, 3072), (3072, 768), (197, 50))
NOISE_KW = dict(drift_rate_nm=0.01, wander_sigma_nm=0.01,
                recal_bound_nm=0.08)
# the kernel's checks: each branch of its multiplier (the wander normal and
# the FPV normal are drawn only when their sigma is above 0)
NOISE_CHECK_SPECS = {"wander+fpv": NOISE_KW, "default (no wander)": {},
                     "no fpv": dict(NOISE_KW, fpv_sigma=0.0)}
# 32-bit integer ops of one threefry2x32 draw (2 + 20 rounds x 3 + 5 key
# injections x 2, the counter's split and the output xor) and of turning
# its bits into a float; f32 instructions an element of the multiplier
# (two normals at ~35 each: erfinv's log1p and 8 FMAs; the Lorentzian and
# the products ~18)
OPS_PER_DRAW = 75 + 2
F32_PER_CODE = 90


def vit_entry_fault(launches: dict) -> str | None:
    """Why the ViT kernels' launches of a serving run (paths a and c) did
    not take the entries the path requires, or None: every B2 launch the
    tensor-core entry, every B1 launch at K = 768 the K-major entry (and
    some did), every B3 launch the K-major entry, and every launch counted
    under one entry."""
    b1, b2, b3 = (launches.get(k, 0) for k in (
        "photonic_matmul", "flash_attention_masked", "fused_ffn"))
    if launches.get("fused_ffn.kmajor", 0) != b3 or launches.get(
            "fused_ffn.nmajor", 0):
        return (f"fused_ffn: {launches.get('fused_ffn.kmajor', 0)} K-major, "
                f"{launches.get('fused_ffn.nmajor', 0)} N-major launches of "
                f"{b3}")
    if launches.get("flash_attention_masked.tc", 0) != b2 or b2 == 0:
        return (f"{launches.get('flash_attention_masked.tc', 0)} of {b2} "
                f"flash_attention_masked launches took the tensor-core entry")
    if launches.get("photonic_matmul.nmajor.K768", 0) or not launches.get(
            "photonic_matmul.kmajor.K768", 0):
        return (f"photonic_matmul at K = 768: "
                f"{launches.get('photonic_matmul.kmajor.K768', 0)} K-major, "
                f"{launches.get('photonic_matmul.nmajor.K768', 0)} N-major "
                f"launches")
    entries = sum(launches.get(f"photonic_matmul.{e}", 0)
                  for e in ("kmajor", "nmajor"))
    if entries != b1:
        return f"photonic_matmul: {entries} entry launches for {b1} launches"
    return None


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
              warmup: int = 5, counter: str | None = None,
              per_launch: int = 1) -> tuple[float, int]:
    """Mean device milliseconds per call of ``fn()`` from torch.profiler:
    the summed device time of the CUDA kernels it launches, or of only
    those whose name holds one of ``match``. Unlike ``cuda_ms`` it leaves
    out the host gaps between launches. Returns (ms, profiling passes).

    A pass that records no such kernel is said, with the launches the
    wrapper counted under ``counter`` in that pass (so a kernel that did
    not launch is told apart from one the profiler missed), and run
    again; a fifth such pass fails. With ``counter`` a pass must also
    record at least ``per_launch`` kernel instances (B3's K-major entry:
    3) for each launch the wrapper counted: a pass that lost some of them
    would read below the true time (one run's dequant epilogue read under its bytes bound after an
    empty pass, PERF.md). One run of the cluster-launched flash decode had
    an empty pass too (PERF.md, open questions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 6):
        before = _build.LAUNCHES[counter] if counter else 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and (not match or any(m in e.key for m in match))]
        us = sum(e.self_device_time_total for e in events)
        recorded = sum(e.count for e in events)
        launched = _build.LAUNCHES[counter] - before if counter else 0
        if us > 0 and recorded >= launched * per_launch:
            return us / 1e3 / iters, attempt
        counted = (f"; {counter} counted {launched} of {iters} calls' "
                   f"launches in it" if counter else "")
        say(f"[numbers] profiling pass {attempt} recorded {recorded} "
            f"instances ({us:.1f} us) of kernels {match or 'any'}{counted}")
    fail(f"the profiler lost device time for kernels {match or 'any'}")


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
    from repro_torch.kernels.flash_attention import (WIDE_D_CHUNK,
                                                     flash_attention_masked,
                                                     masked_entry_for)
    from repro_torch.kernels.fused_ffn import (ffn_entry_for, fused_ffn,
                                               fused_ffn_nmajor,
                                               int_accumulate)
    from repro_torch.kernels.photonic_matmul import (entry_for,
                                                     photonic_matmul_int8)

    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {"photonic_matmul": 0.0, "flash_attention_masked": 0.0,
           "fused_ffn": 0.0}

    # B1: (M, K, N) at base-224 / tiny-224 widths and ragged shapes. The
    # int32 accumulate must be bitwise (unit scales; every |acc| < 2^24 at
    # K <= 768, so f32(acc) is exact); the dequantized output within 1e-6
    # relative to the plain version's largest output.
    # The weight reaches the K-major entry as its K-major copy, as the
    # quantize-once cache holds it (QuantizedWeight.wt).
    b1 = [("base qkv/wo k=196", 788, 768, 768), ("base qkv/wo k=49", 200, 768, 768),
          ("base patch embed", 1568, 768, 768), ("base head", 4, 768, 10),
          ("mgnet wqkv", 1576, 192, 576), ("mgnet head_w", 8, 196, 196),
          ("tiny qkv/wo k=196", 788, 192, 192), ("tiny patch embed", 1568, 768, 192),
          ("ragged", 37, 768, 192), ("ragged", 4, 768, 10),
          ("ring edge K=32", 65, 32, 64), ("ring edge K=96", 63, 96, 128),
          ("ring edge M=1", 1, 768, 768), ("large qkv (2 ranks)", 788, 1024, 512)]
    for tag, m, k, n in b1:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        wt = wq.t().contiguous()
        acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                                   torch.ones(n, device=dev), wt=wt)
        exact = ref.int_accumulate_ref(xq, wq)
        if not torch.equal(acc.to(torch.int64), exact.to(torch.int64)):
            fail(f"B1 {tag} ({m},{k},{n}): int32 accumulate not bitwise")
        sx = torch.rand((), generator=gen, device=dev) * 1e-2
        sw = torch.rand(n, generator=gen, device=dev) * 1e-2
        got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
        want = ref.photonic_matmul_ref(xq, wq, sx, sw)
        e = (got - want).abs().max().item()
        rel = e / max(want.abs().max().item(), 1e-30)
        say(f"[check] B1 {tag:<20s} ({m},{k},{n}) {entry_for(k)} entry: "
            f"accumulate bitwise, max abs err {e:.3e}, rel {rel:.3e} "
            f"(tol 1e-6)")
        if rel > 1e-6:
            fail(f"B1 {tag}: relative error {rel} > 1e-6")
        err["photonic_matmul"] = max(err["photonic_matmul"], e)

    # B2: f32 end to end, held to rtol = atol = 2e-5 against the plain
    # version evaluated in float64, the exact function (at the unscaled
    # Eq. 2 check below, scores spread ~14, the plain version in f32 is
    # itself 2-3e-5 off; its distance is printed too); the tensor-core
    # entries also against their 3xTF32 emulation (on the CPU; the wide
    # entry's in its D-chunk order), at the same limit. "bshd" draws q, k,
    # v in the projections' (B, S, H, D) layout and hands the kernel
    # (B, H, S, D) views, read by strides.
    def b2(tag, b, h, hk, hv, s, d, dv, mode, scale=None, layout="bhsd"):
        def rnd(heads, dim):
            if layout == "bhsd":
                return torch.randn(b, heads, s, dim, generator=gen, device=dev)
            return torch.randn(b, s, heads, dim, generator=gen,
                               device=dev).transpose(1, 2)
        q, k, v = rnd(h, d), rnd(hk, d), rnd(hv, dv)
        kw = {"scale": scale}
        if mode in ("mask", "dead"):
            m = (torch.rand(b, s, generator=gen, device=dev) > 0.5).float()
            if mode == "dead":
                m[b - 1] = 0.0
            kw["key_mask"] = m
        elif mode == "kv_len":
            kw["kv_len"] = s // 2 + 1
        got = flash_attention_masked(q, k, v, **kw)
        want = ref.flash_attention_masked_ref(q.double(), k.double(),
                                              v.double(), **kw).float()
        e = (got - want).abs().max().item()
        e32 = (got - ref.flash_attention_masked_ref(q, k, v, **kw)).abs().max()
        entry = masked_entry_for(d, dv)
        emu = ""
        if entry != "simt":
            cpu = {k_: (w.cpu() if torch.is_tensor(w) else w)
                   for k_, w in kw.items()}
            em = ref.flash_attention_masked_tc_ref(
                q.cpu(), k.cpu(), v.cpu(), **cpu,
                d_chunk=WIDE_D_CHUNK if entry == "wide" else None).to(dev)
            emu = f", {(got - em).abs().max().item():.3e} against the emulation"
            if not torch.allclose(got, em, rtol=2e-5, atol=2e-5):
                fail(f"B2 {tag}: outside 2e-5 of its 3xTF32 emulation")
        say(f"[check] B2 {tag:<24s} q{tuple(q.shape)} {layout} Hk={hk} "
            f"Hv={hv} Dv={dv} {mode} {entry} entry: max abs err {e:.3e} "
            f"against the plain version in f64 ({e32.item():.3e} in f32)"
            f"{emu} (tol 2e-5)")
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
    b2("base bucket k=196", 4, 12, 12, 12, 197, 64, 64, "ones", layout="bshd")
    b2("large, 8 heads a rank", 4, 8, 8, 8, 197, 64, 64, "mask",
       layout="bshd")
    b2("kv_len, ragged S=50", 4, 12, 12, 12, 50, 64, 64, "kv_len",
       layout="bshd")
    for s_ in (1, 33, 63, 64, 65, 129):      # the 32-key / 64-row tile edges
        b2("tile edge", 2, 4, 4, 4, s_, 64, 64, "mask", layout="bshd")
    b2("dead row, GQA Hk=Hv=4", 2, 12, 4, 4, 99, 64, 64, "dead",
       layout="bshd")
    b2("Hk=1, D != Dv (Eq. 2)", 2, 12, 1, 12, 99, 192, 64, "mask", 1.0)
    b2("Eq. 2 tiny, dead row", 2, 3, 1, 3, 50, 192, 64, "dead", 1.0,
       layout="bshd")
    b2("wide, GQA Hk=2 Hv=4", 2, 8, 2, 4, 33, 256, 64, "kv_len",
       layout="bshd")
    b2("GQA Hk=4 Hv=2", 2, 8, 4, 2, 37, 32, 48, "mask")

    # B3: one quant step (quant_step_close), bits (8, 8) and (8, 4), and
    # the packed live_rows prefix; the weights reach the K-major entry as
    # their K-major copies, as the cache holds them, and its output must be
    # bitwise the first design's (the N-major entry, called directly)
    def b3(tag, b, n, d, dff, bits, live=None):
        x = torch.randn(b, n, d, generator=gen, device=dev)
        w1q, s1 = qweight(torch, gen, d, dff, bits[0], dev)
        w2q, s2 = qweight(torch, gen, dff, d, bits[1], dev)
        b1 = torch.randn(dff, generator=gen, device=dev) * 0.1
        b2_ = torch.randn(d, generator=gen, device=dev) * 0.1
        args = (x, w1q, s1, b1, w2q, s2, b2_)
        got = fused_ffn(*args, bits=bits, live_rows=live,
                        w1t=w1q.t().contiguous(), w2t=w2q.t().contiguous())
        first = fused_ffn_nmajor(*args, bits=bits, live_rows=live)
        want = ref.fused_ffn_ref(*args, bits=bits, live_rows=live)
        e = (got - want).abs().max().item()
        entry = ffn_entry_for(d, dff)
        say(f"[check] B3 {tag:<20s} x({b},{n},{d}) d_ff={dff} bits={bits} "
            f"live_rows={live} {entry} entry: max abs err {e:.3e} (one "
            f"quant step), bitwise the first design "
            f"{torch.equal(got, first)}")
        if not quant_step_close(torch, got, want):
            fail(f"B3 {tag}: outside one quant step (max abs err {e})")
        if entry != "kmajor" or not torch.equal(got, first):
            fail(f"B3 {tag}: the {entry} entry is not bitwise the first "
                 f"design (max {(got - first).abs().max().item()})")
        if live is not None and not bool((got[:, live:] == 0).all()):
            fail(f"B3 {tag}: dead rows are not exactly 0")
        err["fused_ffn"] = max(err["fused_ffn"], e)

    b3("base k=196", 4, 197, 768, 3072, (8, 8))
    b3("base k=98 (8,4)", 4, 99, 768, 3072, (8, 4))
    b3("base live_rows", 4, 99, 768, 3072, (8, 8), live=60)
    b3("tiny k=196", 4, 197, 192, 768, (8, 8))
    b3("ragged M=37", 1, 37, 768, 3072, (8, 8))
    b3("M=1", 1, 1, 768, 3072, (8, 8))

    # the int32 accumulate of path c's twin at a ragged (K, N), which
    # torch._int_mm alone refuses: padded, bitwise the plain version
    for m, k, n in ((5, 37, 1003), (37, 196, 13)):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        ok = torch.equal(int_accumulate(xq, wq), ref.int_accumulate_ref(xq, wq))
        say(f"[check] int_accumulate ragged ({m},{k},{n}): bitwise {ok} "
            f"(tol bitwise)")
        if not ok:
            fail(f"int_accumulate ({m},{k},{n}) not bitwise")
    torch.cuda.synchronize()
    return err


def bf16_ulp(torch, t) -> float:
    """1 bf16 ulp of the largest |t|: 2^(floor(log2 max) - 7)."""
    import math
    return 2.0 ** (math.floor(math.log2(t.abs().max().item())) - 7)


def held(torch, got, want) -> tuple[float, bool, str]:
    """(max abs err, within tolerance, tolerance) of a B5/B6 check: f32 is
    held to rtol = atol = 2e-5, bf16 to 1 bf16 ulp of the plain version's
    largest |o|."""
    e = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        ulp = bf16_ulp(torch, want.float())
        return e, e <= ulp, f"1 bf16 ulp = {ulp:.3e}"
    return e, torch.allclose(got, want, rtol=2e-5, atol=2e-5), "2e-5"


def check_lm_kernels(torch, dev) -> dict:
    """Phase 3, LM kernels: B5 and B6 against their plain versions at
    qwen2-1.5b widths (H 12, Hkv 2, D 128), ragged shapes and the edges of
    B5's 64-key and 64-row tiles and of B6's cluster split, bf16 and f32;
    B6 twice on the same inputs, which must be bitwise equal. Returns
    kernel name -> max |kernel - plain|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import blockwise_attention

    gen = torch.Generator(device=dev).manual_seed(4321)
    err = {"flash_attention_causal": 0.0, "flash_decode": 0.0}

    def b5(tag, b, h, hkv, sq, skv, d, dtype, causal=True, window=0,
           layout="bhsd"):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        if layout == "bhsd":
            q, k, v = rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
            got = flash_attention(q, k, v, causal=causal, window=window)
        else:   # the models' (B, S, H, D) layout, read by strides
            q, k, v = rnd(b, sq, h, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
            got = blockwise_attention(q, k, v, causal=causal,
                                      window=window).transpose(1, 2)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        e, ok, tol = held(torch, got, want)
        say(f"[check] B5 {tag:<22s} q({b},{h},{sq},{d}) Hkv={hkv} Skv={skv} "
            f"{str(dtype)[6:]} causal={causal} window={window}: max abs err "
            f"{e:.3e} (tol {tol})")
        if not ok:
            fail(f"B5 {tag}: max abs err {e}")
        err["flash_attention_causal"] = max(err["flash_attention_causal"], e)

    bf, f32 = torch.bfloat16, torch.float32
    b5("qwen2 prefill", 4, 12, 2, 128, 128, 128, bf)
    b5("qwen2 prefill", 4, 12, 2, 128, 128, 128, f32)
    b5("qwen2 (B,S,H,D) strides", 4, 12, 2, 128, 128, 128, bf, layout="bshd")
    b5("ragged Sq = Skv = 77", 2, 12, 2, 77, 77, 128, f32)
    b5("window 32", 2, 12, 2, 100, 100, 128, f32, window=32)
    b5("window 8, G = 1", 1, 4, 4, 45, 45, 64, bf, window=8)
    b5("Sq = 1", 2, 12, 2, 1, 1, 128, bf)
    b5("non-causal 19 x 45", 1, 4, 2, 19, 45, 32, f32, causal=False)
    # the bf16 tensor-core kernel at its 64-key / 64-row tile edges, G = 1
    for s_ in (63, 64, 65, 127, 129, 256):
        for d_ in (64, 128):
            b5("tile edge, G = 1", 1, 2, 2, s_, s_, d_, bf)
    b5("window 8, Sq = 1", 2, 12, 2, 1, 1, 128, bf, window=8)
    b5("window 8, tile edge", 2, 12, 2, 129, 129, 128, bf, window=8)
    b5("window 64, G = 1", 1, 2, 2, 256, 256, 64, bf, window=64)
    b5("non-causal bf16", 1, 4, 2, 65, 130, 128, bf, causal=False)

    def b6(tag, b, s, h, hkv, d, length, dtype, head_major=False):
        q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(dtype)
        if head_major:   # a (B, Hkv, S, D) store seen as (B, S, Hkv, D)
            kc, vc = (torch.randn(b, hkv, s, d, generator=gen, device=dev)
                      .to(dtype).transpose(1, 2) for _ in range(2))
        else:
            kc, vc = (torch.randn(b, s, hkv, d, generator=gen, device=dev)
                      .to(dtype) for _ in range(2))
        got = flash_decode(q, kc, vc, length)
        want = ref.flash_decode_ref(q, kc, vc, length)
        if not torch.equal(flash_decode(q, kc, vc, length), got):
            fail(f"B6 {tag}: two calls on the same inputs differ")
        e, ok, tol = held(torch, got, want)
        say(f"[check] B6 {tag:<22s} q({b},1,{h},{d}) cache S={s} Hkv={hkv} "
            f"length={length} {str(dtype)[6:]}: max abs err {e:.3e} "
            f"(tol {tol})")
        if not ok:
            fail(f"B6 {tag}: max abs err {e}")
        err["flash_decode"] = max(err["flash_decode"], e)

    b6("qwen2 decode", 4, 512, 12, 2, 128, 160, bf)
    b6("qwen2 decode", 4, 512, 12, 2, 128, 160, f32)
    b6("length = 1", 4, 512, 12, 2, 128, 1, bf)
    b6("length = S", 4, 512, 12, 2, 128, 512, f32)
    b6("S = 45, not 32k", 2, 45, 12, 2, 128, 45, f32)
    b6("S = 45, length 33", 2, 45, 12, 2, 128, 33, bf)
    b6("head-major strides", 2, 96, 12, 2, 128, 70, f32, head_major=True)
    b6("G = 1, D = 64", 1, 64, 4, 4, 64, 64, f32)
    # the cluster split's edges (8 blocks a (batch, kv head)): lengths
    # around the split and the lane groups, splits with no row, G below, at
    # and above one 8-row pass
    for length in (7, 8, 9, 63, 64, 65, 159, 511):
        b6("split edge", 2, 512, 12, 2, 128, length, bf)
    for g_, d_ in ((1, 64), (8, 128), (16, 128), (16, 64)):
        b6(f"G = {g_}", 2, 512, 2 * g_, 2, d_, 65, bf)
        b6(f"G = {g_}", 2, 512, 2 * g_, 2, d_, 9, f32)
    torch.cuda.synchronize()
    return err


def corr(torch, a, b) -> float:
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def position_corr(torch, a, b):
    """Correlation of two (B, P, V) logit tensors at each position p over
    its B x V values, in float64 on the card: a (P,) tensor."""
    p = a.shape[1]
    a = a.double().transpose(0, 1).reshape(p, -1)
    b = b.double().transpose(0, 1).reshape(p, -1)
    a = a - a.mean(1, keepdim=True)
    b = b - b.mean(1, keepdim=True)
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def planted_attention(torch, shift: int):
    """A plain (B, S, H, D) GQA attention whose causal mask is moved by
    ``shift``: query i sees keys j <= i + shift. ``shift`` 0 is the right
    mask (the control), +1 lets each query see the next key, -1 hides its
    own key (row 0 then sees none and returns 0). f32 inside, q divided by
    sqrt(D) as the reference's full_attention does."""
    import math

    def attention(q, k, v, *, causal=True, window=0):
        s_len, g = q.shape[1], q.shape[2] // k.shape[2]
        qh = q.transpose(1, 2).float() / math.sqrt(q.shape[-1])
        kh, vh = (t.transpose(1, 2).float().repeat_interleave(g, 1)
                  for t in (k, v))
        pos = torch.arange(s_len, device=q.device)
        vis = pos[None, :] <= pos[:, None] + shift
        p = torch.softmax(qh @ kh.transpose(-1, -2) + torch.where(
            vis, 0.0, -1e30), dim=-1) * vis
        return (p @ vh).transpose(1, 2).to(q.dtype)
    return attention


def run_lm(torch, dev, card: str) -> dict:
    """Phase 4b: the LM main path on qwen2-1.5b at full width. Returns the
    launch counts of the counted run and what the numbers phase reuses."""
    from repro_torch.bridge import to_device
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, init_cache
    from repro_torch.models import api as model_api

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    params = model_api.init_model(0, cfg, dev)
    torch.cuda.synchronize()

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        return [tree]

    n_params = sum(t.numel() for t in leaves(params))
    say(f"[lm] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.kv_heads} KV, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab}, tied; {n_params / 1e9:.3f} G bf16 params from "
        f"init_lm(seed=0) on the card in {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    # warm-up (cuBLAS handles and heuristics at the decode shapes), not
    # counted: 4 prompt tokens + 2 generated on a scratch cache
    generate(params, init_cache(cfg, LM_BATCH, 8, dev), prompt[:, :4], 2, cfg)
    model_api.prefill_fn(params, {"tokens": prompt[:, :16]}, cfg)
    torch.cuda.synchronize()

    cache = init_cache(cfg, LM_BATCH, LM_CACHE, dev)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    toks, tps = generate(params, cache, prompt, LM_GEN, cfg)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = model_api.prefill_fn(params, {"tokens": prompt}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    say(f"[lm] launches on the LM path: {launches}")
    steps = LM_PROMPT + LM_GEN
    want = {"flash_decode": steps * cfg.n_layers,
            "flash_attention_causal": cfg.n_layers}
    for k, n in want.items():
        if launches.get(k, 0) != n:
            fail(f"{k} launched {launches.get(k, 0)} times on the LM path, "
                 f"expected {n}")
    if tuple(toks.shape) != (LM_BATCH, LM_GEN) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"generated tokens {tuple(toks.shape)} outside the vocab")
    if tuple(full.shape) != (LM_BATCH, LM_PROMPT, cfg.vocab) or not bool(
            torch.isfinite(full.float()).all()):
        fail(f"prefill_fn logits {tuple(full.shape)} not finite")
    say(f"[lm] generate: {LM_BATCH} x ({LM_PROMPT} prompt + {LM_GEN} "
        f"greedy) in {serve_s:.3f}s ({steps} decode steps), decode loop "
        f"{tps:.2f} tok/s; prefill_fn over the prompt {prefill_s * 1e3:.3f} "
        f"ms incl. its first call at this shape ({card})")
    say(f"[lm] first sequence: {toks[0, :16].tolist()}")

    # B5's path against B6's: the full-prompt forward's logits at every
    # prompt position vs the decode loop's (prefill_into_cache's steps) at
    # the same position, on the same prompt. The same readings with the
    # causal mask planted one key off, through a plain attention on the
    # card (and the right mask as the control), show what the limits
    # separate: a wrong mask in B5 or B6 against bf16 rounding.
    from repro_torch.models import transformer
    loop_cache = init_cache(cfg, LM_BATCH, LM_CACHE, dev)
    steps_logits = []
    for p in range(LM_PROMPT):
        lg, loop_cache = model_api.decode_fn(params, loop_cache,
                                             prompt[:, p:p + 1], p, cfg)
        steps_logits.append(lg)
    loop = torch.stack(steps_logits, 1)
    del loop_cache, steps_logits

    def reading(tag, logits):
        pc = position_corr(torch, logits, loop)
        top = (logits.argmax(-1) == loop.argmax(-1))
        r = {"last_corr": float(pc[-1]), "last_argmax": int(top[:, -1].sum()),
             "min_corr": float(pc.min()), "argmax_share": float(
                 top.float().mean())}
        say(f"[lm] prefill vs decode loop, {tag}: last position corr "
            f"{r['last_corr']:.6f}, argmax {r['last_argmax']} of {LM_BATCH}; "
            f"over all {LM_PROMPT} positions min corr {r['min_corr']:.6f}, "
            f"argmax agrees in {100 * r['argmax_share']:.2f}% of rows")
        return r

    # limits: at the last position corr > 0.999 and argmax in >= 3 of 4
    # rows; at every position corr > 0.99. On the H100 the kernel path reads
    # 0.999155 / 4 of 4 / 0.999085 and the control 0.999199 / 4 / 0.999097,
    # the planted faults 0.65 and 0.60 / 0 / 0.21 and 0.015 (PERF.md, PR 12)
    def passes(r):
        return (r["last_corr"] > 0.999 and r["last_argmax"] >= LM_BATCH - 1
                and r["min_corr"] > 0.99)

    real = reading("prefill_fn (B5) vs decode_fn (B6)", full)
    if not passes(real):
        fail(f"prefill_fn vs decode-loop prefill: {real}")
    saved = transformer.blockwise_attention
    try:
        for tag, shift in (("control: plain attention, right mask", 0),
                           ("planted fault: query i sees key i+1", 1),
                           ("planted fault: query i misses key i", -1)):
            transformer.blockwise_attention = planted_attention(torch, shift)
            r = reading(tag, model_api.prefill_fn(
                params, {"tokens": prompt}, cfg))
            if shift and passes(r):
                fail(f"the planted fault ({tag}) passes the prefill/decode "
                     f"limits, which therefore cannot catch it: {r}")
    finally:
        transformer.blockwise_attention = saved
    del loop

    # the last decode step again, on the card and on the CPU (plain
    # versions) from CPU copies of the card's params and cache
    pos = steps - 1
    tok = toks[:, -1:]
    card_logits, _ = model_api.decode_fn(params, cache, tok, pos, cfg)
    t0 = time.perf_counter()
    cpu_logits, _ = model_api.decode_fn(to_device(params, "cpu"),
                                        to_device(cache, "cpu"), tok.cpu(),
                                        pos, cfg)
    cpu_s = time.perf_counter() - t0
    c = corr(torch, card_logits, cpu_logits)
    agree = int((card_logits.cpu().argmax(-1) == cpu_logits.argmax(-1)).sum())
    say(f"[lm] last decode step (pos {pos}) re-run on the CPU with the plain "
        f"versions ({cpu_s:.1f}s incl. copies): logits corr {c:.6f}, argmax "
        f"agrees in {agree} of {LM_BATCH} rows, max abs diff "
        f"{(card_logits.cpu().float() - cpu_logits.float()).abs().max().item():.3e}")
    if not c > 0.999:
        fail(f"card vs CPU decode-step logits correlation {c} <= 0.999")
    return {"launches": launches, "cfg": cfg, "params": params,
            "prompt": prompt, "cache": cache, "tok": tok, "pos": pos,
            "tps": tps, "serve_s": serve_s}


def check_b4(torch, dev) -> dict:
    """Phase 3, B4: the dequant epilogue against its plain version, bitwise,
    at the sharded path's shapes, a ragged one and M = 1; each on the
    16-byte path and, from an acc that starts 4 bytes into its buffer, on
    the scalar path."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_ffn import dequant_epilogue

    gen = torch.Generator(device=dev).manual_seed(99)
    err = 0.0
    for tag, m, n in B4_SHAPES:
        buf = torch.randint(-2 ** 30, 2 ** 30, (m * n + 1,), generator=gen,
                            device=dev, dtype=torch.int32)
        sx = torch.rand((), generator=gen, device=dev) * 1e-3
        sw = torch.rand(n, generator=gen, device=dev)
        for path, acc in (("16-byte", buf[:-1].view(m, n)),
                          ("scalar", buf[1:].view(m, n))):
            got = dequant_epilogue(acc, sx, sw)
            want = ref.dequant_epilogue_ref(acc, sx, sw)
            e = (got - want).abs().max().item()
            say(f"[check] B4 {tag:<18s} ({m},{n}) {path} path: max abs err "
                f"{e:.3e}, bitwise {torch.equal(got, want)} (tol bitwise)")
            if not torch.equal(got, want):
                fail(f"B4 {tag} ({m},{n}) {path}: not bitwise (max {e})")
            err = max(err, e)
    torch.cuda.synchronize()
    return {"dequant_epilogue": err}


def log_flushes(server) -> dict:
    """Keep every flush's logits (on the host) as ``server`` serves, keyed
    by the flush's (sid, frame index) pairs, in flush order. ``del
    server._finish`` stops it."""
    logged, finish = {}, server._finish

    def finish_and_log(fb, by_sid):
        finish(fb, by_sid)
        logged[tuple(fb.frame_idx)] = server.last_logits.float().cpu()
    server._finish = finish_and_log
    return logged


def by_stream(logged: dict, sid0: int) -> dict:
    """``log_flushes`` keys with each sid counted from ``sid0``."""
    return {tuple((sid - sid0, fi) for sid, fi in key): v
            for key, v in logged.items()}


def serve_large(cfg, sc, params, device) -> dict:
    """Serve path a's traffic (2 streams x 32 frames, stream 1 from frame
    16, after a one-chunk warm-up) on ``cfg``; returns what path c reads."""
    import torch
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.kernels import _build
    from repro_torch.distributed import collectives
    from repro_torch.models import sharded_encoder
    from repro_torch.models.vit import data_split_calls
    from repro_torch.serving.server import StreamServer

    server = StreamServer(cfg, sc, params=params, n_classes=10,
                          device=device)
    streams = video_fleet(2, img_size=cfg.img_size, patch=cfg.patch,
                          cut_every=32)
    server.add_session(streams[0], n_frames=8, start=1000)
    server.serve()                                     # warm-up
    flushes = log_flushes(server)
    sessions = [server.add_session(st, n_frames=32, start=16 * i)
                for i, st in enumerate(streams)]
    _build.LAUNCHES.clear()
    collectives.STATS.clear()
    calls = sharded_encoder.sharded_encode_calls()
    data_calls = data_split_calls()
    results = server.serve()
    data_after = data_split_calls()
    return {"server": server, "sessions": sessions, "results": results,
            "flushes": flushes,
            "launches": dict(_build.LAUNCHES),
            "stats": dict(collectives.STATS),
            "calls": sharded_encoder.sharded_encode_calls() - calls,
            "data_calls": {k: data_after[k] - data_calls[k]
                           for k in data_calls},
            "wall": max(r.wall_s for r in results.values())}


def sharded_rank(params: dict, cfg, sc, device: str) -> dict:
    """One rank of path 4c. Checks its own launch counts and sharded-encode
    calls, re-encodes the newest flush under two planted faults, and
    returns what the parent compares (predictions and logits from rank
    0)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models.vit import forward_vit_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = serve_large(cfg, sc, params, device)
    server = run["server"]
    if server.graphs:
        raise RuntimeError(f"the sharded server captured CUDA graphs for "
                           f"buckets {sorted(server.graphs)}: its gloo "
                           f"collectives cannot run inside one")
    n_flush = len(server.flush_log)
    launches = run["launches"]
    if run["calls"] != n_flush or n_flush == 0:
        raise RuntimeError(f"{run['calls']} sharded encodes for {n_flush} "
                           f"flushes")
    # (a CPU rehearsal runs the plain versions, which launch nothing)
    if device == "cuda":
        if launches.get("dequant_epilogue", 0) != 2 * cfg.n_layers * n_flush:
            raise RuntimeError(f"dequant_epilogue launched "
                               f"{launches.get('dequant_epilogue', 0)} times "
                               f"for {n_flush} flushes of {cfg.n_layers} "
                               f"layers")
        for k in ("photonic_matmul", "flash_attention_masked"):
            if launches.get(k, 0) <= 0:
                raise RuntimeError(f"{k} never launched on the sharded path")
        fault = vit_entry_fault(launches)
        if fault:
            raise RuntimeError(f"sharded path: {fault}")
        if launches.get("fused_ffn", 0):
            raise RuntimeError("the fused FFN kernel ran on the sharded path")

    fb = server.last_flush

    def encode_newest():
        with use_sharding(server.mesh):
            return forward_vit_tokens(server.params, fb.tokens, cfg,
                                      server.policy,
                                      device=server.device)[0].float().cpu()

    planted = {}
    for tag, name, fault in (
            ("w2 partial accumulates dequantized without the int32 "
             "all-reduce", "exact_int_psum", lambda x, group: x),
            ("absmax scopes left local to the rank", "replicated_absmax_scale",
             lambda x, bits, group, eps=1e-8: quant.absmax_scale(
                 x, bits=bits, eps=eps))):
        saved = getattr(collectives, name)
        setattr(collectives, name, fault)
        try:
            planted[tag] = encode_newest()
        finally:
            setattr(collectives, name, saved)
    # each collective alone at the path's shapes (4 x 197 tokens): the
    # scalar MAX of an absmax scope, the all-gather of a rank's merged
    # heads, the int32 SUM of w2's partial accumulates
    import torch.distributed as dist
    mesh, dev = server.mesh, server.device
    rows, d = 4 * 197, cfg.d_model
    both, model_g = mesh.group(("data", "model")), mesh.group("model")
    probes = {
        "absmax MAX, 1 f32": lambda: collectives.all_reduce(
            torch.ones((), device=dev), dist.ReduceOp.MAX, both),
        f"all-gather ({rows}, {d // mesh.model}) f32": lambda:
            collectives.all_gather_cat(torch.ones(rows, d // mesh.model,
                                                  device=dev), model_g, 1),
        f"int32 SUM ({rows}, {d})": lambda: collectives.exact_int_psum(
            torch.ones(rows, d, dtype=torch.int32, device=dev), model_g)}
    collective_ms = {}
    for tag, fn in probes.items():
        for _ in range(3):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        collective_ms[tag] = (time.perf_counter() - t0) / 20 * 1e3
    out = {"launches": launches, "calls": run["calls"], "n_flush": n_flush,
           "graphs": len(server.graphs), "warm_s": server.warm_s,
           "stats": run["stats"], "wall": run["wall"],
           "collective_ms": collective_ms,
           "backend": server.mesh.backend,
           "mesh": tuple(server.mesh.shape.values())}
    if server.mesh.d == 0 and server.mesh.m == 0:
        out.update(
            flushes=run["flushes"], planted=planted,
            flush_log=[(k, n) for _, k, n in server.flush_log],
            predictions=[run["results"][s.sid].predictions
                         for s in run["sessions"]])
    return out


def run_sharded(torch, dev, card: str, cfg) -> dict:
    """Phase 4c: ``cfg`` (opto-vit-large) served model-sharded over 2 ranks
    on the one card against the same traffic served unsharded on it."""
    from repro_torch.bridge import from_jax_params, init_vit
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.server import ServerConfig

    sc = ServerConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4,
                      chunk=8, model_shards=SHARDS)
    t0 = time.perf_counter()
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")

    def share(tree):
        for v in tree.values():
            if isinstance(v, dict):
                share(v)
            else:
                v.share_memory_()
    share(params)
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[sharded] {cfg.name} {cfg.img_size}x{cfg.img_size} + MGNet: "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff={cfg.d_ff}; {n_params / 1e6:.1f} M f32 params from "
        f"init_vit(seed=0) into shared CPU memory in "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_rank, SHARDS, params, cfg, sc, dev.type,
                        device=dev.type, timeout_s=600)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    say(f"[sharded] {SHARDS} ranks, mesh (data, model) = {r0['mesh']}, "
        f"backend {r0['backend']}, both ranks on {card}; spawn + serve "
        f"{spawn_s:.1f}s")
    for i, r in enumerate(ranks):
        say(f"[sharded] rank {i}: {r['calls']} sharded encodes for "
            f"{r['n_flush']} flushes; {r['graphs']} CUDA graphs (eager "
            f"warm start {r['warm_s']:.2f}s); launches {r['launches']}")

    # the same traffic served unsharded on the card, the same params
    from repro_torch.serving.session import ServingConfig
    plain = serve_large(cfg, ServingConfig(**{
        k: getattr(sc, k) for k in ("bucket_fractions", "microbatch",
                                    "chunk")}), params, dev)
    if [(k, n) for _, k, n in plain["server"].flush_log] != r0["flush_log"]:
        fail("the sharded and unsharded serves flushed different batches")
    # both servers number their sessions alike (a warm-up session, then
    # the two streams), so the flushes key alike
    if r0["flushes"].keys() != plain["flushes"].keys():
        fail("the sharded and unsharded serves logged different flushes")
    cors = [corr(torch, r0["flushes"][k], plain["flushes"][k])
            for k in plain["flushes"]]
    if len(cors) != r0["n_flush"] or not min(cors) > FLUSH_CORR:
        fail(f"sharded vs unsharded flush logits: min corr {min(cors)} "
             f"over {len(cors)} flushes (limit {FLUSH_CORR})")
    agree = total = 0
    for s, preds in zip(plain["sessions"], r0["predictions"]):
        want = plain["results"][s.sid].predictions
        if set(preds) != set(range(s.start, s.start + 32)):
            fail(f"sharded session {s.sid}: {len(preds)} predictions for 32 "
                 f"frames")
        agree += sum(preds[i] == want[i] for i in preds)
        total += len(preds)
    say(f"[sharded] every flush's logits vs the unsharded card serve: min "
        f"corr {min(cors):.9f} over {len(cors)} flushes (limit "
        f"{FLUSH_CORR}); top-1 agreement {agree}/{total} = "
        f"{100 * agree / total:.2f}%")
    newest = list(plain["flushes"].values())[-1]
    for tag, logits in r0["planted"].items():
        c = corr(torch, logits, newest)
        say(f"[sharded] planted fault, {tag}: newest flush corr {c:.9f}")
        if c > FLUSH_CORR:
            fail(f"the planted fault ({tag}) passes the {FLUSH_CORR} limit, "
                 f"which therefore cannot catch it")
    return {"ranks": ranks, "plain": plain, "cfg": cfg, "min_corr": min(cors),
            "agree": agree / total}


def report_sharded(sharded: dict, card: str) -> None:
    """Phase 5, path 4c: frames/s of the ranks against the unsharded serve
    of the same traffic, and the host time of the collectives."""
    r0 = sharded["ranks"][0]
    unsharded = sharded["plain"]
    for i, r in enumerate(sharded["ranks"]):
        st = r["stats"]
        coll_s = sum(v for k, v in st.items() if k.endswith("_s"))
        ops = {k: v for k, v in st.items() if not k.endswith("_s")}
        say(f"[numbers] sharded rank {i}: 64 frames in {r['wall']:.4f}s = "
            f"{64 / r['wall']:.2f} frames/s; collectives {coll_s * 1e3:.3f} "
            f"ms host time over {r['n_flush']} flushes = "
            f"{coll_s * 1e3 / r['n_flush']:.3f} ms a flush ({ops}; "
            + ", ".join(f"{k[:-2]} {v * 1e3 / r['n_flush']:.3f} ms"
                        for k, v in st.items() if k.endswith("_s"))
            + f" a flush); backend {r['backend']}, both ranks on one card "
            f"({card})")
    say(f"[numbers] sharded rank 0, each collective alone (host clock, "
        f"20 calls after 3): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in r0["collective_ms"].items())
        + f" ({card})")
    say(f"[numbers] {sharded['cfg'].name} unsharded on the card: 64 frames in "
        f"{unsharded['wall']:.4f}s = {64 / unsharded['wall']:.2f} frames/s; "
        f"sharded over {SHARDS} ranks on the same card: "
        f"{64 / r0['wall']:.2f} frames/s (rank 0) = "
        f"{unsharded['wall'] / r0['wall']:.3f}x ({card})")


def check_graphs(torch, cfg, sc, params, server, streams, results) -> dict:
    """Phase 4a, warm start: one CUDA graph per bucket, under one-shape
    too; each replay bitwise the eager encode of the same flush with the
    same launch counts; a graphed 2-stream serve bitwise, per stream and
    per flush, two solo eager ``ServingEngine`` runs; a one-shape serve
    and a ``max_wait_chunks=1`` serve of the same traffic."""
    from dataclasses import replace
    from repro_torch.kernels import _build
    from repro_torch.models.vit import embed_patches, forward_vit_tokens
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.server import StreamServer, _gather_topk_rows
    from repro_torch.serving.session import ServingConfig

    dev = server.device
    frames = streams[0].frames_at(0, 8)["frames"]
    toks = embed_patches(server.params, torch.from_numpy(frames).to(dev),
                         cfg, server.policy)
    order = torch.argsort(torch.from_numpy(server._score_fn(frames)).to(dev),
                          dim=-1, descending=True, stable=True)
    one = StreamServer(cfg, replace(sc, one_shape=True), params=params)
    say(f"[graphs] one-shape server: warm start {one.warm_s:.2f}s, CUDA "
        f"graphs at buckets {sorted(one.graphs)}")
    if sorted(one.graphs) != list(one.ladder.sizes):
        fail(f"one-shape graphs {sorted(one.graphs)} for ladder "
             f"{list(one.ladder.sizes)}")
    flushes = {}
    for mode, srv in (("gathered", server), ("one-shape", one)):
        for k in srv.ladder.sizes:
            t = _gather_topk_rows(toks, order, srv.ladder.cap
                                  if srv is one else k)[:4].contiguous()
            kv = k if srv is one else None
            _build.LAUNCHES.clear()
            eager = forward_vit_tokens(srv.params, t, cfg, srv.policy,
                                       kv_len=kv)[0]
            eager_n = dict(_build.LAUNCHES)
            _build.LAUNCHES.clear()
            graphed = srv.graphs[k].replay(t).clone()
            replay_n = dict(_build.LAUNCHES)
            same = torch.equal(graphed, eager)
            vit = {n: replay_n.get(n, 0) for n in VIT_KERNELS}
            say(f"[graphs] {mode} k={k}: replay logits bitwise the eager "
                f"encode's: {same}; launches a replay {vit}, the same as "
                f"eager: {replay_n == eager_n}")
            if not same:
                fail(f"{mode} k={k}: replay logits differ from eager by "
                     f"{(graphed - eager).abs().max().item():.3e}")
            if replay_n != eager_n or min(vit.values()) <= 0:
                fail(f"{mode} k={k}: launches a replay {replay_n}, eager "
                     f"{eager_n}")
            if srv is server:
                flushes[k] = {"tokens": t, "launches": vit}

    # the graphed interleaved serve against two solo eager engine runs
    got = log_flushes(server)
    sessions = [server.add_session(st, n_frames=32, start=16 * i)
                for i, st in enumerate(streams)]
    res = server.serve()
    del server._finish
    got = by_stream(got, sessions[0].sid)
    eng = ServingEngine(cfg, ServingConfig(**{
        f: getattr(sc, f) for f in ("bucket_fractions", "microbatch",
                                    "chunk")}), params=params)
    if eng.server.graphs:
        fail("the ServingEngine (warm start off) captured graphs")
    want = log_flushes(eng.server)
    solo = [eng.run(st, n_frames=32, start=16 * i)
            for i, st in enumerate(streams)]
    want = by_stream(want, 0)
    for s, r in zip(sessions, solo):
        mine = res[s.sid]
        if (mine.predictions != r.predictions
                or mine.bucket_launches != r.bucket_launches
                or mine.mean_frame_uj != r.mean_frame_uj):
            fail(f"graphed interleaved stream {s.sid - sessions[0].sid} "
                 f"differs from its solo eager run")
    if got.keys() != want.keys() or not all(
            torch.equal(got[k], want[k]) for k in want):
        fail("graphed interleaved flush logits are not bitwise the solo "
             "eager runs'")
    say(f"[graphs] 2 streams x 32 frames served interleaved through the "
        f"graphs: predictions, launches and energy per stream and the "
        f"logits of all {len(want)} flushes bitwise equal to two solo "
        f"eager ServingEngine runs")

    def serve_on(srv):
        """Serve the main path's traffic on ``srv``; check the ViT kernels'
        launches; return (results by stream, partial flushes)."""
        ss = [srv.add_session(st, n_frames=32, start=16 * i)
              for i, st in enumerate(streams)]
        _build.LAUNCHES.clear()
        out = srv.serve()
        fault = vit_entry_fault(dict(_build.LAUNCHES))
        if fault or not all(_build.LAUNCHES.get(n, 0) for n in VIT_KERNELS):
            fail(f"serve with {srv.serve_cfg}: "
                 f"{fault or dict(_build.LAUNCHES)}")
        partial = sum(n < srv.serve_cfg.microbatch
                      for _, _, n in srv.flush_log)
        return [out[s.sid] for s in ss], partial

    def same_service(tag, got, base) -> str:
        """Every frame predicted once, hits and modeled energy per stream
        equal to ``base``'s; returns the top-1 agreement with it."""
        agree = total = 0
        for i, (r, b) in enumerate(zip(got, base)):
            if (set(r.predictions) != set(b.predictions) or r.frames != 32
                    or r.bucket_hits != b.bucket_hits
                    or abs(r.mean_frame_uj - b.mean_frame_uj)
                    > 1e-12 * b.mean_frame_uj):
                fail(f"{tag} serve of stream {i}: {r.summary()} against "
                     f"{b.summary()}")
            agree += sum(r.predictions[j] == b.predictions[j]
                         for j in r.predictions)
            total += len(r.predictions)
        return f"{agree}/{total}"

    # one-shape: the gathered serve's routing, other absmax scopes (the
    # dead rows of the cap-size tensor count in every per-launch absmax)
    got, partial = serve_on(one)
    say(f"[graphs] one-shape serve (graphs at {sorted(one.graphs)}): hits "
        f"and energy per stream equal to the gathered serve's, top-1 "
        f"agreement with it {same_service('one-shape', got, results)}")
    # the deadline, with chunk 3 < micro-batch 8 (graphs of their own) so
    # that partial queues outlive a round, against the same traffic
    # without it
    c3 = replace(sc, microbatch=8, chunk=3)
    free, free_partial = serve_on(StreamServer(cfg, c3, params=params))
    tight_srv = StreamServer(cfg, replace(c3, max_wait_chunks=1),
                             params=params)
    tight, tight_partial = serve_on(tight_srv)
    agree = same_service("max_wait_chunks=1", tight, free)
    say(f"[graphs] max_wait_chunks=1 serve, micro-batch 8, chunk 3 (graphs at "
        f"{sorted(tight_srv.graphs)}): {tight_partial} padded flushes "
        f"against {free_partial} without the deadline; every frame "
        f"predicted once, hits and energy per stream equal, top-1 "
        f"agreement {agree}")
    if tight_partial <= free_partial:
        fail("the deadline padded no more flushes than the serve without it")
    return {"flushes": flushes, "eager_server": eng.server}


def plan_kernel_calls(torch, dev) -> dict:
    """B1 (K-major, 768 x 768) and B3 (x (4, 197, 768), d_ff 3072) at the
    widths of ``B1_WIDTHS`` / ``B3_WIDTHS``: x and the weights quantized
    at the width, as a bit plan runs them. Returns (kernel, widths) ->
    (the kernel's call, a check that holds it against its plain version
    and returns the largest absolute error)."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_ffn import fused_ffn, fused_ffn_nmajor
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

    gen = torch.Generator(device=dev).manual_seed(4321)
    calls = {}
    for m, bits in B1_WIDTHS:
        x = torch.randn(m, 768, generator=gen, device=dev)
        wq, sw = qweight(torch, gen, 768, 768, bits, dev)
        wt = wq.t().contiguous()
        sx = quant.absmax_scale(x, bits=bits)
        xq = quant.quantize(x, sx, bits=bits)

        def check(xq=xq, wq=wq, wt=wt, sx=sx, sw=sw, m=m, bits=bits):
            qmax = quant.quant_range(bits)[1]
            if max(int(xq.abs().max()), int(wq.abs().max())) > qmax:
                fail(f"B1 at {bits} bits: codes outside +-{qmax}")
            acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                                       torch.ones(768, device=dev), wt=wt)
            if not torch.equal(acc.long(),
                               ref.int_accumulate_ref(xq, wq).long()):
                fail(f"B1 ({m},768,768) at {bits} bits: accumulate not "
                     f"bitwise")
            got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
            want = ref.photonic_matmul_ref(xq, wq, sx, sw)
            e = (got - want).abs().max().item()
            rel = e / max(want.abs().max().item(), 1e-30)
            say(f"[bitplan] B1 ({m},768,768) at {bits} bits, codes within "
                f"+-{qmax}: accumulate bitwise, max abs err {e:.3e}, rel "
                f"{rel:.3e} (tol 1e-6)")
            if rel > 1e-6:
                fail(f"B1 at {bits} bits: relative error {rel} > 1e-6")
            return e
        calls[("photonic_matmul", (m, bits))] = (
            lambda xq=xq, wq=wq, wt=wt, sx=sx, sw=sw: photonic_matmul_int8(
                xq, wq, sx, sw, wt=wt), check)
    x = torch.randn(4, 197, 768, generator=gen, device=dev)
    b1 = torch.randn(3072, generator=gen, device=dev) * 0.1
    b2 = torch.randn(768, generator=gen, device=dev) * 0.1
    for bits in B3_WIDTHS:
        w1q, s1 = qweight(torch, gen, 768, 3072, bits[0], dev)
        w2q, s2 = qweight(torch, gen, 3072, 768, bits[1], dev)
        args = (x, w1q, s1, b1, w2q, s2, b2)
        w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()

        def check(args=args, w1t=w1t, w2t=w2t, bits=bits):
            got = fused_ffn(*args, bits=bits, w1t=w1t, w2t=w2t)
            first = fused_ffn_nmajor(*args, bits=bits)
            want = ref.fused_ffn_ref(*args, bits=bits)
            e = (got - want).abs().max().item()
            say(f"[bitplan] B3 x(4,197,768) d_ff 3072 at bits {bits}: max "
                f"abs err {e:.3e} (one quant step), bitwise the first "
                f"design {torch.equal(got, first)}")
            if not quant_step_close(torch, got, want):
                fail(f"B3 at bits {bits}: outside one quant step ({e})")
            if not torch.equal(got, first):
                fail(f"B3 at bits {bits}: the K-major entry is not bitwise "
                     f"the first design")
            return e
        calls[("fused_ffn", bits)] = (
            lambda args=args, w1t=w1t, w2t=w2t, bits=bits: fused_ffn(
                *args, bits=bits, w1t=w1t, w2t=w2t), check)
    return calls


def flush_tokens(torch, server, streams) -> dict:
    """Bucket -> 4 frames of a real chunk gathered as ``server`` serves."""
    from repro_torch.models.vit import embed_patches
    from repro_torch.serving.server import _gather_topk_rows

    frames = streams[0].frames_at(0, 8)["frames"]
    toks = embed_patches(server.params, torch.from_numpy(frames).to(
        server.device), server.cfg, server.policy)
    order = torch.argsort(torch.from_numpy(server._score_fn(frames)).to(
        server.device), dim=-1, descending=True, stable=True)
    return {k: _gather_topk_rows(toks, order, k)[:4].contiguous()
            for k in server.ladder.sizes}


def replays_are_eager(torch, server, tokens: dict, tag: str,
                      phase: str = "bitplan") -> None:
    """Every bucket's graph (one for each bucket of ``tokens``, which is
    every warmed one: the whole ladder unless the control plane warmed
    only the buckets it priced) replays the eager encode of the same flush
    bitwise, with the eager call's launch counts: 49 B1 (4 a layer and the
    head), 12 B2 and 12 B3 launches."""
    from repro_torch.kernels import _build
    from repro_torch.models.vit import forward_vit_tokens

    cfg = server.cfg
    want_k = (sorted(tokens) if server.cost_model is not None
              else list(server.ladder.sizes))
    if not (sorted(server.graphs) == sorted(server.warmed) == want_k
            == sorted(tokens)):
        fail(f"{tag}: graphs {sorted(server.graphs)}, warmed "
             f"{sorted(server.warmed)}, checked {sorted(tokens)}")
    want = {"photonic_matmul": 4 * cfg.n_layers + 1,
            "flash_attention_masked": cfg.n_layers,
            "fused_ffn": cfg.n_layers}
    for k, t in tokens.items():
        _build.LAUNCHES.clear()
        eager = forward_vit_tokens(server.params, t, cfg, server.policy)[0]
        eager_n = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        graphed = server.graphs[k].replay(t).clone()
        replay_n = dict(_build.LAUNCHES)
        vit = {n: replay_n.get(n, 0) for n in VIT_KERNELS}
        say(f"[{phase}] {tag} k={k}: replay bitwise the eager encode "
            f"{torch.equal(graphed, eager)}, launches a replay {vit}")
        if not torch.equal(graphed, eager):
            fail(f"{tag} k={k}: replay differs from eager by "
                 f"{(graphed - eager).abs().max().item():.3e}")
        if replay_n != eager_n or vit != want:
            fail(f"{tag} k={k}: launches a replay {replay_n}, eager "
                 f"{eager_n}, want {want}")


def against_cpu(torch, server, fb, logits) -> None:
    """One flush under the plan against the CPU port (the plain versions).
    Each layer on the same input (the CPU's walk's) is held to one quant
    step, corr > 0.9999 (B3's class). End to end, a 4-bit layer turns
    last-bit differences upstream into code flips: moving the flush's
    tokens by one ulp moves the card's own logits to corr ~0.994
    (scripts/bitplan_parity.py), so the card against the CPU is held to
    at most twice the distance (1 - corr) that one ulp moves either
    device by itself, on this flush; top-1 is printed."""
    from repro_torch.bridge import to_device
    from repro_torch.models.layers import layer_view
    from repro_torch.models.vit import encoder_layer_step, forward_vit_tokens

    cfg, pol, dev = server.cfg, server.policy, server.device
    t = fb.tokens
    cpu_params = to_device(server.params, "cpu")
    plain = forward_vit_tokens(cpu_params, t.cpu(), cfg, pol,
                               device="cpu")[0]
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    own = min(corr(torch, forward_vit_tokens(server.params, up, cfg,
                                             pol)[0], logits),
              corr(torch, forward_vit_tokens(cpu_params, up.cpu(), cfg, pol,
                                             device="cpu")[0], plain))
    end = corr(torch, logits, plain)
    top1 = int((logits.cpu().argmax(-1) == plain.argmax(-1)).sum())
    b, _, d = t.shape
    x = torch.cat([(cpu_params["cls"].expand(b, 1, d)
                    + cpu_params["pos"][:, :1]), t.cpu()], dim=1)
    layers = []
    for i in range(cfg.n_layers):
        want = encoder_layer_step(x, layer_view(cpu_params["blocks"], i),
                                  cfg, pol)
        got = encoder_layer_step(x.to(dev), layer_view(
            server.params["blocks"], i), cfg, pol)
        layers.append(corr(torch, got, want))
        x = want
    say(f"[bitplan] flush k={fb.bucket[0]} under the plan re-encoded on the "
        f"CPU with the plain versions: logits corr {end:.6f}, top-1 "
        f"{top1}/{b} (one ulp up the tokens, each device against itself: "
        f"corr {own:.6f}); each layer on the same input, card vs CPU: corr "
        f">= {min(layers):.7f}")
    if not bool(torch.isfinite(logits).all()) or logits.shape != plain.shape:
        fail(f"mixed-plan logits {tuple(logits.shape)} not finite")
    if min(layers) <= 0.9999:
        fail(f"a layer under the plan, card vs CPU on the same input: corr "
             f"{min(layers)} <= 0.9999 ({layers})")
    if 1 - end > 2 * (1 - own):
        fail(f"mixed-plan card vs CPU logits corr {end}: further than twice "
             f"what one ulp of input moves either device alone ({own})")


def run_bitplan(torch, cfg, sc, params, streams, uniform, card) -> dict:
    """The [bitplan] path: 4a's traffic on opto-vit-base-224 under
    ``T224_PLAN`` (graphs, launches, a flush against the CPU, frames/s and
    modeled KFPS/W beside ``uniform``, 4a's server, in alternating
    serves), then ``calibrate_bits(CALIB_TARGET)`` on the same warmed,
    graphed server (re-capture, memory, a planted stale graph)."""
    import gc
    from dataclasses import replace
    from repro_torch.kernels import _build
    from repro_torch.models.vit import forward_vit_tokens
    from repro_torch.serving.server import StreamServer

    mixed = StreamServer(cfg, replace(sc, bit_plan=T224_PLAN), params=params)
    # no local reference to the cache: the memory reading below counts
    # what the server keeps
    w1_bits = mixed.params["blocks"]["ffn"]["w1"].bits
    top = [int(q.abs().max()) for q in mixed.params["blocks"]["ffn"]["w1"].wq]
    say(f"[bitplan] {cfg.name} under the plan {list(T224_PLAN)} (mean "
        f"{sum(T224_PLAN) / len(T224_PLAN):.2f} bits): warm start "
        f"{mixed.warm_s:.2f}s, graphs at {sorted(mixed.graphs)}; largest "
        f"|w1 code| a layer {top}")
    # each layer's largest code is its width's qmax: 127, 31 or 7
    if (mixed.layer_bits != T224_PLAN or w1_bits != T224_PLAN
            or top != [2 ** (b - 1) - 1 for b in T224_PLAN]):
        fail(f"the plan did not reach the cache: layer_bits "
             f"{mixed.layer_bits}, w1.bits {w1_bits}, |codes| {top}")
    tokens = flush_tokens(torch, mixed, streams)
    replays_are_eager(torch, mixed, tokens, "mixed plan")

    mixed.add_session(streams[0], n_frames=8, start=1000)
    mixed.serve()                                      # warm-up
    fps = {"uniform": [], "mixed": []}
    served = {}
    for _ in range(3):
        for tag, srv in (("uniform", uniform), ("mixed", mixed)):
            ss = [srv.add_session(st, n_frames=32, start=16 * i)
                  for i, st in enumerate(streams)]
            _build.LAUNCHES.clear()
            res = srv.serve()
            launches = dict(_build.LAUNCHES)
            fault = vit_entry_fault(launches)
            n_flush = len(srv.flush_log)
            if (fault or launches.get("photonic_matmul", 0) <= 0
                    or launches.get("flash_attention_masked", 0)
                    != cfg.n_layers * n_flush
                    or launches.get("fused_ffn", 0)
                    != cfg.n_layers * n_flush):
                fail(f"{tag} serve: {fault or launches} for {n_flush} "
                     f"flushes")
            for s in ss:
                r = res[s.sid]
                if (set(r.predictions) != set(range(s.start, s.start + 32))
                        or r.frames != 32):
                    fail(f"{tag} session {s.sid}: {len(r.predictions)} "
                         f"predictions for 32 frames")
            rs = [res[s.sid] for s in ss]
            fps[tag].append(64 / max(r.wall_s for r in rs))
            served[tag] = (rs, launches, n_flush)
    (urs, _, _), (mrs, mlaunch, mflush) = served["uniform"], served["mixed"]
    agree = sum(m.predictions[j] == u.predictions[j]
                for m, u in zip(mrs, urs) for j in m.predictions)
    for i, (m, u) in enumerate(zip(mrs, urs)):
        if m.bucket_hits != u.bucket_hits or m.mean_bits != 7.0:
            fail(f"mixed stream {i}: hits {m.bucket_hits} (uniform "
                 f"{u.bucket_hits}), mean bits {m.mean_bits}")
        say(f"[bitplan] stream {i}: modeled {m.kfps_per_watt:.2f} KFPS/W "
            f"and {m.mean_frame_uj:.4f} uJ a frame under the plan against "
            f"{u.kfps_per_watt:.2f} KFPS/W and {u.mean_frame_uj:.4f} uJ "
            f"uniform ({m.kfps_per_watt / u.kfps_per_watt:.4f}x; the "
            f"photonic accelerator model's, not the H100's)")
    say(f"[bitplan] launches of the last mixed serve: "
        f"{ {n: mlaunch.get(n, 0) for n in VIT_KERNELS} } for {mflush} "
        f"flushes; top-1 agreement with the uniform serve {agree}/64")
    say(f"[bitplan] frames/s, alternating serves of 2 streams x 32 frames: "
        f"uniform {', '.join(f'{v:.2f}' for v in fps['uniform'])}; mixed "
        f"plan {', '.join(f'{v:.2f}' for v in fps['mixed'])} ({card})")
    against_cpu(torch, mixed, mixed.last_flush, mixed.last_logits)

    # calibrate_bits on the warmed, graphed server; one graph captured
    # before it is kept (the planted fault: it replays the old cache)
    mixed.add_session(streams[1], n_frames=8, start=3000)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    k_stale = mixed.ladder.sizes[1]
    stale = mixed.graphs[k_stale]
    plan = mixed.calibrate_bits(CALIB_TARGET)
    mean = sum(plan) / len(plan)
    say(f"[bitplan] calibrate_bits({CALIB_TARGET}): plan {list(plan)}, mean "
        f"{mean:.3f} bits; scoring {mixed.calibrate_s:.3f}s wall, re-capture "
        f"of {len(mixed.graphs)} graphs {mixed.recapture_s:.3f}s wall "
        f"({card})")
    if mean > CALIB_TARGET or mixed.layer_bits != plan:
        fail(f"calibrated plan {plan} misses the mean {CALIB_TARGET}")
    replays_are_eager(torch, mixed, tokens, "calibrated")
    eager = forward_vit_tokens(mixed.params, tokens[k_stale], cfg,
                               mixed.policy)[0]
    old = stale.replay(tokens[k_stale]).clone()
    say(f"[bitplan] planted fault, a graph captured before the calibration "
        f"(k={k_stale}): its replay differs from the eager encode under the "
        f"new cache by {(old - eager).abs().max().item():.3e}")
    if torch.equal(old, eager):
        fail("the stale graph replays the new cache: the replay check "
             "cannot tell a stale graph")
    torch.cuda.synchronize()
    mem_stale = torch.cuda.memory_allocated()
    del stale, old
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    say(f"[bitplan] memory allocated on the card: {mem0 / 2**20:.1f} MiB "
        f"before the calibration, {mem_stale / 2**20:.1f} MiB after it with "
        f"the stale graph (and its old cache) held, {mem1 / 2**20:.1f} MiB "
        f"once it is dropped ({mem1 / mem0:.4f}x)")
    if mem1 > 1.10 * mem0:
        fail(f"memory after the re-capture {mem1} > 1.10 x {mem0}: old "
             f"graphs or caches leak")
    (r,) = mixed.serve().values()
    if len(r.predictions) != 8 or r.mean_bits != mean:
        fail(f"the calibrated serve: {r.summary()}, mean bits {r.mean_bits}")
    say(f"[bitplan] 8 frames served under the calibrated plan: "
        f"{r.summary()}")
    return {"fps": fps, "plan": plan}


def time_plan_kernels(torch, calls: dict, card: str) -> dict:
    """Device ms of B1 and B3 at each width of ``calls``, beside the 8-bit
    call of the same shape in the same run. Returns kernel -> {widths:
    ms}."""
    out = {"photonic_matmul": {}, "fused_ffn": {}}
    for (kname, widths), (fn, _) in calls.items():
        ms, _ = device_ms(torch, fn, SYMBOLS[kname], counter=kname,
                          per_launch=PER_LAUNCH.get(kname, 1))
        out[kname][str(widths)] = ms
    for kname, label in (("photonic_matmul", "(M, bits)"),
                         ("fused_ffn", "(w1, w2) bits")):
        say(f"[bitplan] {kname} device ms by {label}: " + ", ".join(
            f"{w} {ms:.5f}" for w, ms in out[kname].items()) + f" ({card})")
    return out


def check_composed_kernels(torch, dev) -> dict:
    """Path 4d's kernel shapes on the card against their plain versions:
    B2's wide tensor-core entry at Eq. 2's (D, Dv) = (768, 64), H 12, and
    ViT-Large's (1024, 64), H 16, with one shared key head and v a strided
    head view (scale 1.0, folded upstream), all keys live and a scattered
    mask with a fully masked batch row; B1 at the composed FFN's w1 / w2 and Eq. 2's
    per-head W_K^T product; the int32 accumulate through B1 with unit
    scales (``int_accumulate_pallas``), bitwise. Returns kernel -> largest
    absolute error."""
    from repro_torch.core.backend import int_accumulate_pallas
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (flash_attention_masked,
                                                     masked_entry_for)
    from repro_torch.kernels.photonic_matmul import (entry_for,
                                                     photonic_matmul_int8)

    gen = torch.Generator(device=dev).manual_seed(2468)
    err = {"photonic_matmul": 0.0, "flash_attention_masked": 0.0}
    b, h, s_, d, dv = EQ2_SHAPE
    for h, d in ((h, d), (16, 1024)):
        # q as Eq. 2 hands it over (Q_h W_K^T / sqrt(dh): unit-scale
        # scores), the key head a view of x, v split from its projection
        q = torch.randn(b, h, s_, d, generator=gen, device=dev) * d ** -0.5
        k = torch.randn(b, s_, d, generator=gen, device=dev)[:, None]
        v = torch.randn(b, s_, h * dv, generator=gen, device=dev).reshape(
            b, s_, h, dv).transpose(1, 2)
        m = (torch.rand(b, s_, generator=gen, device=dev) > 0.5).float()
        m[b - 1] = 0.0
        entry = masked_entry_for(d, dv)
        for mode, mask in (("all keys live", None), ("scattered mask", m)):
            before = _build.LAUNCHES["flash_attention_masked.wide"]
            got = flash_attention_masked(q, k, v, mask, scale=1.0)
            went = _build.LAUNCHES["flash_attention_masked.wide"] - before
            want = ref.flash_attention_masked_ref(q, k, v, mask, scale=1.0)
            e = (got - want).abs().max().item()
            say(f"[composed] B2 Eq. 2 q{tuple(q.shape)} Hk=1 Dv={dv} {mode} "
                f"{entry} entry: max abs err {e:.3e} (tol 2e-5)")
            if entry != "wide" or went != 1:
                fail(f"B2 at ({d}, {dv}): {went} launches of the wide entry "
                     f"(entry {entry})")
            if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
                fail(f"B2 at ({d}, {dv}), {mode}: max abs err {e}")
            if mask is not None and not bool((got[b - 1] == 0).all()):
                fail(f"B2 at ({d}, {dv}): a fully masked batch row is not 0")
            err["flash_attention_masked"] = max(
                err["flash_attention_masked"], e)
    for tag, (m_, k_, n_) in COMPOSED_B1.items():
        xq = torch.randint(-127, 128, (m_, k_), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        wt = wq.t().contiguous()
        acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                                   torch.ones(n_, device=dev), wt=wt)
        if not torch.equal(acc.long(), ref.int_accumulate_ref(xq, wq).long()):
            fail(f"B1 {tag}: int32 accumulate not bitwise")
        sx = torch.rand((), generator=gen, device=dev) * 1e-2
        sw = torch.rand(n_, generator=gen, device=dev) * 1e-2
        got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
        want = ref.photonic_matmul_ref(xq, wq, sx, sw)
        e = (got - want).abs().max().item()
        rel = e / max(want.abs().max().item(), 1e-30)
        say(f"[composed] B1 {tag:<22s} ({m_},{k_},{n_}) {entry_for(k_)} "
            f"entry: accumulate bitwise, max abs err {e:.3e}, rel "
            f"{rel:.3e} (tol 1e-6)")
        if rel > 1e-6:
            fail(f"B1 {tag}: relative error {rel} > 1e-6")
        err["photonic_matmul"] = max(err["photonic_matmul"], e)
    xq = torch.randint(-127, 128, (788, 768), generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (768, 768), generator=gen, device=dev,
                       dtype=torch.int8)
    ok = torch.equal(int_accumulate_pallas(xq, wq),
                     ref.int_accumulate_ref(xq, wq))
    say(f"[composed] int_accumulate_pallas (788,768,768), B1 at unit "
        f"scales: bitwise {ok} (tol bitwise)")
    if not ok:
        fail("int_accumulate_pallas is not the exact int32 accumulate")
    torch.cuda.synchronize()
    return err


def time_composed_kernels(torch, dev, card: str) -> dict:
    """B1 at the composed FFN's and Eq. 2's shapes (device ms, bound,
    ``torch._int_mm`` + dequant) and B2's wide entry at Eq. 2's shape, v
    a strided head view (device ms, CUDA-event ms, its 3xTF32 bound and
    the f32 one, plain, SDPA on the key head expanded with a boolean
    mask). Returns extra fields for the two kernels' entries of the
    kernels line (the wide entry's launches are path 4d's, filled in once
    it ran)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_masked,
                                                     masked_entry_for)
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8

    gen = torch.Generator(device=dev).manual_seed(1357)
    shapes = {}
    for tag, (m_, k_, n_) in COMPOSED_B1.items():
        xq = torch.randint(-127, 128, (m_, k_), generator=gen, device=dev,
                           dtype=torch.int8)
        wq, sw = qweight(torch, gen, k_, n_, 8, dev)
        wt = wq.t().contiguous()
        sx = torch.rand((), generator=gen, device=dev) * 1e-2
        fn = lambda: photonic_matmul_int8(xq, wq, sx, sw, wt=wt)  # noqa
        t_ms, _ = device_ms(torch, fn, SYMBOLS["photonic_matmul"],
                            counter="photonic_matmul")
        event_ms = cuda_ms(fn)
        plain_ms, _ = device_ms(torch, lambda: ref.photonic_matmul_ref(
            xq, wq, sx, sw))
        # torch._int_mm takes M below K = 128 only in multiples of 32
        # (cuBLASLt, kernels/fused_ffn.py::padded_int_mm): the library call
        # gets rows zero-padded once, outside the timing
        xl = xq if k_ >= 128 else torch.nn.functional.pad(
            xq, (0, 0, 0, -m_ % 32))
        lib, _ = device_ms(torch, lambda: torch._int_mm(
            xl, wq)[:m_].float() * sx * sw)
        ops_s = 2 * m_ * k_ * n_ / PEAK_INT8_OPS
        bytes_s = (m_ * k_ + k_ * n_ + 4 + 4 * n_ + 4 * m_ * n_) / PEAK_BYTES
        shapes[f"({m_},{k_},{n_})"] = {
            "ms": t_ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": max(ops_s, bytes_s) * 1e3}
        say(f"[numbers] photonic_matmul {tag} ({m_},{k_},{n_}) int8: kernel "
            f"{t_ms:.5f} ms device ({event_ms:.4f} ms CUDA-event, wrapper "
            f"included), bound {max(ops_s, bytes_s) * 1e3:.5f} ms "
            f"({'operations' if ops_s >= bytes_s else 'bytes'}), plain "
            f"{plain_ms:.4f} ms, library "
            f"{lib:.5f} ms (torch._int_mm + dequant"
            f"{'' if xl is xq else f', M padded to {xl.shape[0]}'}) "
            f"({card})")
    b, h, s_, d, dv = EQ2_SHAPE
    q = torch.randn(b, h, s_, d, generator=gen, device=dev) * d ** -0.5
    k = torch.randn(b, s_, d, generator=gen, device=dev)[:, None]
    v = torch.randn(b, s_, h * dv, generator=gen, device=dev).reshape(
        b, s_, h, dv).transpose(1, 2)
    keep = torch.ones(b, s_, device=dev)
    bmask = (keep > 0)[:, None, None, :]
    entry = masked_entry_for(d, dv)
    fn = lambda: flash_attention_masked(q, k, v, keep, scale=1.0)  # noqa
    # the entry's two kernels: K's split, then the attention
    wide = ("flash_attention_masked_wide_kernel",
            "flash_attention_masked_wide_split_kernel")
    ms, passes = device_ms(torch, fn, wide, counter="flash_attention_masked.wide",
                           per_launch=2)
    split_ms, _ = device_ms(torch, fn, wide[1:])
    event_ms = cuda_ms(fn)
    plain_ms, _ = device_ms(torch, lambda: ref.flash_attention_masked_ref(
        q, k, v, keep, scale=1.0))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q, k.expand(b, h, s_, d), v, attn_mask=bmask, scale=1.0)
    lib_ms, _ = device_ms(torch, sdpa)
    # no launch count guards the library's profiled time (a pass that
    # lost records reads low, PERF.md §7): its CUDA-event time beside it
    lib_event_ms = cuda_ms(sdpa)
    flops = 2 * b * h * s_ * s_ * (d + dv)
    nbytes = 4 * (b * h * s_ * d + b * s_ * d + 2 * b * h * s_ * dv + b * s_)
    # f32-class work on the tensor cores takes three TF32 passes
    ops_s, bytes_s = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    bound = max(ops_s, bytes_s)
    by = "operations" if ops_s >= bytes_s else "bytes"
    say(f"[numbers] flash_attention_masked {entry} (768, 64) "
        f"q{tuple(q.shape)} Hk=1 f32: kernel {ms:.5f} ms device ({split_ms:.5f} "
        f"of it K's split; profiling passes {passes}; {event_ms:.5f} ms "
        f"CUDA-event), bound "
        f"{bound * 1e3:.5f} ms ({by}; TF32 x 3 ops {ops_s * 1e3:.5f} ms, "
        f"bytes {bytes_s * 1e3:.5f} ms; at the f32 CUDA-core rate "
        f"{flops / PEAK_F32_FLOPS * 1e3:.5f} ms), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms device, {lib_event_ms:.4f} ms CUDA-event "
        f"(F.scaled_dot_product_attention, key head expanded, bool mask) "
        f"({card})")
    if not ms < lib_ms:
        say(f"[numbers] flash_attention_masked {entry} at Eq. 2's shape is "
            f"not ahead of SDPA ({ms:.5f} against {lib_ms:.5f} ms)")
    eq2 = {"entry": entry,
           "shape": f"q({b},{h},{s_},{d}) k({b},1,{s_},{d}) "
                    f"v({b},{h},{s_},{dv}) f32",
           "ms": ms, "split_ms": split_ms, "event_ms": event_ms,
           "plain_ms": plain_ms, "bound_ms": bound * 1e3, "bound_by": by,
           "library_ms": lib_ms, "library_event_ms": lib_event_ms}
    return {"flash_attention_masked": {f"{entry}_eq2": eq2},
            "photonic_matmul": {"ms_by_shape": shapes}}


def composed_against_cpu(torch, server, tag: str) -> None:
    """The newest flush of ``server`` against the port on the CPU (the
    plain versions): logits corr > 0.999 and equal argmax; each layer on
    the same input (the CPU walk's), card against CPU, corr > 0.9999 (one
    quant step: B3's class)."""
    from repro_torch.bridge import to_device
    from repro_torch.models.layers import layer_view
    from repro_torch.models.vit import encoder_layer_step, forward_vit_tokens

    cfg, pol = server.cfg, server.policy
    fb, logits = server.last_flush, server.last_logits
    t = fb.tokens
    cpu_params = to_device(server.params, "cpu")
    t0 = time.perf_counter()
    plain = forward_vit_tokens(cpu_params, t.cpu(), cfg, pol,
                               device="cpu")[0]
    plain_s = time.perf_counter() - t0
    end = corr(torch, logits, plain)
    same = bool(torch.equal(logits.cpu().argmax(-1), plain.argmax(-1)))
    b, _, d = t.shape
    x = torch.cat([(cpu_params["cls"].expand(b, 1, d)
                    + cpu_params["pos"][:, :1]), t.cpu()], dim=1)
    layers = []
    for i in range(cfg.n_layers):
        want = encoder_layer_step(x, layer_view(cpu_params["blocks"], i),
                                  cfg, pol)
        got = encoder_layer_step(x.to(server.device), layer_view(
            server.params["blocks"], i), cfg, pol)
        layers.append(corr(torch, got, want))
        x = want
    say(f"[composed] {tag}: flush k={fb.bucket[0]} re-encoded on the CPU "
        f"with the plain versions ({plain_s:.1f}s): logits corr {end:.6f}, "
        f"argmax equal {same}; each layer on the same input, card vs CPU: "
        f"corr >= {min(layers):.7f}")
    if (logits.shape != plain.shape
            or not bool(torch.isfinite(logits).all())):
        fail(f"{tag}: flush logits {tuple(logits.shape)} not finite")
    if not end > 0.999 or not same:
        fail(f"{tag}: card vs CPU logits corr {end}, argmax equal {same}")
    if min(layers) <= 0.9999:
        fail(f"{tag}: a layer, card vs CPU on the same input: corr "
             f"{min(layers)} <= 0.9999 ({layers})")


def run_composed(torch, dev, card: str, cfg, sc, params, streams, fused,
                 fused_results, fused_fps: float) -> dict:
    """Path 4d: opto-vit-base-224 on the composed dispatch through the
    graphed server, 4a's traffic, under (a) the reference CLI's default
    (photonic_pallas + xla attention + xla FFN) and (b) Eq. 2
    (photonic_pallas + flash + xla FFN, attn_impl "decomposed"); then
    ``run_dense`` on 4a's fused server over the same streams; then the
    bf16, qat and photonic_sim encoders, one flush each, against the CPU.
    Returns the checks' errors, the launches of the served runs and the
    readings."""
    import collections
    import gc
    from repro_torch.bridge import to_device
    from repro_torch.core.backend import prepare_params
    from repro_torch.kernels import _build
    from repro_torch.models.vit import forward_vit_masked, forward_vit_tokens
    from repro_torch.serving.server import StreamServer

    errs = check_composed_kernels(torch, dev)
    launches: collections.Counter = collections.Counter()
    fps = {}
    policies = (
        ("a", cfg.with_(attn_backend="", ffn_backend=""),
         {"photonic_matmul": 6 * cfg.n_layers + 1}),
        ("b", cfg.with_(ffn_backend="", attn_impl="decomposed"),
         {"photonic_matmul": (5 + cfg.n_heads) * cfg.n_layers + 1,
          "flash_attention_masked": cfg.n_layers,
          "flash_attention_masked.wide": cfg.n_layers}))
    for tag, c, want in policies:
        srv = StreamServer(c, sc, params=params)
        say(f"[composed] ({tag}) {srv.policy} attn_impl={c.attn_impl}: "
            f"warm start {srv.warm_s:.2f}s, CUDA graphs at buckets "
            f"{sorted(srv.graphs)}")
        if sorted(srv.graphs) != list(srv.ladder.sizes):
            fail(f"({tag}) graphs {sorted(srv.graphs)} for ladder "
                 f"{list(srv.ladder.sizes)}")
        for k, g in sorted(srv.graphs.items()):
            per = {n_: g.launches.get(n_, 0) for n_ in (
                "photonic_matmul", "flash_attention_masked",
                "flash_attention_masked.wide", "flash_attention_masked.simt",
                "flash_attention_masked.tc", "fused_ffn")}
            if {n_: per.get(n_, 0) for n_ in want} != want or per[
                    "fused_ffn"] or per["flash_attention_masked.tc"] or per[
                    "flash_attention_masked.simt"] or (
                    per["flash_attention_masked"] != want.get(
                        "flash_attention_masked", 0)):
                fail(f"({tag}) k={k}: launches a flush {per}, want {want}")
        cap = srv.graphs[srv.ladder.cap].launches
        say(f"[composed] ({tag}) launches a flush (every bucket's graph): "
            f"B1 {cap.get('photonic_matmul', 0)}, B2 wide "
            f"{cap.get('flash_attention_masked.wide', 0)}, B2 simt "
            f"{cap.get('flash_attention_masked.simt', 0)}, B2 tc "
            f"{cap.get('flash_attention_masked.tc', 0)}, B3 "
            f"{cap.get('fused_ffn', 0)}")
        tokens = flush_tokens(torch, srv, streams)
        for k, t in tokens.items():
            _build.LAUNCHES.clear()
            eager = forward_vit_tokens(srv.params, t, c, srv.policy)[0]
            eager_n = dict(_build.LAUNCHES)
            _build.LAUNCHES.clear()
            graphed = srv.graphs[k].replay(t).clone()
            if not torch.equal(graphed, eager) or dict(
                    _build.LAUNCHES) != eager_n:
                fail(f"({tag}) k={k}: replay vs eager max diff "
                     f"{(graphed - eager).abs().max().item():.3e}, "
                     f"launches {dict(_build.LAUNCHES)} against {eager_n}")
        spans = {k: cuda_ms(lambda k=k, t=t: srv.graphs[k].replay(t),
                            iters=10, warmup=2)
                 for k, t in tokens.items()}
        say(f"[composed] ({tag}) every bucket's replay is its eager encode "
            f"bitwise, with the eager call's launches; a flush's replay "
            f"span (4 frames, CUDA events): " + ", ".join(
                f"k={k} {v:.3f} ms" for k, v in spans.items()) + f" ({card})")
        srv.add_session(streams[0], n_frames=8, start=1000)
        srv.serve()                                        # warm-up
        ss = [srv.add_session(st, n_frames=32, start=16 * i)
              for i, st in enumerate(streams)]
        _build.LAUNCHES.clear()
        res = srv.serve()
        n = dict(_build.LAUNCHES)
        launches.update(n)
        for s in ss:
            r = res[s.sid]
            if set(r.predictions) != set(range(s.start, s.start + 32)):
                fail(f"({tag}) session {s.sid}: {len(r.predictions)} "
                     f"predictions for 32 frames")
        shapes = {kk: vv for kk, vv in sorted(n.items())
                  if kk.startswith("photonic_matmul.kmajor.K")}
        if not (n.get("photonic_matmul.kmajor.K3072") and (
                tag == "a" or n.get("photonic_matmul.kmajor.K64"))):
            fail(f"({tag}) B1 missed a composed shape: {shapes}")
        fps[tag] = 64 / max(res[s.sid].wall_s for s in ss)
        say(f"[composed] ({tag}) 2 streams x 32 frames: {fps[tag]:.2f} "
            f"frames/s against 4a's fused serve {fused_fps:.2f} ({card}); "
            f"{len(srv.flush_log)} flushes; launches {n}")
        composed_against_cpu(torch, srv, f"({tag})")
        del srv
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the mask-mode dense baseline on 4a's fused server, same streams
    fused.run_dense(streams[0], n_frames=8, start=1000)  # captures its graph
    if fused.dense_graph is None:
        fail("run_dense on the graphed server captured no graph")
    g = fused.dense_graph
    # the dense encode embeds its chunk too: 4 B1 a layer, the head and
    # the patch embed
    dense_want = {"photonic_matmul": 4 * cfg.n_layers + 2,
                  "flash_attention_masked": cfg.n_layers,
                  "fused_ffn": cfg.n_layers}
    per = {n_: g.launches.get(n_, 0) for n_ in dense_want}
    if per != dense_want:
        fail(f"dense encode launches {dict(g.launches)}, want {dense_want}")
    chunk = torch.from_numpy(streams[0].frames_at(0, sc.chunk)[
        "frames"]).to(dev)
    mask = (torch.rand(sc.chunk, fused.n_patches, device=dev) > 0.5).float()
    eager = forward_vit_masked(fused.params, chunk, mask, fused.cfg,
                               fused.policy)[0]
    if not torch.equal(g.replay(chunk, mask).clone(), eager):
        fail("the dense graph's replay is not its eager encode")
    _build.LAUNCHES.clear()
    dense = [fused.run_dense(st, n_frames=32, start=16 * i)
             for i, st in enumerate(streams)]
    dn = dict(_build.LAUNCHES)
    launches.update(dn)
    fault = vit_entry_fault(dn)
    if fault:
        fail(f"run_dense: {fault}")
    for i, (d_, b_) in enumerate(zip(dense, fused_results)):
        if (d_.frames != b_.frames or set(d_.predictions)
                != set(b_.predictions)
                or d_.scored_frames != b_.scored_frames
                or d_.bucket_hits != {fused.n_patches: 32}
                or not d_.mean_frame_uj > b_.mean_frame_uj):
            fail(f"run_dense stream {i}: {d_.summary()} against the "
                 f"bucketed {b_.summary()}")
        say(f"[composed] (c) dense stream {i}: {d_.summary()}; bucketed "
            f"{b_.mean_frame_uj:.4f} uJ a frame (modeled)")
    dense_fps = sum(d_.frames for d_ in dense) / sum(d_.wall_s for d_ in dense)
    say(f"[composed] (c) run_dense, mask-mode dense on the fused point "
        f"(one CUDA graph a chunk of {sc.chunk}; {dense_want} a chunk): "
        f"{dense_fps:.2f} frames/s; bucketed 4a {fused_fps:.2f} frames/s: "
        f"ratio {fused_fps / dense_fps:.3f}x (a reading, not a gate) "
        f"({card}); launches {dn}")

    # the bf16, qat and photonic_sim encoders, one flush each, card vs CPU
    fb = fused.last_flush
    raw_cpu = params
    for backend in ("bf16", "qat", "photonic_sim"):
        c = cfg.with_(matmul_backend=backend, attn_backend="",
                      ffn_backend="")
        cpu_p = (prepare_params(raw_cpu) if backend == "photonic_sim"
                 else raw_cpu)
        card_p = to_device(cpu_p, dev)
        _build.LAUNCHES.clear()
        got = forward_vit_tokens(card_p, fb.tokens, c)[0]
        n = dict(_build.LAUNCHES)
        want = forward_vit_tokens(cpu_p, fb.tokens.cpu(), c,
                                  device="cpu")[0]
        cc = corr(torch, got, want)
        same = bool(torch.equal(got.cpu().argmax(-1), want.argmax(-1)))
        say(f"[composed] {backend} + xla + xla encoder, flush k="
            f"{fb.bucket[0]}: card vs CPU logits corr {cc:.6f}, argmax "
            f"equal {same}; kernel launches {n or 'none'}")
        if not cc > 0.999 or not same:
            fail(f"{backend} encoder: card vs CPU corr {cc}, argmax equal "
                 f"{same}")
        del card_p
    return {"errs": errs, "launches": launches, "fps": fps,
            "dense_fps": dense_fps}


def noise_call(dev, spec, salts=(3,), counter=2, frame=5, drift=0.037):
    """A NoiseCall of a layer-salted call site on a state tensor on
    ``dev``."""
    from repro_torch.core import noise, threefry
    state = noise.DriftState(threefry.prng_key(3), frame, drift)
    with noise.noise_scope(state, state.to_tensor(dev)) as sc:
        sc.salts, sc.counter = tuple(salts), counter
        return noise.next_call_keys(spec)


def check_noise_kernel(torch, dev) -> float:
    """The noise-draw kernel against its plain version on the same state
    tensor at base-224's weight shapes and a ragged one: the bits (the
    draw key and its wander fold) bitwise; then under each of
    ``NOISE_CHECK_SPECS`` (wander and FPV both on; the default spec, the
    one 4e (B) and the CLI serve, wander off; FPV off) the multiplier (the
    f32 entry on unit weights) within 1e-6 absolute of the plain version
    on the card and on the CPU, the int8 codes bitwise f32(w) *
    multiplier, the shot readout (in place) within 1e-6 relative. Returns
    the largest multiplier error."""
    from repro_torch.core import noise
    from repro_torch.kernels import noise_draw, ref

    gen = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    for k, n in NOISE_SHAPES:
        call = noise_call(dev, noise.NoiseSpec(**NOISE_KW))
        st = call.state_tensor(dev)
        for fold in (0, noise._WANDER_FOLD):
            got = noise_draw.draw_bits(st, call.salts, call.counter, fold,
                                       (k, n))
            want = ref.draw_bits_ref(st.cpu(), call.salts, call.counter,
                                     fold, (k, n))
            if not torch.equal(got.cpu(), want):
                fail(f"noise_draw bits ({k},{n}) fold {fold:#x}: "
                     f"{int((got.cpu() != want).sum())} differ")
        for tag, kw in NOISE_CHECK_SPECS.items():
            spec = noise.NoiseSpec(**kw)
            call = noise_call(dev, spec)
            st = call.state_tensor(dev)
            ones = torch.ones(k, n, device=dev)
            mult = noise_draw.transmission_codes(ones, call, spec)
            args = (call.salts, call.counter, call.fpv_key, spec.mr(),
                    spec.fpv_sigma, spec.wander_sigma_nm)
            on_card = ref.transmission_codes_ref(ones, st, *args)
            on_cpu = ref.transmission_codes_ref(ones.cpu(), st.cpu(), *args)
            e_card = float((mult - on_card).abs().max())
            e_cpu = float((mult.cpu() - on_cpu).abs().max())
            wq, _ = qweight(torch, gen, k, n, 8, dev)
            codes = noise_draw.transmission_codes(wq, call, spec)
            y = torch.randn(k, n, generator=gen, device=dev)
            want = ref.readout_shot_ref(y, st, call.salts, call.counter,
                                        spec.shot_sigma)
            shot = noise_draw.readout_shot(y.clone(), call, spec.shot_sigma)
            e_shot = float((shot - want).abs().max() / y.abs().max())
            bitwise = torch.equal(codes, wq.float() * mult)
            say(f"[check] noise_draw ({k},{n}) {tag}: multiplier max "
                f"|kernel - plain| {e_card:.3e} on the card, {e_cpu:.3e} "
                f"against the CPU (spread {float(mult.std()):.4f}); codes "
                f"bitwise f32(w) * multiplier {bitwise}; shot readout "
                f"{e_shot:.3e} relative")
            if max(e_card, e_cpu) > 1e-6 or e_shot > 1e-6:
                fail(f"noise_draw ({k},{n}) {tag} off its plain version: "
                     f"multiplier {e_card:.3e} / {e_cpu:.3e}, shot "
                     f"{e_shot:.3e}")
            if not bitwise:
                fail(f"noise_draw ({k},{n}) {tag}: int8 codes are not "
                     f"f32(w) * M")
            worst = max(worst, e_card, e_cpu)
        say(f"[check] noise_draw ({k},{n}): bits bitwise (2 keys)")
    return worst


def time_noise_kernel(torch, dev, card: str) -> dict:
    """The kernels-line entry of noise_draw: the transmission entry at the
    w1 / w2 shape (3072, 768) and at (768, 768), device time (profiler)
    and CUDA-event time, its bound (integer operations, f32 instructions
    and bytes), the plain version on the card, and torch.randn at the same
    shape (a different generator: a yardstick, not the same function, so
    library_ms stays null). Launches and the error are filled in by 4e."""
    from repro_torch.core import noise
    from repro_torch.kernels import noise_draw, ref

    spec = noise.NoiseSpec(**NOISE_KW)
    call = noise_call(dev, spec)
    st = call.state_tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    by_shape = {}
    for k, n in ((3072, 768), (768, 768)):
        wq, _ = qweight(torch, gen, k, n, 8, dev)
        fn = lambda: noise_draw.transmission_codes(wq, call, spec)  # noqa
        ms, passes = device_ms(torch, fn, ("noise_transmission_kernel",),
                               counter="noise_draw.codes")
        event_ms = cuda_ms(fn)
        plain_ms, _ = device_ms(torch, lambda: ref.transmission_codes_ref(
            wq, st, call.salts, call.counter, call.fpv_key, spec.mr(),
            spec.fpv_sigma, spec.wander_sigma_nm), iters=3, warmup=1)
        randn_ms, _ = device_ms(torch, lambda: torch.randn(
            k, n, generator=gen, device=dev))
        elems = k * n
        int_s = elems * 3 * OPS_PER_DRAW / PEAK_INT32_OPS
        f32_s = elems * F32_PER_CODE / PEAK_F32_INSTR
        bytes_s = elems * (1 + 4) / PEAK_BYTES
        bound = max(int_s, f32_s, bytes_s)
        by = "operations" if max(int_s, f32_s) >= bytes_s else "bytes"
        by_shape[f"({k},{n})"] = {"ms": ms, "event_ms": event_ms,
                                  "plain_ms": plain_ms,
                                  "bound_ms": bound * 1e3, "bound_by": by,
                                  "randn_ms": randn_ms}
        say(f"[numbers] noise_draw codes ({k},{n}) int8: kernel {ms:.4f} ms "
            f"device (profiling passes {passes}; {event_ms:.4f} ms "
            f"CUDA-event), bound {bound * 1e3:.5f} ms ({by}; int32 ops "
            f"{int_s * 1e3:.5f} ms at {PEAK_INT32_OPS / 1e12:.1f} Tops/s, "
            f"f32 {f32_s * 1e3:.5f} ms, bytes {bytes_s * 1e3:.5f} ms), plain "
            f"{plain_ms:.4f} ms, torch.randn at the same shape (another "
            f"generator, a yardstick) {randn_ms:.4f} ms ({card})")
    y = torch.randn(788, 3072, generator=gen, device=dev)
    shot_ms, _ = device_ms(torch, lambda: noise_draw.readout_shot(
        y, call, spec.shot_sigma), ("noise_readout_shot_kernel",),
        counter="noise_draw.shot")
    say(f"[numbers] noise_draw shot readout (788,3072) in place: "
        f"{shot_ms:.4f} ms device ({card})")
    head = by_shape["(3072,768)"]
    return {"name": "noise_draw", "route": "cuda",
            "source": SOURCES["noise_draw"],
            "replaces": REPLACES["noise_draw"], "launches": 0,
            "max_abs_err": 0.0, "tol": TOLERANCES["noise_draw"],
            "ms": head["ms"], "event_ms": head["event_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "randn_ms": head["randn_ms"], "ms_by_shape": by_shape,
            "shot_ms": shot_ms}


def noisy_eager(torch, server, t):
    """The eager encode of ``t`` at the server's current DriftState (its
    state tensor written, a fresh scope), as ``_encode`` runs it."""
    from repro_torch.models.vit import forward_vit_tokens
    server._write_state()
    with server._scope():
        return forward_vit_tokens(server.params, t, server.cfg,
                                  server.policy, device=server.device)[0]


def noisy_tokens(torch, server, streams) -> dict:
    """Bucket -> 4 frames of a real chunk, embedded clean and gathered by
    the clean gate's order (the graphs' inputs for the replay checks)."""
    from repro_torch.models.vit import embed_patches
    from repro_torch.serving.server import _gather_topk_rows

    frames = streams[0].frames_at(0, 8)["frames"]
    toks = embed_patches(server.params, torch.from_numpy(frames).to(
        server.device), server.cfg, server.policy.without_noise())
    order = torch.argsort(torch.from_numpy(server._score_fn(frames)).to(
        server.device), dim=-1, descending=True, stable=True)
    return {k: _gather_topk_rows(toks, order, k)[:4].contiguous()
            for k in server.ladder.sizes}


def noisy_replays(torch, server, tokens: dict, want: dict, tag: str,
                  plant: bool) -> None:
    """At a pinned DriftState every bucket's graph (captured over the
    server's state tensor) replays the eager encode bitwise with the
    eager call's launch counts (``want``: those of the ViT kernels and
    noise_draw); a replay at the next frame differs. With ``plant``, the
    planted fault: a replay over a state tensor left at the old frame must
    not match the eager encode at the new one."""
    from repro_torch.core import noise, threefry
    from repro_torch.kernels import _build

    spec = server.noise
    pinned = noise.DriftState(threefry.prng_key(spec.seed), 7, 0.03)
    for k, t in tokens.items():
        server.drift = pinned
        _build.LAUNCHES.clear()
        eager = noisy_eager(torch, server, t)
        eager_n = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        server._write_state()
        graphed = server.graphs[k].replay(t).clone()
        replay_n = dict(_build.LAUNCHES)
        got = {n: replay_n.get(n, 0) for n in want}
        server.drift = pinned.advance(spec, 4)
        server._write_state()
        nxt = server.graphs[k].replay(t).clone()
        say(f"[noise] {tag} k={k}: replay bitwise the eager encode "
            f"{torch.equal(graphed, eager)}, launches a replay {got}; next "
            f"frame's replay max |d| {(nxt - graphed).abs().max().item():.3e}")
        if not torch.equal(graphed, eager):
            fail(f"{tag} k={k}: noisy replay differs from eager by "
                 f"{(graphed - eager).abs().max().item():.3e}")
        if replay_n != eager_n or got != want:
            fail(f"{tag} k={k}: launches a replay {replay_n}, eager "
                 f"{eager_n}, want {want}")
        if torch.equal(nxt, graphed):
            fail(f"{tag} k={k}: the next frame replayed the same noise")
        if plant:
            # the state advances but the tensor is not written: the graph
            # replays the old frame's draws
            server.drift = pinned.advance(spec, 8)
            stale = server.graphs[k].replay(t).clone()
            fresh = noisy_eager(torch, server, t)
            caught = not torch.equal(stale, fresh)
            say(f"[noise] planted fault (state tensor not written, k={k}): "
                f"stale replay vs the eager encode at the new frame max |d| "
                f"{(stale - fresh).abs().max().item():.3e}, caught {caught}")
            if not caught:
                fail("a replay over a stale state tensor matched the eager "
                     "encode at the new frame")
            plant = False


def noisy_serve(torch, server, streams) -> tuple:
    """4a's traffic (2 streams x 32 frames from phases 0 and 16) on a
    noisy server from a fresh DriftState; launches counted from 0. Returns
    (results in stream order, launches, wall s)."""
    from repro_torch.core import noise
    from repro_torch.kernels import _build

    server.drift = noise.DriftState.init(server.noise.seed)
    server._host_drift_nm = 0.0
    server.recalibrations = 0
    sessions = [server.add_session(st, n_frames=32, start=16 * i)
                for i, st in enumerate(streams)]
    _build.LAUNCHES.clear()
    res = server.serve()
    launches = dict(_build.LAUNCHES)
    chunks = sum(s.chunks_done for s in sessions)
    out = [res[s.sid] for s in sessions]
    for s, r in zip(sessions, out):
        if set(r.predictions) != set(range(s.start, s.start + 32)):
            fail(f"noisy session {s.sid}: {len(r.predictions)} predictions "
                 f"for 32 frames")
    return out, launches, chunks, max(r.wall_s for r in out)


def run_noise(torch, dev, card: str, cfg, sc, params, streams,
              fused_results, fused_fps: float) -> dict:
    """Path 4e: calibrated device noise on opto-vit-base-224 through the
    graphed server, 4a's traffic: (A) photonic_sim + flash + xla FFN under
    drift 0.01 nm a frame, wander 0.01 nm and a 0.08 nm recalibration
    bound, (B) photonic_pallas + xla + xla under the default NoiseSpec
    (no drift). Each: every bucket's replay bitwise its eager encode at a
    pinned state (and a new frame's replay different), noise_draw and B2
    launched the counted number of times a flush and nothing fused, every
    frame predicted, 4a's bucket hits; (A) also the planted stale-state
    fault, at least one billed recalibration (energy a frame above B's, the
    same routing) with the graphs still valid, and its newest flush
    re-encoded on the CPU at its state (corr > 0.999, equal argmax);
    readings: noisy against clean logits, frames/s beside 4a's."""
    from repro_torch.bridge import to_device
    from repro_torch.core import noise
    from repro_torch.models.vit import forward_vit_tokens
    from repro_torch.serving.server import StreamServer

    err = check_noise_kernel(torch, dev)
    out = {"err": err}
    L = cfg.n_layers
    per_flush = 2 * (6 * L + 1)        # a codes and a shot draw a matmul
    for tag, (backend, attn), spec in (
            ("A", ("photonic_sim", "flash"), noise.NoiseSpec(**NOISE_KW)),
            ("B", ("photonic_pallas", "xla"), noise.NoiseSpec())):
        ncfg = cfg.with_(matmul_backend=backend, attn_backend=attn,
                         ffn_backend="xla", noise=spec)
        t0 = time.perf_counter()
        server = StreamServer(ncfg, sc, params=params)
        build_s = time.perf_counter() - t0
        say(f"[noise] ({tag}) {server.policy}, {spec}: warm start "
            f"{server.warm_s:.2f}s ({build_s:.2f}s with the cache), graphs "
            f"at {sorted(server.graphs)}")
        want = {"noise_draw": per_flush, "photonic_matmul": 0,
                "fused_ffn": 0,
                "flash_attention_masked": L if attn == "flash" else 0,
                "flash_attention_masked.tc": L if attn == "flash" else 0}
        noisy_replays(torch, server, noisy_tokens(torch, server, streams),
                      want, tag, plant=tag == "A")
        res, launches, chunks, wall = noisy_serve(torch, server, streams)
        flushes = len(server.flush_log)
        fps = 64 / wall
        say(f"[noise] ({tag}) launches on the path: {launches}; {flushes} "
            f"flushes, {chunks} ingest chunks, {server.recalibrations} "
            f"recalibrations; 2 streams x 32 frames {fps:.2f} frames/s "
            f"against 4a's clean fused serve {fused_fps:.2f} ({card})")
        for r, c in zip(res, fused_results):
            say(f"[noise] ({tag}) {r.summary()} | recalibrations "
                f"{r.recalibrations}")
            if r.bucket_hits != c.bucket_hits:
                fail(f"({tag}) bucket hits {r.bucket_hits} vs the clean "
                     f"serve's {c.bucket_hits}")
        # the embed draws too: a codes and a shot launch an ingest chunk
        n_draw = per_flush * flushes + 2 * chunks
        b2 = L * flushes if attn == "flash" else 0
        if (launches.get("noise_draw", 0) != n_draw
                or launches.get("flash_attention_masked.tc", 0) != b2
                or launches.get("flash_attention_masked", 0) != b2
                or launches.get("fused_ffn", 0)):
            fail(f"({tag}) launches {launches}: want {n_draw} noise_draw, "
                 f"{b2} B2 on the tensor-core entry, no B3")
        if backend == "photonic_sim" and launches.get("photonic_matmul", 0):
            fail(f"({tag}) B1 launched {launches['photonic_matmul']} times "
                 f"on a photonic_sim path")
        out[tag] = {"server": server, "results": res, "fps": fps,
                    "launches": launches, "flushes": flushes}
    a, b = out["A"], out["B"]
    server = a["server"]
    if server.recalibrations < 1 or any(
            r.recalibrations != server.recalibrations for r in a["results"]):
        fail(f"(A) {server.recalibrations} recalibrations, billed "
             f"{[r.recalibrations for r in a['results']]}")
    uj_a = [r.mean_frame_uj for r in a["results"]]
    uj_b = [r.mean_frame_uj for r in b["results"]]
    say(f"[noise] (A) {server.recalibrations} recalibrations billed: "
        f"{uj_a} uJ a frame against (B)'s no-drift {uj_b}")
    if not all(x > y for x, y in zip(uj_a, uj_b)):
        fail(f"recalibrations not billed: {uj_a} vs {uj_b} uJ a frame")
    # the graphs stay valid across the recalibrations
    t = server.last_flush.tokens
    k = server.last_flush.bucket[0]
    eager = noisy_eager(torch, server, t)
    server._write_state()
    if not torch.equal(server.graphs[k].replay(t), eager):
        fail("(A) a replay after the recalibrations differs from eager")
    # the newest flush again on the CPU at its own state
    fb, logits, st = server.last_flush, server.last_logits, server.last_drift
    cpu_params = to_device(server.params, "cpu")
    t0 = time.perf_counter()
    with noise.noise_scope(st):
        plain = forward_vit_tokens(cpu_params, fb.tokens.cpu(), server.cfg,
                                   server.policy, device="cpu")[0]
    plain_s = time.perf_counter() - t0
    end = corr(torch, logits, plain)
    same = bool(torch.equal(logits.cpu().argmax(-1), plain.argmax(-1)))
    clean = forward_vit_tokens(server.params, fb.tokens, server.cfg,
                               server.policy.without_noise(),
                               device=server.device)[0]
    say(f"[noise] (A) flush k={fb.bucket[0]} at frame {int(st.frame)}, "
        f"drift {float(st.drift_nm):.3f} nm re-encoded on the CPU with the "
        f"plain versions ({plain_s:.1f}s): logits corr {end:.6f}, argmax "
        f"equal {same}; noisy vs clean logits corr "
        f"{corr(torch, logits, clean):.6f} (a reading)")
    if (logits.shape != plain.shape
            or not bool(torch.isfinite(logits).all())):
        fail(f"(A) flush logits {tuple(logits.shape)} not finite")
    if not end > 0.999 or not same:
        fail(f"(A) card vs CPU logits corr {end}, argmax equal {same}")
    # a noisy flush's span: replay (its state write and copy-in included)
    # and device time at every bucket
    tokens = noisy_tokens(torch, server, streams)
    for kb, tk in tokens.items():
        rep_ms = cuda_ms(lambda: server._encode(kb, tk), iters=10,
                         warmup=2)
        say(f"[noise] (A) noisy encode flush k={kb} (4 frames): graph "
            f"replay {rep_ms:.3f} ms (CUDA events, the state write "
            f"included) ({card})")
        out.setdefault("replay_ms", {})[kb] = rep_ms
    # where a noisy flush's device time goes (k = 196, 3 replays; a
    # reading: the profiler may drop records, PERF.md §7)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kb = max(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            server._encode(kb, tokens[kb])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 3e3
    say(f"[noise] (A) k={kb} flush under the profiler: device busy "
        f"{busy:.3f} ms a replay, {sum(e.count for e in events) / 3:.0f} "
        f"kernels ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"[noise] {e.self_device_time_total / 3e3:9.3f} ms "
            f"{e.count / 3:7.0f}x  {e.key[:90]}")
    out["launches"] = a["launches"]
    return out


def vit_flush_fault(launches: dict, flushes: int) -> str | None:
    """Why a serve of ``flushes`` encode flushes (each bucket's graph
    capture's eager run counting as one more) did not launch 12 B2 and 12
    B3 a flush and at least 49 B1 a flush (the gate and the patch embed
    launch B1 too) on the entries path a requires, or None."""
    b2, b3 = (launches.get(n, 0) for n in ("flash_attention_masked",
                                            "fused_ffn"))
    b1 = launches.get("photonic_matmul", 0)
    if (b2, b3) != (12 * flushes, 12 * flushes) or b1 < 49 * flushes:
        return (f"launches B1 {b1}, B2 {b2}, B3 {b3} for {flushes} flushes: "
                f"want at least {49 * flushes}, {12 * flushes} and "
                f"{12 * flushes}")
    return vit_entry_fault(launches)


def add_traffic(server, streams) -> list:
    """Register 4a's traffic on ``server``: 2 streams x 32 frames from
    phases 0 and 16."""
    return [server.add_session(st, n_frames=32, start=16 * i)
            for i, st in enumerate(streams)]


def control_serve(torch, server, sessions, encode_hook=None) -> tuple:
    """Serve the registered ``sessions`` (``add_traffic``), launches
    counted from 0. Returns (results in stream order, launches, graphs
    captured during the serve, wall s)."""
    from repro_torch.kernels import _build

    if encode_hook is not None:
        server._encode = encode_hook(server._encode)
    before = set(server.graphs)
    _build.LAUNCHES.clear()
    res = server.serve()
    launches = dict(_build.LAUNCHES)
    out = [res[s.sid] for s in sessions]
    for s, r in zip(sessions, out):
        if set(r.predictions) != set(range(s.start, s.start + 32)):
            fail(f"session {s.sid}: {len(r.predictions)} predictions for 32 "
                 f"frames")
    return (out, launches, sorted(set(server.graphs) - before),
            max(r.wall_s for r in out))


def run_control(torch, dev, card: str, cfg, sc, params, streams,
                fused) -> dict:
    """Path 4f: the serving control plane on 4a's model and traffic through
    the graphed server. (a) ``autotune=True, retune_every=8``, natural
    routing: the probed buckets priced on the H100 roofline, pricing
    capturing their graphs (each replay bitwise its eager encode); after
    the serve each priced bucket's replay time beside its roofline bound,
    the controller's report and held-out error, frames/s beside the static
    4a server's
    serve of the same traffic right after; every frame predicted, 49 B1,
    12 B2 (64, 64) and 12 B3 a flush, no clamp violation, calibrated. (b)
    ``force_bucket=0.5``, autotuned against static: predictions bitwise
    equal. (c) a ``watchdog=True`` server whose 13th flush this script
    delays by 50 ms: that flush is flagged; every flush in the telemetry;
    predictions bitwise 4a's. The static 4a server records nothing."""
    from dataclasses import replace
    from repro_torch.serving.server import StreamServer

    out = {}
    # (a) the autotuned server, natural routing
    t0 = time.perf_counter()
    server = StreamServer(cfg, replace(sc, autotune=True, retune_every=8),
                          params=params)
    if server.graphs or server.warmed:
        fail(f"an autotuned server warmed {sorted(server.warmed)} before "
             f"its probe")
    sessions = add_traffic(server, streams)
    ctl = server.autotune_prepare()
    prep_s = time.perf_counter() - t0
    cm = server.cost_model
    priced = sorted(cm.costs)
    say(f"[control] (a) autotune_prepare: probed and priced buckets "
        f"{priced} of {list(server.ladder.sizes)}, CUDA graphs at "
        f"{sorted(server.graphs)}; {prep_s:.2f}s with the cache ({card})")
    tokens = flush_tokens(torch, server, streams)
    replays_are_eager(torch, server, {k: tokens[k] for k in priced},
                      "costing-installed graph", phase="control")
    # the held-out error just before each step recuts the fit: the flushes
    # since the previous fit, scored against it (a reading of this script)
    held, step = [], ctl.step

    def scored_step(*args):
        e = ctl.median_rel_error()
        if e is not None:
            held.append((e, ctl.telemetry.seq - ctl._fit_seq))
        return step(*args)

    ctl.step = scored_step
    res, launches, lazy, wall = control_serve(torch, server, sessions)
    del ctl.step                    # no reference cycle keeps it alive
    flushes = len(server.flush_log)
    fps = 64 / wall
    fault = vit_flush_fault(launches, flushes + len(lazy))
    if fault:
        fail(f"(a) {fault}")
    if len(server.telemetry) != flushes or [
            (o.bucket, o.n_real) for o in server.telemetry] != [
            (k, n) for _, k, n in server.flush_log]:
        fail(f"(a) {len(server.telemetry)} telemetry records for {flushes} "
             f"flushes")
    err = (sorted(e for e, _ in held)[len(held) // 2] if held else None)
    err_all = ctl.median_rel_error(holdout=False)
    say(f"[control] (a) {flushes} flushes ({len(lazy)} buckets captured "
        f"during the serve: {lazy}), launches {launches}")
    say(f"[control] (a) {ctl.report()}")
    say(f"[control] (a) median relative error held out, before each step "
        f"(error, flushes since the fit): "
        f"{[(round(e, 4), n) for e, n in held]}, their median "
        f"{'n/a' if err is None else f'{err:.4f}'}; in window at the end "
        f"{'n/a' if err_all is None else f'{err_all:.4f}'}; fit "
        f"{ctl._fit}; buckets priced after the probe "
        f"{sorted(set(cm.costs) - set(priced))}")
    for r in res:
        say(f"[control] (a) {r.summary()} | measured ms a flush "
            f"{ {k: round(v, 4) for k, v in sorted(r.flush_wall_ms.items())} }")
    say("[control] cost model after the serve (H100 roofline, HW of "
        "repro_torch/roofline/report.py; buckets the probe missed were "
        "priced, and captured, at their first flush):")
    for line in cm.render().splitlines():
        say(f"[control]   {line}")
    replay = {}
    for k in sorted(cm.costs):
        replay[k] = cuda_ms(lambda: server.graphs[k].replay(tokens[k]),
                            iters=20)
        c = cm.costs[k]
        by = ("bytes" if c.hbm_bytes / cm.hw.hbm_bw >= c.device_s
              else "operations")
        say(f"[control] (a) k={k}: replay {replay[k]:.4f} ms (CUDA events, "
            f"copy-in included) against the roofline {c.device_s * 1e6:.2f} "
            f"us ({by}; {c.flops / 1e9:.3f} GFLOP, {c.int8_flops / 1e9:.3f} "
            f"of it int8, {c.hbm_bytes / 1e6:.2f} MB): "
            f"{replay[k] * 1e3 / (c.device_s * 1e6):.1f}x ({card})")
    if ctl.clamp_violations != 0 or not ctl.calibrated:
        fail(f"(a) controller: {ctl.clamp_violations} clamp violations, "
             f"calibrated {ctl.calibrated}")
    # the static 4a server on the same traffic, right after
    static4a, _, _, swall = control_serve(torch, fused,
                                          add_traffic(fused, streams))
    sfps = 64 / swall
    if fused.telemetry is not None or any(r.flush_wall_ms
                                          for r in static4a):
        fail("the untimed 4a server recorded flush times")
    say(f"[control] (a) 2 streams x 32 frames: autotuned {fps:.2f} frames/s "
        f"(one sync a flush) against the static 4a server's {sfps:.2f} in "
        f"the same run ({card})")
    out.update(launches=launches, fps=fps, static_fps=sfps, replay=replay,
               err=err, err_all=err_all)
    del server
    torch.cuda.empty_cache()

    # (b) force_bucket=0.5: autotuned against static, predictions bitwise
    fsc = replace(sc, force_bucket=0.5)
    auto = StreamServer(cfg, replace(fsc, autotune=True, retune_every=8),
                        params=params)
    asess = add_traffic(auto, streams)
    auto.autotune_prepare()
    static = StreamServer(cfg, fsc, params=params)
    ares, alaunch, alazy, _ = control_serve(torch, auto, asess)
    sres, _, _, _ = control_serve(torch, static, add_traffic(static,
                                                             streams))
    same = [a.predictions == b.predictions for a, b in zip(ares, sres)]
    say(f"[control] (b) force_bucket 0.5: ladder {list(auto.ladder.sizes)}, "
        f"priced {sorted(auto.cost_model.costs)}; predictions bitwise the "
        f"static server's per stream {same}; flush logs equal "
        f"{auto.flush_log == static.flush_log}; {auto.controller.report()}")
    if not all(same) or auto.flush_log != static.flush_log:
        fail("(b) autotuning changed predictions where every queue fills")
    fault = vit_flush_fault(alaunch, len(auto.flush_log) + len(alazy))
    if fault or auto.controller.clamp_violations:
        fail(f"(b) {fault}, {auto.controller.clamp_violations} clamp "
             f"violations")
    del auto, static
    torch.cuda.empty_cache()

    # (c) the watchdog flags a flush this script delays by 50 ms
    wsrv = StreamServer(cfg, replace(sc, watchdog=True), params=params)
    target, seen = 12, [0]

    def hook(encode):
        def delayed(k, tokens):
            logits = encode(k, tokens)
            if seen[0] == target:
                torch.cuda.synchronize(dev)
                time.sleep(0.05)
            seen[0] += 1
            return logits
        return delayed

    wres, wlaunch, _, _ = control_serve(torch, wsrv,
                                        add_traffic(wsrv, streams), hook)
    del wsrv._encode                # no reference cycle keeps it alive
    seqs = [o.seq for o in wsrv.straggler_flags]
    walls = [o.wall_s for o in wsrv.telemetry]
    say(f"[control] (c) watchdog: flush {target} delayed 50 ms by this "
        f"script; flagged flushes {seqs} ({len([q for q in seqs if q != target])} "
        f"others); {len(wsrv.telemetry)} telemetry records for "
        f"{len(wsrv.flush_log)} flushes; flush wall ms median "
        f"{sorted(walls)[len(walls) // 2] * 1e3:.3f}, the delayed one "
        f"{walls[target] * 1e3:.3f} ({card})")
    if target not in seqs:
        fail(f"(c) the delayed flush {target} was not flagged ({seqs})")
    if len(wsrv.telemetry) != len(wsrv.flush_log) or wsrv.controller:
        fail("(c) not every flush landed in the watchdog's telemetry")
    if [r.predictions for r in wres] != [r.predictions for r in static4a]:
        fail("(c) the watchdog server's predictions differ from 4a's")
    fault = vit_flush_fault(wlaunch, len(wsrv.flush_log))
    if fault:
        fail(f"(c) {fault}")
    del wsrv
    torch.cuda.empty_cache()
    return out


def flush_tags(server) -> list:
    """Keep each flush's (bucket, first (sid, frame index)) as ``server``
    serves, in flush order: the sites the fault injector hashes. ``del
    server._finish`` stops it."""
    tags, finish = [], server._finish

    def finish_and_tag(fb, by_sid):
        finish(fb, by_sid)
        tags.append((fb.bucket[0], fb.frame_idx[0]))
    server._finish = finish_and_tag
    return tags


def first_seed(hits, start: int, want) -> int:
    """The first fault seed from ``start`` whose injected sites (``hits``
    of a seed: the flush indices it injects at) satisfy ``want``."""
    for seed in range(start, start + 1000):
        if want(hits(seed)):
            return seed
    fail(f"no fault seed in [{start}, {start + 1000}) exercises the check")


def normalized(flush_log, sid0: int) -> list:
    """A flush log with its owners counted from ``sid0``."""
    return [(tuple(o - sid0 for o in owners), k, n)
            for owners, k, n in flush_log]


def faults_serve(torch, server, streams, check=True) -> tuple:
    """4a's traffic on ``server``; launches counted from 0. Returns
    (sessions, results in stream order, launches, wall s)."""
    from repro_torch.kernels import _build

    sessions = add_traffic(server, streams)
    _build.LAUNCHES.clear()
    res = server.serve()
    launches = dict(_build.LAUNCHES)
    out = [res[s.sid] for s in sessions]
    if check:
        for s, r in zip(sessions, out):
            if set(r.predictions) != set(range(s.start, s.start + 32)):
                fail(f"[faults] session {s.sid}: {len(r.predictions)} "
                     f"predictions for 32 frames")
    return sessions, out, launches, max(r.wall_s for r in out)


def state_checked(server) -> list:
    """Wrap every graph of a noisy ``server``: before each replay record
    whether its state tensor holds the words of the server's DriftState
    (the state the flush must draw at)."""
    import numpy as np

    seen = []
    for g in server.graphs.values():
        def checked(tokens, mask=None, g=g, replay=g.replay):
            seen.append(bool(np.array_equal(server._state_t.cpu().numpy(),
                                            server.drift.words())))
            return replay(tokens, mask)
        g.replay = checked
    return seen


def run_faults(torch, dev, card: str, cfg, sc, params, streams, fused,
               clean, noisy_b) -> dict:
    """Path 4g: faults, checkpoints and migration on 4a's model and traffic
    through the graphed server (each sub-phase's server built from the same
    raw params; ``fused`` is the 4a server, ``clean`` its results,
    ``noisy_b`` 4e (B)'s). (A) 10% transient flush faults: every session
    completes with retries, predictions and flush log bitwise a clean
    re-serve's, frames/s beside it. (B) session 1 hard-fails at chunk 2:
    it comes back poisoned, no later flush carries its frames, session 0
    bitwise its solo serve. (C) a crash at round 2 with a checkpoint every
    round, through ``serve_with_restarts``: one restart, predictions
    bitwise 4a's, the restored server's graphs bitwise its eager encode.
    (D) paused at round 2, session 1 exported and adopted by a second
    graphed server: both bitwise 4a's. (E) under 4e (B)'s NoiseSpec: a
    checkpoint at round 2 restored into a fresh server, whose state tensor
    holds the snapshot's DriftState at every replay and whose predictions
    are the uninterrupted ones; a planted restore that leaves ``_written``
    stale must fail that check. (F) injected stalls under the watchdog:
    each one after the detector's 10-flush warm-up is flagged. Readings:
    a ``checkpoint()``'s wall ms, a restore's read and re-capture s."""
    import gc
    import tempfile
    from dataclasses import replace

    from repro_torch.core import noise
    from repro_torch.serving.faults import (FaultInjector, FaultSpec,
                                            serve_with_restarts)
    from repro_torch.serving.server import StreamServer

    out = {}
    want = [r.predictions for r in clean]
    # the clean re-serve on the 4a server: the baseline flush log, the
    # flush sites (in flush order) and frames/s
    tags = flush_tags(fused)
    csess, cres, _, cwall = faults_serve(torch, fused, streams)
    del fused._finish
    sid0 = csess[0].sid
    clog = normalized(fused.flush_log, sid0)
    sites = [(k, (sid - sid0, fi)) for k, (sid, fi) in tags]
    if [r.predictions for r in cres] != want:
        fail("[faults] the clean re-serve differs from 4a's serve")
    cfps = 64 / cwall

    # (A) 10% transient flush faults
    def flush_hits(seed):
        inj = FaultInjector(FaultSpec(flush_fault_rate=0.10, seed=seed))
        return [i for i, (k, (sid, fi)) in enumerate(sites)
                if inj._hit(0.10, "flush", k, sid, fi)]
    seed_a = first_seed(flush_hits, 7, bool)
    srv = StreamServer(cfg, replace(sc, faults=FaultSpec(
        flush_fault_rate=0.10, seed=seed_a)), params=params)
    sess, res, launches, wall = faults_serve(torch, srv, streams)
    fps = 64 / wall
    retries = [r.retries for r in res]
    say(f"[faults] (A) flush_fault_rate 0.10 (seed {seed_a}, the first "
        f"from 7 that hits one of the {len(sites)} flush sites: "
        f"{flush_hits(seed_a)}): {srv._injector.report()}; retries "
        f"{retries}; predictions bitwise the clean serve's "
        f"{[r.predictions for r in res] == want}, flush log equal "
        f"{normalized(srv.flush_log, sess[0].sid) == clog}; {fps:.2f} "
        f"frames/s against the clean re-serve's {cfps:.2f} "
        f"({fps / cfps:.3f}x; the reference's gate is 0.7x) ({card})")
    if ([r.predictions for r in res] != want or any(r.poisoned for r in res)
            or sum(retries) != len(flush_hits(seed_a))
            or normalized(srv.flush_log, sess[0].sid) != clog):
        fail("(A) transient flush faults changed the served predictions")
    fault = vit_flush_fault(launches, len(srv.flush_log))
    if fault:
        fail(f"[faults] (A) {fault}")
    out.update(launches=launches, fps=fps, clean_fps=cfps)
    del srv
    torch.cuda.empty_cache()

    # (B) session 1 hard-fails at its chunk 2; session 0 against its solo
    srv = StreamServer(cfg, replace(sc, faults=FaultSpec(
        hard_fail_session=1, hard_fail_at_chunk=2)), params=params)
    late, finish = [], srv._finish

    def watch(fb, by_sid):
        if by_sid[1].failed_reason and any(s == 1 for s, _ in fb.frame_idx):
            late.append(fb.frame_idx)
        return finish(fb, by_sid)
    srv._finish = watch
    sess, res, _, _ = faults_serve(torch, srv, streams, check=False)
    del srv._finish
    solo = fused.add_session(streams[0], n_frames=32, start=0)
    sres = fused.serve()[solo.sid]
    r0, r1 = res
    say(f"[faults] (B) session 1 poisoned {r1.poisoned} ({r1.failure!r}), "
        f"{r1.frames} of its frames served, {len(late)} flushes after the "
        f"failure carrying its frames; session 0 bitwise its solo serve "
        f"{r0.predictions == sres.predictions} and 4a's "
        f"{r0.predictions == want[0]}")
    if (not r1.poisoned or "session 1" not in r1.failure or late
            or r0.poisoned or r0.predictions != sres.predictions
            or r0.predictions != want[0] or r1.frames >= 32):
        fail("(B) quarantine leaked into the other session or the victim")
    del srv
    torch.cuda.empty_cache()

    # (C) a crash at round 2 and a checkpoint every round:
    # serve_with_restarts restores from the last snapshot
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    built, read_s, queued = [], [], []

    def make_server(attempt):
        t0 = time.perf_counter()
        s_ = StreamServer(cfg, replace(
            sc, checkpoint_dir=root, checkpoint_every=1,
            faults=FaultSpec(crash_at_round=2) if attempt == 0 else None),
            params=params)
        built.append((time.perf_counter() - t0, s_.warm_s))
        real = s_.restore_checkpoint

        def timed(*a, **k):
            t1 = time.perf_counter()
            got = real(*a, **k)
            read_s.append(time.perf_counter() - t1)
            queued.append(sum(len(x._pending_restore or ())
                              for x in got.values()))
            return got
        s_.restore_checkpoint = timed
        return s_

    t0 = time.perf_counter()
    results, restarts, srv = serve_with_restarts(
        make_server, lambda s_: add_traffic(s_, streams), root)
    c_s = time.perf_counter() - t0
    del srv.restore_checkpoint
    got = [results[sid].predictions for sid in sorted(results)]
    say(f"[faults] (C) crash at round 2, a checkpoint every round: "
        f"{restarts} restart(s), predictions bitwise 4a's {got == want}, "
        f"{queued[0]} queued groups restored; "
        f"the restored server built in {built[-1][0]:.3f}s (warm start, "
        f"the graphs' re-capture, {built[-1][1]:.3f}s), the snapshot read "
        f"in {read_s[0] if read_s else float('nan'):.4f}s; {c_s:.2f}s in "
        f"all ({card})")
    if restarts != 1 or got != want or len(read_s) != 1:
        fail(f"(C) {restarts} restarts, predictions bitwise {got == want}")
    replays_are_eager(torch, srv, flush_tokens(torch, srv, streams),
                      "restored server's graph", phase="faults")
    out.update(restore_read_s=read_s[0], restore_capture_s=built[-1][1],
               restore_build_s=built[-1][0])
    del srv, results
    gc.collect()
    torch.cuda.empty_cache()

    # (D) paused at round 2, a checkpoint timed, session 1 migrated
    droot = tempfile.mkdtemp(prefix="chip_smoke_dckpt_")
    srv = StreamServer(cfg, sc, params=params)
    sess = add_traffic(srv, streams)
    if srv.serve(max_rounds=2) != {}:
        fail("(D) serve(max_rounds=2) did not pause")
    ck_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        srv.checkpoint(root=droot, step=100 + len(ck_ms))
        ck_ms.append((time.perf_counter() - t0) * 1e3)
    dst = StreamServer(cfg, sc, params=params)
    t0 = time.perf_counter()
    snap = srv.export_session(sess[1].sid)
    dst.adopt_session(snap)
    mig_ms = (time.perf_counter() - t0) * 1e3
    rb, ra = dst.serve(), srv.serve()
    ok = (ra[sess[0].sid].predictions == want[0]
          and rb[sess[1].sid].predictions == want[1]
          and sess[1].sid not in ra)
    say(f"[faults] (D) paused at round 2: checkpoint() "
        f"{', '.join(f'{m:.3f}' for m in ck_ms)} ms; session 1 exported "
        f"with {len(snap['meta']['pending'])} queued groups "
        f"({sum(len(p_['fidx']) for p_ in snap['meta']['pending'])} rows) "
        f"and adopted in {mig_ms:.3f} ms; both servers bitwise 4a's {ok} "
        f"({card})")
    if not ok:
        fail("(D) a migrated session's predictions differ")
    out["checkpoint_ms"] = ck_ms
    del srv, dst, snap
    torch.cuda.empty_cache()

    # (E) under 4e (B)'s NoiseSpec: checkpoint at round 2, restore, the
    # state tensor checked at every replay; a planted stale restore
    ncfg = cfg.with_(matmul_backend="photonic_pallas", attn_backend="xla",
                     ffn_backend="xla", noise=noise.NoiseSpec())
    nroot = tempfile.mkdtemp(prefix="chip_smoke_nckpt_")
    srv = StreamServer(ncfg, sc, params=params)
    add_traffic(srv, streams)
    if srv.serve(max_rounds=2) != {}:
        fail("(E) serve(max_rounds=2) did not pause")
    srv.checkpoint(root=nroot)
    resumed = srv.serve()
    nwant = [r.predictions for r in noisy_b]
    if [resumed[sid].predictions for sid in sorted(resumed)] != nwant:
        fail("(E) the paused noisy serve, resumed, differs from 4e (B)'s")
    del srv
    torch.cuda.empty_cache()
    checks = {}
    for plant in (False, True):
        t0 = time.perf_counter()
        fresh = StreamServer(ncfg, sc, params=params)
        capture_s = fresh.warm_s
        t1 = time.perf_counter()
        fresh.restore_checkpoint(nroot)
        read = time.perf_counter() - t1
        if plant:
            # the planted fault: the restore claims the state is written
            fresh._written = fresh.drift.words()
        seen = state_checked(fresh)
        res = fresh.serve()
        got = [res[sid].predictions for sid in sorted(res)]
        checks[plant] = (bool(seen) and all(seen), got == nwant)
        say(f"[faults] (E) {'planted stale restore' if plant else 'restore'}"
            f" of the noisy snapshot (round 2): built {t1 - t0:.3f}s (re-capture "
            f"{capture_s:.3f}s), read {read:.4f}s; state tensor = the "
            f"DriftState at every replay {checks[plant][0]} ({len(seen)} "
            f"replays, first {seen[0] if seen else None}); predictions "
            f"bitwise the uninterrupted noisy serve's {checks[plant][1]}")
        for g in fresh.graphs.values():
            del g.replay
        del fresh
        torch.cuda.empty_cache()
    if checks[False] != (True, True):
        fail("(E) a restored noisy server replayed a stale state tensor or "
             "other predictions")
    if checks[True][0]:
        fail("(E) the planted stale restore was not caught")

    # (F) injected stalls under the watchdog
    def stall_hits(seed):
        inj = FaultInjector(FaultSpec(stall_rate=0.15, seed=seed))
        return [i for i, (k, (sid, fi)) in enumerate(sites)
                if inj._hit(0.15, "stall", k, sid, fi)]
    seed_f = first_seed(stall_hits, 6, lambda h: h and min(h) >= 10)
    srv = StreamServer(cfg, replace(sc, watchdog=True, faults=FaultSpec(
        stall_rate=0.15, stall_s=0.05, seed=seed_f)), params=params)
    _, res, _, _ = faults_serve(torch, srv, streams)
    flagged = sorted(o.seq for o in srv.straggler_flags)
    stalled = stall_hits(seed_f)
    walls = sorted(o.wall_s for o in srv.telemetry)
    say(f"[faults] (F) stall_rate 0.15 (seed {seed_f}, the first from 6 "
        f"whose stalls all fall after the detector's 10-flush warm-up): "
        f"stalled flushes {stalled} ({srv._injector.report()}), flagged "
        f"{flagged}; flush wall ms median "
        f"{walls[len(walls) // 2] * 1e3:.3f}; predictions bitwise 4a's "
        f"{[r.predictions for r in res] == want} ({card})")
    if (not set(stalled) <= set(flagged)
            or srv._injector.injected["stall"] != len(stalled)
            or [r.predictions for r in res] != want):
        fail("(F) an injected stall was not flagged")
    del srv
    torch.cuda.empty_cache()
    return out


# path 4h: the fleet router over the reference CLI's traffic (8 streams,
# frames 32 x (1, 3, 2, ...), stream i from frame 8 i, a scene cut every 32
# frames) on 4 in-process workers, and the 1-D data mesh over 2 ranks
FLEET_WORKERS, FLEET_STREAMS = 4, 8


def fleet_spec(streams) -> list:
    """(stream, frames, start) of each job of the reference CLI's mix."""
    return [(st, 32 * (1 + (2 * i) % 3), 8 * i)
            for i, st in enumerate(streams)]


def per_worker_launches(router) -> dict:
    """Wrap each worker's ``serve`` to record the kernel launches it made
    (worker index -> counts); ``del w.serve`` stops it."""
    import collections

    from repro_torch.kernels import _build

    per = {}
    for i, w in enumerate(router.workers):
        def serve(*a, i=i, orig=w.serve, **k):
            before = collections.Counter(_build.LAUNCHES)
            out = orig(*a, **k)
            per[i] = dict(collections.Counter(_build.LAUNCHES) - before)
            return out
        w.serve = serve
    return per


def job_flushes(logged: dict, sid: int) -> dict:
    """``log_flushes`` entries of session ``sid``, keyed by frame indices
    (micro-batches are session-pure, so each flush has one owner)."""
    return {tuple(f for _, f in key): v for key, v in logged.items()
            if key[0][0] == sid}


def fleet_round(torch, router, spec, solo: dict, tag: str,
                change=None) -> dict:
    """Place ``spec`` on ``router`` (``change(router, jobs)`` runs after
    placement), serve, and hold every job to its solo serve: every frame
    predicted, predictions and each flush's logits bitwise. Returns the
    jobs, walls, per-worker launches, aggregate frames/s and warnings."""
    import warnings

    from repro_torch.kernels import _build

    router.jobs.clear()
    jobs = [router.add_job(st, n_frames=nf, start=s0)
            for st, nf, s0 in spec]
    if change is not None:
        change(router, jobs)
    per = per_worker_launches(router)
    logs = [log_flushes(w) for w in router.workers]
    _build.LAUNCHES.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = router.serve()
    launches = dict(_build.LAUNCHES)
    for w in router.workers:
        del w.serve, w._finish
    for i, j in enumerate(jobs):
        preds, flushes = solo[i]
        got = res[j.job_id].predictions
        if set(got) != set(range(j.start, j.start + j.n_frames)):
            fail(f"[fleet] {tag} job {j.job_id}: {len(got)} predictions "
                 f"for {j.n_frames} frames")
        mine = job_flushes(logs[j.worker], j.sid)
        if got != preds or mine.keys() != flushes.keys() or not all(
                torch.equal(mine[k], v) for k, v in flushes.items()):
            fail(f"[fleet] {tag} job {j.job_id} (worker {j.worker}) is not "
                 f"bitwise its solo serve")
    for i, n in per.items():
        fault = vit_entry_fault(n)
        if fault or not all(n.get(k, 0) for k in VIT_KERNELS):
            fail(f"[fleet] {tag} worker {i}: {fault or n}")
    dead = [str(w.message) for w in rec
            if "fleet dead buckets" in str(w.message)]
    if len(dead) != 1:
        fail(f"[fleet] {tag}: {len(dead)} aggregated dead-bucket warnings")
    frames = sum(j.n_frames for j in jobs)
    return {"jobs": jobs, "walls": list(router.last_walls),
            "fps": frames / max(router.last_walls), "per": per,
            "launches": launches, "warning": dead[0]}


def data_mesh_rank(params: dict, cfg, sc, device: str) -> dict:
    """One rank of path 4h (D): 4a's traffic on the 1-D data mesh (mesh
    "auto", no model shards). Checks its own launches (B1 inside the split
    at half a flush's rows, every B3 launch through the host-split
    binding), re-encodes the newest flush with and without a planted
    local absmax, and returns what the parent compares (rank 0's flush
    logits)."""
    import torch
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import ops
    from repro_torch.models.vit import forward_vit_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, launch = [], ops.photonic_matmul_int8

    def recorded(xq, *a, **k):
        if sharding.absmax_group() is not None:
            rows.append(int(xq.shape[0]))
        return launch(xq, *a, **k)
    ops.photonic_matmul_int8 = recorded
    run = serve_large(cfg, sc, params, device)
    server = run["server"]
    mesh = server.mesh
    if mesh.axis_names != ("data",) or server.graphs:
        raise RuntimeError(f"mesh {mesh.axis_names}, graphs "
                           f"{sorted(server.graphs)}")
    n_flush = len(server.flush_log)
    launches = run["launches"]
    if device == "cuda":
        fault = vit_entry_fault(launches)
        b3 = launches.get("fused_ffn", 0)
        if fault or b3 != cfg.n_layers * n_flush or launches.get(
                "fused_ffn.kmajor.split", 0) != b3:
            raise RuntimeError(f"data mesh launches {launches}: {fault}")

    fb = server.last_flush

    def encode_newest():
        with sharding.use_sharding(mesh):
            return forward_vit_tokens(server.params, fb.tokens, cfg,
                                      server.policy,
                                      device=server.device)[0].float().cpu()

    again = encode_newest()
    saved = sharding.absmax_group
    sharding.absmax_group = lambda: None
    try:
        planted = encode_newest()
    finally:
        sharding.absmax_group = saved
    ops.photonic_matmul_int8 = launch
    out = {"launches": launches, "n_flush": n_flush, "wall": run["wall"],
           "stats": run["stats"], "rows": sorted(set(rows)),
           "split": run["data_calls"]["split"],
           "whole": run["data_calls"]["whole"],
           "backend": mesh.backend, "shape": mesh.shape}
    if mesh.d == 0:
        out.update(flushes=run["flushes"], again=again, planted=planted,
                   newest=tuple(fb.frame_idx),
                   flush_log=[(k, n) for _, k, n in server.flush_log],
                   predictions=[run["results"][s.sid].predictions
                                for s in run["sessions"]])
    return out


def run_fleet(torch, dev, card: str, cfg, sc, params, fused) -> dict:
    """Path 4h on ``cfg`` (opto-vit-base-224): (A) 4 in-process workers
    sharing one cache, each with its own CUDA graphs over it, serve the
    reference CLI's 8 streams under cost placement, then rr; every job
    bitwise its solo serve (a graphed server over the same cache), B1-B3
    launched on every worker; readings: walls, aggregate frames/s, one
    worker (the solo server with all 8 streams) against 4. (B) rr
    placement, ``rebalance``, one ``migrate`` and ``drain(1)`` through
    checkpoint / restore: every job bitwise its solo serve, the
    replacement's replays bitwise its eager encode. (C) two spawned
    workers on the card: each reports its launches and graphs and built
    no kernel; worker 0's jobs (seed 0, 4a's weights) bitwise their solo
    serves. (D) the 1-D data mesh: 2 gloo ranks on the card serve 4a's
    traffic (``fused``: 4a's eager server config) with every flush's
    logits bitwise the unsharded eager card serve, B1 inside the split at
    half a flush's rows, every B3 launch through its host-split binding,
    and a planted local absmax that must break the equality; readings:
    frames/s, collective ms a flush."""
    import tempfile

    from repro_torch.data.pipeline import video_fleet
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.fleet import FleetRouter
    from repro_torch.serving.server import ServerConfig, StreamServer
    from repro_torch.serving.session import ServingConfig

    out = {}
    fsc = ServerConfig.from_serving(
        ServingConfig(microbatch=4, chunk=8, force_bucket=0.5),
        warm_start=True)
    streams = video_fleet(FLEET_STREAMS, img_size=cfg.img_size,
                          patch=cfg.patch, cut_every=32)
    spec = fleet_spec(streams)
    t0 = time.perf_counter()
    router = FleetRouter(cfg, fsc, workers=FLEET_WORKERS, seed=0)
    build_s = time.perf_counter() - t0
    w0 = router.workers[0]
    for i, w in enumerate(router.workers):
        if sorted(w.graphs) != list(w.ladder.sizes) or any(
                g.params is not w.params for g in w.graphs.values()):
            fail(f"[fleet] worker {i}: graphs {sorted(w.graphs)}")
        if (w.params["blocks"]["ffn"]["w1"].wq.data_ptr()
                != w0.params["blocks"]["ffn"]["w1"].wq.data_ptr()):
            fail(f"[fleet] worker {i} does not share worker 0's cache")
    price = router.price_per_frame()
    say(f"[fleet] {FLEET_WORKERS} in-process workers of {cfg.name}-"
        f"{cfg.img_size} (force_bucket 0.5, micro-batch 4, chunk 8) on one "
        f"shared cache, {len(w0.graphs)} CUDA graphs each, built in "
        f"{build_s:.2f}s; price {price * 1e6:.3f} us a frame "
        f"(EncodeCostModel at bucket "
        f"{w0.ladder.route(int(round(0.5 * w0.n_patches)))}, {card})")

    # the solo serves: each job's stream alone on a graphed server over the
    # same cache; then all 8 at once (one worker)
    solo_srv = StreamServer(cfg, fsc, params=w0.params)
    solo = []
    for st, nf, s0 in spec:
        logged = log_flushes(solo_srv)
        s = solo_srv.add_session(st, n_frames=nf, start=s0)
        res = solo_srv.serve()
        del solo_srv._finish
        solo.append((res[s.sid].predictions, job_flushes(logged, s.sid)))
    one = [solo_srv.add_session(st, n_frames=nf, start=s0)
           for st, nf, s0 in spec]
    t0 = time.time()
    res = solo_srv.serve()
    one_wall = time.time() - t0
    if [res[s.sid].predictions for s in one] != [p for p, _ in solo]:
        fail("[fleet] one worker serving all 8 streams is not bitwise the "
             "solo serves")
    frames = sum(nf for _, nf, _ in spec)
    one_fps = frames / one_wall

    # (A) cost placement, then rr
    for placement in ("cost", "rr"):
        router.placement = placement
        r = fleet_round(torch, router, spec, solo, placement)
        out[placement] = r
        say(f"[fleet] (A) {placement}: workers "
            f"{[j.worker for j in r['jobs']]}, predicted queue "
            f"{[round(sum(j.cost_s for j in r['jobs'] if j.worker == i), 6) for i in range(FLEET_WORKERS)]} s; "
            f"every job bitwise its solo serve; walls "
            f"{[round(w, 4) for w in r['walls']]} s -> {r['fps']:.2f} "
            f"frames/s aggregate ({frames} frames); launches a worker "
            f"{ {i: {k: n.get(k, 0) for k in VIT_KERNELS} for i, n in sorted(r['per'].items())} } "
            f"({card})")
    say(f"[fleet] (A) the aggregated warning: {out['cost']['warning']}")
    say(f"[fleet] (A) 1 worker (8 streams on one server): {one_wall:.4f}s "
        f"= {one_fps:.2f} frames/s; 4 workers: cost "
        f"{out['cost']['fps']:.2f} ({out['cost']['fps'] / one_fps:.3f}x, "
        f"the reference's structural gate 1.5x), rr {out['rr']['fps']:.2f}"
        f" (cost / rr {out['cost']['fps'] / out['rr']['fps']:.3f}x, the "
        f"reference's gate 1.15x); readings, not gated ({card})")

    # (B) rr placement, rebalance, one migrate, drain(1)
    moved, repl = [], []

    def change(router, jobs):
        moved.extend(router.rebalance())
        j = next(j for j in jobs if j.worker != 0)
        router.migrate(j.job_id, 0)
        moved.append(("migrate", j.job_id, 0))
        with tempfile.TemporaryDirectory(prefix="fleet_drain_") as root:
            t = time.perf_counter()
            repl.append(router.drain(1, root=root))
            moved.append(("drain_s", round(time.perf_counter() - t, 3)))
    router.placement = "rr"
    r = fleet_round(torch, router, spec, solo, "(B)", change)
    new = repl[0]
    replays_are_eager(torch, new, flush_tokens(torch, new, streams),
                      "drain replacement", phase="fleet")
    say(f"[fleet] (B) rr, then rebalance / migrate / drain(1): {moved}; "
        f"workers {[j.worker for j in r['jobs']]}; every job bitwise its "
        f"solo serve; walls {[round(w, 4) for w in r['walls']]} s")
    out["B"] = r
    for w in router.workers:
        w.graphs = {}
    del router, new, repl
    solo_srv.graphs = {}
    torch.cuda.empty_cache()

    # (C) two spawned workers on the card
    spawned = FleetRouter(cfg, fsc, workers=2, spawn=True, seed=0)
    sjobs = [spawned.add_job(st, n_frames=nf, start=s0)
             for st, nf, s0 in spec[:4]]
    t0 = time.perf_counter()
    sres = spawned.serve()
    spawn_s = time.perf_counter() - t0
    for j in sjobs:
        got = sres[j.job_id].predictions
        if set(got) != set(range(j.start, j.start + j.n_frames)):
            fail(f"[fleet] (C) job {j.job_id}: {len(got)} predictions")
        if j.worker == 0 and got != solo[j.job_id][0]:
            fail(f"[fleet] (C) job {j.job_id} on spawned worker 0 (seed 0) "
                 f"is not bitwise its solo serve")
    for i, info in sorted(spawned.last_worker_info.items()):
        fault = vit_entry_fault(info["launches"])
        if (info["built"] or fault or info["graphs"] != list(w0.ladder.sizes)
                or not all(info["launches"].get(k, 0) for k in VIT_KERNELS)):
            fail(f"[fleet] (C) spawned worker {i}: {info} {fault}")
        say(f"[fleet] (C) spawned worker {i} on {info['device']}: graphs "
            f"{info['graphs']}, kernels built {len(info['built'])}, "
            f"launches { {k: info['launches'].get(k, 0) for k in VIT_KERNELS} }, "
            f"wall {spawned.last_walls[i]:.3f}s")
    say(f"[fleet] (C) 2 spawned workers, 4 jobs: spawn + serve "
        f"{spawn_s:.1f}s; worker 0's jobs bitwise their solo serves "
        f"({card})")
    out["spawn_s"] = spawn_s

    # (D) the 1-D data mesh: 2 gloo ranks on the one card
    t0 = time.perf_counter()
    ranks = spawn_ranks(data_mesh_rank, 2, params, cfg, sc, dev.type,
                        device=dev.type, timeout_s=600)
    mesh_s = time.perf_counter() - t0
    r0 = ranks[0]
    plain = serve_large(cfg, fused, params, dev)
    keys = plain["flushes"].keys()
    if r0["flushes"].keys() != keys or r0["flush_log"] != [
            (k, n) for _, k, n in plain["server"].flush_log]:
        fail("[fleet] (D) the data mesh and the unsharded serve flushed "
             "different batches")
    same = [torch.equal(r0["flushes"][k], plain["flushes"][k]) for k in keys]
    if not all(same):
        fail(f"[fleet] (D) {same.count(False)} of {len(same)} data-mesh "
             f"flushes differ from the unsharded eager card serve")
    preds = [plain["results"][s.sid].predictions for s in plain["sessions"]]
    if r0["predictions"] != preds:
        fail("[fleet] (D) data-mesh predictions differ from the unsharded")
    want = plain["flushes"][r0["newest"]]
    if not torch.equal(r0["again"], want):
        fail("[fleet] (D) the newest flush re-encoded is not bitwise")
    planted_err = (r0["planted"] - want).abs().max().item()
    if torch.equal(r0["planted"], want):
        fail("[fleet] (D) the planted local absmax passes the bitwise "
             "check, which therefore cannot catch it")
    halves = {2 * (k + 1) for k in plain["server"].ladder.sizes} | {2}
    fulls = {4 * (k + 1) for k in plain["server"].ladder.sizes} | {4}
    for i, r in enumerate(ranks):
        if not set(r["rows"]) <= halves or set(r["rows"]) & fulls or \
                r["split"] != r["n_flush"] or r["whole"]:
            fail(f"[fleet] (D) rank {i}: B1 rows in the split {r['rows']}, "
                 f"split / whole encodes {r['split']} / {r['whole']}")
        st = r["stats"]
        coll_s = sum(v for k, v in st.items() if k.endswith("_s"))
        ops = {k: v for k, v in st.items() if not k.endswith("_s")}
        say(f"[fleet] (D) rank {i} (mesh {r['shape']}, backend "
            f"{r['backend']}): {r['n_flush']} flushes split, B1 rows inside "
            f"the split {r['rows']}, launches "
            f"{ {k: r['launches'].get(k, 0) for k in VIT_KERNELS} }, "
            f"{r['launches'].get('fused_ffn.kmajor.split', 0)} of B3's "
            f"through its host-split binding; 64 frames in {r['wall']:.4f}s "
            f"= {64 / r['wall']:.2f} frames/s; collectives "
            f"{coll_s * 1e3 / r['n_flush']:.3f} ms host time a flush "
            f"({ops}) ({card})")
    say(f"[fleet] (D) every data-mesh flush bitwise the unsharded eager card "
        f"serve ({len(same)} flushes, {64 / plain['wall']:.2f} frames/s "
        f"unsharded eager); planted local absmax: newest flush max |diff| "
        f"{planted_err:.3e} (caught); spawn + serve {mesh_s:.1f}s ({card})")
    out["mesh"] = {"ranks": ranks, "plain_fps": 64 / plain["wall"]}
    del plain
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def main() -> int:
    import torch

    # -- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this test runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bridge import from_jax_params, init_vit, to_device
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_masked
    from repro_torch.kernels.fused_ffn import fused_ffn, fused_ffn_nmajor
    from repro_torch.kernels.photonic_matmul import photonic_matmul_int8
    from repro_torch.models.vit import (embed_patches, forward_vit_tokens,
                                        vit_matmul_shapes)
    from repro_torch.serving.server import (ServerConfig, StreamServer,
                                            serving_cfg)

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
    # the reference's bf16 matmuls accumulate in f32 and round once
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    errs.update(check_lm_kernels(torch, dev))
    errs.update(check_b4(torch, dev))
    # B1 and B3 at the bit plan's widths
    plan_calls = plan_kernel_calls(torch, dev)
    for (kname, _), (_, check) in plan_calls.items():
        errs[kname] = max(errs[kname], check())

    # -- 4a. main path: ViT serving ----------------------------------------
    cfg = serving_cfg("base", 224)
    sc = ServerConfig(bucket_fractions=(0.25, 0.5, 0.75, 1.0), microbatch=4,
                      chunk=8)
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    server = StreamServer(cfg, sc, params=params)
    say(f"[main] {cfg.name} {cfg.img_size}x{cfg.img_size} + MGNet "
        f"(embed {cfg.mgnet_embed}, {cfg.mgnet_heads} heads): "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff={cfg.d_ff}; ladder {list(server.ladder.sizes)}; warm start "
        f"{server.warm_s:.2f}s, CUDA graphs at buckets "
        f"{sorted(server.graphs)}")
    if sorted(server.graphs) != list(server.ladder.sizes):
        fail(f"graphs {sorted(server.graphs)} for ladder "
             f"{list(server.ladder.sizes)}")
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
    for name_ in VIT_KERNELS:
        if launches.get(name_, 0) <= 0:
            fail(f"kernel {name_} was never launched on the main path")
    fault = vit_entry_fault(launches)
    if fault:
        fail(f"main path: {fault}")
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
    graphs = check_graphs(torch, cfg, sc, params, server, streams,
                          [results[s.sid] for s in sessions])

    # -- [bitplan]: 4a under a per-layer bit plan, then calibrate_bits ------
    bitplan = run_bitplan(torch, cfg, sc, params, streams, server, card)

    # -- 4b. main path: LM serving -----------------------------------------
    lm = run_lm(torch, dev, card)
    launches.update(lm["launches"])

    # -- 4c. main path: model-sharded ViT serving ----------------------------
    sharded = run_sharded(torch, dev, card, serving_cfg("large", 224))
    r0 = sharded["ranks"][0]
    launches["dequant_epilogue"] = r0["launches"].get("dequant_epilogue", 0)

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
    reps = 20
    t0 = time.perf_counter()
    for i in range(reps):
        chunk = streams[0].frames_at(8 * i, 8)["frames"]
    synth_ms = (time.perf_counter() - t0) * 1e3 / reps
    fdev = torch.from_numpy(chunk).to(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        server._score_fn(chunk)
    gate_ms = (time.perf_counter() - t0) * 1e3 / reps
    embed_ms = cuda_ms(lambda: embed_patches(server.params, fdev, cfg,
                                             server.policy), iters=reps)
    say(f"[layers] frame synthesis (VideoStream, 8 frames, host clock): "
        f"{synth_ms:.3f} ms; gate (MGNet scores, 8 frames, host clock): "
        f"{gate_ms:.3f} ms; embed (8 frames): {embed_ms:.3f} ms ({card})")
    # one flush a bucket (4 frames of a real chunk, gathered as served):
    # eager, and the bucket's graph replayed (its copy-in included)
    for kb, fl in graphs["flushes"].items():
        t = fl["tokens"]
        fl["eager_ms"] = cuda_ms(lambda: forward_vit_tokens(
            server.params, t, cfg, server.policy), iters=reps)
        fl["replay_ms"] = cuda_ms(lambda: server.graphs[kb].replay(t),
                                  iters=reps)
        # the encoder's matmul work for 4 frames (vit_matmul_shapes minus
        # the patch embed, which ran before the gather)
        ops = 4 * sum(2 * m * k * n for m, k, n in
                      vit_matmul_shapes(cfg, kept_patches=kb)[1:])
        say(f"[layers] encode flush k={kb} (4 frames): eager "
            f"{fl['eager_ms']:.3f} ms, graph replay {fl['replay_ms']:.3f} ms "
            f"({fl['eager_ms'] / fl['replay_ms']:.2f}x); {fl['launches']} "
            f"launches a replay; {ops / 1e9:.2f} GOP of matmul work = "
            f"{ops / (fl['replay_ms'] * 1e-3) / 1e12:.3f} TOP/s replayed "
            f"({card})")

    # the LM path: one decode step at batch 4 (pos 159 of the cache, its
    # row rewritten in place each time) and prefill_fn over the 128-token
    # prompt, CUDA events around back-to-back calls (host gaps count)
    from repro_torch.models import api as model_api
    lcfg, lparams, lcache = lm["cfg"], lm["params"], lm["cache"]
    step_ms = cuda_ms(lambda: model_api.decode_fn(
        lparams, lcache, lm["tok"], lm["pos"], lcfg), iters=20, warmup=3)
    prefill_ms = cuda_ms(lambda: model_api.prefill_fn(
        lparams, {"tokens": lm["prompt"]}, lcfg), iters=5, warmup=2)
    say(f"[numbers] LM decode: {lm['tps']:.2f} tok/s over the generate "
        f"loop ({LM_BATCH} x {LM_GEN} tokens); one decode step {step_ms:.3f} "
        f"ms = {LM_BATCH / step_ms * 1e3:.2f} tok/s steady state; "
        f"{lcfg.n_layers} flash_decode launches per step, "
        f"{lm['launches'].get('flash_decode', 0)} per serve ({card})")
    say(f"[numbers] LM prefill_fn: {prefill_ms:.3f} ms for {LM_BATCH} x "
        f"{LM_PROMPT} tokens = {LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} "
        f"tokens/s; {lm['launches'].get('flash_attention_causal', 0)} "
        f"flash_attention_causal launches per forward ({card})")

    report_sharded(sharded, card)

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []

    # B1 at the largest QKV/wo shape of the path: 4 frames at k=196
    m, k, n = 788, 768, 768
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    wq, sw = qweight(torch, gen, k, n, 8, dev)
    wt = wq.t().contiguous()
    sx = torch.rand((), generator=gen, device=dev) * 1e-2
    fns = (lambda: photonic_matmul_int8(xq, wq, sx, sw, wt=wt),
           lambda: ref.photonic_matmul_ref(xq, wq, sx, sw),
           lambda: torch._int_mm(xq, wq).float() * sx * sw)
    ops = 2 * m * k * n
    nbytes = m * k + k * n + 4 + 4 * n + 4 * m * n
    rows.append(("photonic_matmul", f"({m},{k},{n}) int8", fns,
                 ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES,
                 "torch._int_mm + dequant"))

    # B2 at the largest bucket: (4, 12, 197, 64), all keys live, in the
    # path's (B, S, H, D) layout read by strides
    bb, h, s, d = 4, 12, 197, 64
    q, kk, v = (torch.randn(bb, s, h, d, generator=gen, device=dev)
                .transpose(1, 2) for _ in range(3))
    keep = torch.ones(bb, s, device=dev)
    bmask = (keep > 0)[:, None, None, :]
    fns = (lambda: flash_attention_masked(q, kk, v, keep),
           lambda: ref.flash_attention_masked_ref(q, kk, v, keep),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, kk, v, attn_mask=bmask))
    flops = 2 * bb * h * s * s * d * 2
    nbytes = 4 * (4 * bb * h * s * d + bb * s)
    b2_f32_bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    # f32-class work on the tensor cores takes three TF32 passes
    rows.append(("flash_attention_masked", f"({bb},{h},{s},{d}) f32", fns,
                 3 * flops / PEAK_TF32_FLOPS,
                 nbytes / PEAK_BYTES, "F.scaled_dot_product_attention"))

    # B3 at the largest bucket: x (4, 197, 768), d_ff 3072, bits (8, 8)
    x = torch.randn(4, 197, 768, generator=gen, device=dev)
    w1q, s1 = qweight(torch, gen, 768, 3072, 8, dev)
    w2q, s2 = qweight(torch, gen, 3072, 768, 8, dev)
    bias1 = torch.zeros(3072, device=dev)
    bias2 = torch.zeros(768, device=dev)
    args = (x, w1q, s1, bias1, w2q, s2, bias2)
    w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
    fns = (lambda: fused_ffn(*args, w1t=w1t, w2t=w2t),
           lambda: ref.fused_ffn_ref(*args, bits=(8, 8)), None)
    b3_first = (lambda: fused_ffn_nmajor(*args), B3_FIRST_DESIGN)
    m = 4 * 197
    ops = 2 * m * 768 * 3072 * 2
    nbytes = (4 * m * 768 + 768 * 3072 * 2 + 4 * (3072 * 2 + 768 * 2)
              + 4 * m * 768)
    rows.append(("fused_ffn", f"x(4,197,768) d_ff 3072 int8", fns,
                 ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES,
                 "none: no single call"))

    # B5 at the LM prefill shape, in the path's (B, S, H, D) layout read by
    # strides: q (4, 128, 12, 128), k/v (4, 128, 2, 128) bf16, causal
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    bb, sq, h, hkv, d = LM_BATCH, LM_PROMPT, 12, 2, 128
    q5, k5, v5 = (torch.randn(bb, sq, hh, d, generator=gen, device=dev)
                  .to(torch.bfloat16).transpose(1, 2)
                  for hh in (h, hkv, hkv))
    fns = (lambda: flash_attention(q5, k5, v5),
           lambda: ref.flash_attention_ref(q5, k5, v5),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q5, k5, v5, is_causal=True, enable_gqa=True))
    pairs = bb * h * sq * (sq + 1) // 2        # visible (query, key) pairs
    flops = pairs * 4 * d                      # QK and PV, 2 flops a MAC
    nbytes = 2 * (2 * bb * h * sq * d + 2 * bb * hkv * sq * d)
    b5_f32_bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    rows.append(("flash_attention_causal",
                 f"q({bb},{h},{sq},{d}) Hkv {hkv} bf16 causal", fns,
                 flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES,
                 "F.scaled_dot_product_attention(is_causal, enable_gqa)"))

    # B6 at the LM decode shape: B 4, cache 512, length 160, bf16
    length = LM_PROMPT + LM_GEN
    q6 = torch.randn(bb, 1, h, d, generator=gen, device=dev).to(
        torch.bfloat16)
    k6, v6 = (torch.randn(bb, LM_CACHE, hkv, d, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    live = (torch.arange(LM_CACHE, device=dev) < length)[None, None, None]
    fns = (lambda: flash_decode(q6, k6, v6, length),
           lambda: ref.flash_decode_ref(q6, k6, v6, length),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q6.transpose(1, 2), k6.transpose(1, 2), v6.transpose(1, 2),
               attn_mask=live, enable_gqa=True))
    flops = bb * h * length * 4 * d
    nbytes = 2 * (2 * bb * length * hkv * d + 2 * bb * h * d)
    rows.append(("flash_decode",
                 f"q({bb},1,{h},{d}) cache ({bb},{LM_CACHE},{hkv},{d}) "
                 f"length {length} bf16", fns,
                 flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES,
                 "F.scaled_dot_product_attention(length mask, enable_gqa)"))

    # B4 at the sharded path's larger shape: after w1's local columns,
    # 4 frames x 197 tokens x d_ff / 2 = (788, 2048)
    from repro_torch.kernels.fused_ffn import dequant_epilogue
    m, n = 788, 2048
    acc = torch.randint(-2 ** 30, 2 ** 30, (m, n), generator=gen, device=dev,
                        dtype=torch.int32)
    sx4 = torch.rand((), generator=gen, device=dev) * 1e-3
    sw4 = torch.rand(n, generator=gen, device=dev)
    fns = (lambda: dequant_epilogue(acc, sx4, sw4),
           lambda: ref.dequant_epilogue_ref(acc, sx4, sw4), None)
    rows.append(("dequant_epilogue", f"acc ({m},{n}) int32", fns,
                 2 * m * n / PEAK_F32_FLOPS,
                 (4 * m * n + 4 + 4 * n + 4 * m * n) / PEAK_BYTES,
                 "none: no single call"))

    # ms, plain_ms and library_ms: device time per call from the profiler
    # (the kernel's own launches; every launch of the plain version and of
    # the library call); event_ms: CUDA-event time of back-to-back wrapper
    # calls, so the wrapper's host work counts where it outlasts the kernel
    kernels = []
    for (kname, shape, (fn, plain_fn, lib_fn), ops_s, bytes_s, lib) in rows:
        ms, passes = device_ms(torch, fn, SYMBOLS[kname], counter=kname,
                               per_launch=PER_LAUNCH.get(kname, 1))
        event_ms = cuda_ms(fn)
        plain_ms, _ = device_ms(torch, plain_fn)
        lib_ms = device_ms(torch, lib_fn)[0] if lib_fn is not None else None
        bound_s = max(ops_s, bytes_s)
        by = "operations" if ops_s >= bytes_s else "bytes"
        lib_txt = f"{lib_ms:.4f} ms ({lib})" if lib_ms is not None else lib
        f32_bound = {"flash_attention_causal": b5_f32_bound,
                     "flash_attention_masked": b2_f32_bound}.get(kname)
        f32_txt = (f"; at the f32 CUDA-core rate {f32_bound * 1e3:.5f} ms"
                   if f32_bound is not None else "")
        extra, first_txt = {}, ""
        if kname == "fused_ffn":
            # its first design, and each launch of the K-major entry apart
            extra["first_design_ms"] = device_ms(torch, *b3_first)[0]
            apart = [device_ms(torch, fn, (sym,))[0] for sym in B3_KMAJOR]
            first_txt = (f" [first design {extra['first_design_ms']:.4f} "
                         f"ms]; phase 0 / requant / phase 1 "
                         + " / ".join(f"{t:.4f}" for t in apart) + " ms")
        say(f"[numbers] {kname} {shape}: kernel {ms:.4f} ms device"
            f"{first_txt} "
            f"(profiling passes {passes}; {event_ms:.4f} ms CUDA-event, "
            f"wrapper included), bound "
            f"{bound_s * 1e3:.5f} ms ({by}; ops {ops_s * 1e3:.5f} ms, bytes "
            f"{bytes_s * 1e3:.5f} ms{f32_txt}), plain {plain_ms:.4f} ms, "
            f"library {lib_txt}, {launches.get(kname, 0)} launches on the "
            f"main path "
            f"({card})")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches.get(kname, 0),
            "max_abs_err": errs[kname], "tol": TOLERANCES[kname],
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": by, "library_ms": lib_ms,
            **extra})

    # the noise-draw kernel, timed next to the table too; its launches
    # come with 4e
    noise_entry = time_noise_kernel(torch, dev, card)
    # path 4d's kernel shapes, timed next to the table (later profiled
    # sessions drop records, §7 of PERF.md); their launches come with 4d
    extra = time_composed_kernels(torch, dev, card)
    plan_ms = time_plan_kernels(torch, plan_calls, card)
    for entry in kernels:
        if entry["name"] in plan_ms:
            entry["ms_by_bits"] = plan_ms[entry["name"]]

    # -- 4d. [composed]: the composed dispatch, Eq. 2 and the dense
    # baseline on opto-vit-base-224 (after the kernel table, before the
    # profiled phases); its launches join B1's and B2's counts
    composed = run_composed(torch, dev, card, cfg, sc, params, streams,
                            server, [results[s.sid] for s in sessions], fps)
    eq2 = extra["flash_attention_masked"]["wide_eq2"]
    eq2["launches"] = composed["launches"].get(
        "flash_attention_masked.wide", 0)
    say(f"[numbers] flash_attention_masked wide (768, 64): "
        f"{eq2['launches']} launches on path 4d, "
        f"{composed['launches'].get('flash_attention_masked.simt', 0)} on "
        f"the SIMT entry ({card})")
    for entry in kernels:
        kname = entry["name"]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   composed["errs"].get(kname, 0.0))
        entry["launches"] += composed["launches"].get(kname, 0)
        entry.update(extra.get(kname, {}))
    say(f"[composed] launches on the main paths with 4d's: "
        f"{ {e['name']: e['launches'] for e in kernels} }")

    # -- 4e. [noise]: calibrated device noise on opto-vit-base-224 through
    # the graphed server (after 4d, before the profiled phases)
    noisy = run_noise(torch, dev, card, cfg, sc, params, streams,
                      [results[s.sid] for s in sessions], fps)
    for entry in kernels:
        entry["launches"] += noisy["launches"].get(entry["name"], 0)
    noise_entry["launches"] = noisy["launches"].get("noise_draw", 0)
    noise_entry["max_abs_err"] = noisy["err"]
    say(f"[numbers] noise_draw: {noise_entry['launches']} launches on path "
        f"4e ({card})")
    kernels.append(noise_entry)
    for tag in ("A", "B"):
        del noisy[tag]["server"]           # its graphs' memory back
    torch.cuda.empty_cache()

    # -- 4f. [control]: the serving control plane on 4a's model and traffic
    # (after 4e, before the profiled phases); (a)'s launches join the counts
    t0 = time.perf_counter()
    control = run_control(torch, dev, card, cfg, sc, params, streams, server)
    for entry in kernels:
        entry["launches"] += control["launches"].get(entry["name"], 0)
    say(f"[control] path 4f in {time.perf_counter() - t0:.2f}s; launches on "
        f"the main paths with 4f's (a): "
        f"{ {e['name']: e['launches'] for e in kernels} }")

    # -- 4g. [faults]: faults, checkpoints and migration on 4a's model and
    # traffic (after 4f, before the profiled phases); (A)'s launches join
    # the counts
    t0 = time.perf_counter()
    faults = run_faults(torch, dev, card, cfg, sc, params, streams, server,
                        [results[s.sid] for s in sessions],
                        noisy["B"]["results"])
    for entry in kernels:
        entry["launches"] += faults["launches"].get(entry["name"], 0)
    say(f"[faults] path 4g in {time.perf_counter() - t0:.2f}s; (A) "
        f"{faults['fps']:.2f} frames/s against the clean re-serve's "
        f"{faults['clean_fps']:.2f}; checkpoint() "
        f"{min(faults['checkpoint_ms']):.3f} ms; restore: read "
        f"{faults['restore_read_s']:.4f}s, re-capture "
        f"{faults['restore_capture_s']:.3f}s; launches on the main paths "
        f"with 4g's (A): { {e['name']: e['launches'] for e in kernels} } "
        f"({card})")

    # -- 4h. [fleet]: the fleet router and the 1-D data mesh on
    # opto-vit-base-224 (after 4g, before the profiled phases); (A)'s cost
    # serve's launches join the counts
    t0 = time.perf_counter()
    fleet = run_fleet(torch, dev, card, cfg, sc, params,
                      ServerConfig.from_serving(sc, warm_start=False))
    for entry in kernels:
        entry["launches"] += fleet["cost"]["launches"].get(entry["name"], 0)
    say(f"[fleet] path 4h in {time.perf_counter() - t0:.2f}s; launches on "
        f"the main paths with 4h's (A): "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del fleet
    torch.cuda.empty_cache()

    # each flush's device time, from the profiler over its replays. After
    # the kernel table: once a profiled session has recorded thousands of
    # kernels, the next sessions lose a few records each (PERF.md §7)
    for kb, fl in graphs["flushes"].items():
        flush_ms, _ = device_ms(torch, lambda: server.graphs[kb].replay(
            fl["tokens"]), iters=10)
        say(f"[layers] encode flush k={kb}: device {flush_ms:.3f} ms a "
            f"replay (profiler); spans: replay {fl['replay_ms']:.3f} ms, "
            f"eager {fl['eager_ms']:.3f} ms ({card})")

    # where a serve's device time goes, by kernel (one stream, 16 frames),
    # served through the graphs and eagerly (the engine's server)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tag, srv in (("graphed", server),
                     ("eager", graphs["eager_server"])):
        ps = srv.add_session(streams[1], n_frames=16, start=2000)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pres = srv.serve()[ps.sid]
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        wall_ms = pres.wall_s * 1e3
        say(f"[profile] 16 frames served {tag} under the profiler: wall "
            f"{wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}%), {len(events)} kernel kinds "
            f"({card})")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            say(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:8]
        say(f"[profile] {tag}, host ops by self CPU time (profiled): "
            + ", ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} "
                        f"ms {e.count}x" for e in host))

    # the card's busy share over 8 LM decode steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(8):
            model_api.decode_fn(lparams, lcache, lm["tok"], lm["pos"] - 7 + i,
                                lcfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    say(f"[profile] 8 LM decode steps under the profiler: wall {wall_ms:.3f} "
        f"ms, device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), "
        f"{n_launch / 8:.0f} kernel launches per step; against the "
        f"unprofiled step ({step_ms:.3f} ms, CUDA events) the card is busy "
        f"{100 * dev_ms / 8 / step_ms:.1f}% ({card})")
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
