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
     card at ViT-Base/16-224, ViT-Tiny/16-224, ViT-Large/16-224,
     qwen2-1.5b and recurrentgemma-9b widths (B5's bf16 entry at head dim
     256 under the 2048-key window, B6 at D 256 / G 16 on a ring and on a
     window view), at path p's (B5's bf16 entry at head dim 160 and B6 at
     D 160 / G 4 for stablelm-12b, B5 / B6 at qwen2.5-3b's G 8 and
     llama3-405b's G 16; a bf16 call at head dim 112 must raise), at
     ragged shapes and, for B1, B2, B5 and B6, at
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
        scopes local to the rank, must fail that check); (B) then 8
        frames of one stream served on the same ranks under 4e (B)'s
        noise point (photonic_pallas + xla + xla, the default NoiseSpec)
        with ``model_shards=2``: the whole cache on each rank, no sharded
        encode, every flush's logits bitwise the same frames served noisy
        on one device;
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
        times it, the shot readout within 1e-6 relative, and each half of
        a (788, 3072) readout drawn at its offset bitwise its rows of the
        one-launch draw); then
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
        (a planted fault) not bitwise. (E) on the same ranks, 2 rounds of
        4a's traffic under each policy off the fused point: 4e (A)'s noise
        point (photonic_sim + flash + xla, drift, wander, recalibration)
        and 4d (a)'s composed photonic_pallas + xla + xla: every flush's
        logits on both ranks bitwise the mesh's arithmetic on one device
        (``split_arithmetic``: the two row blocks as two threads, each
        launch under the whole flush's scales, each readout at its block's
        offset), within twice that control's distance of the unsplit
        one-device encode; under noise B2 and noise_draw on both ranks,
        the newest flush's readouts' shot multipliers bitwise each rank's
        rows of the one-launch draw, both ranks at one DriftState after
        the same recalibrations, and readouts planted at offset 0 not
        bitwise. Readings: worker walls, aggregate
        frames/s of 4 workers (cost, rr) against one server with all 8
        streams (the reference's gates, 1.5x and 1.15x, are structural and
        not applied), the data mesh's frames/s and collective ms a flush;
     i. ``[train]``, after 4h: ViT training on opto-vit-base-224 + MGNet
        (keep 0.33) on qat + xla + xla under a training policy, batch 32
        of ``ImageStream(224, 32, n_classes=8, patch=16)``, a 10-step
        warmup. (A) MGNet alone by BCE, 40 AdamW steps: BCE falls and the
        held-out mask mIoU ends above max(untrained + 0.15, 0.4) (the
        reference's ``test_mgnet.py`` margin). (B) 30 QAT steps through
        ``launch/train.py::train_loop`` / ``launch/steps.py::
        make_train_fn`` from the trained gate: the loss falls; a run
        resumed from its step-10 checkpoint, and one resumed after a fault
        injected at step 13, give bitwise the straight run's losses and
        final state, all under ``torch.use_deterministic_algorithms``.
        (C) one step's gradients on the card against the CPU at equal
        state and batch: global relative L2 < 0.25, each leaf's corr >
        0.95, the loss within 1% (the gate's routing, the rounding and the
        STE are discontinuous, so rounding differences move whole leaves;
        the CPU against itself one ulp up is printed beside it); the
        inference fake quant planted in the qat entry (zero gradients to
        nearly every weight element) must fail it. (D) the trained params
        through ``prepare_params``, served on the fused point
        (photonic_pallas + flash + fused) against the QAT forward
        (training=False) on a held-out batch: corr > 0.99, top-1
        agreement and both accuracies printed (after the straight run is
        continued to 100 steps), B1-B3 launched. Readings:
        a step's CUDA-event ms and images/s on a device batch, the host's
        synthesis ms a batch, peak memory, a profiled step's GEMMs
        against the rest;
     j. ``[lm_mesh]``, after 4i: qwen2-1.5b (4b's weights and prompt,
        copied once to shared host memory) on ``make_host_mesh(1, 2)``
        over 2 gloo ranks on the one card. (A) 4b's traffic through
        ``generate`` and ``prefill_fn`` on the tensor-parallel layers:
        each rank launches B6 4,480 and B5 28 times (6 query heads on one
        KV head), both ranks' greedy tokens equal; the prefill logits and
        the teacher-forced decode logits (the same 160 inputs through the
        unsharded decode step) bitwise the control, the mesh's arithmetic
        on one device (``tp_arithmetic``), and against the unsharded card
        runs at every position within twice the control's distance from
        1; two gross planted faults (wo's partial products unreduced,
        each rank's heads on the other rank's KV head) must fall below
        that, a subtle one (layer 0's wo partials rounded to bf16) must
        break the bitwise check; tok/s and gloo ms a decode step beside
        4b's. (B) the same prefill under
        photonic_pallas bitwise the unsharded int8 prefill, B1 and B4
        launches a rank. (C) the first 4 layers at batch 8 x seq 128 of
        ``TokenStream`` (warmup 10): 20 steps through ``train_loop`` on
        (1, 2), the loss falls; one step against the unsharded step on
        the card (loss within 1e-3; gradient relative L2 within 4x the
        control, the step on two half-batches averaged in f32; the
        "copy to model" backward planted without its all-reduce must read
        10x that); a run resumed from its step-10 checkpoint bitwise
        under deterministic algorithms, the checkpoint (the logical
        state) restored on one device bitwise. (D) a (2, 1) step against
        the unsharded step on the whole batch. B5 and B6 are also checked
        and timed at the per-rank shapes (phases 3 and 5);
     k. ``[lm_fsdp]``, after 4j: 4b's qwen2-1.5b weights (full width, the
        first 2 of 28 layers) and prompt under
        ``DEFAULT_RULES`` on ``make_host_mesh(2, 2)`` and ``MULTIPOD_RULES``
        on a (pod 2, data 1, model 2) mesh, 4 gloo ranks on the one card:
        the params FSDP-split over the batch axes and gathered a layer at
        a time, the vocab and the decode cache's sequence over "model".
        (A) 4b's traffic against a cache of 256 (128 rows a rank: the
        prompt on model rank 0, every generated token on rank 1):
        B6's partial entry 320 and B5 2 times a rank, no whole-cache
        B6, each model group's tokens equal; the prefill and the
        teacher-forced decode logits within twice the distance of 4j's
        control (``tp_arithmetic``) from the unsharded card runs at every
        position; the planted fault (the decode merge drops the last
        rank's partial) must fall below that; tok/s, gloo ms a decode
        step by op, MB the FSDP gathers put on a rank a step and peak
        memory beside 4j's. (B) the int8 prefill bitwise the unsharded
        one. (C) 4j's batch and steps under FSDP: one step's gradient within
        4x the two-half-batch control (an FSDP backward that keeps its own
        block must read 10x that), every rank's loss equal (a vocab loss
        that shifts by its own block's max must break that), 10 steps
        through ``train_loop``, the step-5 resume bitwise, the logical
        checkpoint restored on one device bitwise. (D) on the pod mesh:
        the prefill, 8 greedy tokens after the prompt's first 8 (a cache
        of 16), one step and 3 train steps against (A)'s and (C)'s
        unsharded runs. B6's partial entry is also checked at 4b's
        shapes split in two (phase 3: lengths 1, row0, row0 + 1 and S,
        the halves merged against ``flash_decode_ref``) and timed at 4k's
        rank shape (phase 5);
     l. ``[vit_mesh]``, after 4k: opto-vit-base-224 + MGNet (keep 0.33)
        QAT training (qat + xla + xla, AdamW, a global batch of 32 of
        ``ImageStream(224, 32, n_classes=8)``) on gloo ranks on the one
        card, 3 of its 12 layers: (A) ``DATA_RULES`` on (data 2) and (B)
        ``MODEL_RULES`` on (data 1, model 2) in one spawn of 2 ranks,
        (C) ``DEFAULT_RULES`` on (2, 2) and (D) ``MULTIPOD_RULES`` on
        (pod 2, data 1, model 2) in one spawn of 4. Each: one step,
        pruning off, against the one-device step on the card, beside
        five order controls (the qat contractions summed in 2, 3, 4, 6
        and 8 blocks; at full size a code flip cascades and they read
        ~2e-2): the gradient and the loss within 4x the controls'
        largest; the checks that do not cascade, each bitwise: every
        weight scale of the forward's fake quants the one-device
        forward's, every activation scale the whole mesh's (the MAX of
        the rank-local absmaxes), every FSDP block's gradient the
        group's mean of the gathered weight's; and on the same mesh at
        smoke size the tight check: within 4x the 2-block control and
        under 1e-4, the loss within 1e-6, every rank's loss equal.
        Planted faults (A) rank-local activation scales, (B) w2's weight
        absmax without its MAX over "model", (C) the FSDP backward
        without its reduce-scatter must each read 10x the tight bound
        and fail their bitwise check at full size;
        ms a train step
        (CUDA events), gloo ms by op (the absmax MAXes apart), MB the
        FSDP gathers put on a rank, peak memory. (B) also the
        photonic_sim row-parallel entry at w2's shape bitwise the
        unsharded one; (C) 4 steps through ``train_loop`` (pruning on),
        the step-2 resume bitwise, the logical checkpoint restored on one
        device bitwise. (E) (C)'s weights gathered, prepared and served
        on B1-B3 at the fused point against the QAT forward: corr >
        0.999, equal accuracy. (F) inside (C)'s and (D)'s contexts, (C)'s
        trained blocks gathered (``steps.gather_tree``), prepared and
        served on the fused point (``vit.serving_cache``: model-sharded
        on (2, 2) with B1, B2 and B4 twice a layer; split over ("pod",
        "data") on the pod mesh with B1-B3, B3 on its host-split
        binding): logits bitwise the one-device fused forward of the same
        cache on every rank, and on the pod mesh the absmax scope left
        local (a planted fault) not bitwise. (G) on (A)'s ranks, one step
        of 2 microbatches (pruning off) at both sizes, each rank's rows
        its share of every global microbatch: weight scales and
        activation scopes bitwise, each microbatch's first activation
        scale bitwise the one-device 2-microbatch step's, the gradient
        within 4x its 2-block order control;
        the rank-local row split (each rank microbatching its own block)
        planted must fail the scale check;
     m. ``[hybrid]``, after 4l: recurrentgemma-9b at full width (38
        layers, d 4096, 16 heads on one KV head, head dim 256, d_ff
        12288, vocab 256000, window 2048; random bf16 weights from seed
        0, ~20.9 GB) through ``generate`` / ``prefill_fn`` /
        ``decode_fn``. (A) 4b's traffic on a 512-slot ring: B6 160 x 12
        and B5 12 times, prefill_fn against the decode loop at every
        prompt position and the last decode step on the CPU, each within
        twice the distance of its control on the card (the kernel
        replaced by its plain version: the model's own rounding reads
        ~0.9988 there, under 4b's 0.999) and above 0.99 everywhere; tok/s
        and the card's busy share over 8 steps. (B) the same 160
        positions on a 128-slot ring, which wraps, against prefill_fn
        under window 128 in the same way (every position and the
        generated ones); the ring written one slot off and B6 over a
        linear 160-row cache (no window) planted must fail. (C) one
        4096-token prompt on B5 under the 2048-key window against the
        plain attention (last corr > 0.999, every position > 0.99),
        tok/s and peak memory; window 0 planted must agree below
        position 2048 (> 0.999) and fail from it;
     n. ``[hybrid_train]`` / ``[hybrid_mesh]``, after 4m. (A) its first 5
        layers (one (rec, rec, attn) super-block and the 2-layer tail) at
        full width trained on the card through ``make_train_fn`` as the
        config says (remat, 2 microbatches, bf16 AdamW moments) on
        ``TokenStream`` batches of 2 x 4096 (the window binds): 2 warmup
        and 8 timed steps (ms a step by CUDA events, tokens/s, peak
        memory, each step's loss and grad norm), then 3 on step 0's batch,
        whose loss must fall; the gradient with remat off bitwise, the
        batch at once against its 2 microbatches within 4x the control
        (the microbatches accumulated in bf16), ``lru_scan``'s gradient at
        (1, 4096, 4096) within 1e-5 of the largest against the f64
        recurrence stepped position by position. (B) all 38 layers under
        MODEL_RULES on make_host_mesh(1, 2), 2 gloo ranks on the card,
        each drawing its blocks of 4m's weights leaf group by leaf group:
        4m (B)'s 160 positions on the 128-slot ring through the decode
        step (B6 160 x 12 and B5 12 times a rank), each position's logits
        within twice 4m (B)'s control's distance of 4m's unsharded run
        (and above 0.99), the prefill and the first 4 decode steps bitwise
        the split's arithmetic on one device (``tp_arithmetic``), and two
        planted faults (a gate GEMM's partials unreduced, b_a added on
        every rank) outside 4m (A)'s limits; tok/s, gloo ms and MB a step
        by op, peak memory a rank. (C) (A)'s model and its (4 x 512) batch
        under MODEL_RULES (1, 2) and DATA_RULES (2): one step's loss equal
        on both ranks and its gradient within 4x the order control of
        (A)'s one-device gradient, every whole leaf's gradient bitwise
        equal across the ranks; then 1 + 2 steps through ``train_loop``
        (at a vocab of 32768: at 256000 the whole embedding and head with
        their moments overflow one card for two ranks), the losses and
        every whole leaf bitwise equal across the ranks after them;
     o. ``[hybrid_fsdp]``: recurrentgemma-9b's first 5 layers at full
        width (the full vocab) under DEFAULT_RULES / MULTIPOD_RULES on 4
        gloo ranks, its serving beside 4m and its training after it;
     p. ``[dense]``, after 4i: (D) alone on the card, then (C), (A) and
        (B) in the foreground while 4j's and 4k's gloo ranks run beside
        them (4j reports after them): the dense family's
        other configs through 4b's body (``run_lm``) and traffic, each
        drawn by ``init_model(seed=0)`` in bf16 and freed before the
        next: (A) stablelm-12b whole (40
        layers; B5's bf16 entry at head dim 160, B6 at D 160 / G 4: B6
        6,400 and B5 40 launches), (B) qwen2.5-3b whole (36 layers, G 8:
        5,760 and 36), (C) llama3-405b at full width on its first 2 of
        126 layers (G 16: 320 and 2). Each: the exact launch counts, the
        prefill against the decode loop at every prompt position and the
        two planted mask faults (held within twice the control's distance
        from 1 where the control, the prefill on the plain attention,
        itself reads under 4b's limits), the last decode step against the
        CPU's plain versions (stablelm-12b's by 4m's rule, against the
        card's step on B6's plain version), decode tok/s,
        ms a decode step and prefill ms. (D) stablelm-12b's first 2
        layers at full width trained through ``make_train_fn`` (2
        microbatches, bf16 AdamW moments) on 2 x 512 ``TokenStream``
        tokens a step: 3 steps, then one on step 0's batch, whose loss
        must fall; every loss finite; ms a step and peak memory;
  5. numbers: frames/s, decode tokens/s and prefill tokens/s, then per
     kernel at a main-path shape its device time (torch.profiler) and
     CUDA-event time, its bound (the larger of operations over the peak of
     their type and bytes over 3.35 TB/s; B2 at the TF32 rate of its
     three passes and B5 at the bf16 rate, both also at the f32 rate), its
     plain version's time and a PyTorch library yardstick the port never
     calls (B5 and B6 also at recurrentgemma-9b's shapes and at a 4n (B)
     rank's, the kernels line's ``hybrid`` and ``hybrid_rank`` entries,
     and at each path-p config's, its ``dense_configs`` entries;
     B3 also its first design and each of its three launches; B1
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
     (eight entries: B1-B6, B6's partial entry and noise_draw);
  7. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

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
    # B6's partial entry, for a cache split along its sequence: the
    # reference composes the cross-shard merge outside this kernel
    "flash_decode_partial": "src/repro/kernels/flash_decode.py:35",
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
    "flash_decode_partial": ("flash_decode_cluster_kernel",),
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
    "flash_decode_partial": ("o and lse f32 rtol = atol = 2e-5; an empty "
                             "range o = 0, lse = NEG_INF exactly; merged, "
                             "flash_decode's"),
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
    "flash_decode_partial": "src/repro_torch/kernels/csrc/flash_decode.cu",
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


def stamp(what: str) -> None:
    """The script's wall clock at the end of ``what``."""
    say(f"[time] {what} at {time.perf_counter() - T_START:.1f}s")


def in_background(fn, *args):
    """``fn(*args)`` on a thread of its own; returns its Future. The mesh
    paths 4j, 4k and 4l start their gloo ranks so, to run side by side:
    their ranks wait on the host's collectives most of the time and the
    card is idle under them (their speeds are not measured). The thread
    is not a daemon: the script exits only after its ranks have ended."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return fut


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
    B6 twice on the same inputs, which must be bitwise equal. Then 4p's
    shapes: B5's bf16 entry at head dim 160 (stablelm-12b's prefill, bf16
    and f32; Sq = Skv at the 64-key / 64-row tile edges at G 1 and G 4,
    where a row overwritten through the swizzle of the 20-chunk row would
    show; windows; the (B, S, H, D) strided layout) and B6 at D 160 / G 4
    (lengths around its cluster split); B5 / B6 at qwen2.5-3b's G 8 and
    llama3-405b's G 16 (D 128). Returns kernel name -> max |kernel -
    plain|."""
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
    # path 4p: stablelm-12b (D 160, G 4), qwen2.5-3b (G 8), llama3-405b (G 16)
    b5("stablelm prefill", 4, 32, 8, 128, 128, 160, bf)
    b5("stablelm prefill", 4, 32, 8, 128, 128, 160, f32)
    b5("stablelm (B,S,H,D) strides", 4, 32, 8, 128, 128, 160, bf,
       layout="bshd")
    for s_ in (63, 64, 65, 127, 129):
        for g_ in (1, 4):
            b5(f"D 160 tile edge, G = {g_}", 1, 2 * g_, 2, s_, s_, 160, bf)
    b5("D 160 window 64", 2, 8, 2, 200, 200, 160, bf, window=64)
    b5("D 160 window 8, tile edge", 1, 8, 2, 129, 129, 160, bf, window=8)
    b5("D 160 non-causal", 1, 8, 2, 65, 130, 160, bf, causal=False)
    b5("qwen2.5 prefill, G = 8", 4, 16, 2, 128, 128, 128, bf)
    b5("llama3 prefill, G = 16", 4, 128, 8, 128, 128, 128, bf,
       layout="bshd")

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
    # path 4p: stablelm-12b's decode (D 160, G 4), at its cluster split's
    # edges too; qwen2.5-3b's (G 8) and llama3-405b's (G 16)
    b6("stablelm decode", 4, 512, 32, 8, 160, 160, bf)
    b6("stablelm decode", 4, 512, 32, 8, 160, 160, f32)
    for length in (7, 8, 9, 65, 159, 511):
        b6("D 160 split edge", 2, 512, 8, 2, 160, length, bf)
    b6("D 160 head-major", 2, 96, 8, 2, 160, 70, bf, head_major=True)
    b6("qwen2.5 decode, G = 8", 4, 512, 16, 2, 128, 160, bf)
    b6("llama3 decode, G = 16", 4, 512, 128, 8, 128, 160, bf)
    torch.cuda.synchronize()
    return err


# B5 / B6 at path 4j's per-rank shapes (qwen2-1.5b on make_host_mesh(1, 2)):
# each rank's 6 query heads read one KV head, a view of the whole 2-head
# K / V (the prefill) or cache (the decode)
TP_HEADS, TP_KV = 6, 1


def check_tp_kernels(torch, dev) -> dict:
    """Phase 3, B5 and B6 at 4j's per-rank shapes against their plain
    versions, bf16 (1 bf16 ulp of the largest |o|) and f32 (2e-5): K / V
    and the cache one KV head of a whole 2-head tensor, read by strides.
    Returns kernel name -> max |kernel - plain|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import blockwise_attention

    gen = torch.Generator(device=dev).manual_seed(4242)
    err = {"flash_attention_causal": 0.0, "flash_decode": 0.0}
    b, d = LM_BATCH, 128
    for dtype in (torch.bfloat16, torch.float32):
        for kv in (0, 1):
            q = torch.randn(b, LM_PROMPT, TP_HEADS, d, generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn(b, LM_PROMPT, 2, d, generator=gen,
                                device=dev).to(dtype)[:, :, kv:kv + 1]
                    for _ in range(2))
            got = blockwise_attention(q, k, v, causal=True)
            want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(
                1, 2), v.transpose(1, 2)).transpose(1, 2)
            e, ok, tol = held(torch, got, want)
            say(f"[check] B5 4j rank KV head {kv} q({b},{LM_PROMPT},"
                f"{TP_HEADS},{d}) K/V a head of (..,2,{d}) "
                f"{str(dtype)[6:]}: max abs err {e:.3e} (tol {tol})")
            if not ok:
                fail(f"B5 at 4j's rank shape: max abs err {e}")
            err["flash_attention_causal"] = max(
                err["flash_attention_causal"], e)
            qd = torch.randn(b, 1, TP_HEADS, d, generator=gen,
                             device=dev).to(dtype)
            kc, vc = (torch.randn(b, LM_CACHE, 2, d, generator=gen,
                                  device=dev).to(dtype)[:, :, kv:kv + 1]
                      for _ in range(2))
            length = LM_PROMPT + LM_GEN
            got = flash_decode(qd, kc, vc, length)
            if not torch.equal(flash_decode(qd, kc, vc, length), got):
                fail("B6 at 4j's rank shape: two calls differ")
            e, ok, tol = held(torch, got,
                              ref.flash_decode_ref(qd, kc, vc, length))
            say(f"[check] B6 4j rank KV head {kv} q({b},1,{TP_HEADS},{d}) "
                f"cache a head of ({b},{LM_CACHE},2,{d}) length {length} "
                f"{str(dtype)[6:]}: max abs err {e:.3e} (tol {tol})")
            if not ok:
                fail(f"B6 at 4j's rank shape: max abs err {e}")
            err["flash_decode"] = max(err["flash_decode"], e)
    torch.cuda.synchronize()
    return err


def time_tp_kernels(torch, dev, card: str) -> dict:
    """B5 and B6 at 4j's per-rank shapes (bf16, KV head 1 of 2): device
    ms, bound, plain version and SDPA, each a sub-entry ``tp_rank`` of
    the kernel's line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(77)
    b, sq, h, d, bf = LM_BATCH, LM_PROMPT, TP_HEADS, 128, torch.bfloat16
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(b, sq, 2, d, generator=gen, device=dev).to(bf)
            [:, :, 1:2] for _ in range(2))
    q5, k5, v5 = (t.transpose(1, 2) for t in (q, k, v))
    pairs = b * h * sq * (sq + 1) // 2
    b5 = dict(shape=f"q({b},{sq},{h},{d}) KV 1 head of 2 bf16 causal",
              fns=(lambda: flash_attention(q5, k5, v5),
                   lambda: ref.flash_attention_ref(q5, k5, v5),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q5, k5, v5, is_causal=True, enable_gqa=True)),
              ops=pairs * 4 * d / PEAK_BF16_FLOPS,
              nbytes=2 * (2 * b * h * sq * d + 2 * b * sq * d) / PEAK_BYTES)
    length = LM_PROMPT + LM_GEN
    q6 = torch.randn(b, 1, h, d, generator=gen, device=dev).to(bf)
    k6, v6 = (torch.randn(b, LM_CACHE, 2, d, generator=gen, device=dev)
              .to(bf)[:, :, 1:2] for _ in range(2))
    live = (torch.arange(LM_CACHE, device=dev) < length)[None, None, None]
    b6 = dict(shape=f"q({b},1,{h},{d}) cache 1 head of ({b},{LM_CACHE},2,"
                    f"{d}) length {length} bf16",
              fns=(lambda: flash_decode(q6, k6, v6, length),
                   lambda: ref.flash_decode_ref(q6, k6, v6, length),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q6.transpose(1, 2), k6.transpose(1, 2),
                       v6.transpose(1, 2), attn_mask=live, enable_gqa=True)),
              ops=b * h * length * 4 * d / PEAK_F32_FLOPS,
              nbytes=2 * (2 * b * length * d + 2 * b * h * d) / PEAK_BYTES)
    return time_attention_rows(
        torch, {"flash_attention_causal": b5, "flash_decode": b6},
        "4j's rank shape", card)


def time_attention_rows(torch, rows: dict, label: str, card: str,
                        iters: int = 50) -> dict:
    """Each row of ``rows`` (kernel name -> its ``shape``, ``fns``: the
    kernel, its plain version and the SDPA call, and ``ops`` / ``nbytes``:
    seconds at the card's peaks): the kernel's device ms (profiler) and
    CUDA-event ms, the bound, the plain version's and SDPA's device ms.
    Returns kernel name -> the kernels-line sub-entry."""
    out = {}
    for kname, row in rows.items():
        fn, plain_fn, lib_fn = row["fns"]
        ms, passes = device_ms(torch, fn, SYMBOLS[kname], counter=kname,
                               iters=iters)
        event_ms = cuda_ms(fn, iters=iters)
        plain_ms, _ = device_ms(torch, plain_fn, iters=iters)
        lib_ms, _ = device_ms(torch, lib_fn, iters=iters)
        bound = max(row["ops"], row["nbytes"])
        by = "operations" if row["ops"] >= row["nbytes"] else "bytes"
        say(f"[numbers] {kname} at {label} {row['shape']}: kernel "
            f"{ms:.5f} ms device (profiling passes {passes}; {event_ms:.5f} "
            f"ms CUDA-event), bound {bound * 1e3:.6f} ms ({by}), plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.5f} ms ({card})")
        out[kname] = {"shape": row["shape"], "ms": ms, "event_ms": event_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound * 1e3, "bound_by": by}
    return out


def time_dense_kernels(torch, dev, card: str) -> dict:
    """B5 and B6 at each 4p config's shapes (bf16, 4b's traffic): B5 over
    the prompt, q (4, H, 128, D) in the path's (B, S, H, D) layout read
    by strides; B6 at the last decode step, q (4, 1, H, D) over 160 of a
    512-row cache. Device and event ms, bound, the plain version and SDPA
    (``is_causal`` / ``enable_gqa``; a length mask for the decode).
    Returns kernel name -> config id -> the kernels-line sub-entry."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(83)
    bf, b, sq, length = torch.bfloat16, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_GEN
    out = {"flash_attention_causal": {}, "flash_decode": {}}
    for arch, *_ in DP_CONFIGS:
        cfg = get_config(arch)
        h, hkv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q5, k5, v5 = (torch.randn(b, sq, hh, d, generator=gen, device=dev)
                      .to(bf).transpose(1, 2) for hh in (h, hkv, hkv))
        q6 = torch.randn(b, 1, h, d, generator=gen, device=dev).to(bf)
        k6, v6 = (torch.randn(b, LM_CACHE, hkv, d, generator=gen, device=dev)
                  .to(bf) for _ in range(2))
        live = (torch.arange(LM_CACHE, device=dev) < length)[None, None, None]
        pairs = b * h * sq * (sq + 1) // 2
        rows = {
            "flash_attention_causal": dict(
                shape=f"q({b},{h},{sq},{d}) Hkv {hkv} bf16 causal, (B, S, "
                      f"H, D) strides",
                fns=(lambda: flash_attention(q5, k5, v5),
                     lambda: ref.flash_attention_ref(q5, k5, v5),
                     lambda: sdpa(q5, k5, v5, is_causal=True,
                                  enable_gqa=True)),
                ops=pairs * 4 * d / PEAK_BF16_FLOPS,
                nbytes=2 * (2 * b * h * sq * d + 2 * b * hkv * sq * d)
                / PEAK_BYTES),
            "flash_decode": dict(
                shape=f"q({b},1,{h},{d}) cache ({b},{LM_CACHE},{hkv},{d}) "
                      f"length {length} bf16",
                fns=(lambda: flash_decode(q6, k6, v6, length),
                     lambda: ref.flash_decode_ref(q6, k6, v6, length),
                     lambda: sdpa(q6.transpose(1, 2), k6.transpose(1, 2),
                                  v6.transpose(1, 2), attn_mask=live,
                                  enable_gqa=True)),
                ops=b * h * length * 4 * d / PEAK_F32_FLOPS,
                nbytes=2 * (2 * b * length * hkv * d + 2 * b * h * d)
                / PEAK_BYTES)}
        for kname, entry in time_attention_rows(
                torch, rows, f"{arch}'s", card, iters=20).items():
            out[kname][arch] = entry
    return out


def check_partial_kernel(torch, dev) -> float:
    """Phase 3, B6's partial entry at 4b's decode shapes split in two (q
    (4, 1, 12, 128), each half of a (4, 512, 2, 128) cache), lengths 1,
    row0, row0 + 1 and S, bf16 and f32, against its plain version: o and
    lse within 2e-5, an empty range exactly o = 0 and lse = NEG_INF, two
    calls bitwise, and the halves merged (``attention.merge_partials``)
    against ``flash_decode_ref`` within B6's tolerance. Returns the max
    |kernel - plain| over o and lse."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_partial
    from repro_torch.models.attention import merge_partials

    gen = torch.Generator(device=dev).manual_seed(4343)
    half = LM_CACHE // 2
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(LM_BATCH, 1, 12, 128, generator=gen,
                        device=dev).to(dtype)
        kc, vc = (torch.randn(LM_BATCH, LM_CACHE, 2, 128, generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        for length in (1, half, half + 1, LM_CACHE):
            parts = []
            for row0 in (0, half):
                kr, vr = kc[:, row0:row0 + half], vc[:, row0:row0 + half]
                o, lse = flash_decode_partial(q, kr, vr, row0, length)
                again = flash_decode_partial(q, kr, vr, row0, length)
                if not (torch.equal(again[0], o) and torch.equal(again[1],
                                                                 lse)):
                    fail("B6 partial: two calls on the same inputs differ")
                wo, wl = ref.flash_decode_partial_ref(q, kr, vr, row0,
                                                      length)
                e = max((o - wo).abs().max().item(),
                        (lse - wl).abs().max().item())
                ok = (torch.allclose(o, wo, rtol=2e-5, atol=2e-5)
                      and torch.allclose(lse, wl, rtol=2e-5, atol=2e-5))
                if row0 >= length:
                    ok = ok and bool((o == 0).all()) and bool(
                        (lse == ref.NEG_INF).all())
                say(f"[check] B6 partial rows [{row0}, {row0 + half}) of "
                    f"S={LM_CACHE} q({LM_BATCH},1,12,128) length {length} "
                    f"{str(dtype)[6:]}: max abs err {e:.3e} (tol 2e-5"
                    + (", empty: o = 0, lse = NEG_INF" if row0 >= length
                       else "") + ")")
                if not ok:
                    fail(f"B6 partial rows from {row0}, length {length}: "
                         f"max abs err {e}")
                err = max(err, e)
                parts.append((o, lse))
            merged = merge_partials(torch.stack([o for o, _ in parts]),
                                    torch.stack([l for _, l in parts]))
            e, ok, tol = held(torch, merged.to(dtype),
                              ref.flash_decode_ref(q, kc, vc, length))
            say(f"[check] B6 partial, both halves merged, length {length} "
                f"{str(dtype)[6:]}: max abs err {e:.3e} (tol {tol})")
            if not ok:
                fail(f"B6 partial merged, length {length}: max abs err {e}")
    torch.cuda.synchronize()
    return err


def time_partial_kernel(torch, dev, card: str) -> dict:
    """B6's partial entry at 4k's rank shape (qwen2-1.5b under
    DEFAULT_RULES on (2, 2): 2 batch rows, all 12 query heads after q's
    gather, the rank's 128 of 256 cache rows, bf16), at model rank 0's
    rows with length 160 (all 128 valid) and model rank 1's (32 valid):
    device and event ms, bound (the bytes of the valid rows, q and the f32
    outputs; its f32 work), plain version and SDPA over the same valid
    rows (which returns no lse). Returns the kernels-line entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_partial

    gen = torch.Generator(device=dev).manual_seed(78)
    b, h, d = LM_BATCH // 2, 12, 128
    rows, length = LMK_CACHE // 2, LM_PROMPT + LM_GEN
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    kr, vr = (torch.randn(b, rows, 2, d, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    out = {}
    for tag, row0 in (("model rank 0", 0), ("model rank 1", rows)):
        valid = max(0, min(length - row0, rows))
        kv, vv = (t[:, :valid].transpose(1, 2) for t in (kr, vr))
        fns = (lambda: flash_decode_partial(q, kr, vr, row0, length),
               lambda: ref.flash_decode_partial_ref(q, kr, vr, row0, length),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q.transpose(1, 2), kv, vv, enable_gqa=True))
        ops = b * h * valid * 4 * d / PEAK_F32_FLOPS
        nbytes = (2 * (2 * b * valid * 2 * d + b * h * d)
                  + 4 * (b * h * d + b * h)) / PEAK_BYTES
        ms, passes = device_ms(torch, fns[0], SYMBOLS["flash_decode_partial"],
                               counter="flash_decode_partial")
        event_ms = cuda_ms(fns[0])
        plain_ms, _ = device_ms(torch, fns[1])
        lib_ms, _ = device_ms(torch, fns[2])
        bound = max(ops, nbytes)
        by = "operations" if ops >= nbytes else "bytes"
        say(f"[numbers] flash_decode_partial at 4k's rank shape, {tag}: q({b},"
            f"1,{h},{d}) rows [{row0}, {row0 + rows}) of a ({b},{LMK_CACHE},2,"
            f"{d}) cache, length {length} ({valid} valid) bf16: kernel "
            f"{ms:.5f} ms device (profiling passes {passes}; {event_ms:.5f} "
            f"ms CUDA-event, wrapper included), bound {bound * 1e3:.6f} ms "
            f"({by}), plain {plain_ms:.4f} ms, SDPA over the valid rows "
            f"{lib_ms:.5f} ms (no lse) ({card})")
        out[tag] = {"shape": f"q({b},1,{h},{d}) rows [{row0}, {row0 + rows}) "
                             f"length {length} ({valid} valid) bf16",
                    "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound * 1e3,
                    "bound_by": by}
    main = out["model rank 0"]
    return {"name": "flash_decode_partial", "route": "cuda",
            "source": SOURCES["flash_decode_partial"],
            "replaces": REPLACES["flash_decode_partial"], "launches": 0,
            "max_abs_err": 0.0, "tol": TOLERANCES["flash_decode_partial"],
            **{k: main[k] for k in ("ms", "event_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "shape": main["shape"], "rank1": out["model rank 1"]}


def check_ring_partial_kernel(torch, dev) -> float:
    """Phase 3, B6's partial entry at a 4o rank's shape: q (2, 1, 16, 256)
    (all 16 query heads, gathered over "model") over each half of a
    HO_RING-slot ring on the one KV head, a layer's view of the stacked
    (L, B, W / 2, 1, 256) rings, at ring lengths 1, W / 2, W / 2 + 1 and W
    (the valid prefix min(pos + 1, W)), bf16 and f32, against its plain
    version: o and lse within 2e-5, an empty range exactly o = 0 and lse
    = NEG_INF, two calls bitwise, and the halves merged against
    ``flash_decode_ref`` over the whole ring within B6's tolerance.
    Returns the max |kernel - plain| over o and lse."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_partial
    from repro_torch.models.attention import merge_partials

    gen = torch.Generator(device=dev).manual_seed(4444)
    half, b = HO_RING // 2, HO_BATCH // 2
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, 1, HY_HEADS, HY_D, generator=gen,
                        device=dev).to(dtype)
        stacked = [torch.randn(2, 2, b, half, HY_KV, HY_D, generator=gen,
                               device=dev).to(dtype) for _ in range(2)]
        whole = [torch.cat([t[0, 1], t[1, 1]], 1) for t in stacked]
        for length in (1, half, half + 1, HO_RING):
            parts = []
            for r in range(2):
                row0 = r * half
                kr, vr = stacked[0][r, 1], stacked[1][r, 1]
                o, lse = flash_decode_partial(q, kr, vr, row0, length)
                again = flash_decode_partial(q, kr, vr, row0, length)
                if not (torch.equal(again[0], o) and torch.equal(again[1],
                                                                 lse)):
                    fail("B6 partial on a ring block: two calls differ")
                wo, wl = ref.flash_decode_partial_ref(q, kr, vr, row0,
                                                      length)
                e = max((o - wo).abs().max().item(),
                        (lse - wl).abs().max().item())
                ok = (torch.allclose(o, wo, rtol=2e-5, atol=2e-5)
                      and torch.allclose(lse, wl, rtol=2e-5, atol=2e-5))
                if row0 >= length:
                    ok = ok and bool((o == 0).all()) and bool(
                        (lse == ref.NEG_INF).all())
                say(f"[check] B6 partial 4o rank q({b},1,{HY_HEADS},{HY_D}) "
                    f"ring slots [{row0}, {row0 + half}) of {HO_RING}, length "
                    f"{length} {str(dtype)[6:]}: max abs err {e:.3e} (tol "
                    f"2e-5" + (", empty: o = 0, lse = NEG_INF"
                               if row0 >= length else "") + ")")
                if not ok:
                    fail(f"B6 partial at 4o's rank shape, slots from {row0}, "
                         f"length {length}: max abs err {e}")
                err = max(err, e)
                parts.append((o, lse))
            merged = merge_partials(torch.stack([o for o, _ in parts]),
                                    torch.stack([l for _, l in parts]))
            e, ok, tol = held(torch, merged.to(dtype), ref.flash_decode_ref(
                q, whole[0], whole[1], length))
            say(f"[check] B6 partial at 4o's rank shape, both halves merged, "
                f"length {length} {str(dtype)[6:]}: max abs err {e:.3e} (tol "
                f"{tol})")
            if not ok:
                fail(f"B6 partial merged at 4o's rank shape, length {length}: "
                     f"max abs err {e}")
    torch.cuda.synchronize()
    return err


def time_ring_partial_kernel(torch, dev, card: str) -> dict:
    """B6's partial entry at a 4o rank's shape once the ring is full: q
    (2, 1, 16, 256) bf16 over one rank's HO_RING / 2 slots, all valid:
    device and event ms, bound (the bytes of the valid slots, q and the
    f32 outputs; its f32 work), plain version and SDPA over the same slots
    (which returns no lse). The ``ring_rank`` sub-entry of B6 partial's
    kernels line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_partial

    gen = torch.Generator(device=dev).manual_seed(79)
    b, h, d, rows = HO_BATCH // 2, HY_HEADS, HY_D, HO_RING // 2
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    kr, vr = (torch.randn(b, rows, HY_KV, d, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    fns = (lambda: flash_decode_partial(q, kr, vr, 0, HO_RING),
           lambda: ref.flash_decode_partial_ref(q, kr, vr, 0, HO_RING),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
               enable_gqa=True))
    ops = b * h * rows * 4 * d / PEAK_F32_FLOPS
    nbytes = (2 * (2 * b * rows * HY_KV * d + b * h * d)
              + 4 * (b * h * d + b * h)) / PEAK_BYTES
    ms, passes = device_ms(torch, fns[0], SYMBOLS["flash_decode_partial"],
                           counter="flash_decode_partial")
    event_ms = cuda_ms(fns[0])
    plain_ms, _ = device_ms(torch, fns[1])
    lib_ms, _ = device_ms(torch, fns[2])
    bound = max(ops, nbytes)
    by = "operations" if ops >= nbytes else "bytes"
    shape = (f"q({b},1,{h},{d}) ring slots [0, {rows}) of {HO_RING}, all "
             f"valid, bf16")
    say(f"[numbers] flash_decode_partial at 4o's rank shape {shape}: kernel "
        f"{ms:.5f} ms device (profiling passes {passes}; {event_ms:.5f} ms "
        f"CUDA-event, wrapper included), bound {bound * 1e3:.6f} ms ({by}), "
        f"plain {plain_ms:.4f} ms, SDPA over the slots {lib_ms:.5f} ms (no "
        f"lse) ({card})")
    return {"shape": shape, "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound * 1e3, "bound_by": by, "launches": 0}


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


def card_memory(torch) -> str:
    """The card's memory in use, from ``mem_get_info`` (every process on
    it, the gloo ranks beside this one included)."""
    free, total = torch.cuda.mem_get_info()
    return f"{(total - free) / 1e9:.2f} GB used of {total / 1e9:.2f}"


def run_lm(torch, dev, card: str, arch: str = "qwen2-1.5b",
           layers: int | None = None, tag: str = "lm", beside: bool = False,
           cpu_control: bool = False) -> dict:
    """Phase 4b on qwen2-1.5b, and 4p on each of the dense family's other
    configs: the LM main path on ``arch`` at full width (its first
    ``layers`` layers where given), 4b's traffic and checks. ``beside``:
    other processes share the card, so print its memory around the draw.
    ``cpu_control``: the last decode step against the CPU is held by 4m's
    rule, against a control on the card (see the step). Returns the
    launch counts of the counted run and what the numbers phase reuses."""
    from repro_torch.bridge import to_device
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.launch.serve import generate, init_cache
    from repro_torch.models import api as model_api

    cfg = get_config(arch)
    cut = ""
    if layers is not None:
        cut = f" (its first {layers} of {cfg.n_layers})"
        cfg = cfg.with_(n_layers=layers)
    if beside:
        say(f"[{tag}] before {cfg.name}'s draw the card has "
            f"{card_memory(torch)} (mem_get_info; the gloo ranks of 4j and "
            f"4k run beside this path; {torch.cuda.memory_reserved() / 1e9:.2f}"
            f" GB reserved by this process)")
    t0 = time.perf_counter()
    params = model_api.init_model(0, cfg, dev)
    torch.cuda.synchronize()

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        return [tree]

    n_params = sum(t.numel() for t in leaves(params))
    say(f"[{tag}] {cfg.name}: {cfg.n_layers} layers{cut}, d={cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.kv_heads} KV, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab}, {'tied' if cfg.tie_embeddings else 'untied'}; "
        f"{n_params / 1e9:.3f} G bf16 params from "
        f"init_lm(seed=0) on the card in {time.perf_counter() - t0:.2f}s")
    if beside:
        # the f32 draws' transient back to the card for the ranks beside
        torch.cuda.empty_cache()
        say(f"[{tag}] after the draw: {card_memory(torch)} ("
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved by this "
            f"process, its peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB allocated)")
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
    say(f"[{tag}] launches on the LM path: {launches}")
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
    say(f"[{tag}] generate: {LM_BATCH} x ({LM_PROMPT} prompt + {LM_GEN} "
        f"greedy) in {serve_s:.3f}s ({steps} decode steps), decode loop "
        f"{tps:.2f} tok/s; prefill_fn over the prompt {prefill_s * 1e3:.3f} "
        f"ms incl. its first call at this shape ({card})")
    say(f"[{tag}] first sequence: {toks[0, :16].tolist()}")

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

    def reading(what, logits):
        pc = position_corr(torch, logits, loop)
        top = (logits.argmax(-1) == loop.argmax(-1))
        r = {"last_corr": float(pc[-1]), "last_argmax": int(top[:, -1].sum()),
             "min_corr": float(pc.min()), "argmax_share": float(
                 top.float().mean())}
        say(f"[{tag}] prefill vs decode loop, {what}: last position corr "
            f"{r['last_corr']:.6f}, argmax {r['last_argmax']} of {LM_BATCH}; "
            f"over all {LM_PROMPT} positions min corr {r['min_corr']:.6f}, "
            f"argmax agrees in {100 * r['argmax_share']:.2f}% of rows")
        return r

    # limits: at the last position corr > 0.999 and argmax in >= 3 of 4
    # rows; at every position corr > 0.99. On the H100 the kernel path reads
    # 0.999155 / 4 of 4 / 0.999085 and the control 0.999199 / 4 / 0.999097,
    # the planted faults 0.65 and 0.60 / 0 / 0.21 and 0.015 (PERF.md, PR 12)
    # Where the control itself (the model's own rounding, without B5) reads
    # under them, the kernel path is held within HY_CORR_FACTOR times the
    # control's distance from 1, 4m's rule
    def passes(r):
        return (r["last_corr"] > 0.999 and r["last_argmax"] >= LM_BATCH - 1
                and r["min_corr"] > 0.99)

    real = reading("prefill_fn (B5) vs decode_fn (B6)", full)
    saved = transformer.blockwise_attention
    planted = {}
    try:
        for what, shift in (("control: plain attention, right mask", 0),
                            ("planted fault: query i sees key i+1", 1),
                            ("planted fault: query i misses key i", -1)):
            transformer.blockwise_attention = planted_attention(torch, shift)
            planted[what] = reading(what, model_api.prefill_fn(
                params, {"tokens": prompt}, cfg))
    finally:
        transformer.blockwise_attention = saved
    del loop
    control = planted.pop("control: plain attention, right mask")
    limit = passes
    if not passes(control):
        say(f"[{tag}] the control reads under 4b's limits: the kernel path "
            f"and the planted faults are held within {HY_CORR_FACTOR}x its "
            f"distance from 1 (4m's rule)")
        def limit(r):
            return within_control(r, control, LM_BATCH)
    if not limit(real):
        fail(f"{cfg.name}: prefill_fn vs decode-loop prefill: {real} "
             f"(control {control})")
    for what, r in planted.items():
        if limit(r):
            fail(f"the planted fault ({what}) passes the prefill/decode "
                 f"limits, which therefore cannot catch it: {r}")

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
    say(f"[{tag}] last decode step (pos {pos}) re-run on the CPU with the "
        f"plain versions ({cpu_s:.1f}s incl. copies): logits corr {c:.6f}, "
        f"argmax agrees in {agree} of {LM_BATCH} rows, max abs diff "
        f"{(card_logits.cpu().float() - cpu_logits.float()).abs().max().item():.3e}")
    if not cpu_control:
        if not c > 0.999:
            fail(f"card vs CPU decode-step logits correlation {c} <= 0.999")
    else:
        # the control: the same step on the card with B6's plain version,
        # and 4m's rule: within HY_CORR_FACTOR times the control's
        # distance from the CPU, above 0.99, the argmax in all rows but one
        saved = transformer.decode_attention
        try:
            transformer.decode_attention = (
                lambda q, k, v, n, **kw: ref.flash_decode_ref(q, k, v, n))
            plain_logits, _ = model_api.decode_fn(params, cache, tok, pos,
                                                  cfg)
        finally:
            transformer.decode_attention = saved
        c_ctl = corr(torch, plain_logits, cpu_logits)
        c_pk = corr(torch, card_logits, plain_logits)
        say(f"[{tag}] the control, the card's step on B6's plain version: "
            f"against the CPU corr {c_ctl:.6f}; the card's step on B6 "
            f"against it corr {c_pk:.6f}")
        if not (1 - c <= HY_CORR_FACTOR * (1 - c_ctl) and c > 0.99
                and agree >= LM_BATCH - 1):
            fail(f"{cfg.name}: card vs CPU decode-step logits correlation "
                 f"{c} (control {c_ctl}, argmax {agree} of {LM_BATCH})")
    return {"launches": launches, "cfg": cfg, "params": params,
            "prompt": prompt, "cache": cache, "tok": tok, "pos": pos,
            "tps": tps, "serve_s": serve_s, "toks": toks}


# path 4p: the dense family's other configs, each through 4b's body and
# traffic (``run_lm``) at full width: stablelm-12b whole (40 layers; B5's
# bf16 entry at head dim 160, B6 at D 160 / G 4), qwen2.5-3b whole (36
# layers; D 128 / G 8) and llama3-405b on its first 2 of 126 layers (D 128
# / G 16: the whole model is ~812 GB in bf16, its first 2 layers with the
# embedding and the head 21.2 GB). Each is drawn by init_model(seed=0) in
# bf16 and freed before the next, the two large ones first: from ~140 s
# after 4j's and 4k's ranks start beside them, their training holds ~52
# GB of the card. (D) stablelm-12b trained at full width on
# its first DP_TRAIN_LAYERS layers: the config's 2 microbatches and bf16
# AdamW moments, DP_TRAIN_STEPS steps of DP_TRAIN_BATCH x DP_TRAIN_SEQ
# ``TokenStream`` tokens, then one more on step 0's batch. Each entry: the
# id, the layers served (None: all) and whether the last decode step
# against the CPU is held by 4m's rule (``run_lm``'s ``cpu_control``):
# at stablelm-12b's 40 layers of random bf16 weights that step reads corr
# 0.998999 against the CPU, under 4b's absolute 0.999, where the control
# (the card's step on B6's plain version) reads 0.999040 and B6 against
# its plain version on the same card 0.999342: the depth amplifies
# rounding within B6's 1-ulp class that far (PERF.md §6, the dense family)
DP_CONFIGS = (("llama3-405b", 2, False), ("stablelm-12b", None, True),
              ("qwen2.5-3b", None, False))
DP_TRAIN_LAYERS = 2
DP_TRAIN_BATCH, DP_TRAIN_SEQ, DP_TRAIN_STEPS = 2, 512, 3


def run_dense_configs(torch, dev, card: str) -> dict:
    """Phase 4p, ``[dense]``: (A)-(C), each config of DP_CONFIGS through
    ``run_lm`` (4b's checks: the exact launch counts, the prefill against
    the decode loop at every prompt position with the two planted mask
    faults, the last decode step against the CPU's plain versions), then
    its decode step and prefill timed with CUDA events. Returns each
    config's launch counts."""
    from repro_torch.models import api as model_api

    out = {}
    for arch, layers, cpu_control in DP_CONFIGS:
        t0 = time.perf_counter()
        r = run_lm(torch, dev, card, arch, layers, tag="dense", beside=True,
                   cpu_control=cpu_control)
        cfg, params, cache = r["cfg"], r["params"], r["cache"]
        step_ms = cuda_ms(lambda: model_api.decode_fn(
            params, cache, r["tok"], r["pos"], cfg), iters=10, warmup=2)
        prefill_ms = cuda_ms(lambda: model_api.prefill_fn(
            params, {"tokens": r["prompt"]}, cfg), iters=3, warmup=1)
        n = r["launches"]
        say(f"[numbers] {cfg.name} ({cfg.n_layers} layers) decode: "
            f"{r['tps']:.2f} tok/s over the generate loop ({LM_BATCH} x "
            f"{LM_GEN} tokens); one decode step {step_ms:.3f} ms = "
            f"{LM_BATCH / step_ms * 1e3:.2f} tok/s steady state; prefill_fn "
            f"{prefill_ms:.3f} ms for {LM_BATCH} x {LM_PROMPT} tokens = "
            f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} tokens/s; "
            f"flash_decode {n.get('flash_decode', 0)} and "
            f"flash_attention_causal {n.get('flash_attention_causal', 0)} "
            f"launches ({card})")
        out[arch] = n
        del r, params, cache
        torch.cuda.empty_cache()
        say(f"[dense] path 4p ({cfg.name}) in {time.perf_counter() - t0:.1f}"
            f"s; freed: the card has {card_memory(torch)}")
    return out


def run_dense_train(torch, dev, card: str) -> None:
    """Phase 4p (D): stablelm-12b's first DP_TRAIN_LAYERS layers at full
    width trained on one card through ``launch/steps.py::make_train_fn``
    (the config's remat, 2 microbatches and bf16 AdamW moments) on
    ``TokenStream`` batches of DP_TRAIN_BATCH x DP_TRAIN_SEQ:
    DP_TRAIN_STEPS steps on fresh batches, then one more on step 0's.
    Every loss finite, and the repeated batch's loss below its first;
    ms a step (CUDA events) and peak memory."""
    from repro_torch.bridge import init_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    full_precision_matmuls()
    full = get_config("stablelm-12b")
    cfg = full.with_(n_layers=DP_TRAIN_LAYERS)
    params = init_lm(0, cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    state = {"params": params, "opt": adamw_init(params, AdamWConfig(
        low_mem=not cfg.use_fp32_master)),
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    say(f"[dense_train] (D) {cfg.name} cut to its first {cfg.n_layers} of "
        f"{full.n_layers} layers, full width: {n_params / 1e9:.3f} G bf16 "
        f"params from init_lm(seed=0); remat {cfg.remat}, microbatch_steps "
        f"{cfg.microbatch_steps}, AdamW moments "
        f"{'f32' if cfg.use_fp32_master else 'bf16'}; the card has "
        f"{card_memory(torch)} ({card})")
    step_fn = steps.make_train_fn(cfg)
    ts = TokenStream(cfg.vocab, DP_TRAIN_SEQ, DP_TRAIN_BATCH, seed=0,
                     device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms, losses, norms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(DP_TRAIN_STEPS + 1):
        batch = ts.batch_at(i if i < DP_TRAIN_STEPS else 0)
        torch.cuda.synchronize()
        ev[0].record()
        state, m = step_fn(state, batch)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        what = "step" if i < DP_TRAIN_STEPS else "step 0's batch again,"
        say(f"[dense_train] (D) {what} {i}: loss {losses[-1]:.5f}, grad norm "
            f"{norms[-1]:.4f}, {ms[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, m
    torch.cuda.empty_cache()
    timed = ms[1:DP_TRAIN_STEPS]            # the first step warms up
    step_ms = sum(timed) / len(timed)
    tokens = DP_TRAIN_BATCH * DP_TRAIN_SEQ
    say(f"[dense_train] (D) {step_ms:.1f} ms a step (CUDA events, mean of "
        f"steps 1-{DP_TRAIN_STEPS - 1}; step 0 {ms[0]:.1f} ms) = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB "
        f"allocated by this process ({card})")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"4p (D): a loss or gradient norm is not finite: {losses}, "
             f"{norms}")
    if not losses[-1] < losses[0]:
        fail(f"4p (D): the loss on step 0's batch did not fall: "
             f"{losses[0]} -> {losses[-1]}")
    say(f"[dense_train] path 4p (D) in {time.perf_counter() - t_phase:.1f}s "
        f"({card})")


# path 4m: the hybrid family, recurrentgemma-9b at full width (38 layers,
# d 4096, 16 heads on one KV head, head dim 256, d_ff 12288, vocab 256000,
# window 2048; random bf16 weights from seed 0). (A) 4b's traffic on a
# 512-slot ring (the window does not bind); (B) the same 160 positions on
# a ring of HY_RING slots, which wraps; (C) one prompt of HY_LONG tokens,
# where B5's 2048-key window binds
HY_RING = 128
HY_LONG = 4096
# (A), (B) and the CPU step are held against a control on the card, the
# same computation with the kernel replaced by its plain version: at
# recurrentgemma-9b's width (38 layers, random bf16 weights) the model's
# own rounding puts the prefill 0.99875 and the card 0.9990 from the
# decode loop and from the CPU (PERF.md §6, the hybrid), under 4b's absolute
# 0.999. The kernel path must lie within HY_CORR_FACTOR times the
# control's distance from 1 at the last position and at the worst, and
# above 0.99 at every position, with the last argmax in all rows but one
HY_CORR_FACTOR = 2
# B5 / B6 at recurrentgemma's shapes: 16 query heads on one KV head, D 256
HY_HEADS, HY_KV, HY_D, HY_WINDOW = 16, 1, 256, 2048


def hybrid_window_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of one head of a causal prefill of s
    tokens under a window: sum over i of min(i + 1, window)."""
    w = min(s, window)
    return w * (w + 1) // 2 + (s - w) * window


def check_hybrid_kernels(torch, dev) -> dict:
    """Phase 3, B5's bf16 entry at head dim 256 and B6 at D 256 / G 16
    (recurrentgemma-9b) against their plain versions at ``held``'s bf16
    tolerance: B5 at (1, 16, 4096, 256) on one KV head under the 2048-key
    window, in the model's (B, S, H, D) layout, ragged Sq = Skv of 1, 63,
    65 and 129, window 8 at G 1 and the 64-key / 64-row tile edges; B6 at
    lengths 1, 128, 160 and 512 on a ring (a layer's view of the stacked
    (L, B, W, 1, 256) ring, read over its first min(pos + 1, W) slots,
    held against the reference's ring decode ``ring_decode_ref``) and on
    the strided view of a linear cache's last ``window`` rows, each call
    twice and bitwise equal. A bf16 call at a head dim the entry does not
    take (112: kimi-k2's) must raise. Returns kernel name -> max |kernel -
    plain|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import (blockwise_attention,
                                              decode_attention,
                                              ring_decode_attention)

    gen = torch.Generator(device=dev).manual_seed(4444)
    err = {"flash_attention_causal": 0.0, "flash_decode": 0.0}
    bf, d = torch.bfloat16, HY_D

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def b5(tag, b, h, hkv, sq, skv, window, causal=True, layout="bhsd"):
        if layout == "bhsd":
            q, k, v = rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
            got = flash_attention(q, k, v, causal=causal, window=window)
        else:
            q, k, v = rnd(b, sq, h, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
            got = blockwise_attention(q, k, v, causal=causal,
                                      window=window).transpose(1, 2)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        e, ok, tol = held(torch, got, want)
        say(f"[check] B5 D 256 {tag:<24s} q({b},{h},{sq},{d}) Hkv={hkv} "
            f"Skv={skv} bf16 causal={causal} window={window}: max abs err "
            f"{e:.3e} (tol {tol})")
        if not ok:
            fail(f"B5 at D 256, {tag}: max abs err {e}")
        err["flash_attention_causal"] = max(err["flash_attention_causal"], e)

    b5("recurrentgemma prefill", 1, HY_HEADS, HY_KV, HY_LONG, HY_LONG,
       HY_WINDOW, layout="bshd")
    for s_ in (1, 63, 65, 129):
        b5("ragged", 2, HY_HEADS, HY_KV, s_, s_, HY_WINDOW)
    b5("window 8, G = 1", 1, 2, 2, 200, 200, 8)
    for s_ in (64, 127, 256):
        b5("tile edge, G = 1", 1, 2, 2, s_, s_, 0)
    b5("window 64 at a tile edge", 1, HY_HEADS, HY_KV, 257, 257, 64)
    b5("non-causal", 1, 4, 1, 65, 130, 0, causal=False)
    for bad in (112,):
        q = torch.zeros(1, 2, 8, bad, dtype=bf, device=dev)
        try:
            flash_attention(q, q, q)
        except ValueError as exc:
            say(f"[check] B5 bf16 at head dim {bad} raises: {exc}")
        else:
            fail(f"B5's bf16 entry took head dim {bad} without raising")

    b, w = LM_BATCH, LM_CACHE
    for length in (1, 128, 160, 512):
        q = rnd(b, 1, HY_HEADS, d)
        ring = rnd(2, b, w, HY_KV, d)[1]        # a layer's view of the stack
        vring = rnd(2, b, w, HY_KV, d)[1]
        pos = length - 1 if length < w else 700  # 512: the ring has wrapped
        got = ring_decode_attention(q, ring, vring, pos)
        if not torch.equal(ring_decode_attention(q, ring, vring, pos), got):
            fail(f"B6 on the ring, length {length}: two calls differ")
        e, ok, tol = held(torch, got, ref.ring_decode_ref(q, ring, vring, pos))
        say(f"[check] B6 D 256 G 16 ring view q({b},1,{HY_HEADS},{d}) ring "
            f"({b},{w},{HY_KV},{d}) of a stack, pos {pos} (length {length}) "
            f"bf16: max abs err {e:.3e} (tol {tol})")
        if not ok:
            fail(f"B6 on the ring, length {length}: max abs err {e}")
        err["flash_decode"] = max(err["flash_decode"], e)
        kc, vc = rnd(b, 1024, HY_KV, d), rnd(b, 1024, HY_KV, d)
        n = length + 100                         # a window over a longer cache
        got = decode_attention(q, kc, vc, n, window=length)
        if not torch.equal(decode_attention(q, kc, vc, n, window=length), got):
            fail(f"B6 on a window view, window {length}: two calls differ")
        want = ref.flash_decode_ref(q, kc[:, n - length:n], vc[:, n - length:n],
                                    length)
        e, ok, tol = held(torch, got, want)
        say(f"[check] B6 D 256 G 16 window view rows [{n - length}, {n}) of "
            f"({b},1024,{HY_KV},{d}) bf16: max abs err {e:.3e} (tol {tol})")
        if not ok:
            fail(f"B6 on a window view, window {length}: max abs err {e}")
        err["flash_decode"] = max(err["flash_decode"], e)
    # the window view is B6 itself, not a copy: the same call on the rows
    got = flash_decode(q, kc[:, 412:512], vc[:, 412:512], 100)
    if not torch.equal(got, decode_attention(q, kc, vc, 512, window=100)):
        fail("B6 on a window view differs from B6 on the same rows")
    torch.cuda.synchronize()
    return err


def time_hybrid_kernels(torch, dev, card: str) -> dict:
    """B5 and B6 at recurrentgemma-9b's shapes (bf16): B5 over 4m (C)'s
    prompt, q (1, 16, 4096, 256) on one KV head under the 2048-key window;
    B6 at 4m (A)'s last decode step, q (4, 1, 16, 256) over 160 of a
    512-slot ring. Device and event ms, bound (B5's visible pairs at the
    bf16 rate against its bytes; B6's valid rows' bytes against its f32
    work), the plain version and SDPA (B5 with a bool window mask, which
    skips nothing: a yardstick only; B6 over the valid rows). Returns
    kernel name -> the kernels-line sub-entry ``hybrid``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(79)
    bf, d, h, s = torch.bfloat16, HY_D, HY_HEADS, HY_LONG
    q, k, v = (torch.randn(1, s, hh, d, generator=gen, device=dev).to(bf)
               .transpose(1, 2) for hh in (h, HY_KV, HY_KV))
    pos = torch.arange(s, device=dev)
    vis = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                            < HY_WINDOW)
    pairs = h * hybrid_window_pairs(s, HY_WINDOW)
    b5 = dict(shape=f"q(1,{h},{s},{d}) Hkv {HY_KV} bf16 window {HY_WINDOW}",
              fns=(lambda: flash_attention(q, k, v, window=HY_WINDOW),
                   lambda: ref.flash_attention_ref(q, k, v, window=HY_WINDOW),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, attn_mask=vis, enable_gqa=True)),
              ops=pairs * 4 * d / PEAK_BF16_FLOPS,
              nbytes=2 * (2 * h * s * d + 2 * HY_KV * s * d) / PEAK_BYTES,
              lib="F.scaled_dot_product_attention(bool window mask)")
    b, w, length = LM_BATCH, LM_CACHE, LM_PROMPT + LM_GEN
    q6 = torch.randn(b, 1, h, d, generator=gen, device=dev).to(bf)
    k6, v6 = (torch.randn(b, w, HY_KV, d, generator=gen, device=dev).to(bf)
              for _ in range(2))
    b6 = dict(shape=f"q({b},1,{h},{d}) ring ({b},{w},{HY_KV},{d}) length "
                    f"{length} bf16",
              fns=(lambda: flash_decode(q6, k6, v6, length),
                   lambda: ref.ring_decode_ref(q6, k6, v6, length - 1),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q6.transpose(1, 2), k6[:, :length].transpose(1, 2),
                       v6[:, :length].transpose(1, 2), enable_gqa=True)),
              ops=b * h * length * 4 * d / PEAK_F32_FLOPS,
              nbytes=2 * (2 * b * length * HY_KV * d + 2 * b * h * d)
              / PEAK_BYTES,
              lib="F.scaled_dot_product_attention over the valid rows")
    out = {}
    for kname, row in (("flash_attention_causal", b5), ("flash_decode", b6)):
        fn, plain_fn, lib_fn = row["fns"]
        iters = 10 if kname == "flash_attention_causal" else 50
        ms, passes = device_ms(torch, fn, SYMBOLS[kname], counter=kname,
                               iters=iters)
        event_ms = cuda_ms(fn, iters=iters)
        plain_ms, _ = device_ms(torch, plain_fn, iters=iters)
        lib_ms, _ = device_ms(torch, lib_fn, iters=iters)
        bound = max(row["ops"], row["nbytes"])
        by = "operations" if row["ops"] >= row["nbytes"] else "bytes"
        say(f"[numbers] {kname} at recurrentgemma-9b's {row['shape']}: "
            f"kernel {ms:.5f} ms device (profiling passes {passes}; "
            f"{event_ms:.5f} ms CUDA-event, wrapper included), bound "
            f"{bound * 1e3:.6f} ms ({by}; ops {row['ops'] * 1e3:.6f} ms, "
            f"bytes {row['nbytes'] * 1e3:.6f} ms), plain {plain_ms:.4f} ms, "
            f"{row['lib']} {lib_ms:.5f} ms ({card})")
        out[kname] = {"shape": row["shape"], "ms": ms, "event_ms": event_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound * 1e3, "bound_by": by}
    del vis
    return out


def position_corr_chunked(torch, a, b, chunk: int = 256):
    """``position_corr`` over position chunks (a (1, 4096, 256000) pair in
    float64 would take 16 GB at once)."""
    return torch.cat([position_corr(torch, a[:, i:i + chunk], b[:, i:i + chunk])
                      for i in range(0, a.shape[1], chunk)])


def corr_reading(pc, top, lo: int = 0) -> dict:
    """The prefill-vs-reference reading over positions [lo, P): the last
    position's corr and argmax agreement (rows), the least corr."""
    return {"last_corr": float(pc[-1]), "last_argmax": int(top[:, -1].sum()),
            "min_corr": float(pc[lo:].min()),
            "argmax_share": float(top[:, lo:].float().mean())}


def corr_passes(r, rows: int) -> bool:
    """4b's limits: last position corr > 0.999 with argmax equal in all
    rows but one (at least 1 of 1), every position corr > 0.99."""
    return (r["last_corr"] > 0.999 and r["last_argmax"] >= max(rows - 1, 1)
            and r["min_corr"] > 0.99)


def within_control(r, ctl, rows: int) -> bool:
    """``r`` within HY_CORR_FACTOR times the control ``ctl``'s distance
    from 1 at the last position and at the least, every position above
    0.99 and the last argmax in all rows but one (at least 1 of 1)."""
    return (1 - r["last_corr"] <= HY_CORR_FACTOR * (1 - ctl["last_corr"])
            and 1 - r["min_corr"] <= HY_CORR_FACTOR * (1 - ctl["min_corr"])
            and r["min_corr"] > 0.99
            and r["last_argmax"] >= max(rows - 1, 1))


def run_hybrid(torch, dev, card: str) -> dict:
    """Phase 4m, ``[hybrid]``: recurrentgemma-9b at full width through the
    LM entry points. (A) 4b's traffic (batch 4, prompt 128, 32 greedy
    tokens) on a 512-slot ring: launches, prefill_fn against the decode
    loop at every prompt position, the last decode step on the CPU, tok/s
    and the card's busy share over 8 decode steps. (B) the same 160
    positions on a 128-slot ring, which wraps: each generated position's
    decode logits against prefill_fn over the 160 tokens under window 128;
    the ring written one slot off and B6 over a linear 160-row cache (no
    window) planted, each must fail. (C) batch 1, a 4096-token prompt:
    prefill_fn on B5 under the 2048-key window against the same forward on
    the plain attention; window 0 planted must agree below position 2048
    and fail from it. Returns the launch counts of (A)'s counted run and
    the readings."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, init_cache
    from repro_torch.models import api as model_api
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer
    from repro_torch.bridge import to_device

    t_phase = time.perf_counter()
    cfg = get_config("recurrentgemma-9b")
    nsb = cfg.n_layers // 3
    t0 = time.perf_counter()
    params = model_api.init_model(0, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[hybrid] {cfg.name}: {cfg.n_layers} layers ({nsb} x (rec, rec, "
        f"attn) + {cfg.n_layers % 3} rec), d={cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.kv_heads} KV (head dim {cfg.head_dim}), d_ff="
        f"{cfg.d_ff}, LRU width {cfg.lru_dim}, vocab {cfg.vocab}, window "
        f"{cfg.window}; {n_params / 1e9:.3f} G params (bf16, lambda / b_a / "
        f"b_x f32) from init_lm(seed=0) on the card in "
        f"{time.perf_counter() - t0:.2f}s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev)
    # warm-up (cuBLAS handles and heuristics at the decode shapes), not
    # counted: 4 prompt tokens + 2 generated on a scratch cache
    generate(params, init_cache(cfg, LM_BATCH, 8, dev), prompt[:, :4], 2, cfg)
    model_api.prefill_fn(params, {"tokens": prompt[:, :16]}, cfg)
    torch.cuda.synchronize()

    # -- (A) 4b's traffic on a 512-slot ring. Every decode step's logits
    # are kept as generate runs (the prompt's steps are prefill_into_cache's),
    # and the cache before the last step (position 159) is copied
    cache = init_cache(cfg, LM_BATCH, LM_CACHE, dev)
    steps = LM_PROMPT + LM_GEN
    stepped, before_last = [], {}
    real_decode = model_api.decode_fn

    def recording(params_, cache_, tok_, pos_, cfg_, policy=None):
        if pos_ == steps - 1:
            before_last.update({k: v.clone() for k, v in cache_.items()})
        lg, cache_ = real_decode(params_, cache_, tok_, pos_, cfg_, policy)
        stepped.append(lg)
        return lg, cache_

    _build.LAUNCHES.clear()
    model_api.decode_fn = recording
    t0 = time.perf_counter()
    try:
        toks, tps = generate(params, cache, prompt, LM_GEN, cfg)
    finally:
        model_api.decode_fn = real_decode
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = model_api.prefill_fn(params, {"tokens": prompt}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    say(f"[hybrid] (A) launches: {launches}")
    want = {"flash_decode": steps * nsb, "flash_attention_causal": nsb}
    for k, n in want.items():
        if launches.get(k, 0) != n:
            fail(f"[hybrid] {k} launched {launches.get(k, 0)} times, "
                 f"expected {n}")
    if tuple(toks.shape) != (LM_BATCH, LM_GEN) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"[hybrid] generated tokens {tuple(toks.shape)} outside the "
             f"vocab")
    if tuple(full.shape) != (LM_BATCH, LM_PROMPT, cfg.vocab) or not bool(
            torch.isfinite(full.float()).all()):
        fail(f"[hybrid] prefill_fn logits {tuple(full.shape)} not finite")
    say(f"[hybrid] (A) generate: {LM_BATCH} x ({LM_PROMPT} prompt + "
        f"{LM_GEN} greedy) in {serve_s:.3f}s ({steps} decode steps), decode "
        f"loop {tps:.2f} tok/s; prefill_fn over the prompt "
        f"{prefill_s * 1e3:.3f} ms incl. its first call at this shape = "
        f"{LM_BATCH * LM_PROMPT / prefill_s:.1f} tok/s ({card})")
    say(f"[hybrid] (A) first sequence: {toks[0, :16].tolist()}")

    seq = torch.cat([prompt, toks], 1)            # the 160 positions' tokens

    def decode_loop(cfg_, rows, n):
        """decode_fn over positions 0..n-1 of ``seq`` on a fresh cache of
        ``rows``: the logits (B, n, V)."""
        c = init_cache(cfg_, LM_BATCH, rows, dev)
        out = []
        for p in range(n):
            lg, c = model_api.decode_fn(params, c, seq[:, p:p + 1], p, cfg_)
            out.append(lg)
        return torch.stack(out, 1)

    def reading(tag, logits, ref_logits, lo=0):
        pc = position_corr_chunked(torch, logits, ref_logits)
        top = logits.argmax(-1) == ref_logits.argmax(-1)
        r = corr_reading(pc, top, lo)
        say(f"[hybrid] {tag}: last position corr {r['last_corr']:.6f}, "
            f"argmax {r['last_argmax']} of {logits.shape[0]}; over positions "
            f"[{lo}, {logits.shape[1]}) min corr {r['min_corr']:.6f}, argmax "
            f"agrees in {100 * r['argmax_share']:.2f}% of rows")
        return r

    # B5's prefill against B6's decode steps at every prompt position; the
    # same prefill through the plain attention on the card is the control
    loop = torch.stack(stepped, 1)
    del stepped
    real = reading("(A) prefill_fn (B5) vs decode_fn (B6) over the prompt",
                   full, loop[:, :LM_PROMPT])
    saved = transformer.blockwise_attention
    try:
        transformer.blockwise_attention = attn_mod.plain_attention
        control = reading("(A) control: prefill_fn on the plain attention vs "
                          "decode_fn (B6)", model_api.prefill_fn(
                              params, {"tokens": prompt}, cfg),
                          loop[:, :LM_PROMPT])
    finally:
        transformer.blockwise_attention = saved
    if not within_control(real, control, LM_BATCH):
        fail(f"[hybrid] (A) prefill_fn vs the decode loop: {real}, beyond "
             f"{HY_CORR_FACTOR}x the control's distance ({control})")
    del loop
    # the last decode step (pos 159) on the card and on the CPU (plain
    # versions) from copies of the params and of the cache before it; the
    # same card step on the ring's plain version is the control
    pos, tok = steps - 1, toks[:, -1:]
    before = {k: v.clone() for k, v in before_last.items()}
    cpu_cache = {k: v.to("cpu", copy=True) for k, v in before_last.items()}
    card_logits, _ = model_api.decode_fn(params, before_last, tok, pos, cfg)
    from repro_torch.kernels.ref import ring_decode_ref
    saved = transformer.ring_decode_attention
    try:
        transformer.ring_decode_attention = ring_decode_ref
        plain_logits, _ = model_api.decode_fn(params, before, tok, pos, cfg)
    finally:
        transformer.ring_decode_attention = saved
    del before
    t0 = time.perf_counter()
    cpu_params = to_device(params, "cpu")
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_logits, _ = model_api.decode_fn(cpu_params, cpu_cache, tok.cpu(), pos,
                                        cfg)
    cpu_s = time.perf_counter() - t0
    del cpu_params, cpu_cache
    c = corr(torch, card_logits, cpu_logits)
    c_ctl = corr(torch, plain_logits, cpu_logits)
    agree = int((card_logits.cpu().argmax(-1) == cpu_logits.argmax(-1)).sum())
    say(f"[hybrid] (A) last decode step (pos {pos}) re-run on the CPU with "
        f"the plain versions ({copy_s:.1f}s to copy the params, {cpu_s:.1f}s "
        f"the step): logits corr {c:.6f} (control, the card's step on the "
        f"ring's plain version: {c_ctl:.6f}), argmax agrees in {agree} of "
        f"{LM_BATCH} rows, max abs diff "
        f"{(card_logits.cpu().float() - cpu_logits.float()).abs().max().item():.3e}")
    if not (1 - c <= HY_CORR_FACTOR * (1 - c_ctl) and c > 0.99
            and agree >= LM_BATCH - 1):
        fail(f"[hybrid] card vs CPU decode-step logits: corr {c}, control "
             f"{c_ctl}, argmax {agree} of {LM_BATCH}")
    # steady-state decode step and the card's busy share over 8 steps
    step_ms = cuda_ms(lambda: model_api.decode_fn(params, before_last, tok,
                                                  pos, cfg), iters=10,
                      warmup=2)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(8):
            model_api.decode_fn(params, cache, tok, pos + 1 + i, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    say(f"[hybrid] (A) one decode step {step_ms:.3f} ms (CUDA events) = "
        f"{LM_BATCH / step_ms * 1e3:.2f} tok/s steady state; 8 steps under "
        f"the profiler: wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
        f"({100 * dev_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in events) / 8:.0f} kernel launches a step "
        f"({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    del before_last, cache, full

    # -- (B) the ring wraps: 160 positions on 128 slots (positions 128-159
    # overwrite slots 0-31), held at every position against prefill_fn
    # under window 128 (each reading also over the generated positions
    # alone). A ring written at a consistent wrong slot holds the same
    # keys once it has wrapped (softmax ignores their order), so that
    # fault shows where the ring has not wrapped yet: each prompt position
    # reads a zero slot in place of its own key
    ring_cfg = cfg.with_(window=HY_RING)
    want_b = model_api.prefill_fn(params, {"tokens": seq}, ring_cfg)

    def ring_reading(tag, logits):
        r = reading(tag, logits, want_b)
        r["generated"] = reading(f"{tag}, generated positions only", logits,
                                 want_b, LM_PROMPT)
        return r

    on_ring = decode_loop(cfg, HY_RING, steps)
    wrap = ring_reading(f"(B) decode on a {HY_RING}-slot ring vs prefill_fn "
                        f"under window {HY_RING}", on_ring)
    saved = transformer.blockwise_attention
    try:
        transformer.blockwise_attention = attn_mod.plain_attention
        want_plain = model_api.prefill_fn(params, {"tokens": seq}, ring_cfg)
    finally:
        transformer.blockwise_attention = saved
    ctl_b = reading("(B) control: prefill_fn on the plain attention under "
                    f"window {HY_RING} vs the ring", on_ring, want_plain)
    ctl_b["generated"] = reading("(B) control, generated positions only",
                                 on_ring, want_plain, LM_PROMPT)
    del want_plain

    def ring_passes(r):
        return (within_control(r, ctl_b, LM_BATCH)
                and within_control(r["generated"], ctl_b["generated"],
                                   LM_BATCH))

    if not ring_passes(wrap):
        fail(f"[hybrid] (B) the wrapped ring vs the windowed prefill: {wrap}, "
             f"beyond {HY_CORR_FACTOR}x the control's distance ({ctl_b})")
    # 4n (B) holds its mesh's decode of the same positions against these
    ring_cpu = on_ring.cpu().share_memory_()
    seq_cpu = seq.cpu().share_memory_()
    del on_ring
    faults = {}
    saved = transformer.ring_slot
    try:
        transformer.ring_slot = lambda p, w: (p + 1) % w
        planted = decode_loop(cfg, HY_RING, steps)
    finally:
        transformer.ring_slot = saved
    faults["ring written one slot off"] = ring_reading(
        "(B) planted fault: the ring written one slot off", planted)
    del planted
    planted = decode_loop(cfg.with_(window=0), steps, steps)
    faults["B6 over a linear 160-row cache, no window"] = ring_reading(
        "(B) planted fault: B6 at length pos + 1 over a linear 160-row cache",
        planted)
    del planted, want_b
    for tag, r in faults.items():
        if ring_passes(r):
            fail(f"[hybrid] (B) the planted fault ({tag}) passes the ring's "
                 f"limits, which therefore cannot catch it: {r}")

    # -- (C) the window binds: one 4096-token prompt on B5 under the
    # 2048-key window against the plain attention on the card
    long = torch.randint(0, cfg.vocab, (1, HY_LONG), generator=gen,
                         device=dev)
    model_api.prefill_fn(params, {"tokens": long[:, :256]}, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    kern = model_api.prefill_fn(params, {"tokens": long}, cfg)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    long_launches = _build.LAUNCHES.get("flash_attention_causal", 0)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if long_launches != nsb:
        fail(f"[hybrid] (C) B5 launched {long_launches} times, expected "
             f"{nsb}")
    if not bool(torch.isfinite(kern.float()).all()):
        fail("[hybrid] (C) prefill logits not finite")
    saved = transformer.blockwise_attention
    try:
        transformer.blockwise_attention = attn_mod.plain_attention
        plain = model_api.prefill_fn(params, {"tokens": long}, cfg)
    finally:
        transformer.blockwise_attention = saved
    say(f"[hybrid] (C) prefill_fn over 1 x {HY_LONG} tokens on B5 (window "
        f"{cfg.window}, {long_launches} launches): {long_s * 1e3:.3f} ms = "
        f"{HY_LONG / long_s:.1f} tok/s; peak memory {peak_gb:.2f} GiB "
        f"({card})")
    win = reading("(C) B5 under the window vs the plain attention", kern,
                  plain)
    if not corr_passes(win, 1):
        fail(f"[hybrid] (C) B5's windowed prefill vs the plain one: {win}")
    del kern
    causal = model_api.prefill_fn(params, {"tokens": long},
                                  cfg.with_(window=0))
    pc = position_corr_chunked(torch, causal, plain)
    top = causal.argmax(-1) == plain.argmax(-1)
    before = corr_reading(pc[:HY_WINDOW], top[:, :HY_WINDOW])
    after = corr_reading(pc, top, HY_WINDOW)
    say(f"[hybrid] (C) planted fault, window 0 (plain causal) vs the plain "
        f"windowed attention: positions < {HY_WINDOW} min corr "
        f"{before['min_corr']:.6f}; positions >= {HY_WINDOW}: min corr "
        f"{after['min_corr']:.6f}, last {after['last_corr']:.6f}, argmax "
        f"{100 * after['argmax_share']:.2f}%")
    if not before["min_corr"] > 0.999:
        fail(f"[hybrid] (C) window 0 disagrees before position {HY_WINDOW}: "
             f"{before}")
    if corr_passes(after, 1):
        fail(f"[hybrid] (C) window 0 passes from position {HY_WINDOW} on, so "
             f"the check cannot tell the window was applied: {after}")
    del causal, plain, params
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"[hybrid] path 4m in {phase_s:.1f}s ({card})")
    return {"launches": launches, "tps": tps, "step_ms": step_ms,
            "busy": dev_ms / wall_ms, "prefill_tps": LM_BATCH * LM_PROMPT
            / prefill_s, "long_tps": HY_LONG / long_s, "peak_gb": peak_gb,
            "phase_s": phase_s, "A": real, "A_control": control,
            "cpu_corr": c, "cpu_control": c_ctl, "B": wrap,
            "B_control": ctl_b, "C": win, "faults": faults,
            "ring": ring_cpu, "seq": seq_cpu}


# path 4n: recurrentgemma-9b trains, and runs on the ("data", "model")
# mesh. (A) one card: the first HN_LAYERS layers (one (rec, rec, attn)
# super-block and the 2-layer tail, so the tail trains too) at full width,
# TokenStream batches of HN_BATCH x HN_SEQ tokens (the 2048-key window
# binds), HN_WARMUP + HN_STEPS steps of the config's step (remat,
# microbatch_steps 2, bf16 AdamW moments), then HN_REPEAT more on the
# batch of step 0. (B) MODEL_RULES on (data 1, model 2), 2 gloo ranks on
# the card: the full 38 layers, 4m (B)'s 160 positions on the 128-slot
# ring, the first HN_ARITH_STEPS decode steps and the prefill held bitwise
# against the split's arithmetic on one device. (C) MODEL_RULES (1, 2)
# and DATA_RULES (2): one step's gradient at (A)'s size on HN_C_BATCH x
# HN_C_SEQ tokens against (A)'s one-device gradient; the steps themselves
# at a vocab of HN_C_VOCAB (see HN_C_VOCAB)
HN_LAYERS = 5
HN_BATCH, HN_SEQ = 2, 4096
HN_WARMUP, HN_STEPS, HN_REPEAT = 2, 8, 3
# the lru_scan gradient check: one layer's (B, S, W), against a
# sequential loop over the positions in f64, within this share of the
# largest |gradient|
HN_SCAN = (1, 4096, 4096)
HN_SCAN_REL = 1e-5
# (A)'s two microbatches against the batch at once: within this many times
# the control, the same microbatched step with a bf16 accumulator (the
# distance one more rounding of the gradient moves it)
HN_MICRO_FACTOR = 4
HN_ARITH_STEPS = 4
HN_FAULTS = ("gate partials not reduced", "b_a added on every rank")
HN_C_BATCH, HN_C_SEQ = 4, 512
HN_C_WARMUP, HN_C_STEPS = 1, 2
# (C)'s gradient bound: this many times the order control (the one-device
# step on the batch at once against the same step in its 2 microbatches,
# as 4j's half-batch control)
HN_GRAD_FACTOR = 4
# (C)'s steps carry AdamW's moments, which at the full vocab do not fit:
# under either table every rank holds the whole 256000-row embedding and
# head (2.1 G params) with their moments and the f32 microbatch
# accumulator, 37 GB a rank before the update, so two ranks overflow the
# one 80 GB card. The steps run at this vocab, every other width full
HN_C_VOCAB = 32768


def _chunks(t, n: int = 1 << 26):
    flat = t.reshape(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)]


def rel_l2_sums(torch, a, b) -> tuple:
    """(sum (a - b)^2, sum b^2) of two tensors, in f64, in chunks (a 1
    G-element leaf in f64 at once would take 8 GB); b moved to a's
    device."""
    num = den = 0.0
    for x, y in zip(_chunks(a), _chunks(b)):
        y = y.to(x.device).double()
        num += float(((x.double() - y) ** 2).sum())
        den += float((y ** 2).sum())
    return num, den


def tree_rel_l2(torch, ga, gb) -> float:
    """Relative L2 of tree ga against tree gb (chunked f64), leaves
    matched by key."""
    from repro_torch.optim.adamw import tree_leaves

    num = den = 0.0
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        n, d = rel_l2_sums(torch, a, b)
        num, den = num + n, den + d
    return (num / den) ** 0.5


def bits_digest(torch, t) -> int:
    """A 64-bit digest of a tensor's bits (its 16- or 32-bit words times
    fixed odd multipliers, summed mod 2^64): equal tensors give equal
    digests, and a tensor differing in any word gives another with
    probability 1 - 2^-63."""
    words = t.reshape(-1).view(torch.int16 if t.element_size() == 2
                               else torch.int32)
    gen = torch.Generator(device=t.device).manual_seed(12345)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for c in _chunks(words):
        mult = torch.randint(-2 ** 62, 2 ** 62, c.shape, generator=gen,
                             device=t.device, dtype=torch.int64) * 2 + 1
        total += (c.to(torch.int64) * mult).sum()
    return int(total)


def scan_grad_check(torch, dev) -> dict:
    """``lru_scan``'s gradient at one layer's shape (1, 4096, 4096) against
    the recurrence stepped position by position in f64: a = exp(-8
    softplus(lambda) r) with the model's lambda and r = sigmoid(N(0, 1)),
    b ~ N(0, 1) sqrt(1 - a^2), the loss sum(h w) with w ~ N(0, 1). The
    f64 adjoint: g_t = w_t + a_{t+1} g_{t+1}, dL/db_t = g_t, dL/da_t =
    g_t h_{t-1}. The f32 loop of the same recurrence is printed beside
    it, a control."""
    from repro_torch.models import rglru

    gen = torch.Generator(device=dev).manual_seed(31)
    bsz, s, w = HN_SCAN
    lam = rglru.lambda_init(w, dev)
    r = torch.sigmoid(torch.randn(bsz, s, w, generator=gen, device=dev))
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    b = torch.randn(bsz, s, w, generator=gen, device=dev) * torch.sqrt(
        1 - a * a)
    wt = torch.randn(bsz, s, w, generator=gen, device=dev)
    a32, b32 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    t0 = time.perf_counter()
    (rglru.lru_scan(a32, b32) * wt).sum().backward()
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0

    def sequential(dtype):
        ad, bd, wd = a.to(dtype), b.to(dtype), wt.to(dtype)
        h = torch.zeros(bsz, s, w, dtype=dtype, device=dev)
        prev = torch.zeros(bsz, w, dtype=dtype, device=dev)
        for t in range(s):
            prev = ad[:, t] * prev + bd[:, t]
            h[:, t] = prev
        gb = torch.empty_like(h)
        g = torch.zeros(bsz, w, dtype=dtype, device=dev)
        for t in range(s - 1, -1, -1):
            g = wd[:, t] + (ad[:, t + 1] * g if t + 1 < s else 0)
            gb[:, t] = g
        ga = gb.clone()
        ga[:, 1:] *= h[:, :-1]
        ga[:, 0] = 0
        return ga, gb

    ga64, gb64 = sequential(torch.float64)
    ga32, gb32 = sequential(torch.float32)

    def err(x, ref):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    out = {"a": err(a32.grad, ga64), "b": err(b32.grad, gb64),
           "a_loop32": err(ga32, ga64), "b_loop32": err(gb32, gb64),
           "scan_s": scan_s}
    del ga64, gb64, ga32, gb32, a32, b32, a, b, wt, r
    torch.cuda.empty_cache()
    return out


def run_hybrid_train(torch, dev, card: str) -> dict:
    """Phase 4n (A), ``[hybrid_train]``: recurrentgemma-9b's first
    HN_LAYERS layers at full width trained on one card through
    ``launch/steps.py::make_train_fn`` (the config's remat, 2
    microbatches and bf16 AdamW moments) on ``TokenStream`` batches of
    HN_BATCH x HN_SEQ. Checks, under deterministic algorithms (the
    embedding's gradient accumulates by index): the step's gradient with
    remat off bitwise (the loss, and every leaf's 64-bit ``bits_digest``);
    the two microbatches against the batch at once
    within HN_MICRO_FACTOR times the bf16-accumulator control;
    ``lru_scan``'s gradient against an f64 sequential loop; the loss
    falling over HN_REPEAT steps on step 0's batch. Also (C)'s one-device
    gradient on (C)'s batch from the same initial params: its loss, its
    leaves' digests (``bits_digest``: (C)'s rank 0 recomputes it and
    checks it is this one, bit for bit) and its order control."""
    from repro_torch.bridge import init_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves

    t_phase = time.perf_counter()
    full_precision_matmuls()
    cfg = get_config("recurrentgemma-9b").with_(n_layers=HN_LAYERS)
    params = init_lm(0, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[hybrid_train] {cfg.name} cut to {cfg.n_layers} layers (one (rec, "
        f"rec, attn) super-block + {cfg.n_layers % 3} tail rec), full width: "
        f"{n_params / 1e9:.3f} G params, bf16 from init_lm(seed=0); remat "
        f"{cfg.remat}, microbatch_steps {cfg.microbatch_steps}, AdamW moments "
        f"{'f32' if cfg.use_fp32_master else 'bf16'}, grad accumulator "
        f"{cfg.grad_accum_dtype} ({card})")
    out = {"n_params": n_params}

    # lru_scan's gradient against the f64 recurrence
    scan = scan_grad_check(torch, dev)
    say(f"[hybrid_train] (A) lru_scan gradient at {HN_SCAN} ({scan['scan_s']:.3f}s "
        f"forward + backward) against the f64 sequential recurrence: max "
        f"|err| / max |grad| a {scan['a']:.3e}, b {scan['b']:.3e} (limit "
        f"{HN_SCAN_REL:g}); the f32 sequential loop, a control: a "
        f"{scan['a_loop32']:.3e}, b {scan['b_loop32']:.3e}")
    if not max(scan["a"], scan["b"]) <= HN_SCAN_REL:
        fail(f"4n (A): lru_scan's gradient off the f64 recurrence: {scan}")
    out["scan"] = scan

    def grads(c, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = steps.make_grad_fn(c)(params, batch)
        torch.cuda.synchronize()
        return loss, g, time.perf_counter() - t0

    torch.use_deterministic_algorithms(True)
    try:
        # (C)'s one-device gradient (its batch, 2 microbatches) and the order
        # control (the batch at once), from these initial params
        cb = TokenStream(cfg.vocab, HN_C_SEQ, HN_C_BATCH, seed=0,
                         device=dev).batch_at(0)
        loss_c, g_c, _ = grads(cfg, cb)
        _, g_c1, _ = grads(cfg.with_(microbatch_steps=1), cb)
        out["c_control"] = tree_rel_l2(torch, g_c1, g_c)
        del g_c1
        out["c_loss"] = float(loss_c)
        out["c_digests"] = [bits_digest(torch, t) for t in tree_leaves(g_c)]
        say(f"[hybrid_train] (C)'s one-device gradient on {HN_C_BATCH} x "
            f"{HN_C_SEQ} tokens: loss {float(loss_c):.6f}; the batch at once "
            f"against its 2 microbatches (the order control) "
            f"{out['c_control']:.3e}")
        del g_c

        ts = TokenStream(cfg.vocab, HN_SEQ, HN_BATCH, seed=0, device=dev)
        b0 = ts.batch_at(0)
        torch.cuda.reset_peak_memory_stats()
        l_on, g_on, s_on = grads(cfg, b0)
        peak_grad = torch.cuda.max_memory_allocated() / 2 ** 30
        d_on = [bits_digest(torch, t) for t in tree_leaves(g_on)]
        _, g_whole, s_whole = grads(cfg.with_(microbatch_steps=1), b0)
        micro = tree_rel_l2(torch, g_whole, g_on)
        del g_whole
        _, g_16, _ = grads(cfg.with_(grad_accum_dtype="bf16"), b0)
        micro_ctl = tree_rel_l2(torch, g_16, g_on)
        del g_16, g_on
        l_off, g_off, s_off = grads(cfg.with_(remat=False), b0)
        remat_bitwise = bool(torch.equal(l_on, l_off)) and d_on == [
            bits_digest(torch, t) for t in tree_leaves(g_off)]
        del g_off
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    say(f"[hybrid_train] (A) one step's gradient on {HN_BATCH} x {HN_SEQ}: "
        f"{s_on:.3f}s with remat (peak {peak_grad:.2f} GiB), {s_off:.3f}s "
        f"without, bitwise equal: {remat_bitwise}; the batch at once "
        f"({s_whole:.3f}s) against the 2 microbatches: relative L2 "
        f"{micro:.3e}, limit {HN_MICRO_FACTOR} x the control {micro_ctl:.3e} "
        f"(the 2 microbatches accumulated in bf16)")
    if not remat_bitwise:
        fail("4n (A): the gradient with remat off is not bitwise the remat one")
    if not micro <= HN_MICRO_FACTOR * micro_ctl:
        fail(f"4n (A): microbatches vs the batch at once {micro}, beyond "
             f"{HN_MICRO_FACTOR} x {micro_ctl}")
    out.update(remat_bitwise=remat_bitwise, micro=micro, micro_ctl=micro_ctl)

    # the train steps: HN_WARMUP, then HN_STEPS timed, then HN_REPEAT on
    # step 0's batch again
    state = {"params": params, "opt": adamw_init(params, AdamWConfig(
        low_mem=not cfg.use_fp32_master)),
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    step_fn = steps.make_train_fn(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms, losses, norms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(HN_WARMUP + HN_STEPS + HN_REPEAT):
        batch = ts.batch_at(i if i < HN_WARMUP + HN_STEPS else 0)
        torch.cuda.synchronize()
        ev[0].record()
        state, m = step_fn(state, batch)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, m
    torch.cuda.empty_cache()
    timed = ms[HN_WARMUP:HN_WARMUP + HN_STEPS]
    step_ms = sum(timed) / len(timed)
    tokens = HN_BATCH * HN_SEQ
    say(f"[hybrid_train] (A) {HN_WARMUP} warmup + {HN_STEPS} steps on fresh "
        f"batches: {step_ms:.1f} ms a step (CUDA events, mean of "
        f"{len(timed)}; {min(timed):.1f}-{max(timed):.1f}) = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB "
        f"({card})")
    for i, (x, g, t) in enumerate(zip(losses, norms, ms)):
        tag = ("warmup" if i < HN_WARMUP else "repeat of batch 0"
               if i >= HN_WARMUP + HN_STEPS else "step")
        say(f"[hybrid_train] (A) {tag} {i}: loss {x:.5f}, grad norm {g:.4f}, "
            f"{t:.1f} ms")
    rep = losses[HN_WARMUP + HN_STEPS:]
    if not all(b < a for a, b in zip(rep, rep[1:])):
        fail(f"4n (A): the loss on step 0's batch did not fall over "
             f"{HN_REPEAT} steps: {rep}")
    out.update(step_ms=step_ms, tps=tokens / step_ms * 1e3, peak_gib=peak,
               losses=losses, norms=norms, ms=ms,
               phase_s=time.perf_counter() - t_phase)
    say(f"[hybrid_train] path 4n (A) in {out['phase_s']:.1f}s ({card})")
    return out


def _b_a_on_every_rank(p, uf, split):
    """4n (B)'s planted fault: each rank adds the gate biases to its
    partial products before the reduce, so the sum carries them twice."""
    import torch
    from repro_torch.models import rglru

    partial = torch.stack([uf @ p["w_a"].float() + p["b_a"],
                           uf @ p["w_x"].float() + p["b_x"]])
    whole = rglru._reduce_gates(partial, split.group)
    c0, c1 = split.block(whole.shape[-1])
    return whole[0, ..., c0:c1], whole[1, ..., c0:c1]


def hybrid_ranks(seq_cpu, ring_cpu, ref: dict, device: str) -> tuple:
    """One of the 2 gloo ranks of path 4n: (B), then (C), in one spawn
    (each rank starts once)."""
    return (hybrid_mesh_rank(seq_cpu, ring_cpu, device),
            hybrid_train_rank(ref, device))


def hybrid_mesh_rank(seq_cpu, ring_cpu, device: str) -> dict:
    """One rank of path 4n (B): recurrentgemma-9b at full depth and width
    under MODEL_RULES on make_host_mesh(1, 2), 2 gloo ranks on the card,
    each drawing its blocks of init_lm(seed=0) leaf group by leaf group.
    Counted: the decode step over 4m (B)'s 160 positions (``seq_cpu``) on
    a HY_RING-slot ring and ``prefill_fn`` over the prompt. Then the two
    planted faults' prefills (with the gate biases drawn N(0, 0.5), which
    init_lm leaves at 0, so the fault that counts b_a twice shows), and on
    rank 0, after both ranks free their blocks, the split's arithmetic on
    one device (``tp_arithmetic`` on the whole params): its prefill and
    first HN_ARITH_STEPS decode steps against the mesh's, bitwise, and the
    mesh's decode against 4m (B)'s unsharded one (``ring_cpu``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import init_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api as model_api
    from repro_torch.models import rglru

    mesh = make_host_mesh(1, 2, device=device)
    dev = mesh.device
    full_precision_matmuls()
    cfg = get_config("recurrentgemma-9b")
    r0 = dist.get_rank() == 0
    n_pos = seq_cpu.shape[1]
    out = {"rank": dist.get_rank(), "backend": mesh.backend}

    def sync():
        torch.cuda.synchronize(dev)

    with sharding.use_sharding(mesh), torch.no_grad():
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        local = init_lm(0, cfg, dev, place=True)
        sync()
        out.update(draw_s=time.perf_counter() - t0,
                   held_gb=torch.cuda.memory_allocated(dev) / 1e9,
                   draw_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        rec = local["blocks"]["rec0"]["rec"]
        out["shapes"] = {k: tuple(v.shape) for k, v in (
            ("in_proj", rec["in_proj"]), ("w_a", rec["w_a"]),
            ("conv_w", rec["conv_w"]),
            ("wq", local["blocks"]["attn"]["attn"]["wq"]),
            ("w_down", local["blocks"]["attn"]["ffn"]["w_down"]))}
        seq = seq_cpu.to(dev)
        prompt = seq[:, :LM_PROMPT]
        # warm-up through the entry points, not counted
        serve.generate(local, serve.init_cache(cfg, LM_BATCH, HY_RING, dev),
                       prompt[:, :2], 1, cfg)
        model_api.prefill_fn(local, {"tokens": prompt[:, :16]}, cfg)
        sync()
        cache = serve.init_cache(cfg, LM_BATCH, HY_RING, dev)
        out["cache"] = {k: tuple(v.shape) for k, v in cache.items()}
        collectives.STATS.clear()
        collectives.BYTES.clear()
        _build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        lgs = []
        t0 = time.perf_counter()
        for pos in range(n_pos):
            lg, cache = model_api.decode_fn(local, cache, seq[:, pos:pos + 1],
                                            pos, cfg)
            lgs.append(lg)
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["stats"] = dict(collectives.STATS)
        out["bytes"] = dict(collectives.BYTES)
        t0 = time.perf_counter()
        pre = model_api.prefill_fn(local, {"tokens": prompt}, cfg)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["launches"] = dict(_build.LAUNCHES)
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        dec = torch.stack(lgs, 1)
        del lgs, cache
        out["digest"] = (bits_digest(torch, dec), bits_digest(torch, pre))

        # the planted faults, on both ranks (their collectives pair up),
        # with the gate biases drawn so a doubled b_a shows
        gen = torch.Generator(device=dev).manual_seed(55)
        for sub in (local["blocks"]["rec0"], local["blocks"]["rec1"],
                    local["tail_blocks"]):
            for k in ("b_a", "b_x"):
                t = sub["rec"][k]
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
        clean = model_api.prefill_fn(local, {"tokens": prompt}, cfg)
        faults = {HN_FAULTS[0]: ("_reduce_gates", lambda p, g: p),
                  HN_FAULTS[1]: ("_gate_preacts", _b_a_on_every_rank)}
        out["planted"] = {}
        for tag, (attr, fn) in faults.items():
            saved = getattr(rglru, attr)
            setattr(rglru, attr, fn)
            try:
                lg = model_api.prefill_fn(local, {"tokens": prompt}, cfg)
            finally:
                setattr(rglru, attr, saved)
            pc = position_corr_chunked(torch, lg, clean)
            top = lg.argmax(-1) == clean.argmax(-1)
            out["planted"][tag] = corr_reading(pc, top)
        del clean, lg, local
        torch.cuda.empty_cache()
        dist.barrier()
        if r0:
            with sharding._installed(None):
                whole = init_lm(0, cfg, dev)
                with tp_arithmetic(torch, whole, cfg):
                    twin = model_api.prefill_fn(whole, {"tokens": prompt}, cfg)
                    c = serve.init_cache(cfg, LM_BATCH, HY_RING, dev)
                    tdec = []
                    for pos in range(HN_ARITH_STEPS):
                        lg, c = model_api.decode_fn(
                            whole, c, seq[:, pos:pos + 1], pos, cfg)
                        tdec.append(lg)
                del whole, c
            out["twin_prefill"] = bool(torch.equal(twin, pre))
            out["twin_decode"] = bool(torch.equal(
                torch.stack(tdec, 1), dec[:, :HN_ARITH_STEPS]))
            out["twin_maxdiff"] = float((twin.float() - pre.float()).abs()
                                        .max())
            del twin, tdec
            ring = ring_cpu.to(dev)
            for tag, lo in (("all", 0), ("generated", LM_PROMPT)):
                pc = position_corr_chunked(torch, dec[:, lo:], ring[:, lo:])
                top = dec[:, lo:].argmax(-1) == ring[:, lo:].argmax(-1)
                out[tag] = corr_reading(pc, top)
                out[tag]["before_wrap"] = (
                    float(pc[:max(HY_RING - lo, 0)].min())
                    if lo < HY_RING else None)
            del ring
        del dec, pre
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def hybrid_train_rank(ref: dict, device: str) -> dict:
    """One of 2 gloo ranks of path 4n (C), on the card. Rank 0 first
    recomputes (A)'s one-device gradient on (C)'s batch (no context) and
    checks it against ``ref`` (its loss and leaf digests) bit for bit.
    Then under MODEL_RULES on (data 1, model 2) and DATA_RULES on (data
    2), (A)'s cut model drawn in blocks (init_lm(seed=0)) and (C)'s batch,
    each rank its rows of each microbatch: one step's gradient (the loss,
    gloo ms and MB, the logical gradient's relative L2 against the
    one-device one on rank 0, each whole leaf's gradient digest). Then
    under each table HN_C_WARMUP + HN_C_STEPS steps through
    ``train_loop`` at a vocab of HN_C_VOCAB (the losses, seconds, gloo ms
    and MB, each whole leaf's digest after them)."""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import init_lm
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import _build_mesh, make_host_mesh
    from repro_torch.models import api as model_api
    from repro_torch.optim.adamw import tree_leaves

    meshes = (("MODEL_RULES (1, 2)", make_host_mesh(1, 2, device=device),
               sharding.MODEL_RULES),
              ("DATA_RULES (2)", _build_mesh(2, 1, device,
                                             axis_names=("data",)),
               sharding.DATA_RULES))
    dev = meshes[0][1].device
    full_precision_matmuls()
    r0 = dist.get_rank() == 0
    cfg = get_config("recurrentgemma-9b").with_(n_layers=HN_LAYERS)

    def sync():
        torch.cuda.synchronize(dev)

    def agree(values) -> bool:
        """Whether every rank holds the same list of ints."""
        mine = torch.tensor(values, dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        return all(torch.equal(e, mine) for e in every)

    def f32_bits(x: float) -> int:
        return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))

    def whole_digests(tree, split) -> dict:
        """name -> bits digest of every leaf placed whole (no split dim)."""
        return {name: bits_digest(torch, t) for name, t, sp in zip(
            _leaf_names(tree), tree_leaves(tree), tree_leaves(split))
            if not any(sp)}

    def grads(c, params, batch):
        torch.use_deterministic_algorithms(True)
        try:
            sync()
            t0 = time.perf_counter()
            loss, g = steps.make_grad_fn(c)(params, batch)
            sync()
        finally:
            torch.use_deterministic_algorithms(False)
        return loss, g, time.perf_counter() - t0

    out = {tag: {} for tag, _, _ in meshes}
    g_one = None
    if r0:
        whole = init_lm(0, cfg, dev)
        loss1, g_one, _ = grads(cfg, whole, TokenStream(
            cfg.vocab, HN_C_SEQ, HN_C_BATCH, seed=0, device=dev).batch_at(0))
        del whole
        out["one_is_A"] = (float(loss1) == ref["loss"] and [
            bits_digest(torch, t) for t in tree_leaves(g_one)]
            == ref["digests"])
        # to host memory: on the card its 12.9 GB beside a DATA_RULES
        # rank's whole gradient and the earlier paths' leftovers overflow
        # the card
        g_one = [t.cpu() for t in tree_leaves(g_one)]
        torch.cuda.empty_cache()
    dist.barrier()
    for tag, mesh, rules in meshes:
        r = out[tag]
        with sharding.use_sharding(mesh, rules) as ctx:
            axes = steps.placement_axes(cfg, model_api.model_logical_axes(cfg))
            split = steps._split_leaves(axes, ctx)
            params = init_lm(0, cfg, dev, place=True)
            batch = TokenStream(cfg.vocab, HN_C_SEQ, HN_C_BATCH, seed=0,
                                ctx=ctx, device=dev,
                                microbatches=cfg.microbatch_steps).batch_at(0)
            collectives.STATS.clear()
            collectives.BYTES.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            loss, g, r["grad_s"] = grads(cfg, params, batch)
            r["grad_stats"] = dict(collectives.STATS)
            r["grad_bytes"] = dict(collectives.BYTES)
            r["grad_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            r["loss"] = float(loss)
            r["losses_agree"] = agree([f32_bits(float(loss))])
            digests = whole_digests(g, split)
            r["whole_grads_agree"] = agree(list(digests.values()))
            r["n_whole"] = len(digests)
            r["held"] = {k: tuple(v.shape) for k, v in (
                ("in_proj", params["blocks"]["rec0"]["rec"]["in_proj"]),
                ("w_a", params["blocks"]["rec0"]["rec"]["w_a"]),
                ("embed", params["embed"]))}
            del params
            num = den = 0.0
            for leaf, ax, one in zip(tree_leaves(g), tree_leaves(axes),
                                     g_one if r0 else
                                     [None] * len(tree_leaves(g))):
                whole = steps.gather_tree({"t": leaf}, {"t": ax}, ctx)["t"]
                if r0:
                    n_, d_ = rel_l2_sums(torch, whole, one)
                    num, den = num + n_, den + d_
                del whole
            if r0:
                r["grad_rel"] = (num / den) ** 0.5
            del g
            torch.cuda.empty_cache()
    del g_one
    torch.cuda.empty_cache()

    # the steps, at a vocab of HN_C_VOCAB
    cfg_v = cfg.with_(vocab=HN_C_VOCAB)
    shape = ShapeConfig("4n", HN_C_SEQ, HN_C_BATCH, "train")
    for tag, mesh, rules in meshes:
        r = out[tag]
        with sharding.use_sharding(mesh, rules) as ctx:
            split_v = steps._split_leaves(steps.placement_axes(
                cfg_v, model_api.model_logical_axes(cfg_v)), ctx)
            state = train.init_state(cfg_v, 0, dev)
            collectives.STATS.clear()
            collectives.BYTES.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            sync()
            t0 = time.perf_counter()
            final, losses, _ = train.train_loop(
                cfg_v, shape, HN_C_WARMUP + HN_C_STEPS, device=dev,
                state=state, log_every=10 ** 9)
            sync()
            r["steps_s"] = time.perf_counter() - t0
            r["step_stats"] = dict(collectives.STATS)
            r["step_bytes"] = dict(collectives.BYTES)
            r["step_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            r["losses"] = losses
            r["step_losses_agree"] = agree([f32_bits(x) for x in losses])
            digests = whole_digests(final["params"], split_v)
            r["whole_after_steps_agree"] = agree(list(digests.values()))
            r["whole_after_steps"] = sorted({k.rsplit("/", 1)[-1]
                                             for k in digests})
            del state, final
            torch.cuda.empty_cache()
    return out

def check_hybrid_rank_kernels(torch, dev) -> dict:
    """Phase 3, B5 and B6 at a recurrentgemma-9b rank's shapes under
    MODEL_RULES on (1, 2) (path 4n (B)): B5 q (4, 128, 8, 256) on the one
    KV head under the 2048-key window, in the model's (B, S, H, D)
    layout; B6 q (4, 1, 8, 256) over a layer's view of a (4, 128, 1, 256)
    ring at positions 63, 127 (full) and 200 (wrapped), each call twice
    and bitwise equal; against their plain versions at ``held``'s bf16
    tolerance. Returns kernel name -> max |kernel - plain|."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import (blockwise_attention,
                                              ring_decode_attention)

    gen = torch.Generator(device=dev).manual_seed(4646)
    bf, h, d = torch.bfloat16, HY_HEADS // 2, HY_D
    err = {"flash_attention_causal": 0.0, "flash_decode": 0.0}
    q = torch.randn(LM_BATCH, LM_PROMPT, h, d, generator=gen,
                    device=dev).to(bf)
    k, v = (torch.randn(LM_BATCH, LM_PROMPT, HY_KV, d, generator=gen,
                        device=dev).to(bf) for _ in range(2))
    got = blockwise_attention(q, k, v, causal=True, window=HY_WINDOW)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   window=HY_WINDOW).transpose(1, 2)
    e, ok, tol = held(torch, got, want)
    say(f"[check] B5 4n rank q({LM_BATCH},{LM_PROMPT},{h},{d}) Hkv {HY_KV} "
        f"bf16 window {HY_WINDOW}: max abs err {e:.3e} (tol {tol})")
    if not ok:
        fail(f"B5 at 4n's rank shape: max abs err {e}")
    err["flash_attention_causal"] = e
    for pos in (63, 127, 200):
        qd = torch.randn(LM_BATCH, 1, h, d, generator=gen, device=dev).to(bf)
        kr, vr = (torch.randn(2, LM_BATCH, HY_RING, HY_KV, d, generator=gen,
                              device=dev).to(bf)[1] for _ in range(2))
        got = ring_decode_attention(qd, kr, vr, pos)
        if not torch.equal(ring_decode_attention(qd, kr, vr, pos), got):
            fail(f"B6 at 4n's rank shape, pos {pos}: two calls differ")
        e, ok, tol = held(torch, got, ref.ring_decode_ref(qd, kr, vr, pos))
        say(f"[check] B6 4n rank q({LM_BATCH},1,{h},{d}) ring ({LM_BATCH},"
            f"{HY_RING},{HY_KV},{d}) of a stack, pos {pos} bf16: max abs err "
            f"{e:.3e} (tol {tol})")
        if not ok:
            fail(f"B6 at 4n's rank shape, pos {pos}: max abs err {e}")
        err["flash_decode"] = max(err["flash_decode"], e)
    torch.cuda.synchronize()
    return err


def time_hybrid_rank_kernels(torch, dev, card: str) -> dict:
    """B5 and B6 at a 4n (B) rank's shapes (bf16): B5 over the prompt, q
    (4, 128, 8, 256) on one KV head under the 2048-key window (all 128
    keys visible: causal); B6 at a decode step past the wrap, q (4, 1, 8,
    256) over the full 128-slot ring. Device ms (profiler), bound, the
    plain version and SDPA; each the sub-entry ``hybrid_rank`` of the
    kernel's line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    gen = torch.Generator(device=dev).manual_seed(78)
    b, s, h, d, bf = LM_BATCH, LM_PROMPT, HY_HEADS // 2, HY_D, torch.bfloat16
    q5, k5, v5 = (torch.randn(b, s, hh, d, generator=gen, device=dev).to(bf)
                  .transpose(1, 2) for hh in (h, HY_KV, HY_KV))
    pairs = b * h * hybrid_window_pairs(s, HY_WINDOW)
    b5 = dict(shape=f"q({b},{h},{s},{d}) Hkv {HY_KV} bf16 window {HY_WINDOW}",
              fns=(lambda: flash_attention(q5, k5, v5, window=HY_WINDOW),
                   lambda: ref.flash_attention_ref(q5, k5, v5,
                                                   window=HY_WINDOW),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q5, k5, v5, is_causal=True, enable_gqa=True)),
              ops=pairs * 4 * d / PEAK_BF16_FLOPS,
              nbytes=2 * (2 * b * h * s * d + 2 * b * HY_KV * s * d)
              / PEAK_BYTES)
    w = HY_RING
    q6 = torch.randn(b, 1, h, d, generator=gen, device=dev).to(bf)
    k6, v6 = (torch.randn(b, w, HY_KV, d, generator=gen, device=dev).to(bf)
              for _ in range(2))
    b6 = dict(shape=f"q({b},1,{h},{d}) ring ({b},{w},{HY_KV},{d}) full bf16",
              fns=(lambda: flash_decode(q6, k6, v6, w),
                   lambda: ref.ring_decode_ref(q6, k6, v6, 2 * w),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q6.transpose(1, 2), k6.transpose(1, 2),
                       v6.transpose(1, 2), enable_gqa=True)),
              ops=b * h * w * 4 * d / PEAK_F32_FLOPS,
              nbytes=2 * (2 * b * w * HY_KV * d + 2 * b * h * d)
              / PEAK_BYTES)
    return time_attention_rows(
        torch, {"flash_attention_causal": b5, "flash_decode": b6},
        "4n's rank shape", card)


def _gloo_txt(stats: dict, nbytes: dict, per: float) -> str:
    """gloo ms and MB of each op, per ``per`` (steps)."""
    ops = sorted(k for k in stats if not k.endswith("_s"))
    return ", ".join(f"{k} {stats[k] / per:.0f}x {1e3 * stats[k + '_s'] / per:.2f} ms "
                     f"{nbytes.get(k, 0) / per / 1e6:.2f} MB" for k in ops)


def run_hybrid_mesh(torch, dev, card: str, hybrid: dict,
                    trained: dict) -> dict:
    """Path 4n (B) and (C), ``[hybrid_mesh]``: 2 gloo ranks sharing the
    card. (B) recurrentgemma-9b at full depth and width under MODEL_RULES
    against 4m (B)'s unsharded run of the same 160 positions on the
    128-slot ring (``hybrid["ring"]``) and the split's arithmetic on one
    device; (C) (A)'s cut model under MODEL_RULES and DATA_RULES against
    (A)'s one-device gradient (recomputed on rank 0 and checked against
    ``trained``'s digests). Returns rank 0's launches and the
    readings."""
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    both = spawn_ranks(hybrid_ranks, 2, hybrid["seq"], hybrid["ring"], {
        "loss": trained["c_loss"], "digests": trained["c_digests"]}, "cuda",
        device="cuda", timeout_s=900)
    spawn_s = time.perf_counter() - t_phase
    ranks, tr = [b for b, _ in both], [c for _, c in both]
    r0 = ranks[0]
    n_pos = hybrid["seq"].shape[1]
    nsb = 38 // 3
    want = {"flash_decode": n_pos * nsb, "flash_attention_causal": nsb}
    say(f"[hybrid_mesh] (B) recurrentgemma-9b, 38 layers, on make_host_mesh(1, "
        f"2) under MODEL_RULES, 2 ranks, backend {r0['backend']}; each rank "
        f"drew its blocks of init_lm(seed=0) in {r0['draw_s']:.2f}s and holds "
        f"{r0['held_gb']:.2f} GB (peak {r0['draw_peak_gb']:.2f} GB while "
        f"drawing); shapes {r0['shapes']}; cache {r0['cache']} (gloo ranks "
        f"on one card prove a path, never a speed; {card})")
    for i, r in enumerate(ranks):
        say(f"[hybrid_mesh] (B) rank {i}: {n_pos} decode steps in "
            f"{r['decode_s']:.3f}s = {1e3 * r['decode_s'] / n_pos:.1f} ms a "
            f"step, {LM_BATCH * n_pos / r['decode_s']:.2f} tok/s a rank; "
            f"prefill_fn over {LM_BATCH} x {LM_PROMPT} {r['prefill_s']:.3f}s; "
            f"gloo a decode step: {_gloo_txt(r['stats'], r['bytes'], n_pos)}; "
            f"peak memory {r['peak_gb']:.2f} GB; launches {r['launches']} "
            f"({card})")
        for k, n in want.items():
            if r["launches"].get(k, 0) != n:
                fail(f"4n (B) rank {i}: {k} launched "
                     f"{r['launches'].get(k, 0)} times, expected {n}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("4n (B): the two ranks' logits differ")
    ctl = hybrid["B_control"]
    for tag in ("all", "generated"):
        x = r0[tag]
        c = ctl if tag == "all" else ctl["generated"]
        say(f"[hybrid_mesh] (B) decode logits vs 4m (B)'s unsharded run on the "
            f"ring, {tag} positions: last corr {x['last_corr']:.6f}, min corr "
            f"{x['min_corr']:.6f}"
            + (f" (before the wrap {x['before_wrap']:.6f})"
               if x["before_wrap"] is not None else "")
            + f", argmax {100 * x['argmax_share']:.2f}%; limit "
            f"{HY_CORR_FACTOR} x 4m's control (last {c['last_corr']:.6f}, "
            f"min {c['min_corr']:.6f}) and > 0.99")
        if not within_control(x, c, LM_BATCH):
            fail(f"4n (B): the mesh's decode ({tag}) vs the unsharded one: {x}")
    say(f"[hybrid_mesh] (B) the split's arithmetic on one device "
        f"(tp_arithmetic): prefill bitwise {r0['twin_prefill']} (max diff "
        f"{r0['twin_maxdiff']:.3e}), first {HN_ARITH_STEPS} decode steps "
        f"bitwise {r0['twin_decode']}")
    for tag, x in r0["planted"].items():
        caught = not within_control(x, hybrid["A_control"], LM_BATCH)
        say(f"[hybrid_mesh] (B) planted fault, {tag} (gate biases N(0, 0.5)): "
            f"prefill vs the clean one last corr {x['last_corr']:.6f}, min "
            f"{x['min_corr']:.6f}, argmax {100 * x['argmax_share']:.2f}%: "
            f"caught {caught}")
        if not caught:
            fail(f"4n (B): the planted fault ({tag}) passes 4m (A)'s limits")
    if not (r0["twin_prefill"] and r0["twin_decode"]):
        fail("4n (B): the mesh's logits are not bitwise the split's "
             "arithmetic on one device")

    bound = HN_GRAD_FACTOR * trained["c_control"]
    one_is_a = tr[0].pop("one_is_A")
    say(f"[hybrid_mesh] (C) rank 0's one-device gradient on (C)'s batch is "
        f"(A)'s bit for bit (its loss and every leaf's digest): {one_is_a}")
    if not one_is_a:
        fail("4n (C): rank 0's one-device gradient is not (A)'s")
    for tag in tr[0]:
        x = tr[0][tag]
        say(f"[hybrid_mesh] (C) {tag}: {HN_LAYERS} layers, {HN_C_BATCH} x "
            f"{HN_C_SEQ}; rank 0 holds {x['held']}; one step's gradient in "
            f"{x['grad_s']:.3f}s (peak {x['grad_peak_gb']:.2f} GB a rank), "
            f"gloo a step: {_gloo_txt(x['grad_stats'], x['grad_bytes'], 1)}; "
            f"loss {x['loss']:.6f} (one device {trained['c_loss']:.6f}), equal "
            f"on both ranks {x['losses_agree']}; gradient relative L2 against "
            f"(A)'s one-device step {x['grad_rel']:.3e}, bound {bound:.3e} = "
            f"{HN_GRAD_FACTOR} x the order control; the {x['n_whole']} whole "
            f"leaves' gradients bitwise equal on both ranks "
            f"{x['whole_grads_agree']} ({card})")
        say(f"[hybrid_mesh] (C) {tag}, vocab {HN_C_VOCAB}: {HN_C_WARMUP} + "
            f"{HN_C_STEPS} steps through train_loop in {x['steps_s']:.2f}s "
            f"(peak {x['step_peak_gb']:.2f} GB a rank), losses "
            + " ".join(f"{v:.5f}" for v in x["losses"])
            + f", equal on both ranks {x['step_losses_agree']}; gloo a step: "
            f"{_gloo_txt(x['step_stats'], x['step_bytes'], HN_C_WARMUP + HN_C_STEPS)}; "
            f"whole leaves {x['whole_after_steps']} bitwise equal on both "
            f"ranks after them {x['whole_after_steps_agree']}")
        if not (x["losses_agree"] and x["step_losses_agree"]):
            fail(f"4n (C) {tag}: the ranks' losses differ")
        if not x["grad_rel"] <= bound:
            fail(f"4n (C) {tag}: gradient rel L2 {x['grad_rel']} above {bound}")
        if not (x["whole_grads_agree"] and x["whole_after_steps_agree"]):
            fail(f"4n (C) {tag}: a whole leaf differs across the ranks")
        for k in ("conv_w", "lambda", "b_a", "b_x", "ln1", "embed", "lm_head"):
            if k not in x["whole_after_steps"]:
                fail(f"4n (C) {tag}: {k} not among the whole leaves checked")
    say(f"[hybrid_mesh] (B) and (C) in one spawn of 2 ranks: {spawn_s:.1f}s "
        f"({card})")
    return {"launches": r0["launches"], "B": r0, "C": tr[0],
            "phase_s": time.perf_counter() - t_phase}


# path 4o: recurrentgemma-9b under the FSDP tables, 4 gloo ranks of the
# one card: 4n (A)'s model (the first HO_LAYERS layers, a super-block and
# the 2-layer tail, at full width and the full 256000 vocab) from
# init_lm(seed=0, place=True). (A) serving under DEFAULT_RULES on (data 2,
# model 2): a ring of HO_RING slots split along "kv_seq" (HO_RING / 2 a
# rank), a prompt of HO_PROMPT and HO_FORCED teacher-forced tokens: the
# decode writes model rank 0's slots, then rank 1's, and wraps into rank
# 0's. (B) training on HO_T_BATCH x HO_T_SEQ tokens (2 x 512 a rank): one
# step's gradient under DEFAULT_RULES against the one-device gradient
# (4n (C)'s class), HO_STEPS step through train_loop, and the gradient
# under MULTIPOD_RULES on (pod 2, data 1, model 2). (C) the planted
# faults. Every FSDP step gathers 3.09 GB a rank over gloo (the
# full-vocab embedding and head 2.1 GB of it): 4.0-5.0 s a decode step,
# 24-35 s a gradient (H100 80GB HBM3, 700 W; PERF.md §6), so the
# lengths are cut to fit the script's time (PERF.md §4): the ring, the
# prompt and the tokens; one microbatch a mesh step (HO_MICRO); one
# train_loop step; no card checkpoint (the logical checkpoint gathers
# the whole state, 19.3 GB at the full vocab, on every rank: more than
# the card holds for 4 ranks)
HO_LAYERS = 5
HO_BATCH = 4
HO_RING, HO_PROMPT, HO_FORCED = 8, 6, 3
HO_T_BATCH, HO_T_SEQ = 4, 512
HO_STEPS = 1
# the mesh steps' microbatches: the config's 2 would double every gather
# and reduce-scatter of a step (25.9 s a gradient at 2, PERF.md §6)
HO_MICRO = 1
HO_FAULTS = ("the FSDP backward without its reduce-scatter",
             "the ring written at rank 0's slot on every rank",
             "the merge without the last rank's partial")
# how long the ranks wait for the card after (A): the foreground phase
# beside them (4m) must have ended
HO_WAIT_S = 900


def _ring_at_rank0(transformer):
    """4o's planted fault: every rank writes a ring slot as rank 0 would
    (the owner's row offset taken as 0), so rank 0's block is written on
    every rank and the later blocks on none."""
    import dataclasses

    real = transformer.update_kv_cache

    def write(kc, vc, k, v, pos, seq=None):
        if seq is not None:
            seq = dataclasses.replace(seq, index=0)
        return real(kc, vc, k, v, pos, seq)
    return write


def hybrid_fsdp_rank(seq_cpu, go: str, device: str, smoke: bool = False
                     ) -> dict:
    """One of the 4 gloo ranks of path 4o (on the card; on the CPU at the
    smoke config with ``smoke``, a rehearsal). (A) under DEFAULT_RULES:
    each rank draws its blocks (``init_lm(place=True)``); counted, the
    decode step at every position of ``seq_cpu`` on the split ring and
    ``prefill_fn`` over its prompt; then the planted ring and merge faults'
    decode steps. Rank 0 also draws the whole params and runs on one device
    the split's arithmetic on its own rows (``fsdp_ring_arithmetic``: held
    bitwise), the unsharded decode loop and prefill on the whole batch, and
    4m (B)'s control (``prefill_fn`` under the ring's window on the plain
    attention). (B), once ``go`` exists (the foreground phase has freed
    the card): rank 0's one-device gradient (the config's 2 microbatches)
    and its order control (the batch at once), to the host; one mesh
    step's gradient under DEFAULT_RULES (its loss on every rank, its
    relative L2 against the one-device one, peak memory), the same with
    the FSDP backward's reduce-scatter planted away, HO_STEPS steps through
    ``train_loop``, and the gradient under MULTIPOD_RULES (its blocks'
    digests against DEFAULT_RULES'). Rank 0 returns the readings."""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import init_lm
    from repro_torch.configs.base import ShapeConfig, smoke_variant
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import serve, steps, train
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh
    from repro_torch.models import api as model_api
    from repro_torch.models import attention, transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves

    mesh = make_host_mesh(2, 2, device=device)
    pod_mesh = _build_mesh(1, 2, device, _AXES, n_pod=2)
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        full_precision_matmuls()
    cfg = get_config("recurrentgemma-9b")
    if smoke:
        cfg = smoke_variant(cfg)
    cfg = cfg.with_(n_layers=HO_LAYERS)
    r0 = dist.get_rank() == 0
    n_pos = seq_cpu.shape[1]
    half = HO_RING // 2
    out = {"rank": dist.get_rank(), "backend": mesh.backend,
           "device": str(dev), "vocab": cfg.vocab,
           "micro": cfg.microbatch_steps}
    t_rank = time.perf_counter()

    def progress(what):
        if r0:
            say(f"[hybrid_fsdp] rank 0: {what} at "
                f"{time.perf_counter() - t_rank:.1f}s")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def whole_of(t, ctx):
        """The whole (rows, vocab) of this rank's block, on every rank."""
        t = collectives.all_gather_cat(t.contiguous(),
                                       ctx.mesh.group("model"), -1)
        return collectives.all_gather_cat(t, ctx.mesh.group(
            ctx.rules["batch"]), 0)

    def decode(params, toks, lo, hi, cache):
        """decode_fn at positions [lo, hi) of ``toks`` on ``cache``: the
        logits (B, hi - lo, V)."""
        lgs = []
        for pos in range(lo, hi):
            lg, cache = model_api.decode_fn(params, cache,
                                            toks[:, pos:pos + 1], pos, cfg)
            lgs.append(lg)
        return torch.stack(lgs, 1)

    def agree(values) -> bool:
        mine = torch.tensor(values, dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        return all(torch.equal(e, mine) for e in every)

    def f32_bits(x: float) -> int:
        return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))

    seq = seq_cpu.to(dev)
    # -- (A) serving under DEFAULT_RULES
    with sharding.use_sharding(mesh, sharding.DEFAULT_RULES) as ctx, \
            torch.no_grad():
        # one rank draws at a time, its f32 draw of a whole leaf (4.2 GB
        # for the embedding) released before the next: 4 ranks drawing at
        # once beside 4m's model and the earlier paths' tensors overflowed
        # the card
        for r in range(dist.get_world_size()):
            if dist.get_rank() == r:
                reset_peak()
                t0 = time.perf_counter()
                local = init_lm(0, cfg, dev, place=True)
                sync()
                out.update(draw_s=time.perf_counter() - t0,
                           draw_peak_gb=peak_gb(),
                           held_gb=(torch.cuda.memory_allocated(dev) / 1e9
                                    if cuda else 0.0))
                if cuda:
                    torch.cuda.empty_cache()
            dist.barrier()
        rec = local["blocks"]["rec0"]["rec"]
        out["shapes"] = {k: tuple(v.shape) for k, v in (
            ("in_proj", rec["in_proj"]), ("out_proj", rec["out_proj"]),
            ("w_a", rec["w_a"]), ("wq", local["blocks"]["attn"]["attn"]["wq"]),
            ("embed", local["embed"]), ("lm_head", local["lm_head"]))}
        mine = sharding.named_sharding(seq.shape, ("batch", "seq"),
                                       ctx).block(seq)
        cache = serve.init_cache(cfg, HO_BATCH, HO_RING, dev)
        out["cache"] = {k: tuple(v.shape) for k, v in cache.items()}
        collectives.STATS.clear()
        collectives.BYTES.clear()
        _build.LAUNCHES.clear()
        reset_peak()
        t0 = time.perf_counter()
        dec = decode(local, mine, 0, half, cache)
        snap = {k: v.clone() for k, v in cache.items()}
        dec = torch.cat([dec, decode(local, mine, half, n_pos, cache)], 1)
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["stats"] = dict(collectives.STATS)
        out["bytes"] = dict(collectives.BYTES)
        t0 = time.perf_counter()
        pre = model_api.prefill_fn(local, {"tokens": mine[:, :HO_PROMPT]},
                                   cfg)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["launches"] = dict(_build.LAUNCHES)
        out["serve_peak_gb"] = peak_gb()
        # (C) the ring written at rank 0's slot on every rank: fresh ring,
        # up to the first position whose key lies in rank 1's slots; the
        # merge without the last rank's partial at that position, from the
        # counted run's ring before it
        saved = transformer.update_kv_cache
        transformer.update_kv_cache = _ring_at_rank0(transformer)
        try:
            bad_ring = decode(local, mine, 0, half + 1, serve.init_cache(
                cfg, HO_BATCH, HO_RING, dev))
        finally:
            transformer.update_kv_cache = saved
        merge = attention.merge_partials
        attention.merge_partials = lambda o, lse: merge(o[:-1], lse[:-1])
        try:
            bad_merge = decode(local, mine, half, half + 1, snap)
        finally:
            attention.merge_partials = merge
        progress("(A) the counted serve and the faults done")
        got = {k: whole_of(t, ctx) for k, t in (
            ("decode", dec), ("prefill", pre), ("ring", bad_ring),
            ("merge", bad_merge))}
        whole = None
        if r0:
            with sharding._installed(None):
                whole = init_lm(0, cfg, dev)
                if cuda:
                    torch.cuda.empty_cache()
                v0, v1 = 0, cfg.vocab // 2          # rank 0's vocab block
                with fsdp_ring_arithmetic(torch, whole, cfg):
                    twin_pre = model_api.prefill_fn(
                        whole, {"tokens": mine[:, :HO_PROMPT]}, cfg)
                    twin_dec = decode(whole, mine, 0, n_pos, serve.init_cache(
                        cfg, mine.shape[0], HO_RING, dev))
                out["twin_prefill"] = bool(torch.equal(twin_pre[..., v0:v1],
                                                       pre))
                out["twin_decode"] = bool(torch.equal(twin_dec[..., v0:v1],
                                                      dec))
                del twin_pre, twin_dec

                def runs():
                    return (model_api.prefill_fn(
                        whole, {"tokens": seq[:, :HO_PROMPT]}, cfg),
                        decode(whole, seq, 0, n_pos, serve.init_cache(
                            cfg, HO_BATCH, HO_RING, dev)))
                one_pre, one = runs()
                # the control: the model split's arithmetic alone (4j's and
                # 4k's), whose f32 partial sums are the whole of the mesh's
                # distance from the unsharded run (PERF.md §6, the hybrid
                # under the FSDP tables)
                with tp_arithmetic(torch, whole, cfg):
                    tp_pre, tp = runs()

            def reading(a, b):
                pc = position_corr(torch, a, b)
                return corr_reading(pc, a.argmax(-1) == b.argmax(-1))

            wrap, rows1 = slice(0, min(HO_RING, n_pos)), slice(0, half + 1)
            out["A"] = {
                "decode": reading(got["decode"], one),
                "control": reading(tp, one),
                "decode_before_wrap": reading(got["decode"][:, wrap],
                                              one[:, wrap]),
                "control_before_wrap": reading(tp[:, wrap], one[:, wrap]),
                "prefill": reading(got["prefill"], one_pre),
                "control_prefill": reading(tp_pre, one_pre),
                "ring": reading(got["ring"], one[:, rows1]),
                "control_ring": reading(tp[:, rows1], one[:, rows1]),
                "merge": reading(got["merge"], one[:, half:half + 1]),
                "control_merge": reading(tp[:, half:half + 1],
                                         one[:, half:half + 1])}
            out["finite"] = bool(torch.isfinite(got["decode"].float()).all()
                                 and torch.isfinite(got["prefill"].float())
                                 .all())
            out["shape"] = tuple(got["decode"].shape)
            del one, one_pre, tp, tp_pre
        del got, dec, pre, bad_ring, bad_merge, snap, cache
        if cuda:
            torch.cuda.empty_cache()
        progress("(A) done")

    # -- (B) training, once the foreground phase has ended (``go``): beside
    # 4m, rank 0's one-device gradient slowed 4m by a third (PERF.md §6)
    deadline = time.monotonic() + HO_WAIT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError(f"4o: no go after {HO_WAIT_S}s")
        time.sleep(0.2)
    dist.barrier()
    t_b = time.perf_counter()
    mcfg = cfg.with_(microbatch_steps=HO_MICRO)
    g_one = None
    if r0:
        with sharding._installed(None):
            batch = TokenStream(cfg.vocab, HO_T_SEQ, HO_T_BATCH, seed=0,
                                device=dev).batch_at(0)
            torch.use_deterministic_algorithms(True)
            try:
                reset_peak()
                loss1, g = steps.make_grad_fn(cfg)(whole, batch)
                out["one_peak_gb"] = peak_gb()
                g_one = [t.cpu() for t in tree_leaves(g)]
                del g
                _, g1 = steps.make_grad_fn(cfg.with_(microbatch_steps=1))(
                    whole, batch)
            finally:
                torch.use_deterministic_algorithms(False)
            num = den = 0.0
            for a, b in zip(tree_leaves(g1), g_one):
                n_, d_ = rel_l2_sums(torch, a, b)
                num, den = num + n_, den + d_
            out["control_B"] = (num / den) ** 0.5
            out["one_norm"] = den ** 0.5
            out["loss1"] = float(loss1)
            del g1, whole, batch
        if cuda:
            torch.cuda.empty_cache()
        out["one_s"] = time.perf_counter() - t_b
    dist.barrier()
    progress("(B) the one-device gradient done")

    def mesh_grad(params, ctx, tag):
        """One step's gradient on this rank's rows under ``ctx``: the
        loss (equal on every rank?), seconds, peak memory, gloo ops and
        the blocks' digests."""
        batch = TokenStream(cfg.vocab, HO_T_SEQ, HO_T_BATCH, seed=0, ctx=ctx,
                            device=dev, microbatches=HO_MICRO).batch_at(0)
        collectives.STATS.clear()
        collectives.BYTES.clear()
        reset_peak()
        torch.use_deterministic_algorithms(True)
        try:
            sync()
            t0 = time.perf_counter()
            loss, g = steps.make_grad_fn(mcfg)(params, batch)
            sync()
        finally:
            torch.use_deterministic_algorithms(False)
        out[tag] = {"s": time.perf_counter() - t0, "peak_gb": peak_gb(),
                    "loss": float(loss), "stats": dict(collectives.STATS),
                    "bytes": dict(collectives.BYTES),
                    "losses_agree": agree([f32_bits(float(loss))]),
                    "digests": [bits_digest(torch, t)
                                for t in tree_leaves(g)]}
        return g

    with sharding.use_sharding(mesh, sharding.DEFAULT_RULES) as ctx:
        axes = steps.placement_axes(cfg, model_api.model_logical_axes(cfg))
        g = mesh_grad(local, ctx, "default")
        # the logical gradient's relative L2 against the one-device one, on
        # rank 0: every rank gathers its blocks leaf by leaf
        num = 0.0
        for leaf, ax, one in zip(tree_leaves(g), tree_leaves(axes),
                                 g_one if r0 else [None] * len(
                                     tree_leaves(g))):
            w = steps.gather_tree({"t": leaf}, {"t": ax}, ctx)["t"]
            if r0:
                num += rel_l2_sums(torch, w, one)[0]
            del w
        del g_one
        if r0:
            out["default"]["rel"] = num ** 0.5 / out["one_norm"]
        progress("(B) DEFAULT_RULES' gradient done")
        n = transformer.fsdp_split(cfg).n

        def no_reduce(g, group, dim):
            step = g.shape[dim] // n
            part = g.narrow(dim, dist.get_rank(group) * step, step)
            return (part.float() / n).to(g.dtype)

        saved = collectives.reduce_scatter_mean
        collectives.reduce_scatter_mean = no_reduce
        try:
            bad = mesh_grad(local, ctx, "fault")
        finally:
            collectives.reduce_scatter_mean = saved
        # its logical distance from the sound mesh gradient, from each
        # rank's blocks (a leaf's sum over the ranks that hold it whole
        # divided by their count): by the triangle inequality its distance
        # from the one-device gradient is at least this less the sound
        # gradient's own
        split = steps._split_leaves(axes, ctx)
        sq = torch.zeros((), dtype=torch.float64)
        for a, b, sp in zip(tree_leaves(bad), tree_leaves(g),
                            tree_leaves(split)):
            held = 1
            for ax in sp:
                held *= mesh.shape[ax]
            sq += rel_l2_sums(torch, a, b)[0] * held / mesh.world
        dist.all_reduce(sq)
        if r0:
            out["fault"]["from_sound"] = float(sq) ** 0.5 / out["one_norm"]
        del g, bad
        progress("(B) the planted FSDP fault done")
        state = {"params": local, "opt": adamw_init(local, AdamWConfig(
            low_mem=not cfg.use_fp32_master)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
        reset_peak()
        sync()
        t0 = time.perf_counter()
        final, losses, _ = train.train_loop(
            mcfg, ShapeConfig("4o", HO_T_SEQ, HO_T_BATCH, "train"), HO_STEPS,
            device=dev, state=state, log_every=10 ** 9)
        sync()
        out["steps"] = {
            "s": time.perf_counter() - t0, "peak_gb": peak_gb(),
            "losses": losses,
            "losses_agree": agree([f32_bits(x) for x in losses]),
            "whole_agree": agree([bits_digest(torch, t) for t, sp in zip(
                tree_leaves(final["params"]), tree_leaves(split))
                if not any(sp)]),
            "moved": not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(final["params"]), tree_leaves(local)))}
        del state, final, local
        if cuda:
            torch.cuda.empty_cache()
        progress("(B) the train_loop steps done")
    with sharding.use_sharding(pod_mesh) as pctx:
        out["pod_rules"] = pctx.rules is sharding.MULTIPOD_RULES
        plocal = init_lm(0, cfg, dev, place=True)
        g = mesh_grad(plocal, pctx, "multipod")
        del g, plocal
        out["multipod"]["bitwise_default"] = (
            out["multipod"]["digests"] == out["default"]["digests"])
    out["B_s"] = time.perf_counter() - t_b
    progress("(B) done")
    return out


def start_hybrid_fsdp(go: str, smoke: bool = False) -> tuple:
    """Path 4o's 4 gloo ranks, started in the background (``in_background``:
    their (A) beside 4m; their (B) waits for ``go``); returns (start time,
    Future of the ranks' results)."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(404)
    vocab = 256 if smoke else 256000
    seq = torch.randint(0, vocab, (HO_BATCH, HO_PROMPT + HO_FORCED),
                        generator=gen)
    device = "cpu" if smoke else "cuda"
    return t_phase, in_background(
        lambda: spawn_ranks(hybrid_fsdp_rank, 4, seq, go, device, smoke,
                            device=device, timeout_s=1100))


def run_hybrid_fsdp(torch, card: str, started: tuple, fg_peak_gb: float
                    ) -> dict:
    """Path 4o, ``[hybrid_fsdp]``: the ranks' (A), (B) and (C) readings
    and checks (``hybrid_fsdp_rank``'s); ``fg_peak_gb`` the foreground
    phase's peak beside their (A). Returns rank 0's launches and
    readings."""
    t_phase, pending = started
    ranks = pending.result()
    r0 = ranks[0]
    n_pos = HO_PROMPT + HO_FORCED
    say(f"[hybrid_fsdp] path 4o: recurrentgemma-9b at full width, "
        f"{HO_LAYERS} layers, vocab {r0['vocab']}, 4 ranks on {r0['device']}, "
        f"backend {r0['backend']}; rank 0 holds {r0['shapes']} after drawing "
        f"its blocks in {r0['draw_s']:.2f}s ({r0['held_gb']:.2f} GB, peak "
        f"{r0['draw_peak_gb']:.2f} GB while drawing); cache {r0['cache']} "
        f"(gloo ranks on one card prove a path, never a speed; {card})")
    a_peaks = [r["serve_peak_gb"] for r in ranks]
    say(f"[hybrid_fsdp] (A) beside 4m: the ranks' serving peaks {a_peaks} GB "
        f"(drawing, one rank at a time: {[r['draw_peak_gb'] for r in ranks]} "
        f"GB) + 4m's {fg_peak_gb:.2f} GB = {sum(a_peaks) + fg_peak_gb:.2f} GB "
        f"of the card's 80")
    if not sum(a_peaks) + fg_peak_gb < 80:
        fail(f"4o (A) beside 4m: {sum(a_peaks) + fg_peak_gb} GB")
    want = {"flash_decode_partial": n_pos, "flash_attention_causal": 1}
    for i, r in enumerate(ranks):
        st, nb = r["stats"], r["bytes"]
        say(f"[hybrid_fsdp] (A) rank {i}: {n_pos} decode steps in "
            f"{r['decode_s']:.2f}s = {1e3 * r['decode_s'] / n_pos:.0f} ms a "
            f"step, {HO_BATCH // 2 * n_pos / r['decode_s']:.3f} tok/s a rank; "
            f"FSDP gathers {2 * nb.get('fsdp_gather', 0) / n_pos / 1e6:.1f} "
            f"MB a step ({nb.get('fsdp_gather', 0) / n_pos / 1e6:.1f} MB put "
            f"in); gloo a step: {_gloo_txt(st, nb, n_pos)}; prefill_fn over "
            f"{HO_BATCH // 2} x {HO_PROMPT} {r['prefill_s']:.2f}s; peak "
            f"{r['serve_peak_gb']:.2f} GB; launches {r['launches']} ({card})")
        for k, n in want.items():
            if r["device"].startswith("cuda") and r["launches"].get(k, 0) != n:
                fail(f"4o (A) rank {i}: {k} launched "
                     f"{r['launches'].get(k, 0)} times, expected {n}")
    a = r0["A"]
    if not (r0["finite"] and r0["shape"] == (HO_BATCH, n_pos, r0["vocab"])):
        fail(f"4o (A): logits {r0['shape']} not finite")
    say(f"[hybrid_fsdp] (A) the split's arithmetic on one device "
        f"(fsdp_ring_arithmetic, rank 0's rows and vocab block): prefill "
        f"bitwise {r0['twin_prefill']}, decode bitwise {r0['twin_decode']}")
    if not (r0["twin_prefill"] and r0["twin_decode"]):
        fail("4o (A): the mesh's logits are not bitwise the split's "
             "arithmetic on one device")
    for tag, ctl in (("decode", "control"),
                     ("decode_before_wrap", "control_before_wrap"),
                     ("prefill", "control_prefill")):
        x, c = a[tag], a[ctl]
        say(f"[hybrid_fsdp] (A) {tag} vs the unsharded run on the card: last "
            f"corr {x['last_corr']:.6f}, min {x['min_corr']:.6f}, argmax "
            f"{100 * x['argmax_share']:.2f}%; limit {HY_CORR_FACTOR} x the "
            f"control's distance (the model split's arithmetic on one device, "
            f"tp_arithmetic, vs the same run: last {c['last_corr']:.6f}, min "
            f"{c['min_corr']:.6f}) and > 0.99")
        if not within_control(x, c, HO_BATCH):
            fail(f"4o (A): the mesh's {tag} vs the unsharded run: {x}")
    for tag, ctl, name in (("ring", "control_ring", HO_FAULTS[1]),
                           ("merge", "control_merge", HO_FAULTS[2])):
        x = a[tag]
        caught = not within_control(x, a[ctl], HO_BATCH)
        say(f"[hybrid_fsdp] (C) planted fault, {name}: last corr "
            f"{x['last_corr']:.6f}, min {x['min_corr']:.6f}: caught {caught}")
        if not caught:
            fail(f"4o (C): the planted fault ({name}) passes (A)'s limits")
    bound = HN_GRAD_FACTOR * r0["control_B"]
    say(f"[hybrid_fsdp] (B) rank 0's one-device gradient (the config's "
        f"{r0['micro']} microbatches, vocab {r0['vocab']}): "
        f"{r0['one_s']:.1f}s with its order control, peak "
        f"{r0['one_peak_gb']:.2f} GB; loss {r0['loss1']:.6f}; the batch at "
        f"once against it {r0['control_B']:.3e} ({card})")
    for tag, table in (("default", "DEFAULT_RULES (2, 2)"),
                       ("multipod", "MULTIPOD_RULES (2, 1, 2)")):
        x = r0[tag]
        rel = x.get("rel")
        say(f"[hybrid_fsdp] (B) {table}: one step's gradient on "
            f"{HO_T_BATCH} x {HO_T_SEQ} tokens (2 x 512 a rank, "
            f"{HO_MICRO} microbatch) at vocab {r0['vocab']} in {x['s']:.2f}s, peak "
            f"{[r[tag]['peak_gb'] for r in ranks]} GB a rank; loss "
            f"{x['loss']:.6f} (one device {r0['loss1']:.6f}), equal on every "
            f"rank {x['losses_agree']}; gloo: {_gloo_txt(x['stats'], x['bytes'], 1)}"
            + (f"; relative L2 against the one-device gradient {rel:.3e}, "
               f"bound {bound:.3e} = {HN_GRAD_FACTOR} x the order control "
               f"{r0['control_B']:.3e}" if rel is not None else
               f"; its blocks bitwise DEFAULT_RULES' on every rank "
               f"{all(r['multipod']['bitwise_default'] for r in ranks)}")
            + f" ({card})")
        if not x["losses_agree"]:
            fail(f"4o (B) {table}: the ranks' losses differ")
        if rel is not None and not rel <= bound:
            fail(f"4o (B) {table}: gradient rel L2 {rel} above {bound}")
    if not all(r["multipod"]["bitwise_default"] for r in ranks):
        fail("4o (B): MULTIPOD_RULES' gradient blocks differ from "
             "DEFAULT_RULES' on the same ranks")
    if not r0["pod_rules"]:
        fail("4o (B): the pod mesh did not take MULTIPOD_RULES")
    x = r0["fault"]
    least = x["from_sound"] - r0["default"]["rel"]
    say(f"[hybrid_fsdp] (C) planted fault, {HO_FAULTS[0]}: relative L2 "
        f"{x['from_sound']:.3e} from the sound mesh gradient, so at least "
        f"{least:.3e} from the one-device one, against the bound {bound:.3e}")
    if not least > bound:
        fail(f"4o (C): the planted fault ({HO_FAULTS[0]}) is not shown to "
             f"miss (B)'s bound: {least}")
    x = r0["steps"]
    say(f"[hybrid_fsdp] (B) {HO_STEPS} steps through train_loop under "
        f"DEFAULT_RULES in {x['s']:.2f}s (peak "
        f"{[r['steps']['peak_gb'] for r in ranks]} GB a rank): losses "
        + " ".join(f"{v:.5f}" for v in x["losses"])
        + f", equal on every rank {x['losses_agree']}; the whole leaves "
        f"bitwise equal on every rank {x['whole_agree']}; params moved "
        f"{x['moved']} ({card})")
    if not (x["losses_agree"] and x["whole_agree"] and x["moved"]):
        fail(f"4o (B): the train_loop steps: {x}")
    say(f"[hybrid_fsdp] path 4o in {time.perf_counter() - t_phase:.1f}s from "
        f"its spawn, (B) {r0['B_s']:.1f}s ({card})")
    return {"launches": r0["launches"], "ranks": ranks}


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
    del server, run
    out["noisy"] = noisy_flushes(noisy_large_cfg(cfg), sc, params, device)
    return out


def noisy_large_cfg(cfg):
    """4c (B)'s config: ``cfg`` under 4e (B)'s noise point
    (photonic_pallas + xla + xla, the default NoiseSpec)."""
    from repro_torch.core.noise import NoiseSpec
    return cfg.with_(matmul_backend="photonic_pallas", attn_backend="xla",
                     ffn_backend="xla", noise=NoiseSpec())


def noisy_flushes(cfg, sc, params, device) -> dict:
    """4c (B): ``NOISY_FRAMES`` frames of one stream served eagerly under
    ``cfg`` (a noise point) and ``sc`` (``model_shards=2`` on the ranks,
    none in the parent): every flush's logits, the launches, the sharded
    encodes and the shape of the first layer's wq this rank holds."""
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.kernels import _build
    from repro_torch.models import sharded_encoder
    from repro_torch.serving.server import ServerConfig, StreamServer

    sc = ServerConfig.from_serving(sc, warm_start=False)
    server = StreamServer(cfg, sc, params=params, n_classes=10,
                          device=device)
    flushes = log_flushes(server)
    server.add_session(video_fleet(1, img_size=cfg.img_size,
                                   patch=cfg.patch, cut_every=32)[0],
                       n_frames=NOISY_FRAMES)
    _build.LAUNCHES.clear()
    calls = sharded_encoder.sharded_encode_calls()
    server.serve()
    return {"flushes": flushes, "launches": dict(_build.LAUNCHES),
            "sharded": sharded_encoder.sharded_encode_calls() - calls,
            "wq": tuple(server.params["blocks"]["attn"]["wq"].wq.shape),
            "mesh": (None if server.mesh is None
                     else tuple(server.mesh.shape.values()))}


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

    # (B) noisy flushes under model_shards=2 against one device's
    from repro_torch.serving.session import ServingConfig as _SC
    one = noisy_flushes(noisy_large_cfg(cfg), _SC(**{
        k: getattr(sc, k) for k in ("bucket_fractions", "microbatch",
                                    "chunk")}), params, dev)
    keys = list(one["flushes"])
    for i, r in enumerate(ranks):
        nb = r["noisy"]
        same = (list(nb["flushes"]) == keys and all(
            torch.equal(nb["flushes"][k], one["flushes"][k]) for k in keys))
        la = nb["launches"]
        say(f"[sharded] (B) rank {i}, mesh {nb['mesh']}, {cfg.name} under "
            f"4e (B)'s noise point (photonic_pallas + xla + xla): "
            f"{len(keys)} noisy flushes of {NOISY_FRAMES} frames bitwise "
            f"the one-device noisy serve: {same}; whole wq {nb['wq']}, "
            f"{nb['sharded']} sharded encodes; launches {la} ({card})")
        if not keys or not same:
            fail(f"[sharded] (B) rank {i}: the noisy model_shards serve is "
                 f"not bitwise the one-device serve")
        if (nb["sharded"] or la.get("noise_draw", 0) <= 0
                or la.get("dequant_epilogue", 0) or nb["wq"] != one["wq"]):
            fail(f"[sharded] (B) rank {i}: sharded {nb['sharded']}, wq "
                 f"{nb['wq']} vs {one['wq']}, launches {la}")
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
    # the shot entry at an offset (a rank's rows of a readout split along
    # its batch, 4h (E)): each half of a (788, 3072) readout drawn at its
    # offset bitwise its rows of the one-launch draw, and within 1e-6
    # relative of the plain version at that offset
    spec = noise.NoiseSpec(**NOISE_KW)
    call = noise_call(dev, spec)
    st = call.state_tensor(dev)
    y = torch.randn(788, 3072, generator=gen, device=dev)
    whole = noise_draw.readout_shot(y.clone(), call, spec.shot_sigma)
    for j in range(2):
        rows = slice(j * 394, (j + 1) * 394)
        off = j * 394 * 3072
        part = noise_draw.readout_shot(y[rows].clone(), call,
                                       spec.shot_sigma, off)
        plain = ref.readout_shot_ref(y[rows], st, call.salts, call.counter,
                                     spec.shot_sigma, off)
        e = float((part - plain).abs().max() / y[rows].abs().max())
        same = bool(torch.equal(part, whole[rows]))
        say(f"[check] noise_draw shot (394,3072) at offset {off}: bitwise "
            f"its rows of the one-launch draw {same}; {e:.3e} relative "
            f"from its plain version there")
        if not same or e > 1e-6:
            fail(f"noise_draw shot at offset {off}: rows bitwise {same}, "
                 f"{e:.3e} from the plain version")
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
    half = y[:394].clone()
    shot_off_ms, _ = device_ms(torch, lambda: noise_draw.readout_shot(
        half, call, spec.shot_sigma, 394 * 3072),
        ("noise_readout_shot_kernel",), counter="noise_draw.shot")
    say(f"[numbers] noise_draw shot readout (788,3072) in place: "
        f"{shot_ms:.4f} ms device; a rank's half (394,3072) at its offset "
        f"{shot_off_ms:.4f} ms device ({card})")
    head = by_shape["(3072,768)"]
    return {"name": "noise_draw", "route": "cuda",
            "source": SOURCES["noise_draw"],
            "replaces": REPLACES["noise_draw"], "launches": 0,
            "max_abs_err": 0.0, "tol": TOLERANCES["noise_draw"],
            "ms": head["ms"], "event_ms": head["event_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "randn_ms": head["randn_ms"], "ms_by_shape": by_shape,
            "shot_ms": shot_ms, "shot_offset_ms": shot_off_ms}


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


def split_arithmetic(torch, fn, device, n: int = 2):
    """``fn()`` (a serving forward of a whole flush) computed on one device
    as the n ranks of the 1-D ("data",) n mesh compute it: n threads, each
    one rank (its own thread-local sharding context over a ("data",) mesh
    whose groups are the threads, and whatever scope ``fn`` installs), so
    every launch holds that rank's rows, each absmax scope is MAX-reduced
    over the threads, each readout draws at that rank's offset and the
    logits are gathered in rank order, through host barriers instead of
    gloo. Returns rank 0's result. The control of 4h (E): where each
    kernel depends only on its own operands, the mesh's logits are bitwise
    these."""
    import threading

    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import DATA_RULES, use_sharding
    from repro_torch.launch.mesh import ServingMesh

    class Threads:
        def __init__(self):
            self.bar = threading.Barrier(n, timeout=300)
            self.slots = [None] * n
            self.local = threading.local()

        def exchange(self, t):
            self.slots[self.local.rank] = t
            self.bar.wait()
            parts = list(self.slots)
            self.bar.wait()
            return parts

    group = Threads()
    real_reduce, real_gather = (collectives.all_reduce,
                                collectives.all_gather_cat)

    def all_reduce(t, op, grp, name="all_reduce", direct=False):
        if grp is not group:
            return real_reduce(t, op, grp, name, direct)
        out = None
        for part in group.exchange(t.detach()):
            out = part.clone() if out is None else (
                torch.maximum(out, part) if op == dist.ReduceOp.MAX
                else out + part)
        return out

    def all_gather_cat(x, grp, dim, name="all_gather", direct=False):
        if grp is not group:
            return real_gather(x, grp, dim, name, direct)
        return torch.cat(group.exchange(x.detach().contiguous()), dim)

    out, errors = [None] * n, []

    def rank(j):
        group.local.rank = j
        mesh = ServingMesh(n, 1, j, 0, torch.device(device), "threads",
                           {("data",): group, ("data", "model"): group,
                            ("pod", "data", "model"): group},
                           axis_names=("data",))
        try:
            with use_sharding(mesh, DATA_RULES):
                out[j] = fn()
        except BaseException as e:          # re-raised below
            errors.append(e)
            group.bar.abort()
    collectives.all_reduce = all_reduce
    collectives.all_gather_cat = all_gather_cat
    try:
        threads = [threading.Thread(target=rank, args=(j,)) for j in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        collectives.all_reduce = real_reduce
        collectives.all_gather_cat = real_gather
    if errors:
        raise errors[0]
    return out[0]


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
    del server, run
    from repro_torch.core.noise import NoiseSpec
    out["E"] = {tag: data_mesh_policy(cfg.with_(
        **kw, noise=NoiseSpec(**NOISE_KW) if tag == "noisy" else None),
        sc, params, device) for tag, kw in MESH_POLICIES.items()}
    return out


def data_mesh_policy(cfg, sc, params, device: str) -> dict:
    """One rank of 4h (E): 4a's traffic for ``MESH_ROUNDS`` rounds on the
    data mesh under a policy off the fused point (``cfg``), every flush's
    tokens, DriftState and logits logged. Every rank re-encodes the newest
    flush on the mesh with each readout drawn at offset 0 (a planted
    fault) and holds each readout's shot multipliers of that flush (the
    calls recorded) bitwise against its rows of the one-launch draw. Rank
    0 then computes every flush on its own card twice: the mesh's
    arithmetic (``split_arithmetic``: the two row blocks apart, each
    launch under the whole flush's scales, each readout at the block's
    offset) and the unsplit encode. Returns the launches of the serve,
    the shot check, the flush logits (and, on rank 0, the controls)."""
    import torch
    from repro_torch.core import noise
    from repro_torch.data.pipeline import video_fleet
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build, noise_draw
    from repro_torch.models.vit import forward_vit_tokens
    from repro_torch.serving.server import StreamServer

    server = StreamServer(cfg, sc, params=params, n_classes=10,
                          device=device)
    mesh, dev = server.mesh, server.device
    if mesh.axis_names != ("data",) or server.graphs:
        raise RuntimeError(f"mesh {mesh.axis_names}, graphs "
                           f"{sorted(server.graphs)}")
    logged, finish = {}, server._finish

    def finish_and_log(fb, by_sid):
        finish(fb, by_sid)
        logged[tuple(fb.frame_idx)] = (fb.tokens.clone(), server.last_drift,
                                       server.last_logits.float().cpu())
    server._finish = finish_and_log
    for i, st in enumerate(video_fleet(2, img_size=cfg.img_size,
                                       patch=cfg.patch, cut_every=32)):
        server.add_session(st, n_frames=32, start=16 * i)
    _build.LAUNCHES.clear()
    server.serve(max_rounds=MESH_ROUNDS)
    launches = dict(_build.LAUNCHES)

    def encode(tokens, state):
        scope = (noise.noise_scope(state) if state is not None
                 else contextlib.nullcontext())
        with scope, torch.no_grad():
            return forward_vit_tokens(server.params, tokens, cfg,
                                      server.policy, device=dev)[0]

    newest = list(logged)[-1]
    tokens, state, _ = logged[newest]
    calls, real_shot = [], noise_draw.readout_shot

    def shot(y, call, sigma, offset=0):
        calls.append((call, tuple(y.shape), sigma, offset))
        return real_shot(y, call, sigma, offset)
    with sharding.use_sharding(mesh), \
            _patched(sharding, "draw_offset", lambda numel: 0), \
            _patched(noise_draw, "readout_shot", shot):
        planted = encode(tokens, state).float().cpu()
    shots = []
    for call, shape, sigma, _ in calls[:SHOT_CHECKS]:
        mine = real_shot(torch.ones(shape, device=dev), call, sigma,
                         mesh.d * math.prod(shape))
        whole = real_shot(torch.ones((mesh.data * shape[0],) + shape[1:],
                                     device=dev), call, sigma)
        rows = slice(mesh.d * shape[0], (mesh.d + 1) * shape[0])
        shots.append(bool(torch.equal(mine, whole[rows])))
    out = {"launches": launches, "n_flush": len(logged), "shots": shots,
           "logits": {k: v[2] for k, v in logged.items()},
           "planted": planted, "newest": newest,
           "recalibrations": server.recalibrations,
           "drift": None if server.drift is None else server.drift.words()}
    if mesh.d == 0:
        ctl, plain = {}, {}
        for k, (t, st, _) in logged.items():
            ctl[k] = split_arithmetic(torch, lambda: encode(t, st), dev,
                                      mesh.data).float().cpu()
            with sharding._installed(None):
                plain[k] = encode(t, st).float().cpu()
        out.update(control=ctl, unsplit=plain)
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
    out["policies"] = report_data_mesh_policies(torch, ranks, card)
    return out


def report_data_mesh_policies(torch, ranks: list, card: str) -> dict:
    """4h (E)'s checks: every flush of each policy off the fused point on
    both ranks bitwise the mesh's arithmetic on one device (rank 0's
    ``split_arithmetic``); against the unsplit one-device encode within
    twice that control's distance (1 - corr); under noise the planted
    offset-0 readouts break the bitwise check, each rank's shot
    multipliers are bitwise its rows of the one-launch draw, the ranks
    end at one DriftState after the same recalibrations, and B2 and
    noise_draw launched on both ranks; composed, B1 and no B3."""
    readings = {}
    for tag in MESH_POLICIES:
        e0, e1 = (r["E"][tag] for r in ranks)
        keys = list(e0["control"])
        if not keys or list(e1["logits"]) != keys:
            fail(f"[fleet] (E) {tag}: flushes {len(keys)} / "
                 f"{len(e1['logits'])}")
        same = [torch.equal(e0["logits"][k], e0["control"][k])
                and torch.equal(e1["logits"][k], e0["logits"][k])
                for k in keys]
        c_mesh = min(corr(torch, e0["logits"][k], e0["unsplit"][k])
                     for k in keys)
        c_ctl = min(corr(torch, e0["control"][k], e0["unsplit"][k])
                    for k in keys)
        n_unsplit = sum(torch.equal(e0["logits"][k], e0["unsplit"][k])
                        for k in keys)
        say(f"[fleet] (E) {tag} on the data mesh (2 ranks, {len(keys)} "
            f"flushes in {MESH_ROUNDS} rounds of 4a's traffic): "
            f"{same.count(True)} of {len(keys)} flushes bitwise the mesh's "
            f"arithmetic on one device on both ranks; against the unsplit "
            f"one-device encode min corr {c_mesh:.9f} (control "
            f"{c_ctl:.9f}, limit 1 - 2 x its distance; {n_unsplit} flushes "
            f"bitwise it); launches rank 0 {e0['launches']}, rank 1 "
            f"{e1['launches']} ({card})")
        if not all(same):
            fail(f"[fleet] (E) {tag}: {same.count(False)} flushes differ "
                 f"from the mesh's arithmetic on one device")
        if 1.0 - c_mesh > 2.0 * (1.0 - c_ctl):
            fail(f"[fleet] (E) {tag}: corr {c_mesh} against the unsplit "
                 f"encode beyond twice the control's distance ({c_ctl})")
        for i, e in enumerate((e0, e1)):
            la = e["launches"]
            if tag == "noisy":
                bad = (la.get("noise_draw", 0) <= 0
                       or la.get("flash_attention_masked", 0) <= 0
                       or la.get("photonic_matmul", 0)
                       or la.get("fused_ffn", 0))
            else:
                bad = (la.get("photonic_matmul", 0) <= 0
                       or la.get("fused_ffn", 0)
                       or la.get("flash_attention_masked", 0))
            if bad:
                fail(f"[fleet] (E) {tag} rank {i} launches {la}")
        if tag == "noisy":
            want = e0["control"][e0["newest"]]
            gap = float((e0["planted"] - want).abs().max())
            shots = e0["shots"] + e1["shots"]
            say(f"[fleet] (E) noisy: {sum(shots)} of {len(shots)} recorded "
                f"readouts' shot multipliers bitwise the ranks' rows of "
                f"the one-launch draw; planted offset-0 readouts: newest "
                f"flush max |diff| {gap:.3e} from the control; "
                f"{e0['recalibrations']} recalibrations on each rank "
                f"({card})")
            if torch.equal(e0["planted"], want):
                fail("[fleet] (E) the planted offset-0 readouts pass the "
                     "bitwise check, which therefore cannot catch them")
            if not shots or not all(shots):
                fail(f"[fleet] (E) shot multipliers {shots}")
            if (e0["recalibrations"] != e1["recalibrations"]
                    or e0["recalibrations"] < 1
                    or (e0["drift"] != e1["drift"]).any()):
                fail(f"[fleet] (E) the ranks' drift states diverge: "
                     f"{e0['recalibrations']} / {e1['recalibrations']} "
                     f"recalibrations")
        readings[tag] = {"flushes": len(keys), "corr": c_mesh,
                         "control_corr": c_ctl, "bitwise_unsplit": n_unsplit}
    return readings


# path 4c (B): frames of one stream served noisy under model_shards=2
NOISY_FRAMES = 8

# path 4h (E): the policies off the fused point on the data mesh, 4a's
# traffic for a few rounds each: 4e (A)'s noise point (photonic_sim +
# flash + xla under NOISE_KW: drift, wander, a recalibration bound) and
# 4d (a)'s clean composed point (photonic_pallas + xla + xla); the shot
# readouts of the newest flush held against the one-launch draw
MESH_POLICIES = {
    "noisy": dict(matmul_backend="photonic_sim", attn_backend="flash",
                  ffn_backend="xla"),
    "composed": dict(matmul_backend="photonic_pallas", attn_backend="xla",
                     ffn_backend="xla")}
MESH_ROUNDS = 2
SHOT_CHECKS = 8

# path 4i: ViT training on opto-vit-base-224 + MGNet at the config's keep
# ratio (0.33) on qat + xla + xla, training=True, batch 32 of
# ImageStream(224, 32, n_classes=8, patch=16); a 10-step warmup so the
# short run trains (the config's default is 100 of 10,000)
TRAIN_BATCH = 32
TRAIN_STEPS = 30          # the QAT phase's straight run
TRAIN_RESUME_AT = 10      # the checkpoint the resumed runs start from
TRAIN_FAULT_AT = 13       # the injected fault (after the step-10 save)
TRAIN_LONG = 100          # the straight run continued, for (D)'s weights
MGNET_STEPS = 40
MGNET_LR = 3e-3           # AdamW on MGNet's leaves alone, constant rate
# the card's gradients against the CPU's at equal inputs and state: the
# quantized gate's top-k routing, the fake quant's rounding and the STE
# (0.5 on a clip bound, 1 an ulp inside) are discontinuous, so rounding
# differences move whole leaves (a routing flip moved the loss by 2e-2
# and the gradients by 5.9e-2 in relative L2; the CPU against itself with
# its images one ulp up, printed beside it, reads the same class). The
# bounds catch gross faults: the planted inference fake quant reads ~1.
GRAD_REL_L2 = 0.25
GRAD_LEAF_CORR = 0.95
GRAD_LOSS_REL = 1e-2
# the tight check beside it, at smoke size (opto-vit-tiny cut to 2 layers,
# batch 8 of 32x32 images) with MGNet's pruning off: where no fake-quant
# code flips, card and CPU differ by their GEMMs' summation order only
# (7.7e-7 measured, the CPU against itself with its matmuls summed in
# another order 7.2e-7: scripts/qat_grad_gap.py). With pruning on, an
# ulp-level input at a rounding boundary flips a code (one quant step) and
# the flip cascades: 2.364e-3 on the card and in the CPU's own reordered
# control alike
GRAD_REL_L2_TIGHT = 1e-5
GRAD_LOSS_REL_TIGHT = 1e-6
TRAINED_SERVE_CORR = 0.99  # tests/test_vit_qat.py::test_execution_modes_agree


def train_cfg():
    from repro_torch.configs.opto_vit import get_config
    return get_config("base", 224, mgnet=True).with_(lr_warmup=10,
                                                     lr_total=1000)


def grad_distance(torch, ga: dict, gb: dict) -> tuple:
    """(global relative L2 of ga against gb, min corr over the leaves gb
    moves, the leaf of that min, leaves compared)."""
    from repro_torch.optim.adamw import tree_leaves
    num = den = 0.0
    worst, worst_name, n = 1.0, "", 0
    names = _leaf_names(gb)
    for name, a, b in zip(names, tree_leaves(ga), tree_leaves(gb)):
        a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
        if float(b.norm()) > 0 and b.numel() > 1:
            c = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
            n += 1
            if not c >= worst:
                worst, worst_name = c, name
    return (num / den) ** 0.5, worst, worst_name, n


def _leaf_names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}" if prefix
                                     else k)]
    return [prefix]


def train_mgnet(torch, dev, cfg, params: dict, stream, card: str) -> dict:
    """4i (A): MGNet alone, by BCE against the box-derived patch labels,
    under the training policy; mIoU on a held-out batch before and after."""
    from repro_torch.core.mgnet import bce_loss, mask_iou, mgnet_scores
    from repro_torch.models.layers import ExecPolicy
    from repro_torch.models.vit import mgnet_config
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves, tree_map,
                                         tree_unflatten)
    mcfg = mgnet_config(cfg)
    pol = ExecPolicy.from_cfg(cfg, training=True).gate_policy()
    held = stream.batch_at(9999)

    def miou(p):
        with torch.no_grad():
            s = mgnet_scores(p, held["images"], mcfg, pol)
        return float(mask_iou((torch.sigmoid(s) > mcfg.t_reg).float(),
                              held["patch_mask"]))

    ocfg = AdamWConfig(lr=MGNET_LR, low_mem=False)
    p = params
    opt = adamw_init(p, ocfg)
    m0 = miou(p)
    losses = []
    t0 = time.perf_counter()
    for i in range(MGNET_STEPS):
        b = stream.batch_at(i)
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = bce_loss(mgnet_scores(live, b["images"], mcfg, pol),
                        b["patch_mask"])
        g = torch.autograd.grad(loss, tree_leaves(live))
        p, opt = adamw_update(tree_unflatten(p, list(g)), opt, p, ocfg)
        losses.append(float(loss.detach()))
    wall = time.perf_counter() - t0
    m1 = miou(p)
    say(f"[train] (A) MGNet (embed {mcfg.embed}, {mcfg.heads} heads, "
        f"{mcfg.n_patches} patches) by BCE, {MGNET_STEPS} AdamW steps at lr "
        f"{MGNET_LR} on batches of {stream.global_batch}: BCE "
        f"{losses[0]:.4f} -> {sum(losses[-5:]) / 5:.4f} (last 5); mask mIoU "
        f"{m0:.4f} untrained -> {m1:.4f} trained; {wall:.2f}s ({card})")
    if not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
        fail(f"4i (A): BCE did not fall ({losses[:5]} -> {losses[-5:]})")
    if not m1 > max(m0 + 0.15, 0.4):
        fail(f"4i (A): mIoU {m0:.4f} -> {m1:.4f}, not above "
             f"max(m0 + 0.15, 0.4)")
    return {"params": p, "miou": (m0, m1), "bce": (losses[0], losses[-1])}


def tight_grad_check(torch, dev, cpu) -> None:
    """4i (C)'s tight check: one QAT step's loss and gradients at smoke size
    with MGNet's pruning off (and, as a reading, on), card against CPU."""
    from repro_torch.bridge import to_device
    from repro_torch.configs.base import smoke_variant
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import init_state

    base = smoke_variant(get_config("opto-vit-tiny")).with_(
        n_layers=2, lr_warmup=4, lr_total=200)
    b = {k: v for k, v in ImageStream(32, 8, n_classes=8, patch=8, seed=0,
                                      device=cpu).batch_at(0).items()
         if k in ("images", "labels")}
    read = {}
    for tag, cfg in (("pruning off", base),
                     ("pruning on", base.with_(
                         mgnet=True, mgnet_keep_ratio=0.5, mgnet_embed=32,
                         mgnet_heads=2))):
        p = init_state(cfg, 0, cpu)["params"]
        grads_of = make_grad_fn(cfg)
        lh, gh = grads_of(p, b)
        lc, gc = grads_of(to_device(p, dev), {k: v.to(dev)
                                              for k, v in b.items()})
        rel, worst, _, _ = grad_distance(torch, gc, gh)
        dl = abs(float(lc) - float(lh)) / abs(float(lh))
        read[tag] = (rel, dl)
        say(f"[train] (C) smoke size, {tag}: card vs CPU gradient relative "
            f"L2 {rel:.3e}, min leaf corr {worst:.7f}, loss relative diff "
            f"{dl:.2e}")
    rel, dl = read["pruning off"]
    if not (rel < GRAD_REL_L2_TIGHT and dl <= GRAD_LOSS_REL_TIGHT):
        fail(f"4i (C): the tight check (pruning off) reads relative L2 "
             f"{rel}, loss {dl}: limits {GRAD_REL_L2_TIGHT}, "
             f"{GRAD_LOSS_REL_TIGHT}")


def run_train(torch, dev, card: str, cfg=None, batch: int = TRAIN_BATCH,
              cpu=None) -> dict:
    """Path 4i: train, resume, hold the gradients against the CPU, then
    serve the trained weights on the fused point (B1-B3)."""
    import shutil
    import tempfile

    from repro_torch.bridge import to_device
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import quant
    from repro_torch.core.backend import prepare_params
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_grad_fn, make_train_fn
    from repro_torch.launch.train import init_state, make_stream, train_loop
    from repro_torch.models.layers import ExecPolicy
    from repro_torch.models.vit import forward_vit
    from repro_torch.optim.adamw import tree_map

    cfg = cfg or train_cfg()
    cpu = cpu or torch.device("cpu")
    shape = ShapeConfig("4i", 0, batch, "train")
    stream = ImageStream(cfg.img_size, batch, n_classes=8, patch=cfg.patch,
                         seed=0, device=dev)
    say(f"[train] path 4i: {cfg.name} {cfg.img_size}x{cfg.img_size} + MGNet "
        f"keep {cfg.mgnet_keep_ratio} on qat + xla + xla, training=True, "
        f"batch {batch}, warmup {cfg.lr_warmup} of {cfg.lr_total}, "
        f"remat {cfg.remat}, bf16 moments {not cfg.use_fp32_master}")
    t_phase = time.perf_counter()
    state0 = init_state(cfg, 0, dev)
    mg = train_mgnet(torch, dev, cfg, state0["params"]["mgnet"], stream,
                     card)
    state0["params"]["mgnet"] = mg["params"]
    clone = lambda st: tree_map(torch.clone, st)  # noqa: E731

    # (B) the QAT phase: straight, resumed from a checkpoint, after a fault,
    # all under deterministic algorithms
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        final, losses, flags = train_loop(cfg, shape, TRAIN_STEPS,
                                          device=dev, state=clone(state0),
                                          log_every=TRAIN_STEPS)
        straight_s = time.perf_counter() - t0
        say(f"[train] (B) {TRAIN_STEPS} QAT steps through train_loop / "
            f"make_train_fn in {straight_s:.2f}s (host synthesis included); "
            f"losses " + " ".join(f"{x:.4f}" for x in losses)
            + f"; straggler flags {len(flags)} ({card})")
        if not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
            fail(f"4i (B): the loss did not fall ({losses[:5]} -> "
                 f"{losses[-5:]})")
        resumed = {}
        for tag, fault in (("checkpoint", None), ("fault", TRAIN_FAULT_AT)):
            root = f"{tmp}/{tag}"
            mgr = CheckpointManager(root, every=TRAIN_RESUME_AT)
            if fault is None:
                _, first, _ = train_loop(cfg, shape, TRAIN_RESUME_AT,
                                         device=dev, state=clone(state0),
                                         ckpt=mgr, log_every=TRAIN_STEPS)
            else:
                try:
                    train_loop(cfg, shape, TRAIN_STEPS, device=dev,
                               state=clone(state0), ckpt=mgr,
                               inject_fault_at=fault, log_every=TRAIN_STEPS)
                    fail("4i (B): the injected fault did not raise")
                except RuntimeError as e:
                    say(f"[train] (B) fault at step {fault}: {e}")
                mgr.wait()
            t0 = time.perf_counter()
            st, rest, _ = train_loop(cfg, shape, TRAIN_STEPS, device=dev,
                                     state=clone(state0),
                                     ckpt=CheckpointManager(root, every=10**9),
                                     log_every=TRAIN_STEPS)
            same_loss = rest == losses[TRAIN_RESUME_AT:]
            same_state = all(
                torch.equal(a, b) for a, b in zip(_leaves(st), _leaves(final)))
            resumed[tag] = same_loss and same_state
            say(f"[train] (B) resumed after the {tag} from step "
                f"{TRAIN_STEPS - len(rest)}: {len(rest)} steps in "
                f"{time.perf_counter() - t0:.2f}s, losses bitwise the "
                f"straight run's: {same_loss}, final state bitwise: "
                f"{same_state}")
            if not resumed[tag]:
                fail(f"4i (B): the run resumed after the {tag} is not "
                     f"bitwise the straight run")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)

    # (B') the straight run continued to TRAIN_LONG steps: 30 steps reach
    # the 8-way prior, not the task; (D) serves these weights
    step_fn = make_train_fn(cfg)
    batch_at = make_stream(cfg, shape, 0, dev)
    trained, long_losses = final, []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS, TRAIN_LONG):
        trained, m = step_fn(trained, batch_at(step))
        long_losses.append(float(m["loss"]))
    say(f"[train] (B') continued to step {TRAIN_LONG} in "
        f"{time.perf_counter() - t0:.2f}s: mean loss of the last 10 steps "
        f"{sum(long_losses[-10:]) / len(long_losses[-10:]):.4f} ({card})")

    # (C) one step's gradients on the card against the CPU
    b0 = {k: v for k, v in stream.batch_at(0).items()
          if k in ("images", "labels")}
    grads_of = make_grad_fn(cfg)
    lc, gc = grads_of(state0["params"], b0)
    p_cpu = to_device(state0["params"], cpu)
    b_cpu = {k: v.to(cpu) for k, v in b0.items()}
    t0 = time.perf_counter()
    lh, gh = grads_of(p_cpu, b_cpu)
    cpu_s = time.perf_counter() - t0
    b_ulp = dict(b_cpu, images=torch.nextafter(
        b_cpu["images"], torch.tensor(float("inf"))))
    lu, gu = grads_of(p_cpu, b_ulp)
    rel_u, worst_u, _, _ = grad_distance(torch, gu, gh)
    loss_u = abs(float(lu) - float(lh))
    rel, worst, worst_name, n = grad_distance(torch, gc, gh)
    dloss = abs(float(lc) - float(lh))

    def agrees(r, c, dl):
        return (r < GRAD_REL_L2 and c > GRAD_LEAF_CORR
                and dl <= GRAD_LOSS_REL * abs(float(lh)))

    say(f"[train] (C) one step's gradients, card against CPU ({n} leaves; "
        f"a CPU step {cpu_s:.1f}s): global relative L2 {rel:.3e}, min leaf "
        f"corr {worst:.6f} ({worst_name}), loss {float(lc):.6f} vs "
        f"{float(lh):.6f} (diff {dloss:.3e}); the CPU against itself with "
        f"its images one ulp up: relative L2 {rel_u:.3e}, min corr "
        f"{worst_u:.6f}, loss diff {loss_u:.3e}; held to relative L2 < "
        f"{GRAD_REL_L2}, corr > {GRAD_LEAF_CORR}, loss within "
        f"{GRAD_LOSS_REL} relative")
    if not agrees(rel, worst, dloss):
        fail(f"4i (C): card vs CPU gradients rel L2 {rel}, corr {worst}, "
             f"loss diff {dloss}")
    # the planted fault: the inference fake quant in the qat entry
    ste = quant.fake_quant_ste
    quant.fake_quant_ste = quant.fake_quant
    try:
        _, gf = grads_of(state0["params"], b0)
    finally:
        quant.fake_quant_ste = ste
    rel_f, worst_f, _, _ = grad_distance(torch, gf, gh)
    qw = [t for name, t in zip(_leaf_names(gf), _leaves(gf))
          if t.ndim >= 2 and t.numel() >= 128 and "mgnet" not in name
          and name.split("/")[-1] in ("w", "wq", "wk", "wv", "wo", "w1",
                                      "w2", "head")]
    zero = min(float((t == 0).float().mean()) for t in qw)
    caught = not agrees(rel_f, worst_f, 0.0)
    say(f"[train] (C) planted fault (inference fake_quant in the qat entry): "
        f"relative L2 {rel_f:.3e}, min leaf corr {worst_f:.4f}; every one of "
        f"{len(qw)} quantized weight leaves at least {100 * zero:.3f}% zero "
        f"gradients; caught: {caught}")
    if not caught:
        fail("4i (C): the planted zero-gradient fault passed the check")
    del gc, gh, gu, gf, p_cpu
    tight_grad_check(torch, dev, cpu)

    # readings: ms a step (CUDA events), host synthesis, peak memory, and a
    # profiled step
    st = clone(final)
    host = ImageStream(cfg.img_size, batch, n_classes=8, patch=cfg.patch,
                       seed=0)
    t0 = time.perf_counter()
    for i in range(5):
        host.batch_at(100 + i)
    synth_ms = (time.perf_counter() - t0) * 1e3 / 5
    reading = {"synth_ms": synth_ms}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated() / 2 ** 30
        holder = [st]

        def one():
            holder[0], _ = step_fn(holder[0], b0)
        ms = cuda_ms(one, iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        reading.update(ms=ms, peak_gib=peak, step_gib=peak - live)
        say(f"[train] a QAT step (batch {batch}, device batch, CUDA events): "
            f"{ms:.3f} ms = {batch / ms * 1e3:.1f} images/s; the host's "
            f"ImageStream synthesis {synth_ms:.3f} ms a batch; peak memory "
            f"allocated {peak:.2f} GiB, {live:.2f} GiB of it live before "
            f"the steps (the train state, earlier paths' caches), so "
            f"{peak - live:.2f} GiB the steps' own ({card})")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        tot = sum(e.self_device_time_total for e in events) / 1e3
        gemm = sum(e.self_device_time_total for e in events
                   if any(s in e.key.lower() for s in
                          ("gemm", "sgemm", "cutlass", "xmma", "sm90_",
                           "ampere_", "cublas"))) / 1e3
        say(f"[train] a profiled step: device busy {tot:.3f} ms, GEMMs "
            f"{gemm:.3f} ms ({100 * gemm / max(tot, 1e-9):.1f}%), the rest "
            f"(fake-quant elementwise and reduce, attention, norms, AdamW) "
            f"{tot - gemm:.3f} ms; {sum(e.count for e in events)} kernel "
            f"launches of {len(events)} kinds ({card})")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            say(f"[train] {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")
        reading.update(step_device_ms=tot, gemm_ms=gemm)
    del st, step_fn

    # (D) the trained weights served on the fused point (B1-B3)
    fused_cfg = cfg.with_(matmul_backend="photonic_pallas",
                          attn_backend="flash", ffn_backend="fused")
    trained = trained["params"]
    held = stream.batch_at(20000)
    with torch.no_grad():
        qat_logits, _ = forward_vit(trained, held["images"], cfg,
                                    ExecPolicy.from_cfg(cfg, training=False),
                                    device=dev)
        cache = prepare_params(trained, bits=cfg.quant_bits)
        _build.LAUNCHES.clear()
        fused_logits, kept = forward_vit(
            cache, held["images"], fused_cfg,
            ExecPolicy.from_cfg(fused_cfg, training=False), device=dev)
        launches = dict(_build.LAUNCHES)
    a = fused_logits.double().cpu().flatten()
    b = qat_logits.double().cpu().flatten()
    c = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top1 = float((fused_logits.argmax(-1) == qat_logits.argmax(-1))
                 .float().mean())
    labels = held["labels"].long()
    acc_f = float((fused_logits.argmax(-1) == labels).float().mean())
    acc_q = float((qat_logits.argmax(-1) == labels).float().mean())
    say(f"[train] (D) the trained weights served on the fused point "
        f"(photonic_pallas + flash + fused, {kept} patches kept) against the "
        f"QAT forward (training=False) on a held-out batch of {batch}, "
        f"after {TRAIN_LONG} steps: "
        f"logits corr {c:.6f}, top-1 agreement {top1:.4f}; accuracy on the "
        f"synthetic labels: fused {acc_f:.4f}, QAT {acc_q:.4f} (chance "
        f"0.125); launches {launches} ({card})")
    if not c > TRAINED_SERVE_CORR:
        fail(f"4i (D): fused serve vs QAT forward corr {c}")
    if dev.type == "cuda":
        for name_ in VIT_KERNELS:
            if launches.get(name_, 0) <= 0:
                fail(f"4i (D): kernel {name_} was never launched")
    say(f"[train] path 4i in {time.perf_counter() - t_phase:.2f}s ({card})")
    return {"launches": launches, "losses": losses, "miou": mg["miou"],
            "grad_rel": rel, "grad_corr": worst, "fault_rel": rel_f,
            "serve_corr": c, "top1": top1, "acc": (acc_f, acc_q),
            "resumed": resumed, **reading}


# path 4j: qwen2-1.5b on the ("data", "model") mesh, 2 gloo ranks sharing
# the one card. (A) / (B) serve at full depth with 4b's traffic; (C) / (D)
# train at the reference CLI's batch 8 x seq 128 on the first
# LMJ_TRAIN_LAYERS layers (a 28-layer train state's checkpoint is 9.3 GB,
# written and read three times a run; 8 layers until 4m's recurrentgemma-9b
# took the script's time past ~1,050 of its 1,200 s: PERF.md §4 lists the
# cut and what it saved), warmup cut to 10 as 4i cuts it
LMJ_TRAIN_LAYERS = 4
LMJ_TRAIN_BATCH, LMJ_TRAIN_SEQ = 8, 128
LMJ_TRAIN_STEPS, LMJ_RESUME_AT, LMJ_WARMUP = 20, 10, 10
# (A)'s logits checks. The control is the mesh's arithmetic on one device
# (``tp_arithmetic``). Tight: the mesh's prefill and teacher-forced decode
# logits are bitwise it. Against the unsharded path: within twice the
# control's distance of 1 at every position (min corr over the prefill
# and the decode), the gross planted faults below that. On the H100 the
# control reads 0.999019 / 0.998992 against the unsharded path (random
# bf16 weights tie the logits, so one summation-order change moves them
# ~1e-3 of corr) and the mesh is bitwise it; the subtle planted fault
# reads 0.998182, inside the corr limit, and is caught only by the
# bitwise check (PERF.md, PR 26)
LMJ_CORR_FACTOR = 2
# (C) / (D)'s gradient bound: this many times the control (the unsharded
# step against the same step on two half-batches averaged in f32: the
# bf16 class of the gradient). The tensor-parallel step rounds its f32
# sums once where the unsharded backward adds bf16 terms: it reads 3.3x
# the control at smoke size on the CPU (tests/test_torch_lm_mesh.py's
# classes) and 2.3x at 8 layers on the H100 (3.33e-2 against 1.42e-2).
# The planted backward fault must read 10x the bound (0.949 there)
LMJ_GRAD_FACTOR = 4
LMJ_LOSS_REL = 1e-3
# (A)'s planted faults: wo's partial products left unreduced, and each
# rank's query heads paired with the other rank's KV head, must fall
# below the corr limit; the subtle one, layer 0's wo partial products
# rounded to bf16 before the f32 sum, must break the bitwise check
LMJ_FAULTS = ("wo's reduce skipped", "heads paired with the wrong KV head")
LMJ_SUBTLE = "layer 0's wo partials rounded to bf16 before the sum"


@contextlib.contextmanager
def tp_arithmetic(torch, params: dict, cfg, n: int = 2, vocab: bool = False):
    """The unsharded LM forward computing on one device what each rank of a
    (1, n) mesh computes: the column-parallel wq / bq / w_gate / w_up (and
    the hybrid's in_proj / gate_proj) in their n column blocks (contiguous
    copies, as ``place_lm_params`` holds them), the attention one call a
    rank's heads (``attention.kv_runs``), the row-parallel wo / w_down
    (and out_proj) contracted in their n row blocks, each block's product
    in f32, summed in f32 in rank order and rounded once (``layers.
    row_parallel_linear``), and the hybrid's gate GEMMs over each rank's
    u block and w_a / w_x rows, summed the same way before the biases.
    With ``vocab`` the untied head too, in its n vocab (column) blocks.
    Where each GEMM and kernel depends only on its own operands, the
    mesh's logits are bitwise these. The control of 4j (A): its distance
    from the unsharded path sets the limit, and the mesh is held to it
    bitwise; 4n (B)'s bitwise twin."""
    from repro_torch.distributed.sharding import Split
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import transformer

    def key(w):
        return w.data_ptr(), tuple(w.shape)

    blocks = params["blocks"]
    if cfg.family == "hybrid":
        nsb, rem = transformer.hybrid_counts(cfg)
        stacks = [(blocks[k], nsb) for k in ("rec0", "rec1", "attn")]
        if rem:
            stacks.append((params["tail_blocks"], rem))
    else:
        stacks = [(blocks, cfg.n_layers)]
    cols, rows = {}, set()
    for sub, count in stacks:
        split = [("ffn", ("w_gate", "w_up"), ("w_down",))]
        split.append(("rec", ("in_proj", "gate_proj"), ("out_proj",))
                     if "rec" in sub else ("attn", ("wq",), ("wo",)))
        for part, col_names, row_names in split:
            for i in range(count):
                for name in col_names:
                    w = sub[part][name][i]
                    s = w.shape[-1] // n
                    cols[key(w)] = [w[:, j * s:(j + 1) * s].contiguous()
                                    for j in range(n)]
                rows.update(key(sub[part][name][i]) for name in row_names)
    if vocab:
        w = params["lm_head"]
        s = w.shape[-1] // n
        cols[key(w)] = [w[:, j * s:(j + 1) * s].contiguous()
                        for j in range(n)]
    real = (transformer.linear, ffn_mod.linear, rglru_mod.linear,
            transformer._attend, transformer._decode,
            rglru_mod._gate_preacts)

    def linear(x, w, b=None, policy=None):
        if key(w) in cols:
            s = w.shape[-1] // n
            return torch.cat([real[0](x, wj, None if b is None else
                                      b[j * s:(j + 1) * s], policy)
                              for j, wj in enumerate(cols[key(w)])], -1)
        if key(w) in rows:
            k = w.shape[0] // n
            y = None
            for j in range(n):
                p = torch.matmul(x[..., j * k:(j + 1) * k].float(),
                                 w[j * k:(j + 1) * k].float())
                y = p if y is None else y + p
            return y.to(x.dtype)
        return real[0](x, w, b, policy)

    def gate_preacts(p, uf, split):
        k = uf.shape[-1] // n
        outs = []
        for w, bias in ((p["w_a"], p["b_a"]), (p["w_x"], p["b_x"])):
            y = None
            for j in range(n):
                part = (uf[..., j * k:(j + 1) * k].contiguous()
                        @ w[j * k:(j + 1) * k].float())
                y = part if y is None else y + part
            outs.append(y + bias)
        return tuple(outs)

    def per_rank(fn):
        def heads(q, *rest, **kw):
            h = q.shape[2] // n
            return torch.cat([fn(q[:, :, j * h:(j + 1) * h].contiguous(),
                                 *rest[:-1], Split(n, j, None), **kw)
                              for j in range(n)], 2)
        return heads

    transformer.linear = ffn_mod.linear = rglru_mod.linear = linear
    transformer._attend = per_rank(real[3])
    transformer._decode = per_rank(real[4])
    rglru_mod._gate_preacts = gate_preacts
    try:
        yield
    finally:
        (transformer.linear, ffn_mod.linear, rglru_mod.linear,
         transformer._attend, transformer._decode,
         rglru_mod._gate_preacts) = real


@contextlib.contextmanager
def fsdp_ring_arithmetic(torch, params: dict, cfg, n: int = 2):
    """What a rank of the hybrid under DEFAULT_RULES / MULTIPOD_RULES with
    n ranks on "model" computes, on one device from the whole params and
    the rank's rows: ``tp_arithmetic`` with the head's vocab blocks (the
    FSDP gathers and the vocab-split lookup move bits only), and each
    ring read as n blocks of its slots, B6's partial entry over each block
    at the ring's length min(pos + 1, W), merged in rank order
    (``attention.merge_partials``). 4o (A)'s bitwise twin."""
    from repro_torch.kernels.flash_decode import flash_decode_partial
    from repro_torch.models import attention, transformer

    with tp_arithmetic(torch, params, cfg, n, vocab=True):
        heads = transformer._decode

        def decode(q, k, v, length, cfg_, split, attend=None):
            if attend is not transformer._ring:
                return heads(q, k, v, length, cfg_, split, attend=attend)
            rows, valid = k.shape[1] // n, min(length + 1, k.shape[1])
            parts = [flash_decode_partial(
                q, k[:, r * rows:(r + 1) * rows].contiguous(),
                v[:, r * rows:(r + 1) * rows].contiguous(), r * rows, valid)
                for r in range(n)]
            return attention.merge_partials(
                torch.stack([o for o, _ in parts]),
                torch.stack([lse for _, lse in parts])).to(q.dtype)

        transformer._decode = decode
        try:
            yield
        finally:
            transformer._decode = heads


def _tree_rel_l2(torch, ga: dict, gb: dict) -> float:
    """Relative L2 of tree ga against gb, in f64 on the device."""
    from repro_torch.optim.adamw import tree_leaves
    num = den = 0.0
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        a, b = a.double(), b.double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


def lm_mesh_rank(cpu_params: dict, cfg, prompt_cpu, tmp: str, device: str,
                 gen: int = LM_GEN, cache_len: int = LM_CACHE,
                 train_size: tuple = (LMJ_TRAIN_LAYERS, LMJ_TRAIN_BATCH,
                                      LMJ_TRAIN_SEQ, LMJ_TRAIN_STEPS,
                                      LMJ_RESUME_AT)) -> dict:
    """One rank of path 4j (2 ranks on the one card; the sizes are 4b's
    and the constants', smaller in a CPU rehearsal). Rank 0 holds the
    unsharded references (the whole params on its device, no context) and
    returns every reading; both ranks return their launch counts, tokens
    and collective times."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.backend import prepare_params
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import serve, steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api as model_api
    from repro_torch.models import attention, transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map

    mesh = make_host_mesh(1, 2, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        full_precision_matmuls()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_layers, t_batch, t_seq, t_steps, t_resume = train_size
    b, plen = prompt_cpu.shape
    r0 = dist.get_rank() == 0
    whole = tree_map(lambda t: t.to(dev), cpu_params)
    prompt = prompt_cpu.to(dev)
    out = {"rank": dist.get_rank(), "backend": mesh.backend,
           "mesh": (mesh.data, mesh.model), "device": str(dev)}

    def no_ctx():
        return sharding._installed(None)

    # (A) serve: generate (B6) and prefill_fn (B5), the counted main path
    with sharding.use_sharding(mesh):
        local = transformer.place_lm_params(whole, cfg)
        serve.generate(local, serve.init_cache(cfg, b, 8, dev),
                       prompt[:, :4], 2, cfg)
        model_api.prefill_fn(local, {"tokens": prompt[:, :16]}, cfg)
        sync()
        steps_in = []
        real_decode = model_api.decode_fn

        def recording(params, cache, tokens, pos, cfg_, policy=None):
            lg, cache = real_decode(params, cache, tokens, pos, cfg_, policy)
            steps_in.append((tokens, lg))
            return lg, cache

        cache = serve.init_cache(cfg, b, cache_len, dev)
        collectives.STATS.clear()
        _build.LAUNCHES.clear()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model_api.decode_fn = recording
        t0 = time.perf_counter()
        try:
            toks, tps = serve.generate(local, cache, prompt, gen, cfg)
        finally:
            model_api.decode_fn = real_decode
        sync()
        out["serve_s"] = time.perf_counter() - t0
        out["stats"] = dict(collectives.STATS)
        full = model_api.prefill_fn(local, {"tokens": prompt}, cfg)
        sync()
        out["launches"] = dict(_build.LAUNCHES)
        out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else 0.0)
        out["tps"] = tps
        out["toks"] = toks.cpu()
        both = collectives.all_gather_cat(toks, mesh.group("model"), 0)
        out["tokens_agree"] = all(torch.equal(t, toks)
                                  for t in both.split(toks.shape[0]))
        if r0:
            def teacher_forced():
                """The unsharded decode step on the same 160 inputs."""
                pcache = serve.init_cache(cfg, b, cache_len, dev)
                lgs = []
                for pos, (tok, _) in enumerate(steps_in):
                    lg, pcache = model_api.decode_fn(whole, pcache, tok, pos,
                                                     cfg)
                    lgs.append(lg)
                return torch.stack(lgs, 1)

            def gap(x, y):
                return {"min_corr": float(position_corr(torch, x, y).min()),
                        "max_abs": float((x.float() - y.float()).abs()
                                         .max()),
                        "bitwise": bool(torch.equal(x, y))}

            with no_ctx():
                plain = model_api.prefill_fn(whole, {"tokens": prompt}, cfg)
                plg = teacher_forced()
                with tp_arithmetic(torch, whole, cfg):
                    ctl = model_api.prefill_fn(whole, {"tokens": prompt},
                                               cfg)
                    clg = teacher_forced()
            tp_steps = torch.stack([lg for _, lg in steps_in], 1)
            out["prefill_corr"] = position_corr(torch, full, plain).cpu()
            out["prefill_argmax"] = float((full.argmax(-1) ==
                                           plain.argmax(-1)).float().mean())
            out["decode_corr"] = position_corr(torch, tp_steps, plg).cpu()
            out["decode_argmax"] = float((tp_steps.argmax(-1) ==
                                          plg.argmax(-1)).float().mean())
            out["logits_control"] = {"prefill": gap(ctl, plain),
                              "decode": gap(clg, plg)}
            out["control_corr"] = min(v["min_corr"] for v in
                                      out["logits_control"].values())
            out["vs_control"] = {"prefill": gap(full, ctl),
                                 "decode": gap(tp_steps, clg)}
            del plg, clg, tp_steps
        del steps_in, cache
        # the planted faults, on both ranks (their collectives pair up)
        saved = (transformer.row_parallel_linear, attention.kv_runs)
        calls = [0]

        def unreduced(x, w, policy, group):
            return torch.matmul(x.float(), w.float()).to(x.dtype)

        def wrong_kv(h, hkv, split):
            return [(q0, q1, (a + 1) % hkv, (a + 1) % hkv + b - a)
                    for q0, q1, a, b in saved[1](h, hkv, split)]

        def bf16_partials(x, w, policy, group):
            calls[0] += 1
            if calls[0] > 1:
                return saved[0](x, w, policy, group)
            partial = torch.matmul(x.float(), w.float()).to(x.dtype)
            return collectives.reduce_from_model(partial.float(), group,
                                                 x.dtype)

        out["planted"] = {}
        for tag in LMJ_FAULTS + (LMJ_SUBTLE,):
            if tag == LMJ_SUBTLE:
                transformer.row_parallel_linear = bf16_partials
            elif tag.startswith("wo"):
                transformer.row_parallel_linear = unreduced
            else:
                attention.kv_runs = wrong_kv
            try:
                lg = model_api.prefill_fn(local, {"tokens": prompt}, cfg)
            finally:
                transformer.row_parallel_linear, attention.kv_runs = saved
            if r0:
                out["planted"][tag] = float(position_corr(torch, lg,
                                                          plain).min())
                if tag == LMJ_SUBTLE:
                    out["subtle_vs_control"] = gap(lg, ctl)
        del full, lg
        if r0:
            del plain, ctl

        # (B) int8: the same prefill under photonic_pallas
        cfg8 = cfg.with_(matmul_backend="photonic_pallas")
        cache8 = prepare_params(whole, bits=8)
        local8 = transformer.place_lm_params(cache8, cfg8)
        model_api.prefill_fn(local8, {"tokens": prompt[:, :16]}, cfg8)
        sync()
        _build.LAUNCHES.clear()
        tp8 = model_api.prefill_fn(local8, {"tokens": prompt}, cfg8)
        sync()
        out["launches8"] = dict(_build.LAUNCHES)
        if r0:
            with no_ctx():
                one8 = model_api.prefill_fn(cache8, {"tokens": prompt}, cfg8)
            out["int8_bitwise"] = bool(torch.equal(tp8, one8))
            out["int8_maxdiff"] = float((tp8.float() - one8.float()).abs()
                                        .max())
            del one8
        del cache8, local8, tp8, local

    # (C) train on the first n_layers layers; (D) data-parallel
    cfg_t = cfg.with_(n_layers=n_layers, lr_warmup=LMJ_WARMUP)
    tparams = dict(whole, blocks=tree_map(
        lambda t: t[:n_layers].clone(), whole["blocks"]))
    del whole
    torch.cuda.empty_cache()
    shape = ShapeConfig("4j", t_seq, t_batch, "train")
    batch = TokenStream(cfg.vocab, t_seq, t_batch, seed=0,
                        device=dev).batch_at(0)
    clone = lambda st: tree_map(torch.clone, st)  # noqa: E731
    with sharding.use_sharding(mesh) as ctx:
        p0 = transformer.place_lm_params(tparams, cfg_t)
        state0 = {"params": p0, "opt": adamw_init(
            p0, AdamWConfig(low_mem=not cfg_t.use_fp32_master)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
        axes = steps.placement_axes(cfg_t, model_api.model_logical_axes(
            cfg_t))
        loss_tp, g_tp = steps.make_grad_fn(cfg_t)(p0, batch)
        g_tp = steps.gather_tree(g_tp, axes, ctx)
        saved = collectives.copy_to_model
        collectives.copy_to_model = lambda x, group: x
        try:
            _, g_bad = steps.make_grad_fn(cfg_t)(p0, batch)
        finally:
            collectives.copy_to_model = saved
        g_bad = steps.gather_tree(g_bad, axes, ctx)
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            final, losses, _ = train.train_loop(
                cfg_t, shape, t_steps, device=dev,
                state=clone(state0), log_every=t_steps)
            sync()
            out["train_s"] = time.perf_counter() - t0
            root = f"{tmp}/ckpt"
            train.train_loop(cfg_t, shape, t_resume, device=dev,
                             state=clone(state0),
                             ckpt=CheckpointManager(root,
                                                    every=t_resume),
                             log_every=t_steps)
            t0 = time.perf_counter()
            st, rest, _ = train.train_loop(
                cfg_t, shape, t_steps, device=dev,
                state=clone(state0),
                ckpt=CheckpointManager(root, every=10 ** 9),
                log_every=t_steps)
            out["resume_s"] = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        out["losses"] = losses
        out["resumed_bitwise"] = rest == losses[t_resume:] and all(
            torch.equal(a, b) for a, b in zip(_leaves(st), _leaves(final)))
        st_axes = steps.placement_axes(cfg_t, steps.state_logical_axes(cfg_t))
        logical = steps.gather_tree(st, st_axes, ctx)
        if r0:
            back, step = restore(f"{root}/step_{t_steps}", logical)
            out["restored_step"] = step
            out["restored_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(_leaves(back),
                                                  _leaves(logical)))
            del back
        del logical, st, final, state0, p0

    mesh21 = make_host_mesh(2, 1, device=device)
    with sharding.use_sharding(mesh21) as ctx21:
        p21 = transformer.place_lm_params(tparams, cfg_t)
        b21 = TokenStream(cfg.vocab, t_seq, t_batch, seed=0,
                          ctx=ctx21, device=dev).batch_at(0)
        loss_dp, g_dp = steps.make_grad_fn(cfg_t)(p21, b21)
    if r0:
        with no_ctx():
            grads_of = steps.make_grad_fn(cfg_t)
            loss1, g1 = grads_of(tparams, batch)
            half = t_batch // 2
            la, ga = grads_of(tparams, {k: v[:half] for k, v in
                                        batch.items()})
            lb, gb = grads_of(tparams, {k: v[half:] for k, v in
                                        batch.items()})
            g_ctl = tree_map(lambda a, b: ((a.float() + b.float()) / 2)
                             .to(a.dtype), ga, gb)
        out.update(
            loss_tp=float(loss_tp), loss_dp=float(loss_dp),
            loss1=float(loss1), loss_ctl=float((la + lb) / 2),
            control=_tree_rel_l2(torch, g_ctl, g1),
            tp_rel=_tree_rel_l2(torch, g_tp, g1),
            planted_rel=_tree_rel_l2(torch, g_bad, g1),
            dp_rel=_tree_rel_l2(torch, g_dp, g1),
            dp_vs_control=_tree_rel_l2(torch, g_dp, g_ctl))
    return out


def start_lm_mesh(lm: dict) -> tuple:
    """Path 4j's 2 gloo ranks, started in the background
    (``in_background``: they run beside 4k's and under 4p); returns (start
    time, Future of the ranks' results) for ``run_lm_mesh``."""
    import shutil
    import tempfile

    from repro_torch.bridge import to_device
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    params = to_device(lm["params"], "cpu")
    for t in _leaves(params):
        t.share_memory_()
    prompt = lm["prompt"].cpu()

    def spawn():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
        try:
            return spawn_ranks(lm_mesh_rank, 2, params, lm["cfg"], prompt,
                               tmp, "cuda", device="cuda", timeout_s=900)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return t_phase, in_background(spawn)


def run_lm_mesh(torch, dev, card: str, lm: dict, started: tuple) -> dict:
    """Path 4j: 4b's qwen2-1.5b weights and prompt on the (1, 2) and
    (2, 1) meshes, 2 gloo ranks on the one card (``start_lm_mesh``'s),
    against the unsharded runs on the card."""
    cfg = lm["cfg"]
    t_phase, pending = started
    ranks = pending.result()
    r0 = ranks[0]
    say(f"[lm_mesh] path 4j: {cfg.name} on make_host_mesh(1, 2), 2 ranks, "
        f"backend {r0['backend']}, both on {r0['device']} ({card})")
    # (A)
    want = {"flash_decode": (LM_PROMPT + LM_GEN) * cfg.n_layers,
            "flash_attention_causal": cfg.n_layers}
    for i, r in enumerate(ranks):
        st = r["stats"]
        gloo_ms = 1e3 * sum(v for k, v in st.items() if k.endswith("_s")) \
            / (LM_PROMPT + LM_GEN)
        say(f"[lm_mesh] (A) rank {i}: generate {LM_BATCH} x ({LM_PROMPT} + "
            f"{LM_GEN}) in {r['serve_s']:.3f}s, decode loop {r['tps']:.2f} "
            f"tok/s (4b unsharded: {lm['tps']:.2f}); collectives "
            f"{gloo_ms:.3f} ms a decode step ({ {k: v for k, v in st.items() if not k.endswith('_s')} }); "
            f"peak memory {r['peak_gb']:.3f} GB; launches {r['launches']} "
            f"({card})")
        for k, n in want.items():
            if r["launches"].get(k, 0) != n:
                fail(f"4j (A) rank {i}: {k} launched "
                     f"{r['launches'].get(k, 0)} times, expected {n}")
        if not r["tokens_agree"]:
            fail(f"4j (A): rank {i}'s tokens differ from its model group's")
    if not torch.equal(ranks[0]["toks"], ranks[1]["toks"]):
        fail("4j (A): the two ranks generated different tokens")
    same_as_4b = float((ranks[0]["toks"] == lm["toks"].cpu()).float().mean())
    pc, dc = r0["prefill_corr"], r0["decode_corr"]
    limit = 1 - LMJ_CORR_FACTOR * (1 - r0["control_corr"])

    def shown(h):
        return (f"min corr {h['min_corr']:.6f}, max abs diff "
                f"{h['max_abs']:.4g}, bitwise {h['bitwise']}")

    say(f"[lm_mesh] (A) prefill logits vs the unsharded card prefill: min "
        f"corr over {pc.numel()} positions {float(pc.min()):.6f}, argmax "
        f"agrees {100 * r0['prefill_argmax']:.2f}%; teacher-forced decode vs "
        f"the unsharded decode step on the same {dc.numel()} inputs: min corr "
        f"{float(dc.min()):.6f}, argmax agrees "
        f"{100 * r0['decode_argmax']:.2f}%; greedy tokens equal on both "
        f"ranks, {100 * same_as_4b:.2f}% equal to 4b's unsharded ones "
        f"({card})")
    say(f"[lm_mesh] (A) control, the mesh's arithmetic on one device "
        f"(tp_arithmetic: column blocks, heads a rank's run, wo / w_down in "
        f"two f32 row blocks) vs the unsharded path: prefill "
        f"{shown(r0['logits_control']['prefill'])}; decode "
        f"{shown(r0['logits_control']['decode'])}; so the limit is corr > "
        f"{limit:.6f} everywhere. The mesh vs that control: prefill "
        f"{shown(r0['vs_control']['prefill'])}; decode "
        f"{shown(r0['vs_control']['decode'])}")
    if not (float(pc.min()) > limit and float(dc.min()) > limit):
        fail(f"4j (A): prefill min corr {float(pc.min())}, decode min corr "
             f"{float(dc.min())}")
    for tag, c in r0["planted"].items():
        say(f"[lm_mesh] (A) planted fault, {tag}: prefill min corr {c:.6f} "
            f"vs the unsharded prefill"
            + (f"; vs the control {shown(r0['subtle_vs_control'])}"
               if tag == LMJ_SUBTLE else ""))
        if tag in LMJ_FAULTS and c > limit:
            fail(f"4j (A): the planted fault ({tag}) passes the "
                 f"{limit} limit")
    # (B)
    say(f"[lm_mesh] (B) int8 prefill (photonic_pallas) on the mesh bitwise "
        f"the unsharded int8 prefill: {r0['int8_bitwise']} (max diff "
        f"{r0['int8_maxdiff']:.3e}); launches a rank: "
        + "; ".join(f"rank {i} {r['launches8']}" for i, r in enumerate(ranks)))
    if not r0["int8_bitwise"]:
        fail("4j (B): the int8 tensor-parallel prefill is not bitwise")
    for i, r in enumerate(ranks):
        if r["launches8"].get("photonic_matmul", 0) <= 0:
            fail(f"4j (B) rank {i}: photonic_matmul never launched")
    # (C)
    losses = r0["losses"]
    bound = LMJ_GRAD_FACTOR * r0["control"]
    say(f"[lm_mesh] (C) train, {LMJ_TRAIN_LAYERS} of {cfg.n_layers} layers, "
        f"batch {LMJ_TRAIN_BATCH} x {LMJ_TRAIN_SEQ}, warmup {LMJ_WARMUP}: "
        f"{LMJ_TRAIN_STEPS} steps through train_loop on (1, 2) in "
        f"{r0['train_s']:.2f}s ({1e3 * r0['train_s'] / LMJ_TRAIN_STEPS:.1f} "
        f"ms a step); losses " + " ".join(f"{x:.4f}" for x in losses)
        + f" ({card})")
    if not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
        fail(f"4j (C): the loss did not fall ({losses})")
    say(f"[lm_mesh] (C) one step against the unsharded step on the card: "
        f"loss {r0['loss_tp']:.6f} vs {r0['loss1']:.6f}; gradient relative "
        f"L2 {r0['tp_rel']:.3e} against a bound of {bound:.3e} = "
        f"{LMJ_GRAD_FACTOR} x the control {r0['control']:.3e} (the step on "
        f"two half-batches averaged in f32); planted fault (copy to model "
        f"with no backward all-reduce) {r0['planted_rel']:.3e}")
    if abs(r0["loss_tp"] - r0["loss1"]) > LMJ_LOSS_REL * abs(r0["loss1"]):
        fail(f"4j (C): loss {r0['loss_tp']} vs {r0['loss1']}")
    if not r0["tp_rel"] <= bound:
        fail(f"4j (C): gradient rel L2 {r0['tp_rel']} above {bound}")
    if not r0["planted_rel"] >= 10 * bound:
        fail(f"4j (C): the planted backward fault reads "
             f"{r0['planted_rel']}, not 10x the bound {bound}")
    say(f"[lm_mesh] (C) resumed from the step-{LMJ_RESUME_AT} checkpoint "
        f"in {r0['resume_s']:.2f}s: losses and state bitwise the straight "
        f"run's: {r0['resumed_bitwise']}; the (1, 2) checkpoint at step "
        f"{r0['restored_step']} restored on one device bitwise the gathered "
        f"state: {r0['restored_bitwise']}")
    if not (r0["resumed_bitwise"] and r0["restored_bitwise"]):
        fail("4j (C): a resume or a one-device restore is not bitwise")
    # (D)
    say(f"[lm_mesh] (D) a (2, 1) step against the unsharded step on the "
        f"whole batch: loss {r0['loss_dp']:.6f} vs {r0['loss1']:.6f}, "
        f"gradient relative L2 {r0['dp_rel']:.3e} (bound {bound:.3e}); "
        f"against the two-half-batch control {r0['dp_vs_control']:.3e}")
    if abs(r0["loss_dp"] - r0["loss1"]) > LMJ_LOSS_REL * abs(r0["loss1"]):
        fail(f"4j (D): loss {r0['loss_dp']} vs {r0['loss1']}")
    if not r0["dp_rel"] <= bound:
        fail(f"4j (D): gradient rel L2 {r0['dp_rel']} above {bound}")
    # (A)'s tight check, after every reading is printed: the mesh's prefill
    # and teacher-forced decode logits bitwise its arithmetic on one device,
    # which the subtle planted fault must break
    if not all(v["bitwise"] for v in r0["vs_control"].values()):
        fail(f"4j (A): the mesh's logits are not bitwise its arithmetic on "
             f"one device: {r0['vs_control']}")
    if r0["subtle_vs_control"]["bitwise"]:
        fail(f"4j (A): the planted fault ({LMJ_SUBTLE}) is bitwise the "
             f"control")
    say(f"[lm_mesh] path 4j in {time.perf_counter() - t_phase:.2f}s from its "
        f"spawn, beside 4k's ranks and 4p ({card})")
    return {"ranks": ranks, "launches": r0["launches"],
            "launches8": r0["launches8"],
            "peak_gb": [r["peak_gb"] for r in ranks]}


# path 4k: qwen2-1.5b at full width, cut to LMK_LAYERS layers, under
# DEFAULT_RULES on make_host_mesh(2, 2) and under MULTIPOD_RULES on a (pod
# 2, data 1, model 2) mesh, 4 gloo ranks sharing the one card: the params
# FSDP-split over the batch axes and gathered a layer at a time, the vocab
# and the decode cache's sequence over "model". The cut: every decode step
# gathers every layer's weights (46.8 MB a layer a rank) through gloo on
# the host; at 8 layers a decode step took 0.9 s, a train step 7.2 s and
# 4k 487 s on an H100 (PERF.md, the 4k findings), so 4k at 8 would take
# the whole run to ~85% of its limit; at 4 layers 4k took 309 s of a
# 1,148 s run once 4m's recurrentgemma-9b joined it, so it runs 2 layers
# (PERF.md §4 lists the cut and what it saved; at 1 layer its (C) loss
# on fresh batches no longer fell). (A) 4b's batch 4, prompt 128
# and 32 greedy tokens against
# a cache of LMK_CACHE rows, 128 a rank: the prompt fills model rank 0's
# rows and every generated token lands on rank 1 (its first decode step
# has exactly one valid row there). (C) 4j's batch, LMK_TRAIN_STEPS steps
# (3.7 s each) after a warmup of LMK_WARMUP, so most steps run at the
# peak rate and the loss check has power, with the resume from
# LMK_RESUME_AT. (D) the pod mesh: the prefill,
# LMK_MP_GEN greedy tokens after the prompt's first LMK_MP_PROMPT (a cache
# of LMK_MP_CACHE, half a rank) and LMK_MP_STEPS train steps
LMK_LAYERS = 2
LMK_CACHE = 256
LMK_TRAIN_STEPS, LMK_RESUME_AT, LMK_WARMUP = 10, 5, 2
# step 0's batch's loss after the LMK_TRAIN_STEPS steps must lie this far
# below its loss before them (weights that did not train give 0 exactly;
# the stream's five-step means fell 1.05e-2 at warmup 2)
LMK_BATCH0_FALL = 1e-2
LMK_MP_PROMPT, LMK_MP_GEN, LMK_MP_CACHE, LMK_MP_STEPS = 8, 8, 16, 3
# decode steps re-run under the planted merge fault (from the prompt's
# end: the steps whose keys lie on model rank 1 too)
LMK_PLANTED_STEPS = 8
LMK_FAULTS = {"merge": "the decode merge drops the last rank's partial",
              "fsdp": "the FSDP backward keeps its own block, no "
                      "reduce-scatter",
              "vocab": "the vocab loss takes the max of its local block"}


def lm_fsdp_rank(cpu_params: dict, cfg, prompt_cpu, tmp: str, device: str,
                 gen: int = LM_GEN, cache_len: int = LMK_CACHE,
                 train_size: tuple = (LMK_LAYERS, LMJ_TRAIN_BATCH,
                                      LMJ_TRAIN_SEQ, LMK_TRAIN_STEPS,
                                      LMK_RESUME_AT),
                 mp_size: tuple = (LMK_MP_PROMPT, LMK_MP_GEN, LMK_MP_CACHE,
                                   LMK_MP_STEPS)) -> dict:
    """One rank of path 4k (4 ranks on the one card; the sizes are 4b's
    and the constants', smaller in a CPU rehearsal). Rank 0 holds the
    unsharded references (the whole params on its device, no context)
    and returns every reading; every rank returns its launch counts,
    cache shape, collective times and peak memory."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.backend import prepare_params
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import serve, steps, train
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh
    from repro_torch.models import api as model_api
    from repro_torch.models import attention, transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map

    mesh = make_host_mesh(2, 2, device=device)
    pod_mesh = _build_mesh(1, 2, device, _AXES, n_pod=2)
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        full_precision_matmuls()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    n_layers, t_batch, t_seq, t_steps, t_resume = train_size
    mp_prompt, mp_gen, mp_cache, mp_steps = mp_size
    b, plen = prompt_cpu.shape
    r0 = dist.get_rank() == 0
    cfg = cfg.with_(n_layers=n_layers)
    whole = dict(tree_map(lambda t: t.to(dev), {
        k: v for k, v in cpu_params.items() if k != "blocks"}),
        blocks=tree_map(lambda t: t[:n_layers].to(dev),
                        cpu_params["blocks"]))
    prompt = prompt_cpu.to(dev)
    out = {"rank": dist.get_rank(), "backend": mesh.backend,
           "device": str(dev)}
    t_rank = time.perf_counter()

    def progress(what):
        if r0:
            say(f"[lm_fsdp] rank 0: {what} at "
                f"{time.perf_counter() - t_rank:.1f}s")

    def no_ctx():
        return sharding._installed(None)

    def whole_of(t, ctx):
        """The whole tensor of this rank's (rows, vocab) block."""
        t = collectives.all_gather_cat(t.contiguous(),
                                       ctx.mesh.group("model"), -1)
        return collectives.all_gather_cat(t, ctx.mesh.group(
            ctx.rules["batch"]), 0)

    def rows_of(t, ctx):
        return collectives.all_gather_cat(t.contiguous(), ctx.mesh.group(
            ctx.rules["batch"]), 0)

    def recorded(fn):
        """``fn()`` with every decode step's (tokens, logits) recorded."""
        seen, real = [], model_api.decode_fn

        def rec(params, cache, tokens, pos, cfg_, policy=None):
            lg, cache = real(params, cache, tokens, pos, cfg_, policy)
            seen.append((tokens, lg))
            return lg, cache
        model_api.decode_fn = rec
        try:
            res = fn()
        finally:
            model_api.decode_fn = real
        return res, seen

    def teacher_forced(params, toks, cache_rows):
        """The unsharded decode step on the given inputs (B, n)."""
        pcache = serve.init_cache(cfg, toks.shape[0], cache_rows, dev)
        lgs = []
        for pos in range(toks.shape[1]):
            lg, pcache = model_api.decode_fn(params, pcache,
                                             toks[:, pos:pos + 1], pos, cfg)
            lgs.append(lg)
        return torch.stack(lgs, 1)

    def gap(x, y):
        return {"min_corr": float(position_corr(torch, x, y).min()),
                "argmax": float((x.argmax(-1) == y.argmax(-1)).float()
                                .mean()),
                "max_abs": float((x.float() - y.float()).abs().max())}

    # (A) serve under DEFAULT_RULES: generate (B6's partial entry) and
    # prefill_fn (B5), the counted main path
    with sharding.use_sharding(mesh, sharding.DEFAULT_RULES) as ctx:
        local = transformer.place_lm_params(whole, cfg)
        rows = sharding.named_sharding(prompt.shape, ("batch", "seq"), ctx)
        mine = rows.block(prompt)
        serve.generate(local, serve.init_cache(cfg, b, 8, dev), mine[:, :4],
                       4, cfg)
        model_api.prefill_fn(local, {"tokens": mine[:, :16]}, cfg)
        sync()
        cache = serve.init_cache(cfg, b, cache_len, dev)
        out["cache_shape"] = tuple(cache["k"].shape)
        collectives.STATS.clear()
        _build.LAUNCHES.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (toks, tps), steps_in = recorded(
            lambda: serve.generate(local, cache, mine, gen, cfg))
        sync()
        out["serve_s"] = time.perf_counter() - t0
        out["stats"] = dict(collectives.STATS)
        full = model_api.prefill_fn(local, {"tokens": mine}, cfg)
        sync()
        out["launches"] = dict(_build.LAUNCHES)
        out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if cuda else 0.0)
        out["tps"] = tps
        out["toks"] = toks.cpu()
        both = collectives.all_gather_cat(toks, mesh.group("model"), 0)
        out["tokens_agree"] = all(torch.equal(t, toks)
                                  for t in both.split(toks.shape[0]))
        # the bytes the FSDP gathers of one decode step put on this rank:
        # each gathered leaf whole over "data", every layer and the table
        fsdp = transformer.fsdp_split(cfg).n

        def gathered(tree, ax):
            if isinstance(ax, dict):
                return sum(gathered(tree[k], ax[k]) for k in ax)
            return (tree.numel() * tree.element_size() * fsdp
                    if "p_embed" in ax else 0)
        out["gathered_mb"] = gathered(
            local, transformer.lm_placement_axes(cfg)) / 1e6
        inputs = rows_of(torch.cat([t for t, _ in steps_in], 1), ctx)
        tp_steps = whole_of(torch.stack([lg for _, lg in steps_in], 1), ctx)
        full = whole_of(full, ctx)
        out["toks_all"] = rows_of(toks, ctx).cpu()
        if r0:
            with no_ctx():
                plain = model_api.prefill_fn(whole, {"tokens": prompt}, cfg)
                plg = teacher_forced(whole, inputs, cache_len)
                with tp_arithmetic(torch, whole, cfg):
                    ctl = model_api.prefill_fn(whole, {"tokens": prompt},
                                               cfg)
                    clg = teacher_forced(whole, inputs, cache_len)
            out["vs_plain"] = {"prefill": gap(full, plain),
                               "decode": gap(tp_steps, plg)}
            out["control"] = {"prefill": gap(ctl, plain),
                              "decode": gap(clg, plg)}
            del ctl, clg
        del tp_steps, full
        # the planted merge fault: the steps from the prompt's end again
        # (their keys on both model ranks), the cache the counted run's
        merge = attention.merge_partials
        attention.merge_partials = lambda o, lse: merge(o[:-1], lse[:-1])
        n_bad = min(LMK_PLANTED_STEPS, gen)
        try:
            lgs = []
            for pos in range(plen, plen + n_bad):
                lg, cache = model_api.decode_fn(local, cache,
                                                steps_in[pos][0], pos, cfg)
                lgs.append(lg)
        finally:
            attention.merge_partials = merge
        bad = whole_of(torch.stack(lgs, 1), ctx)
        if r0:
            out["planted_merge"] = gap(bad, plg[:, plen:plen + n_bad])
        del steps_in, cache, bad, lgs, local
        progress("(A) done")

        # (B) int8: the same prefill under photonic_pallas
        cfg8 = cfg.with_(matmul_backend="photonic_pallas")
        cache8 = prepare_params(whole, bits=8)
        local8 = transformer.place_lm_params(cache8, cfg8)
        if not r0:
            del cache8
        model_api.prefill_fn(local8, {"tokens": mine[:, :16]}, cfg8)
        sync()
        _build.LAUNCHES.clear()
        tp8 = model_api.prefill_fn(local8, {"tokens": mine}, cfg8)
        sync()
        out["launches8"] = dict(_build.LAUNCHES)
        tp8 = whole_of(tp8, ctx)
        if r0:
            with no_ctx():
                one8 = model_api.prefill_fn(cache8, {"tokens": prompt}, cfg8)
            out["int8_bitwise"] = bool(torch.equal(tp8, one8))
            out["int8_maxdiff"] = float((tp8.float() - one8.float()).abs()
                                        .max())
            del one8, cache8
        del local8, tp8
        progress("(B) done")

    # (D) serving on the pod mesh under MULTIPOD_RULES: the prefill, and
    # greedy tokens after the prompt's first mp_prompt on a short cache
    with sharding.use_sharding(pod_mesh) as pctx:
        out["pod_rules"] = pctx.rules is sharding.MULTIPOD_RULES
        plocal = transformer.place_lm_params(whole, cfg)
        prows = sharding.named_sharding(prompt.shape, ("batch", "seq"), pctx)
        pmine = prows.block(prompt)
        _build.LAUNCHES.clear()
        pfull = whole_of(model_api.prefill_fn(plocal, {"tokens": pmine}, cfg),
                         pctx)
        pcache = serve.init_cache(cfg, b, mp_cache, dev)
        out["pod_cache_shape"] = tuple(pcache["k"].shape)
        (ptoks, _), psteps = recorded(lambda: serve.generate(
            plocal, pcache, pmine[:, :mp_prompt], mp_gen, cfg))
        out["pod_launches"] = dict(_build.LAUNCHES)
        pin = rows_of(torch.cat([t for t, _ in psteps], 1), pctx)
        plgs = whole_of(torch.stack([lg for _, lg in psteps], 1), pctx)
        both = collectives.all_gather_cat(ptoks, pod_mesh.group("model"), 0)
        out["pod_tokens_agree"] = all(torch.equal(t, ptoks)
                                      for t in both.split(ptoks.shape[0]))
        if r0:
            with no_ctx():
                pplain = teacher_forced(whole, pin, mp_cache)
            out["pod_vs_plain"] = {"prefill": gap(pfull, plain),
                                   "decode": gap(plgs, pplain)}
            del plain, plg, pplain
        del plocal, pcache, pfull, plgs, psteps
        progress("(D) serving done")

    # (C) train under DEFAULT_RULES
    cfg_t = cfg.with_(lr_warmup=LMK_WARMUP)
    tparams = whole
    shape = ShapeConfig("4k", t_seq, t_batch, "train")
    batch = TokenStream(cfg.vocab, t_seq, t_batch, seed=0,
                        device=dev).batch_at(0)
    clone = lambda st: tree_map(torch.clone, st)  # noqa: E731
    axes = None

    def grads(cfg_, params, ctx_):
        rows_ = TokenStream(cfg.vocab, t_seq, t_batch, seed=0, ctx=ctx_,
                            device=dev).batch_at(0)
        loss, g = steps.make_grad_fn(cfg_)(params, rows_)
        return float(loss), steps.gather_tree(g, axes, ctx_)

    with sharding.use_sharding(mesh, sharding.DEFAULT_RULES) as ctx:
        p0 = transformer.place_lm_params(tparams, cfg_t)
        out["fsdp_shape"] = tuple(p0["blocks"]["attn"]["wq"].shape)
        state0 = {"params": p0, "opt": adamw_init(
            p0, AdamWConfig(low_mem=not cfg_t.use_fp32_master)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
        axes = steps.placement_axes(cfg_t, model_api.model_logical_axes(
            cfg_t))
        loss_tp, g_tp = grads(cfg_t, p0, ctx)
        n = transformer.fsdp_split(cfg_t).n

        def no_reduce(g, group, dim):
            step = g.shape[dim] // n
            part = g.narrow(dim, dist.get_rank(group) * step, step)
            return (part.float() / n).to(g.dtype)

        planted = {}
        for key, (mod, name, fn) in {
                "fsdp": (collectives, "reduce_scatter_mean", no_reduce),
                "vocab": (collectives, "vocab_max",
                          lambda x, group: x.detach())}.items():
            saved = getattr(mod, name)
            setattr(mod, name, fn)
            try:
                planted[key] = grads(cfg_t, p0, ctx)
            finally:
                setattr(mod, name, saved)
        # every rank's loss: the model group's ranks must agree bitwise
        out["loss_tp_rank"] = loss_tp
        out["loss_vocab_fault_rank"] = planted["vocab"][0]
        progress("(C) one step's gradients and the planted faults done")
        # the straight run checkpoints at t_resume (and its end); the
        # resumed run starts from a copy of that checkpoint alone
        root, again = f"{tmp}/ckpt", f"{tmp}/resume"
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            final, losses, _ = train.train_loop(
                cfg_t, shape, t_steps, device=dev, state=clone(state0),
                ckpt=CheckpointManager(root, every=t_resume),
                log_every=t_steps)
            sync()
            out["train_s"] = time.perf_counter() - t0
            if r0:
                shutil.copytree(f"{root}/step_{t_resume}",
                                f"{again}/step_{t_resume}")
            dist.barrier()
            progress("(C) the straight run done")
            st, rest, _ = train.train_loop(
                cfg_t, shape, t_steps, device=dev, state=clone(state0),
                ckpt=CheckpointManager(again, every=10 ** 9),
                log_every=t_steps)
        finally:
            torch.use_deterministic_algorithms(False)
        out["losses"] = losses
        # step 0's batch again after training: its loss moves only with the
        # weights (the stream's move ~0.03 from batch to batch)
        out["batch0_after"] = grads(cfg_t, final["params"], ctx)[0]
        out["resumed_bitwise"] = rest == losses[t_resume:] and all(
            torch.equal(a, b) for a, b in zip(_leaves(st), _leaves(final)))
        st_axes = steps.placement_axes(cfg_t, steps.state_logical_axes(cfg_t))
        logical = steps.gather_tree(st, st_axes, ctx)
        if r0:
            back, step = restore(f"{again}/step_{t_steps}", logical)
            out["restored_step"] = step
            out["restored_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(_leaves(back),
                                                  _leaves(logical)))
            del back
        del logical, st, final, state0, p0

    # (D) training on the pod mesh
    with sharding.use_sharding(pod_mesh) as pctx:
        pp = transformer.place_lm_params(tparams, cfg_t)
        loss_mp, g_mp = grads(cfg_t, pp, pctx)
        pstate = {"params": pp, "opt": adamw_init(
            pp, AdamWConfig(low_mem=not cfg_t.use_fp32_master)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
        _, mp_losses, _ = train.train_loop(cfg_t, shape, mp_steps,
                                           device=dev, state=pstate,
                                           log_every=t_steps)
        out["mp_losses"] = mp_losses
        del pp, pstate
        progress("(D) training done")
    if r0:
        with no_ctx():
            grads_of = steps.make_grad_fn(cfg_t)
            loss1, g1 = grads_of(tparams, batch)
            half = t_batch // 2
            la, ga = grads_of(tparams, {k: v[:half] for k, v in
                                        batch.items()})
            lb, gb = grads_of(tparams, {k: v[half:] for k, v in
                                        batch.items()})
            g_ctl = tree_map(lambda a, b: ((a.float() + b.float()) / 2)
                             .to(a.dtype), ga, gb)
        out.update(
            loss_tp=loss_tp, loss_mp=loss_mp, loss1=float(loss1),
            loss_ctl=float((la + lb) / 2),
            grad_control=_tree_rel_l2(torch, g_ctl, g1),
            tp_rel=_tree_rel_l2(torch, g_tp, g1),
            mp_rel=_tree_rel_l2(torch, g_mp, g1),
            planted_train={k: {"loss": v[0], "rel": _tree_rel_l2(
                torch, v[1], g1)} for k, v in planted.items()})
    return out


def start_lm_fsdp(lm: dict) -> tuple:
    """Path 4k's 4 gloo ranks, started in the background (``in_background``:
    they run beside 4j's and 4l's); returns (start time, Future of the
    ranks' results) for ``run_lm_fsdp``."""
    import shutil
    import tempfile

    from repro_torch.bridge import to_device
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    params = to_device(lm["params"], "cpu")
    for t in _leaves(params):
        t.share_memory_()
    prompt = lm["prompt"].cpu()

    def spawn():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_fsdp_")
        try:
            return spawn_ranks(lm_fsdp_rank, 4, params, lm["cfg"], prompt,
                               tmp, "cuda", device="cuda", timeout_s=1000)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return t_phase, in_background(spawn)


def run_lm_fsdp(torch, dev, card: str, lm: dict, peak_4j: list,
                started: tuple) -> dict:
    """Path 4k: 4b's qwen2-1.5b weights and prompt under DEFAULT_RULES on
    (2, 2) and MULTIPOD_RULES on (2, 1, 2), 4 gloo ranks on the one card
    (``start_lm_fsdp``'s), against the unsharded runs on the card."""
    cfg = lm["cfg"]
    t_phase, pending = started
    ranks = pending.result()
    r0 = ranks[0]
    report_lm_fsdp(torch, ranks, cfg, card, lm["tps"], lm["toks"].cpu(),
                   peak_4j)
    say(f"[lm_fsdp] path 4k in {time.perf_counter() - t_phase:.2f}s from its "
        f"spawn, beside 4j's and 4l's ranks ({card})")
    return {"launches": r0["launches"], "launches8": r0["launches8"],
            "peak_gb": [r["peak_gb"] for r in ranks]}


def report_lm_fsdp(torch, ranks: list, cfg, card: str, tps_4b: float,
                   toks_4b, peak_4j: list) -> None:
    """4k's readings and checks (rank 0 holds the comparisons)."""
    r0 = ranks[0]
    steps = LM_PROMPT + LM_GEN
    depth = LMK_LAYERS
    say(f"[lm_fsdp] path 4k: {cfg.name} at full width, {depth} of "
        f"{cfg.n_layers} layers, under DEFAULT_RULES on (data 2, model 2) "
        f"and MULTIPOD_RULES on (pod 2, data 1, model 2), 4 ranks, backend "
        f"{r0['backend']}, all on {r0['device']} ({card})")
    # (A)
    rows = LMK_CACHE // 2
    for i, r in enumerate(ranks):
        st = r["stats"]
        ops = {k: v for k, v in st.items() if not k.endswith("_s")}
        by_op = ", ".join(f"{k} {1e3 * st[k + '_s'] / steps:.2f}"
                          for k in sorted(ops))
        gloo_ms = 1e3 * sum(v for k, v in st.items() if k.endswith("_s")) \
            / steps
        say(f"[lm_fsdp] (A) rank {i}: generate {LM_BATCH} x ({LM_PROMPT} + "
            f"{LM_GEN}) in {r['serve_s']:.3f}s, decode loop {r['tps']:.2f} "
            f"tok/s (4b unsharded at {cfg.n_layers} layers: {tps_4b:.2f}); "
            f"collectives "
            f"{gloo_ms:.2f} ms a decode step, by op (ms a step): {by_op}; "
            f"calls {ops}; FSDP gathers {r['gathered_mb']:.1f} MB a decode "
            f"step; cache {r['cache_shape']}; peak memory "
            f"{r['peak_gb']:.3f} GB (4j's ranks: "
            + ", ".join(f"{g:.3f}" for g in peak_4j)
            + f" GB); launches {r['launches']} ({card})")
        want = {"flash_decode_partial": steps * depth,
                "flash_attention_causal": depth}
        for k, n in want.items():
            if r["launches"].get(k, 0) != n:
                fail(f"4k (A) rank {i}: {k} launched "
                     f"{r['launches'].get(k, 0)} times, expected {n}")
        if r["launches"].get("flash_decode", 0):
            fail(f"4k (A) rank {i}: the whole-cache B6 entry launched")
        if r["cache_shape"] != (depth, LM_BATCH // 2, rows,
                                cfg.kv_heads, cfg.head_dim):
            fail(f"4k (A) rank {i}: cache {r['cache_shape']}, not "
                 f"{rows} rows of 2 batch rows")
        if not r["tokens_agree"]:
            fail(f"4k (A): rank {i}'s tokens differ from its model group's")
    same = float((r0["toks_all"] == toks_4b).float().mean())
    ctl = min(v["min_corr"] for v in r0["control"].values())
    limit = 1 - LMJ_CORR_FACTOR * (1 - ctl)

    def shown(h):
        return (f"min corr {h['min_corr']:.6f}, argmax "
                f"{100 * h['argmax']:.2f}%, max abs diff {h['max_abs']:.4g}")

    say(f"[lm_fsdp] (A) vs the unsharded card run: prefill "
        f"{shown(r0['vs_plain']['prefill'])}; teacher-forced decode over "
        f"{steps} steps {shown(r0['vs_plain']['decode'])}; control (4j's "
        f"tensor-parallel arithmetic on one device) prefill "
        f"{shown(r0['control']['prefill'])}, decode "
        f"{shown(r0['control']['decode'])}; limit corr > {limit:.6f}; "
        f"greedy tokens equal in every model group, {100 * same:.2f}% equal "
        f"to 4b's ({card})")
    for k, h in r0["vs_plain"].items():
        if not h["min_corr"] > limit:
            fail(f"4k (A) {k}: min corr {h['min_corr']} <= {limit}")
    pm = r0["planted_merge"]
    say(f"[lm_fsdp] (A) planted fault, {LMK_FAULTS['merge']}: decode "
        f"steps {LM_PROMPT}-{LM_PROMPT + LMK_PLANTED_STEPS - 1} "
        f"{shown(pm)}")
    if pm["min_corr"] > limit:
        fail(f"4k (A): the planted fault ({LMK_FAULTS['merge']}) passes "
             f"the {limit} limit")
    # (B)
    say(f"[lm_fsdp] (B) int8 prefill (photonic_pallas) on the FSDP mesh "
        f"bitwise the unsharded int8 prefill: {r0['int8_bitwise']} (max diff "
        f"{r0['int8_maxdiff']:.3e}); launches a rank: "
        + "; ".join(f"rank {i} {r['launches8']}"
                    for i, r in enumerate(ranks)))
    if not r0["int8_bitwise"]:
        fail("4k (B): the int8 FSDP prefill is not bitwise")
    for i, r in enumerate(ranks):
        if r["launches8"].get("photonic_matmul", 0) <= 0:
            fail(f"4k (B) rank {i}: photonic_matmul never launched")
    # (C)
    losses = r0["losses"]
    bound = LMJ_GRAD_FACTOR * r0["grad_control"]
    loss_gap = abs(r0["loss_tp"] - r0["loss1"])
    say(f"[lm_fsdp] (C) train, {depth} of {cfg.n_layers} layers, "
        f"batch {LMJ_TRAIN_BATCH} x {LMJ_TRAIN_SEQ}, warmup {LMK_WARMUP}, "
        f"FSDP blocks {r0['fsdp_shape']}: {LMK_TRAIN_STEPS} steps through "
        f"train_loop in {r0['train_s']:.2f}s "
        f"({1e3 * r0['train_s'] / LMK_TRAIN_STEPS:.1f} ms a step); losses "
        + " ".join(f"{x:.4f}" for x in losses) + f" ({card})")
    if not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
        fail(f"4k (C): the loss did not fall ({losses})")
    drop = r0["loss_tp_rank"] - r0["batch0_after"]
    say(f"[lm_fsdp] (C) step 0's batch after {LMK_TRAIN_STEPS} steps: loss "
        f"{r0['batch0_after']:.6f} against {r0['loss_tp_rank']:.6f} before "
        f"(a fall of {drop:.4e}, at least {LMK_BATCH0_FALL:.0e})")
    if not drop >= LMK_BATCH0_FALL:
        fail(f"4k (C): step 0's batch's loss fell {drop} after training")
    say(f"[lm_fsdp] (C) one step against the unsharded step on the card: "
        f"loss {r0['loss_tp']:.6f} vs {r0['loss1']:.6f} (gap {loss_gap:.3e}; "
        f"the two-half-batch control {r0['loss_ctl']:.6f}); gradient "
        f"relative L2 {r0['tp_rel']:.3e} against a bound of {bound:.3e} = "
        f"{LMJ_GRAD_FACTOR} x the control {r0['grad_control']:.3e}")
    if loss_gap > LMJ_LOSS_REL * abs(r0["loss1"]):
        fail(f"4k (C): loss {r0['loss_tp']} vs {r0['loss1']}")
    if not r0["tp_rel"] <= bound:
        fail(f"4k (C): gradient rel L2 {r0['tp_rel']} above {bound}")
    for key in ("fsdp", "vocab"):
        p = r0["planted_train"][key]
        say(f"[lm_fsdp] (C) planted fault, {LMK_FAULTS[key]}: loss "
            f"{p['loss']:.6f} (gap {abs(p['loss'] - r0['loss1']):.3e}), "
            f"gradient relative L2 {p['rel']:.3e}")
    if not r0["planted_train"]["fsdp"]["rel"] >= 10 * bound:
        fail(f"4k (C): the planted FSDP fault reads "
             f"{r0['planted_train']['fsdp']['rel']}, not 10x {bound}")
    # the vocab-parallel loss is the same on every rank (its max and sums
    # are all-reduced); a rank that shifts by its own block's max
    # disagrees with the others (at these widths that fault moves the loss
    # and the gradient too little for their bounds: it is caught here)
    healthy = [r["loss_tp_rank"] for r in ranks]
    faulty = [r["loss_vocab_fault_rank"] for r in ranks]
    say(f"[lm_fsdp] (C) the step's loss on each rank: {healthy}; under the "
        f"planted fault ({LMK_FAULTS['vocab']}): {faulty}")
    if len(set(healthy)) != 1:
        fail(f"4k (C): the ranks' losses differ: {healthy}")
    if len(set(faulty)) == 1:
        fail(f"4k (C): the planted vocab-loss fault leaves every rank's "
             f"loss equal: {faulty}")
    say(f"[lm_fsdp] (C) resumed from the step-{LMK_RESUME_AT} checkpoint: "
        f"losses and state bitwise the straight run's: "
        f"{r0['resumed_bitwise']}; the logical checkpoint at step "
        f"{r0['restored_step']} restored on one device bitwise the gathered "
        f"state: {r0['restored_bitwise']}")
    if not (r0["resumed_bitwise"] and r0["restored_bitwise"]):
        fail("4k (C): a resume or a one-device restore is not bitwise")
    # (D)
    pv = r0["pod_vs_plain"]
    say(f"[lm_fsdp] (D) pod mesh, MULTIPOD_RULES {r0['pod_rules']}: prefill "
        f"vs (A)'s unsharded prefill {shown(pv['prefill'])}; {LMK_MP_GEN} "
        f"greedy tokens after {LMK_MP_PROMPT} prompt tokens (cache "
        f"{LMK_MP_CACHE}, {r0['pod_cache_shape']} a rank), teacher-forced "
        f"unsharded decode {shown(pv['decode'])}; launches "
        f"{r0['pod_launches']}; one step: loss {r0['loss_mp']:.6f} vs "
        f"{r0['loss1']:.6f}, gradient relative L2 {r0['mp_rel']:.3e} (bound "
        f"{bound:.3e}); {LMK_MP_STEPS} steps' losses "
        + " ".join(f"{x:.4f}" for x in r0["mp_losses"]) + " vs (C)'s "
        + " ".join(f"{x:.4f}" for x in losses[:LMK_MP_STEPS]))
    if not r0["pod_rules"]:
        fail("4k (D): the pod mesh did not take MULTIPOD_RULES")
    for k, h in pv.items():
        if not h["min_corr"] > limit:
            fail(f"4k (D) {k}: min corr {h['min_corr']} <= {limit}")
    if not all(r["pod_tokens_agree"] for r in ranks):
        fail("4k (D): a model group's tokens differ")
    for r in ranks:
        if r["pod_launches"].get("flash_decode_partial", 0) != (
                LMK_MP_PROMPT + LMK_MP_GEN) * depth:
            fail(f"4k (D): flash_decode_partial launched "
                 f"{r['pod_launches'].get('flash_decode_partial', 0)} times")
    if abs(r0["loss_mp"] - r0["loss1"]) > LMJ_LOSS_REL * abs(r0["loss1"]):
        fail(f"4k (D): loss {r0['loss_mp']} vs {r0['loss1']}")
    if not r0["mp_rel"] <= bound:
        fail(f"4k (D): gradient rel L2 {r0['mp_rel']} above {bound}")
    for a, b in zip(r0["mp_losses"], losses):
        if abs(a - b) > LMJ_LOSS_REL * abs(b):
            fail(f"4k (D): train losses {r0['mp_losses']} vs (C)'s {losses}")


# path 4l: ViT QAT training on every mesh. opto-vit-base-224 + MGNet (keep
# 0.33) at full width, cut to VM_LAYERS of its 12 layers (its gloo time
# scales with the blocks; 4m's recurrentgemma-9b took the script past
# ~1,050 of its 1,200 s at 12, 4n past it at 6: PERF.md §4 lists the
# cuts), on qat + xla + xla, AdamW, a
# global batch of 32 of ImageStream(224, 32, n_classes=8), gloo ranks
# sharing the one card as 4j / 4k: (A) DATA_RULES on ("data",) 2 and (B)
# MODEL_RULES on (data 1, model 2) in one spawn of 2 ranks; (C)
# DEFAULT_RULES on (2, 2) and (D) MULTIPOD_RULES on (pod 2, data 1, model
# 2) in one spawn of 4; (E) (C)'s trained weights served on B1-B3. Each
# phase holds one step, pruning off (keep 1.0), against the one-device
# step on the card beside its order controls: the one-device step with
# its qat contractions summed in n blocks, n in VM_ORDERS
# (scripts/qat_grad_gap.py). At full size a code at a rounding boundary
# flips under any change of summation order and the flip cascades (a
# control reads ~2e-2, PERF.md §6 PR 28), which hides a planted fault in
# the gradient; there the gradient and the loss are held to
# VM_CONTROL_FACTOR x the controls' largest reading, and the checks that
# do not cascade carry the proof: every weight scale of the forward's
# fake quants bitwise the one-device forward's (a MAX is exact), every
# activation scale bitwise the whole mesh's (the MAX over every rank of
# the rank-local absmax; the activations themselves drift as the
# gradient does, so their scales move ~1e-2 from the one-device
# forward's), and every FSDP block's gradient bitwise this rank's block
# of the group's mean of the gathered weight's gradient. Beside it the tight
# check runs on the same mesh at smoke size (opto-vit-tiny cut to 2
# layers, batch 8 of 32x32, as 4i (C)'s), where no code flips: within
# VM_CONTROL_FACTOR x the control and under VM_GRAD_LIMIT, the loss
# within VM_LOSS_REL. Each planted fault must miss that bound by
# VM_FAULT_FACTOR x, and fail its check at full size: (A) the activation
# scales', (B) the weight scales', (C) the FSDP blocks' bitwise equality.
VM_BATCH = 32
VM_LAYERS = 3
VM_MICRO = 2                      # (G)'s microbatches a step
# (G) at smoke size: each later activation scale's relative gap from the
# one-device step's (a rank's GEMMs at half the rows: 3.4333e-7 on the
# H100; the planted row split 2.9157e-1)
VM_MICRO_ACT_LIMIT = 1e-5
# (F)'s launch counts read: B1-B3, B4, B3's host-split binding
F_KERNELS = ("photonic_matmul", "flash_attention_masked", "fused_ffn",
             "dequant_epilogue", "fused_ffn.kmajor.split")
VM_STEPS, VM_RESUME_AT = 4, 2     # (C)'s train_loop: straight, resumed
VM_SMOKE_BATCH = 8
# the order controls' blocks: all at full size (the spread of the flips'
# cascade), the first alone at smoke size (more blocks flip a code there
# too)
VM_ORDERS = (2, 3, 4, 6, 8)
VM_CONTROL_FACTOR = 4
VM_GRAD_LIMIT = 1e-4
VM_LOSS_REL = 1e-6
VM_FAULT_FACTOR = 10
VM_SERVE_CORR = 0.999
VM_FAULTS = {"A": "rank-local activation scales",
             "B": "w2's weight absmax without its MAX over model",
             "C": "the FSDP backward without its reduce-scatter"}
VM_TABLES = {"A": "DATA_RULES on (data 2)",
             "B": "MODEL_RULES on (data 1, model 2)",
             "C": "DEFAULT_RULES on (data 2, model 2)",
             "D": "MULTIPOD_RULES on (pod 2, data 1, model 2)"}


@contextlib.contextmanager
def _patched(owner, name: str, value):
    """``owner.name`` (``owner[name]`` for a dict) set to ``value`` for the
    block."""
    get = owner.get if isinstance(owner, dict) else (
        lambda k: getattr(owner, k))
    put = owner.__setitem__ if isinstance(owner, dict) else (
        lambda k, v: setattr(owner, k, v))
    saved = get(name)
    put(name, value)
    try:
        yield
    finally:
        put(name, saved)


def _scale_recorder(quant, rec: list):
    """``quant.fake_quant_ste`` appending each call's (per tensor, scale,
    the rank-local absmax of a per-tensor call, bits), on the CPU, to
    ``rec``: the forward's fake-quant scales in call order."""
    real = quant.fake_quant_ste

    def fq(x, bits=8, axis=None, scale=None):
        if scale is None:
            scale = quant.absmax_scale(x, bits=bits, axis=axis)
        amax = (x.detach().abs().amax().float().cpu() if axis is None
                else None)
        rec.append((axis is None, scale.detach().float().cpu().reshape(-1),
                    amax, bits))
        return real(x, bits, axis, scale)
    return fq


def _scope_gap(dist, quant, rec: list) -> float:
    """The largest relative gap of a recorded activation scale from the
    whole mesh's: max(MAX over every rank of the rank-local absmax, eps)
    times f32(1/qmax), the MAX taken here over the default group. 0 where
    every activation scale is the global batch's."""
    import torch
    acts = [(s, a, bits) for per_tensor, s, a, bits in rec if per_tensor]
    amax = torch.stack([a for _, a, _ in acts])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    worst = 0.0
    for (s, _, bits), m in zip(acts, amax):
        want = torch.clamp_min(m, 1e-8) * quant.inv_qmax(bits)
        worst = max(worst, float(((s - want).abs() / want).max()))
    return worst


def _scale_gaps(got: list, want: list, m: int) -> tuple:
    """(the activation scales' largest relative gap, the weight scales')
    of ``got`` (a forward's record) against ``want`` (the one-device
    forward's); a weight whose columns are model rank ``m``'s block is
    held to that block of the whole. Records of other calls: inf."""
    if [r[0] for r in got] != [r[0] for r in want]:
        return float("inf"), float("inf")
    gaps = {True: 0.0, False: 0.0}
    for (per_tensor, g, *_), (_, w, *_) in zip(got, want):
        if g.numel() != w.numel():
            w = w[m * g.numel():(m + 1) * g.numel()]
        gap = float(((g.double() - w.double()).abs() / w.double()).max())
        gaps[per_tensor] = max(gaps[per_tensor], gap)
    return gaps[True], gaps[False]


def _fsdp_probe(collectives, seen: list):
    """``collectives.fsdp_gather`` recording, for each gather, the
    gathered weight's gradient and the one its backward hands this rank's
    block."""
    real = collectives.fsdp_gather

    def gather(x, group, dim):
        block = x.view_as(x)
        whole = real(block, group, dim)
        rec = {"group": group, "dim": dim}
        whole.register_hook(
            lambda g: rec.__setitem__("whole", g.detach().clone()))
        block.register_hook(
            lambda g: rec.__setitem__("block", g.detach().clone()))
        seen.append(rec)
        return whole
    return gather


def _fsdp_gap(dist, seen: list) -> float:
    """The largest relative L2 gap of a block's gradient from this rank's
    block of the group's mean of the gathered weight's gradient (f32 sum
    over the group, divided by its size, rounded once): 0 where the FSDP
    backward reduce-scatters."""
    worst = 0.0
    for rec in seen:
        g = rec["whole"].float().cpu()
        dist.all_reduce(g, group=rec["group"])
        n = dist.get_world_size(rec["group"])
        step = g.shape[rec["dim"]] // n
        want = (g.narrow(rec["dim"], dist.get_rank(rec["group"]) * step, step)
                / n).to(rec["block"].dtype).double()
        got = rec["block"].cpu().double()
        worst = max(worst, float((got - want).norm() / want.norm()))
    return worst


def vit_mesh_smoke_cfg():
    """4l's tight check's config: 4i (C)'s (opto-vit-tiny at smoke size,
    2 layers) with MGNet present and its pruning off."""
    from repro_torch.configs.base import smoke_variant
    from repro_torch.configs.registry import get_config
    return smoke_variant(get_config("opto-vit-tiny")).with_(
        n_layers=2, quant_bits=8, mgnet=True, mgnet_keep_ratio=1.0,
        mgnet_embed=32, mgnet_heads=2)


def vit_mesh_rank(cpu_params: dict, cfg, tmp: str, device: str,
                  tables: str) -> dict:
    """One rank of path 4l's phases ``tables`` ("AB" on 2 ranks, "CD" on
    4). Rank 0 also runs the one-device steps and their order controls on
    the whole params (no context) and returns the distances; every rank
    its scale and FSDP gaps, losses, step time, collective times and peak
    memory a phase."""
    import shutil

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "scripts"))
    from qat_grad_gap import qat_split_in
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import quant
    from repro_torch.core.backend import ExecPolicy, place_params
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.device import full_precision_matmuls
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh
    from repro_torch.launch.train import init_state
    from repro_torch.models import api as model_api
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init, tree_leaves,
                                         tree_map)

    if tables == "AB":
        meshes = {"A": (_build_mesh(2, 1, device, axis_names=("data",)),
                        sharding.DATA_RULES),
                  "B": (make_host_mesh(1, 2, device=device),
                        sharding.MODEL_RULES)}
    else:
        meshes = {"C": (make_host_mesh(2, 2, device=device),
                        sharding.DEFAULT_RULES),
                  "D": (_build_mesh(1, 2, device, _AXES, n_pod=2),
                        sharding.MULTIPOD_RULES)}
    first = next(iter(meshes.values()))[0]
    dev = first.device
    cuda = dev.type == "cuda"
    if cuda:
        full_precision_matmuls()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    r0 = dist.get_rank() == 0
    out = {"rank": dist.get_rank(), "backend": first.backend,
           "device": str(dev)}
    t_rank = time.perf_counter()

    def progress(what):
        if r0:
            say(f"[vit_mesh] rank 0: {what} at "
                f"{time.perf_counter() - t_rank:.1f}s")

    # the two sizes: full (the path) and smoke (the tight check)
    full = cfg.with_(mgnet_keep_ratio=1.0)
    smoke = vit_mesh_smoke_cfg()
    sizes = {"full": (full, tree_map(lambda t: t.to(dev), cpu_params),
                      VM_BATCH),
             "smoke": (smoke, init_state(smoke, 0, dev)["params"],
                       VM_SMOKE_BATCH)}

    def batch_of(c, b, ctx=None):
        s = ImageStream(c.img_size, b, n_classes=8, patch=c.patch, seed=0,
                        device=dev, ctx=ctx)
        return {k: v for k, v in s.batch_at(0).items()
                if k in ("images", "labels")}

    # (F)'s flush: (E)'s held-out batch, whole on every rank
    held = ImageStream(cfg.img_size, VM_BATCH, n_classes=8, patch=cfg.patch,
                       seed=0, device=dev).batch_at(20000)["images"]

    def recorded(rec):
        return _patched(quant, "fake_quant_ste", _scale_recorder(quant, rec))

    # the one-device steps, their scales and their order controls (rank 0)
    one = {}
    if r0:
        with sharding._installed(None):
            for size, (c, whole, b) in sizes.items():
                gb = batch_of(c, b)
                grads_of = steps.make_grad_fn(c)
                grads_of(whole, gb)                       # warm-up
                rec = []
                with recorded(rec):
                    loss, g = grads_of(whole, gb)
                loss = float(loss)
                controls = []
                # at smoke size the one order that flips no code: the
                # tight check's class
                orders = VM_ORDERS if size == "full" else VM_ORDERS[:1]
                for parts in orders:
                    rec_c = []
                    # a fresh step: its policy binds the entry it sees
                    with _patched(backend_mod.BACKENDS, "qat",
                                  qat_split_in(parts)), recorded(rec_c):
                        loss_c, g_c = steps.make_grad_fn(c)(whole, gb)
                    controls.append({
                        "parts": parts, "grad": grad_distance(torch, g_c, g)[0],
                        "loss": abs(float(loss_c) - loss) / abs(loss),
                        "act": _scale_gaps(rec_c, rec, 0)[0]})
                    del g_c
                one[size] = {"loss": loss, "g": g, "controls": controls,
                             "scales": rec}
        progress("the one-device steps and their controls done")
    # every rank holds the one-device forward's scales at full size
    box = [one["full"].pop("scales") if r0 else None]
    dist.broadcast_object_list(box, src=0)
    want_scales = box[0]

    def fsdp_no_reduce(g, group, dim):
        n = dist.get_world_size(group)
        step = g.shape[dim] // n
        return (g.narrow(dim, dist.get_rank(group) * step, step).float()
                / n).to(g.dtype)

    whole_scale = collectives.replicated_absmax_scale

    def local_weight_scale(x, bits, group, eps=1e-8, axis=None):
        # an activation's MAX kept, a row-split weight's per-column one not
        if axis is None:
            return whole_scale(x, bits, group, eps)
        return quant.absmax_scale(x, bits=bits, axis=axis)

    planted = {"A": (sharding, "absmax_group", lambda: None),
               "B": (collectives, "replicated_absmax_scale",
                     local_weight_scale),
               "C": (collectives, "reduce_scatter_mean", fsdp_no_reduce)}

    def probed(grads_of, local, rows, m):
        """One gradient with its fake-quant scales and FSDP blocks
        recorded: (the gradient, the gaps: the scales' from the one-device
        forward's, the activation scales' from the whole mesh's and the
        FSDP blocks' (None without FSDP))."""
        rec, seen = [], []
        with recorded(rec), _patched(collectives, "fsdp_gather",
                                     _fsdp_probe(collectives, seen)):
            _, g = grads_of(local, rows)
        act, wgt = _scale_gaps(rec, want_scales, m)
        return g, {"act": act, "weight": wgt,
                   "scope": _scope_gap(dist, quant, rec),
                   "fsdp": _fsdp_gap(dist, seen) if seen else None}

    for tag, (mesh, rules) in meshes.items():
        res = {}
        with sharding.use_sharding(mesh, rules) as ctx:
            for size, (c, whole, b) in sizes.items():
                axes = steps.placement_axes(c, model_api.model_logical_axes(c))
                local = place_params(whole, axes, ctx)
                rows = batch_of(c, b, ctx)
                grads_of = steps.make_grad_fn(c)
                got = {}
                if size == "full":
                    got["local"] = {k: tuple(v.shape) for k, v in (
                        ("wq", local["blocks"]["attn"]["wq"]),
                        ("w2", local["blocks"]["ffn"]["w2"]),
                        ("head", local["head"]), ("images", rows["images"]))}
                    # the warm-up, probed
                    _, got["gaps"] = probed(grads_of, local, rows, mesh.m)
                    sync()
                    collectives.STATS.clear()
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                loss, g = grads_of(local, rows)
                sync()
                got["grad_s"] = time.perf_counter() - t0
                got["loss"] = float(loss)
                if size == "full":
                    got["stats"] = dict(collectives.STATS)
                    got["peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                      / 1e9 if cuda else 0.0)
                    split = sharding.split_of("p_embed", c.d_model)

                    def gathered(tree, ax):
                        if isinstance(ax, dict):
                            return sum(gathered(tree[k], ax[k]) for k in ax)
                        return (tree.numel() * tree.element_size() * split.n
                                if "p_embed" in ax else 0)
                    got["gathered_mb"] = (gathered(local, axes) / 1e6
                                          if split is not None else 0.0)
                g = steps.gather_tree(g, axes, ctx)
                if r0:
                    got["dist"] = grad_distance(torch, g, one[size]["g"])
                    got["one"] = {k: v for k, v in one[size].items()
                                  if k != "g"}
                del g
                if tag in planted:
                    with _patched(*planted[tag]):
                        if size == "full":
                            gf, got["fault_gaps"] = probed(grads_of, local,
                                                           rows, mesh.m)
                        else:
                            _, gf = grads_of(local, rows)
                    gf = steps.gather_tree(gf, axes, ctx)
                    if r0:
                        got["fault"] = grad_distance(torch, gf,
                                                     one[size]["g"])
                    del gf
                if size == "full":
                    # ms a train step (CUDA events, 2 steps after 1)
                    holder = [{"params": local, "opt": adamw_init(
                        local, AdamWConfig(low_mem=not c.use_fp32_master)),
                        "step": torch.zeros((), dtype=torch.int32,
                                            device=dev)}]
                    step_fn = steps.make_train_fn(c)

                    def one_step():
                        holder[0], _ = step_fn(holder[0], rows)
                    got["step_ms"] = (cuda_ms(one_step, iters=2, warmup=1)
                                      if cuda else 0.0)
                    del holder, step_fn
                res[size] = got
            progress(f"({tag}) steps done")
            if tag == "B":
                # the photonic_sim forward's row-parallel entry at w2's
                # shape: bitwise the unsharded entry
                from repro_torch.models.layers import row_parallel_linear
                gen = torch.Generator(device=dev).manual_seed(3)
                m = VM_BATCH * ((cfg.img_size // cfg.patch) ** 2 + 1)
                h = torch.randn(m, cfg.d_ff, generator=gen, device=dev)
                w2 = sizes["full"][1]["blocks"]["ffn"]["w2"][0]
                k0, k1 = (mesh.m * cfg.d_ff // 2,
                          (mesh.m + 1) * cfg.d_ff // 2)
                pol = ExecPolicy(8, "photonic_sim", training=False)
                with sharding.mesh_scope(), torch.no_grad():
                    y = row_parallel_linear(h[:, k0:k1], w2[k0:k1], pol,
                                            mesh.group("model"))
                    with sharding._installed(None):
                        y1 = backend_mod.linear(h, w2, policy=pol)
                res["sim_bitwise"] = bool(torch.equal(y, y1))
                res["sim_maxdiff"] = float((y - y1).abs().max())
                res["sim_shape"] = (m, cfg.d_ff, cfg.d_model)
                del h, y, y1
            if tag == "C":
                # 4 steps through train_loop with pruning on, checkpointed
                # at the resume step; a resumed run from a copy of that
                # checkpoint alone; the logical state restored on one
                # device
                tcfg = cfg.with_(lr_warmup=10)
                shape = ShapeConfig("4l", 0, VM_BATCH, "train")
                axes = steps.placement_axes(tcfg, model_api.model_logical_axes(
                    tcfg))
                st_axes = steps.placement_axes(tcfg,
                                               steps.state_logical_axes(tcfg))
                p0 = place_params(sizes["full"][1], axes, ctx)
                state0 = {"params": p0, "opt": adamw_init(p0, AdamWConfig(
                    low_mem=not tcfg.use_fp32_master)),
                    "step": torch.zeros((), dtype=torch.int32, device=dev)}
                clone = lambda s: tree_map(torch.clone, s)  # noqa: E731
                root, again = f"{tmp}/ckpt", f"{tmp}/resume"
                torch.use_deterministic_algorithms(True)
                try:
                    t0 = time.perf_counter()
                    final, losses, _ = train.train_loop(
                        tcfg, shape, VM_STEPS, device=dev,
                        state=clone(state0),
                        ckpt=CheckpointManager(root, every=VM_RESUME_AT),
                        log_every=VM_STEPS)
                    sync()
                    res["train_s"] = time.perf_counter() - t0
                    if r0:
                        shutil.copytree(f"{root}/step_{VM_RESUME_AT}",
                                        f"{again}/step_{VM_RESUME_AT}")
                    dist.barrier()
                    st2, rest, _ = train.train_loop(
                        tcfg, shape, VM_STEPS, device=dev,
                        state=clone(state0),
                        ckpt=CheckpointManager(again, every=10 ** 9),
                        log_every=VM_STEPS)
                finally:
                    torch.use_deterministic_algorithms(False)
                res["losses"] = losses
                res["resumed_bitwise"] = rest == losses[VM_RESUME_AT:] and all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(st2),
                                                      tree_leaves(final)))
                logical = steps.gather_tree(st2, st_axes, ctx)
                if r0:
                    back, step = restore(f"{again}/step_{VM_STEPS}", logical)
                    res["restored"] = (step, all(
                        torch.equal(a, b) for a, b in zip(
                            tree_leaves(back), tree_leaves(logical))))
                    res["trained"] = tree_map(lambda t: t.cpu(),
                                              logical["params"])
                    del back
                del logical, st2, state0, p0
                progress("(C) train_loop, resume and restore done")
                # (F) the trained blocks gathered, prepared and served on
                # the fused point inside the same context
                res["fused"] = fused_mesh_serve(torch, final["params"], tcfg,
                                                ctx, held, False)
                trained = res["fused"].pop("whole")
                del final
                progress("(F) the fused serve under (C) done")
            if tag == "D":
                # (F) (C)'s trained weights placed as the pod mesh's
                # blocks, gathered over ("pod", "data"), prepared, served;
                # the planted fault leaves the absmax scope local
                axes = steps.placement_axes(cfg, model_api.model_logical_axes(
                    cfg))
                res["fused"] = fused_mesh_serve(
                    torch, place_params(trained, axes, ctx), cfg, ctx, held,
                    True)
                del res["fused"]["whole"], trained
                progress("(F) the fused serve under (D) done")
        out[tag] = res
    if tables == "AB":
        out["G"] = microbatched_mesh_steps(
            torch, dist, sizes, meshes["A"], batch_of, recorded, dev, r0)
        progress("(G) the microbatched steps done")
    return out


def fused_mesh_serve(torch, blocks: dict, cfg, ctx, images, plant: bool
                     ) -> dict:
    """4l (F) on one rank: whole weights from this rank's blocks under
    ``ctx`` (``steps.gather_tree``), prepared into the quantize-once cache,
    put in the form the fused encode under ``ctx`` reads
    (``vit.serving_cache``: "model" shards under DEFAULT_RULES on (2, 2),
    whole on the pod mesh) and served on ``images`` by ``forward_vit`` on
    the fused point; its logits against the one-device fused forward of
    the same cache, its launches, and with ``plant`` the same serve with
    every absmax scope left local to the rank."""
    from repro_torch.core.backend import ExecPolicy, prepare_params
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models.vit import forward_vit, serving_cache

    fused = cfg.with_(matmul_backend="photonic_pallas", attn_backend="flash",
                      ffn_backend="fused")
    pol = ExecPolicy.from_cfg(fused, training=False)
    dev = images.device
    with torch.no_grad():
        whole = steps.gather_tree(blocks, steps.placement_axes(
            cfg, api.model_logical_axes(cfg)), ctx)
        cache = prepare_params(whole, bits=cfg.quant_bits)
        served = serving_cache(cache, fused, pol, ctx)
        _build.LAUNCHES.clear()
        logits, kept = forward_vit(served, images, fused, pol, device=dev)
        launches = dict(_build.LAUNCHES)
        planted = None
        if plant:
            with _patched(sharding, "absmax_group", lambda: None):
                planted = forward_vit(served, images, fused, pol,
                                      device=dev)[0]
        with sharding._installed(None):
            one, _ = forward_vit(cache, images, fused, pol, device=dev)
    return {"bitwise": bool(torch.equal(logits, one)),
            "max_diff": float((logits - one).abs().max()),
            "planted_equal": (None if planted is None
                              else bool(torch.equal(planted, one))),
            "planted_diff": (None if planted is None
                             else float((planted - one).abs().max())),
            "launches": launches, "kept": kept, "shape": tuple(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "wq": tuple(served["blocks"]["attn"]["wq"].wq.shape),
            "whole": whole}


def microbatched_mesh_steps(torch, dist, sizes: dict, mesh_rules, batch_of,
                            recorded, dev, r0: bool) -> dict:
    """4l (G) on one rank of (A)'s mesh (DATA_RULES on (data 2)): at each
    size one gradient with ``VM_MICRO`` microbatches (pruning off), this
    rank's rows its share of every global microbatch (``ImageStream(
    microbatches=)``), its fake-quant scales recorded: their gaps from
    the one-device k-microbatch step's (rank 0 computes it, with its
    2-block summation-order control, and hands its scales to every
    rank; its control's scale gaps beside them), the activation scales'
    from the whole mesh's, the first activation scale of each microbatch
    (the images', before any GEMM) apart; and the same with the
    rank-local row split (each rank microbatching its own block: the
    planted fault)."""
    import sys as _sys
    _sys.path.insert(0, str(ROOT / "scripts"))
    from qat_grad_gap import qat_split_in
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import quant
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps

    mesh, rules = mesh_rules
    res = {}

    def firsts(rec):
        acts = [r[1] for r in rec if r[0]]
        per = len(acts) // VM_MICRO
        return [acts[i * per] for i in range(VM_MICRO)]

    for size, (c, whole, b) in sizes.items():
        ck = c.with_(microbatch_steps=VM_MICRO)
        got = {}
        if r0:
            with sharding._installed(None):
                gb = batch_of(c, b)
                rec1 = []
                with recorded(rec1):
                    loss1, g1 = steps.make_grad_fn(ck)(whole, gb)
                controls, control_act = [], []
                for parts in VM_ORDERS[:1]:
                    rec_c = []
                    with _patched(backend_mod.BACKENDS, "qat",
                                  qat_split_in(parts)), recorded(rec_c):
                        _, g_c = steps.make_grad_fn(ck)(whole, gb)
                    controls.append(grad_distance(torch, g_c, g1)[0])
                    control_act.append(_scale_gaps(rec_c, rec1, 0)[0])
                    del g_c, rec_c
        box = [rec1 if r0 else None]
        dist.broadcast_object_list(box, src=0)
        want = box[0]
        with sharding.use_sharding(mesh, rules) as ctx:
            def rows_of(k):
                st = ImageStream(c.img_size, b, n_classes=8, patch=c.patch,
                                 seed=0, device=dev, ctx=ctx, microbatches=k)
                return {n: v for n, v in st.batch_at(0).items()
                        if n in ("images", "labels")}
            rec = []
            with recorded(rec):
                loss, g = steps.make_grad_fn(ck)(whole, rows_of(VM_MICRO))
            got["act"], got["weight"] = _scale_gaps(rec, want, 0)
            got["scope"] = _scope_gap(dist, quant, rec)
            got["first_equal"] = all(torch.equal(x, y) for x, y in zip(
                firsts(rec), firsts(want)))
            got["loss"] = float(loss)
            bad = []
            with recorded(bad):
                steps.make_grad_fn(ck)(whole, rows_of(1))
            got["fault_act"] = _scale_gaps(bad, want, 0)[0]
            got["fault_first_equal"] = all(torch.equal(x, y) for x, y in zip(
                firsts(bad), firsts(want)))
        if r0:
            got["dist"] = grad_distance(torch, g, g1)
            got["controls"] = controls
            got["control_act"] = max(control_act)
            got["one_loss"] = float(loss1)
        del g
        res[size] = got
    return res


def vit_mesh_cfg():
    """4l's config: 4i's (``train_cfg``) at VM_LAYERS layers."""
    return train_cfg().with_(n_layers=VM_LAYERS)


def start_vit_mesh() -> tuple:
    """Path 4l's two spawns of gloo ranks ((A)-(B) on 2, then (C)-(D) on
    4), in the background (``in_background``: beside 4k's ranks); returns
    (start time, Future of (ranks by table, (G)'s ranks, each spawn's
    seconds)) for ``run_vit_mesh``."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import init_state

    cfg = vit_mesh_cfg()

    def spawns():
        params = init_state(cfg, 0, "cpu")["params"]
        for t in _leaves(params):
            t.share_memory_()
        ranks, took, micro = {}, [], None
        for tables, world in (("AB", 2), ("CD", 4)):
            tmp = tempfile.mkdtemp(prefix="chip_smoke_vit_mesh_")
            t0 = time.perf_counter()
            try:
                got = spawn_ranks(vit_mesh_rank, world, params, cfg, tmp,
                                  "cuda", tables, device="cuda",
                                  timeout_s=900)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            took.append((world, tables, time.perf_counter() - t0,
                         got[0]["backend"], got[0]["device"]))
            for tag in tables:
                ranks[tag] = [r[tag] for r in got]
            if tables == "AB":
                micro = [r["G"] for r in got]
        return ranks, micro, took
    return time.perf_counter(), in_background(spawns)


def run_vit_mesh(torch, dev, card: str, started: tuple) -> dict:
    """Path 4l: (A)-(D) in ``start_vit_mesh``'s two spawns of gloo ranks on
    the one card, then (E) on the parent's card."""
    from repro_torch.core.backend import prepare_params
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.kernels import _build
    from repro_torch.models.layers import ExecPolicy
    from repro_torch.models.vit import forward_vit
    from repro_torch.optim.adamw import tree_map

    cfg = vit_mesh_cfg()
    t_phase, pending = started
    say(f"[vit_mesh] path 4l: {cfg.name} {cfg.img_size}x{cfg.img_size} + "
        f"MGNet keep {cfg.mgnet_keep_ratio} on qat + xla + xla, training=True, "
        f"global batch {VM_BATCH}, {cfg.n_layers} layers; gloo ranks on the "
        f"one card; the tight checks at smoke size beside each ({card})")
    ranks, micro, took = pending.result()
    for world, tables, spawn_s, backend, where in took:
        say(f"[vit_mesh] the {world}-rank spawn ({tables}) in {spawn_s:.2f}s "
            f"(beside 4k's ranks), backend {backend}, all on {where}")
    failures = report_vit_mesh(ranks, card)
    failures += report_vit_mesh_fused(ranks, card)
    failures += report_vit_mesh_micro(micro, card)
    trained = ranks["C"][0]["trained"]

    # (E) (C)'s trained weights gathered to one device, prepared into the
    # quantize-once cache and served on the fused point (B1-B3)
    fused_cfg = cfg.with_(matmul_backend="photonic_pallas",
                          attn_backend="flash", ffn_backend="fused")
    trained = tree_map(lambda t: t.to(dev), trained)
    held = ImageStream(cfg.img_size, VM_BATCH, n_classes=8, patch=cfg.patch,
                       seed=0, device=dev).batch_at(20000)
    with torch.no_grad():
        qat_logits, _ = forward_vit(trained, held["images"], cfg,
                                    ExecPolicy.from_cfg(cfg, training=False),
                                    device=dev)
        cache = prepare_params(trained, bits=cfg.quant_bits)
        _build.LAUNCHES.clear()
        fused_logits, kept = forward_vit(
            cache, held["images"], fused_cfg,
            ExecPolicy.from_cfg(fused_cfg, training=False), device=dev)
        launches = dict(_build.LAUNCHES)
    c = corr(torch, fused_logits, qat_logits)
    labels = held["labels"].long()
    acc_f = float((fused_logits.argmax(-1) == labels).float().mean())
    acc_q = float((qat_logits.argmax(-1) == labels).float().mean())
    top1 = float((fused_logits.argmax(-1) == qat_logits.argmax(-1)).float()
                 .mean())
    say(f"[vit_mesh] (E) (C)'s weights after {VM_STEPS} steps gathered to "
        f"one device and served on the fused point (photonic_pallas + flash "
        f"+ fused, {kept} patches kept) against the QAT forward "
        f"(training=False) on a held-out batch of {VM_BATCH}: logits corr "
        f"{c:.6f}, top-1 agreement {top1:.4f}; accuracy on the synthetic "
        f"labels: fused {acc_f:.4f}, QAT {acc_q:.4f}; launches {launches} "
        f"({card})")
    if not c > VM_SERVE_CORR:
        failures.append(f"4l (E): fused serve vs QAT forward corr {c}")
    if acc_f != acc_q:
        failures.append(f"4l (E): fused accuracy {acc_f} != QAT accuracy "
                        f"{acc_q}")
    for name_ in VIT_KERNELS:
        if launches.get(name_, 0) <= 0:
            failures.append(f"4l (E): kernel {name_} was never launched")
    say(f"[vit_mesh] path 4l in {time.perf_counter() - t_phase:.2f}s from its "
        f"first spawn, beside 4k's ranks ({card})")
    if failures:
        fail("; ".join(failures))
    return {"launches": launches, "serve_corr": c}


def report_vit_mesh(ranks: dict, card: str) -> list:
    """4l (A)-(D)'s readings, then their checks (rank 0 holds the
    distances, every rank its scale and FSDP gaps): the list of what
    failed."""
    failures = []
    for tag, rs in ranks.items():
        r0 = rs[0]
        for size in ("full", "smoke"):
            got = r0[size]
            one = got["one"]
            ctls = one["controls"]
            ctl = max(x["grad"] for x in ctls)
            ctl_loss = max(x["loss"] for x in ctls)
            rel, worst, worst_name, n = got["dist"]
            dl = abs(got["loss"] - one["loss"]) / abs(one["loss"])
            tight = size == "smoke"
            bound = VM_CONTROL_FACTOR * ctl
            loss_bound = VM_CONTROL_FACTOR * ctl_loss
            if tight:
                bound, loss_bound = min(bound, VM_GRAD_LIMIT), VM_LOSS_REL
            say(f"[vit_mesh] ({tag}) {VM_TABLES[tag]}, {len(rs)} ranks, "
                f"{size}: one step's gradient (pruning off) against the "
                f"one-device step on the card: relative L2 {rel:.4e}, min "
                f"leaf corr {worst:.8f} ({worst_name}, {n} leaves), loss "
                f"{got['loss']:.6f} vs {one['loss']:.6f} (relative "
                f"{dl:.4e}); the order controls (qat contractions in n "
                f"blocks) gradient / loss / activation-scale gap "
                + ", ".join(f"n={x['parts']}: {x['grad']:.4e} / "
                            f"{x['loss']:.4e} / {x['act']:.4e}"
                            for x in ctls)
                + f"; held to {bound:.4e} and {loss_bound:.4e} ({card})")
            if not (rel <= bound and dl <= loss_bound):
                failures.append(f"4l ({tag}) {size}: gradient relative L2 "
                                f"{rel} (bound {bound}), loss relative {dl} "
                                f"(bound {loss_bound})")
            if "fault" in got:
                frel = got["fault"][0]
                say(f"[vit_mesh] ({tag}) {size}, planted fault "
                    f"({VM_FAULTS[tag]}): gradient relative L2 {frel:.4e} "
                    f"= {_times(frel, bound):.1f}x the bound")
                if tight and not frel > VM_FAULT_FACTOR * bound:
                    failures.append(f"4l ({tag}): the planted fault "
                                    f"({VM_FAULTS[tag]}) read {frel}, not "
                                    f"{VM_FAULT_FACTOR}x beyond {bound}")
            if len({r[size]["loss"] for r in rs}) != 1:
                failures.append(f"4l ({tag}) {size}: the ranks' losses "
                                f"differ: {[r[size]['loss'] for r in rs]}")
        failures += _report_vit_mesh_scales(tag, rs, card)
        for i, r in enumerate(rs):
            got = r["full"]
            st = got["stats"]
            ops = {k: f"{1e3 * st[k + '_s']:.1f} ms / {st[k]}"
                   for k in sorted(st) if not k.endswith("_s")}
            say(f"[vit_mesh] ({tag}) rank {i}: local {got['local']}; a train "
                f"step {got['step_ms']:.1f} ms (CUDA events); one gradient "
                f"{1e3 * got['grad_s']:.1f} ms, gloo by op (ms / calls) "
                f"{ops}; FSDP gathers {got['gathered_mb']:.1f} MB onto the "
                f"rank; peak memory {got['peak_gb']:.3f} GB ({card})")
        if tag == "B":
            say(f"[vit_mesh] (B) the photonic_sim row-parallel entry at w2's "
                f"{r0['sim_shape']}: bitwise the unsharded entry "
                f"{r0['sim_bitwise']} (max diff {r0['sim_maxdiff']})")
            if not all(r["sim_bitwise"] for r in rs):
                failures.append("4l (B): the photonic_sim row-parallel "
                                "entry is not bitwise the unsharded one")
        if tag == "C":
            say(f"[vit_mesh] (C) {VM_STEPS} steps through train_loop (pruning "
                f"on) in {r0['train_s']:.2f}s: losses "
                + " ".join(f"{x:.4f}" for x in r0["losses"])
                + f"; resumed from step {VM_RESUME_AT} bitwise "
                f"{r0['resumed_bitwise']}; one-device restore of the "
                f"gathered state {r0['restored']}")
            if not all(r["resumed_bitwise"] for r in rs):
                failures.append("4l (C): the resumed run is not bitwise the "
                                "straight one")
            if len({tuple(r["losses"]) for r in rs}) != 1:
                failures.append("4l (C): the ranks' train losses differ")
            if r0["restored"] != (VM_STEPS, True):
                failures.append(f"4l (C): the one-device restore read "
                                f"{r0['restored']}")
    return failures


def report_vit_mesh_fused(ranks: dict, card: str) -> list:
    """4l (F)'s checks: on every rank the fused serve under (C)'s
    DEFAULT_RULES (model-sharded: B1, B2 and B4 twice a layer, no B3) and
    (D)'s MULTIPOD_RULES (split over ("pod", "data"): B1-B3, every B3 on
    its host-split binding) gives logits bitwise the one-device fused
    forward of the same cache, finite, of the batch's shape; the pod
    mesh's absmax scope left local must break that. The failures."""
    failures = []
    layers = vit_mesh_cfg().n_layers
    for tag, rule in (("C", "DEFAULT_RULES on (2, 2)"),
                      ("D", "MULTIPOD_RULES on (2, 1, 2)")):
        for i, r in enumerate(ranks[tag]):
            f = r["fused"]
            la = f["launches"]
            say(f"[vit_mesh] (F) {rule}, rank {i}: (C)'s trained weights "
                f"gathered, prepared and served on the fused point "
                f"({f['kept']} patches kept, wq {f['wq']} a rank): logits "
                f"{f['shape']} bitwise the one-device fused forward "
                f"{f['bitwise']} (max diff {f['max_diff']:.3e}); launches "
                f"{ {k: la.get(k, 0) for k in F_KERNELS} }"
                + ("" if f["planted_diff"] is None else
                   f"; planted local absmax scope: max diff "
                   f"{f['planted_diff']:.3e}") + f" ({card})")
            if not (f["bitwise"] and f["finite"]):
                failures.append(f"4l (F) {tag} rank {i}: the fused serve is "
                                f"not bitwise the one-device forward")
            b1, b2 = (la.get("photonic_matmul", 0),
                      la.get("flash_attention_masked", 0))
            b3, b4 = la.get("fused_ffn", 0), la.get("dequant_epilogue", 0)
            if tag == "C":
                bad = b1 <= 0 or b2 <= 0 or b3 or b4 != 2 * layers
            else:
                bad = (b1 <= 0 or b2 <= 0 or b3 != layers or b4
                       or la.get("fused_ffn.kmajor.split", 0) != b3)
            if bad:
                failures.append(f"4l (F) {tag} rank {i}: launches {la}")
            if tag == "D" and f["planted_equal"]:
                failures.append(f"4l (F) D rank {i}: the planted local "
                                f"absmax scope passes the bitwise check")
    return failures


def report_vit_mesh_micro(ranks: list, card: str) -> list:
    """4l (G)'s checks over (A)'s two ranks: at each size the k = 2
    step's weight scales and activation scopes bitwise (0 gaps), each
    microbatch's first activation scale (the images', before any GEMM)
    bitwise the one-device k = 2 step's; at smoke size every later
    activation scale within ``VM_MICRO_ACT_LIMIT`` of the one-device
    step's (a rank's GEMMs run at half the rows, in another summation
    order: not bitwise on the card, bitwise on the CPU); the gradient
    within 4x the 2-block order control (at smoke size also under
    ``VM_GRAD_LIMIT``), the ranks' losses equal; the rank-local row split
    planted must fail the first-scale check and, at smoke size, miss the
    later scales' limit. At full size the later scales' gap is a reading
    beside the order control's (the flips' cascade moves both). The
    failures."""
    failures = []
    for size in ("full", "smoke"):
        rs = [r[size] for r in ranks]
        r0 = rs[0]
        rel, worst, worst_name, n = r0["dist"]
        ctl = max(r0["controls"])
        bound = VM_CONTROL_FACTOR * ctl
        if size == "smoke":
            bound = min(bound, VM_GRAD_LIMIT)
        act = max(r["act"] for r in rs)
        say(f"[vit_mesh] (G) DATA_RULES on (data 2), {size}, {VM_MICRO} "
            f"microbatches (pruning off), each rank's rows its share of "
            f"every global microbatch: gradient against the one-device "
            f"{VM_MICRO}-microbatch step relative L2 {rel:.4e} (min leaf "
            f"corr {worst:.8f}, {worst_name}), order control "
            + ", ".join(f"{x:.4e}" for x in r0["controls"])
            + f", held to {bound:.4e}; scale gaps over the ranks: weight "
            f"{max(r['weight'] for r in rs):.4e}, activation scope "
            f"{max(r['scope'] for r in rs):.4e}, each microbatch's first "
            f"activation scale bitwise {all(r['first_equal'] for r in rs)}, "
            f"the later ones from the one-device step's {act:.4e} "
            + (f"(held to {VM_MICRO_ACT_LIMIT:.0e})" if size == "smoke"
               else "(a reading)")
            + f", the order control's {r0['control_act']:.4e}; "
            f"planted rank-local row split: activation gap "
            f"{max(r['fault_act'] for r in rs):.4e}, first scales bitwise "
            f"{all(r['fault_first_equal'] for r in rs)} ({card})")
        if not rel <= bound:
            failures.append(f"4l (G) {size}: gradient {rel} beyond {bound}")
        if len({r["loss"] for r in rs}) != 1:
            failures.append(f"4l (G) {size}: the ranks' losses differ")
        for r in rs:
            if r["weight"] or r["scope"] or not r["first_equal"]:
                failures.append(f"4l (G) {size}: a scale is not bitwise "
                                f"(weight {r['weight']}, scope "
                                f"{r['scope']}, first {r['first_equal']})")
            if r["fault_first_equal"] or not r["fault_act"] > 0:
                failures.append(f"4l (G) {size}: the planted row split "
                                f"passes the scale check")
            if size == "smoke" and not r["act"] <= VM_MICRO_ACT_LIMIT:
                failures.append(f"4l (G) smoke: a later activation scale "
                                f"is {r['act']} from the one-device step's, "
                                f"beyond {VM_MICRO_ACT_LIMIT}")
            if size == "smoke" and not r["fault_act"] > VM_MICRO_ACT_LIMIT:
                failures.append(f"4l (G) smoke: the planted row split's "
                                f"later scales ({r['fault_act']}) pass "
                                f"{VM_MICRO_ACT_LIMIT}")
    return failures


def _times(x: float, bound: float) -> float:
    """x in multiples of ``bound`` (inf over a bound of 0)."""
    return x / bound if bound else float("inf")


def _report_vit_mesh_scales(tag: str, rs: list, card: str) -> list:
    """4l's full-size checks that do not cascade, over every rank: every
    weight scale of the forward's fake quants bitwise the one-device
    forward's, every activation scale bitwise the whole mesh's (the MAX of
    the rank-local absmaxes), every FSDP block's gradient bitwise the
    group's mean; beside them the activation scales' gap from the
    one-device forward's (a reading: the activations drift as the
    gradient does) and the planted fault's gaps. The list of what
    failed."""
    failures = []
    ctl_act = max(x["act"] for x in rs[0]["full"]["one"]["controls"])

    def worst(key):
        gaps = [r["full"][key] for r in rs]
        return {k: (None if gaps[0][k] is None
                    else max(g[k] for g in gaps)) for k in gaps[0]}

    def line(g):
        return (f"weight scales {g['weight']:.4e} from the one-device "
                f"forward's, activation scales {g['scope']:.4e} from the "
                f"whole mesh's, FSDP blocks "
                + ("none gathered" if g["fsdp"] is None
                   else f"{g['fsdp']:.4e}")
                + f" from the group's mean (relative); activation scales "
                f"{g['act']:.4e} from the one-device forward's")
    g = worst("gaps")
    say(f"[vit_mesh] ({tag}) full, the checks that do not cascade over "
        f"{len(rs)} ranks (each held bitwise): {line(g)} (a reading; the "
        f"order controls' largest {ctl_act:.4e}) ({card})")
    for k in ("weight", "scope", "fsdp"):
        if g[k] not in (None, 0.0):
            failures.append(f"4l ({tag}) full: the {k} gap {g[k]} is not 0")
    if "fault_gaps" in rs[0]["full"]:
        f = worst("fault_gaps")
        say(f"[vit_mesh] ({tag}) full, planted fault ({VM_FAULTS[tag]}): "
            f"{line(f)} ({card})")
        key = {"A": "scope", "B": "weight", "C": "fsdp"}[tag]
        if not (f[key] or 0.0) > 0.0:
            failures.append(f"4l ({tag}) full: the planted fault "
                            f"({VM_FAULTS[tag]}) passed its check ({key})")
    return failures


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def main() -> int:
    # path 4i runs under deterministic algorithms, which need cuBLAS's
    # fixed workspace, set before the first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    stamp("build")

    # -- 3. kernel checks --------------------------------------------------
    errs = check_kernels(torch, dev)
    errs.update(check_lm_kernels(torch, dev))
    for kname, e in check_tp_kernels(torch, dev).items():
        errs[kname] = max(errs[kname], e)
    for kname, e in check_hybrid_kernels(torch, dev).items():
        errs[kname] = max(errs[kname], e)
    for kname, e in check_hybrid_rank_kernels(torch, dev).items():
        errs[kname] = max(errs[kname], e)
    errs["flash_decode_partial"] = max(check_partial_kernel(torch, dev),
                                       check_ring_partial_kernel(torch, dev))
    errs.update(check_b4(torch, dev))
    # B1 and B3 at the bit plan's widths
    plan_calls = plan_kernel_calls(torch, dev)
    for (kname, _), (_, check) in plan_calls.items():
        errs[kname] = max(errs[kname], check())

    stamp("phase 3 (kernel checks)")

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

    stamp("path 4a")

    # -- [bitplan]: 4a under a per-layer bit plan, then calibrate_bits ------
    bitplan = run_bitplan(torch, cfg, sc, params, streams, server, card)

    stamp("bitplan")

    # -- 4b. main path: LM serving -----------------------------------------
    lm = run_lm(torch, dev, card)
    launches.update(lm["launches"])

    stamp("path 4b")

    # -- 4c. main path: model-sharded ViT serving ----------------------------
    sharded = run_sharded(torch, dev, card, serving_cfg("large", 224))
    r0 = sharded["ranks"][0]
    launches["dequant_epilogue"] = r0["launches"].get("dequant_epilogue", 0)

    stamp("path 4c")

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
    tp_ms = time_tp_kernels(torch, dev, card)
    for entry in kernels:
        if entry["name"] in tp_ms:
            entry["tp_rank"] = tp_ms[entry["name"]]
    # B5 / B6 at recurrentgemma-9b's shapes; their launches come with 4m
    hy_ms = time_hybrid_kernels(torch, dev, card)
    for entry in kernels:
        if entry["name"] in hy_ms:
            entry["hybrid"] = hy_ms[entry["name"]]
    # B5 / B6 at a 4n (B) rank's shapes; their launches come with 4n
    hr_ms = time_hybrid_rank_kernels(torch, dev, card)
    for entry in kernels:
        if entry["name"] in hr_ms:
            entry["hybrid_rank"] = hr_ms[entry["name"]]
    # B5 / B6 at each 4p config's shapes (B5's bf16 entry at head dim 160
    # for stablelm-12b); their launches come with 4p
    dense_ms = time_dense_kernels(torch, dev, card)
    for entry in kernels:
        if entry["name"] in dense_ms:
            entry["dense_configs"] = dense_ms[entry["name"]]
    # B6's partial entry at 4k's rank shape; its launches come with 4k
    partial_entry = time_partial_kernel(torch, dev, card)
    partial_entry["max_abs_err"] = errs["flash_decode_partial"]
    # and at 4o's rank shape (D 256 / G 16 on a ring block); its launches
    # come with 4o
    partial_entry["ring_rank"] = time_ring_partial_kernel(torch, dev, card)

    stamp("phase 5 (numbers)")

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

    stamp("path 4d")

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

    stamp("path 4e")

    # -- 4f. [control]: the serving control plane on 4a's model and traffic
    # (after 4e, before the profiled phases); (a)'s launches join the counts
    t0 = time.perf_counter()
    control = run_control(torch, dev, card, cfg, sc, params, streams, server)
    for entry in kernels:
        entry["launches"] += control["launches"].get(entry["name"], 0)
    say(f"[control] path 4f in {time.perf_counter() - t0:.2f}s; launches on "
        f"the main paths with 4f's (a): "
        f"{ {e['name']: e['launches'] for e in kernels} }")

    stamp("path 4f")

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

    stamp("path 4g")

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

    stamp("path 4h")

    # -- 4i. [train]: ViT training on opto-vit-base-224 + MGNet (after 4h,
    # before the profiled phases); (D)'s launches join the counts
    train = run_train(torch, dev, card)
    for entry in kernels:
        entry["launches"] += train["launches"].get(entry["name"], 0)
    say(f"[train] launches on the main paths with 4i's (D): "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del train
    torch.cuda.empty_cache()

    stamp("path 4i")

    # -- 4j. [lm_mesh]: qwen2-1.5b tensor- and data-parallel on 2 gloo
    # ranks on the card (after 4i, before the profiled phases); rank 0's
    # (A) and (B) launches join the counts, and each kernel of its path
    # records them under ``tp_rank``
    # 4k's ranks start first and run beside 4j's, then 4l's beside 4k's
    # (``in_background``)
    # 4p (D) first, alone on the card: its ~31 GiB peak does not fit
    # beside the ranks' training
    run_dense_train(torch, dev, card)
    stamp("path 4p (D)")
    fsdp_started = start_lm_fsdp(lm)
    mesh_started = start_lm_mesh(lm)

    # -- 4p. [dense]: the dense family's other configs on one card, in the
    # foreground while 4j's and 4k's gloo ranks run beside it; (A)-(C)'s
    # launches join the counts, and B5's and B6's ``dense_configs``
    # entries record each config's
    dense = run_dense_configs(torch, dev, card)
    for entry in kernels:
        for arch, *_ in DP_CONFIGS:
            n = dense[arch].get(entry["name"], 0)
            entry["launches"] += n
            if "dense_configs" in entry:
                entry["dense_configs"][arch]["launches"] = n
    say(f"[dense] launches on the main paths with 4p's: "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del dense

    stamp("path 4p")

    lm_mesh = run_lm_mesh(torch, dev, card, lm, mesh_started)
    vit_started = start_vit_mesh()
    for entry in kernels:
        n = (lm_mesh["launches"].get(entry["name"], 0)
             + lm_mesh["launches8"].get(entry["name"], 0))
        entry["launches"] += n
        if "tp_rank" in entry:
            entry["tp_rank"]["launches"] = n
    say(f"[lm_mesh] launches on the main paths with 4j's rank 0: "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    peak_4j = lm_mesh["peak_gb"]
    del lm_mesh
    torch.cuda.empty_cache()

    stamp("path 4j")

    # -- 4k. [lm_fsdp]: qwen2-1.5b under DEFAULT_RULES / MULTIPOD_RULES on
    # 4 gloo ranks on the card (after 4j, before the profiled phases);
    # rank 0's (A) and (B) launches join the counts, B6's partial entry
    # its own
    lm_fsdp = run_lm_fsdp(torch, dev, card, lm, peak_4j, fsdp_started)
    for entry in kernels:
        entry["launches"] += (lm_fsdp["launches"].get(entry["name"], 0)
                              + lm_fsdp["launches8"].get(entry["name"], 0))
    partial_entry["launches"] = lm_fsdp["launches"].get(
        "flash_decode_partial", 0)
    kernels.append(partial_entry)
    say(f"[lm_fsdp] launches on the main paths with 4k's rank 0: "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del lm_fsdp
    torch.cuda.empty_cache()

    stamp("path 4k")

    # -- 4l. [vit_mesh]: ViT QAT training under DATA_RULES, MODEL_RULES,
    # DEFAULT_RULES and MULTIPOD_RULES on gloo ranks on the card (after 4k,
    # before the profiled phases); (E)'s launches join the counts
    vit_mesh = run_vit_mesh(torch, dev, card, vit_started)
    for entry in kernels:
        entry["launches"] += vit_mesh["launches"].get(entry["name"], 0)
    say(f"[vit_mesh] launches on the main paths with 4l's (E): "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del vit_mesh
    torch.cuda.empty_cache()

    stamp("path 4l")

    # -- 4o's 4 gloo ranks start here: their (A) runs beside 4m, their (B)
    # once 4m has ended (``go``)
    import tempfile
    o_dir = tempfile.mkdtemp(prefix="chip_smoke_4o_")
    go = os.path.join(o_dir, "go")
    o_started = start_hybrid_fsdp(go)

    # -- 4m. [hybrid]: recurrentgemma-9b at full width on B5 / B6 (after 4l,
    # before the profiled phases); (A)'s launches join the counts, and
    # B5's and B6's ``hybrid`` entries record them
    try:
        hybrid = run_hybrid(torch, dev, card)
        say(f"[hybrid_fsdp] at 4m's end, beside 4o's ranks: the card "
            f"{card_memory(torch)} (mem_get_info); 4m's peak "
            f"{hybrid['peak_gb'] * 2 ** 30 / 1e9:.2f} GB")
    finally:
        torch.cuda.empty_cache()
        open(go, "w").close()
    for entry in kernels:
        n = hybrid["launches"].get(entry["name"], 0)
        entry["launches"] += n
        if "hybrid" in entry:
            entry["hybrid"]["launches"] = n
    say(f"[hybrid] launches on the main paths with 4m's (A): "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    say(f"[numbers] recurrentgemma-9b decode: {hybrid['tps']:.2f} tok/s over "
        f"the generate loop ({LM_BATCH} x {LM_GEN}), one step "
        f"{hybrid['step_ms']:.3f} ms, card busy {100 * hybrid['busy']:.1f}% "
        f"under the profiler; prefill {hybrid['prefill_tps']:.1f} tok/s at "
        f"{LM_BATCH} x {LM_PROMPT} (first call), "
        f"{hybrid['long_tps']:.1f} tok/s at 1 x {HY_LONG} ({card})")

    stamp("path 4m")

    # -- 4o. [hybrid_fsdp]: recurrentgemma-9b under DEFAULT_RULES /
    # MULTIPOD_RULES on 4 gloo ranks (their (A) beside 4m, their (B)
    # after it); rank 0's (A) launches join the counts, and B6 partial's
    # ``ring_rank`` entry records its own
    import shutil
    try:
        fsdp_hy = run_hybrid_fsdp(torch, card, o_started,
                                  hybrid["peak_gb"] * 2 ** 30 / 1e9)
    finally:
        shutil.rmtree(o_dir, ignore_errors=True)
    for entry in kernels:
        entry["launches"] += fsdp_hy["launches"].get(entry["name"], 0)
    partial_entry["ring_rank"]["launches"] = fsdp_hy["launches"].get(
        "flash_decode_partial", 0)
    say(f"[hybrid_fsdp] launches on the main paths with 4o (A)'s rank 0: "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del fsdp_hy
    torch.cuda.empty_cache()

    stamp("path 4o")

    # -- 4n. [hybrid_train] / [hybrid_mesh]: recurrentgemma-9b trained on
    # the card, then tensor- and data-parallel on 2 gloo ranks (after 4m,
    # before the profiled phases); rank 0's (B) launches join the counts,
    # and B5's and B6's ``hybrid_rank`` entries record them
    t0 = time.perf_counter()
    trained = run_hybrid_train(torch, dev, card)
    torch.cuda.empty_cache()
    mesh_hy = run_hybrid_mesh(torch, dev, card, hybrid, trained)
    for entry in kernels:
        n = mesh_hy["launches"].get(entry["name"], 0)
        entry["launches"] += n
        if "hybrid_rank" in entry:
            entry["hybrid_rank"]["launches"] = n
    say(f"[hybrid_mesh] path 4n in {time.perf_counter() - t0:.1f}s; launches "
        f"on the main paths with 4n (B)'s rank 0: "
        f"{ {e['name']: e['launches'] for e in kernels} } ({card})")
    del hybrid, trained, mesh_hy
    torch.cuda.empty_cache()

    stamp("path 4n")

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
    stamp("the profiled phases")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
