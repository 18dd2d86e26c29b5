"""Multi-stream session server: many cameras, one accelerator (the
reference's src/repro/serving/server.py, serving main path).

Per ingest chunk of each stream, in round-robin order:

  1. the chunk arrives through the session's double-buffered ingest
     (``data.pipeline.prefetch_to_device``: pinned buffers, a copy stream);
  2. the temporal mask cache decides which frames MGNet re-scores
     (``mgnet_scores`` on the int8 photonic matmul kernel);
  3. ``embed_patches`` embeds the whole chunk;
  4. one stable descending argsort of the region scores, then a per-bucket
     top-k gather (``_gather_topk_rows``) of each frame's routed bucket, or
     under ``one_shape`` one cap-size permutation for every bucket;
  5. the micro-batcher queues the groups keyed (bucket, session), so every
     encode launch holds one stream's frames and its activation absmax
     scope is one stream (``mix_streams`` keys the bare bucket instead and
     fills launches across streams);
  6. every ready flush, interleaved ``interleave_depth`` launches a session
     per pass, runs ``forward_vit_tokens`` under the server's policy (the
     serving default is the fused point: int8 photonic matmul + RoI-masked
     flash attention + fused FFN over the quantize-once int8 cache; any
     other backends run the composed dispatch, and ``attn_impl=
     "decomposed"`` the Eq. 2 attention), then final LayerNorm -> head ->
     argmax; a ``max_wait_chunks`` deadline pad-flushes queues that waited
     too long.

The quantize-once cache is made only under a photonic policy, as the
reference makes it: under ``bf16`` or ``qat`` every matmul reads the raw
float weights.

``run_dense`` is the mask-mode dense baseline: the same gating, but every
ingest chunk is encoded at all N patches by ``forward_vit_masked`` with
the RoI mask on the attention key axis (compute not reduced), billed at N
patches a frame.

Warm start (``ServerConfig.warm_start``, the default) runs every stage the
loop can reach once before any stream starts. On the card, and unsharded,
it also captures each bucket's encode as one CUDA graph (``self.graphs``,
keyed by bucket), under every policy: the port's counterpart of the
reference's per-bucket ``jax.jit`` compile, after which a flush is one
copy into the graph's static input and one replay. ``run_dense`` on such
a server captures its chunk encode the first time it runs. A failed
capture raises; ``warm_start=False`` (``--no-warm-start``) is the only way
to serve eagerly on the card.

Model-sharded serving (``ServerConfig.model_shards`` = M > 1): every rank
of a ``torch.distributed`` world of W = D x M ranks runs this same loop
over the same streams. The gate, embed, routing and micro-batcher are
deterministic and run replicated; only the encode is sharded, over the
2-D ("data", "model") mesh of ``launch.mesh.make_serving_mesh``, on this
rank's shard of the weight cache (``models/vit.py::serving_cache``),
through ``models/sharded_encoder.py``. Every other policy (composed, or
noisy) holds the whole cache and runs the data-split encode below over
"data", replicated over "model". Every rank ends with the same
predictions.
Its collectives go through gloo and the host, which no CUDA graph can
hold, so a sharded server warms eagerly and captures nothing.

The 1-D data mesh (``ServerConfig.mesh="auto"``, the default, on a world
of W > 1 ranks without model shards, e.g. under ``torchrun``): every rank
runs the same loop over the same streams, the gate, embed and routing
replicated as above, and holds the whole replicated cache. Each flush of
B rows is encoded B/D rows a rank with every per-launch absmax scope
MAX-reduced over "data" (B1's activation scales, B3's x and hidden
scales through B3's host-split binding) and the logits all-gathered
(``models/vit.py::encode_tokens``), so every rank's predictions are
bitwise the unsharded serve's; a flush whose B does not divide D is
encoded whole on every rank. Every policy one device serves takes the
split: composed ones scope their activation absmaxes the same way, and
under noise each rank's readout shot draws are its rows of the whole
flush's draw (``core/noise.py::readout_noise``), so the split serve is
the unsplit serve's arithmetic. A policy that asks for the fused FFN
with weights the fused encode cannot take raises with the reason at
construction (never a quiet composed serve). Its ranks warm eagerly, as
a model-sharded server's do.
``mesh="off"`` builds no mesh: each rank then serves on its own.

Mixed precision (``ServerConfig.bit_plan``, ``--bit-plan``): the shared
cache is quantized from the raw weights (``self._raw_params``) under a
per-layer / per-tensor bit plan (core/bitalloc.py) before the warm start,
so B1 and B3 run each layer at its width. ``calibrate_bits``
(``--bit-budget``) derives a plan from the sensitivity of each layer on
the first session's leading frames and re-quantizes the cache. Every CUDA
graph reads the cache it was captured over (``EncodeGraph.params`` keeps
it alive), so replacing the cache drops the graphs and captures each
warmed bucket again.

Energy: each session's ``StreamAccounting`` bills every encode at its
bucket (each layer at its planned width) and every MGNet scoring, so each
``StreamResult`` carries the accelerator model's KFPS/W and energy per
frame.

Calibrated device noise (``cfg.noise``, a ``core.noise.NoiseSpec``,
``--noise``): the server owns one ``DriftState`` (one device, one thermal
history for every stream) and one device state tensor. Before every
noisy stage (embed, encode, a noisy gate) the state is written into that
tensor and the stage runs under a fresh noise scope over it, so a
bucket's CUDA graph, captured over the tensor, draws at each replay what
the eager encode of the state written draws. Each flush ages the device
by its live frames (``_advance_drift``); once the drift crosses
``recal_bound_nm``, ``recalibrate`` resets the drift and bills a
re-tuning pass to every live stream (the reference re-derives the cache
from the raw weights, which gives bitwise the cache already live: it
stays, and so do the graphs).
The gate scores clean unless ``noisy_gate``; ``calibrate_bits`` scores
clean. The fused entries are the clean digital contract and raise under
noise: a noisy server names composed backends (``photonic_sim`` or
``photonic_pallas`` matmuls, ``flash`` or ``xla`` attention, ``xla`` FFN;
photonic_pallas + flash raises too). On a mesh every rank holds the same
``DriftState`` and state tensor, advances them a flush as one device
does and recalibrates at the same flush; the encode splits over "data".

The serving control plane (``ServerConfig.autotune``, ``--autotune``;
``serving/control/``): ``autotune_prepare`` probes which buckets the
sessions' leading frames route to, prices each probed bucket on the H100
roofline (``EncodeCostModel``), which warms it (on the card its CUDA
graph is captured then), and stands up the controller. The serve loop
then reads ``controller.knobs`` every round (the deadline, the interleave
depth, per-bucket flush thresholds), times every flush (launch to the
predictions materialized: one stream sync a flush, which costs the
timed server its asynchronous overlap) into the telemetry ring the
controller calibrates against, and calls ``controller.step`` every
``retune_every`` frames. ``watchdog=True`` times the flushes too and
feeds a ``StragglerDetector`` (``straggler_flags``). An untimed server
adds no sync.

Faults, checkpoints and migration (``ServerConfig.faults``, a
``serving.faults.FaultSpec``; ``--flush-fault-rate`` and the other fault
flags): a transient flush fault retries the flush with bounded
exponential backoff, a transient ingest fault retries the chunk next
round (checked before ``next_batch``, so it never consumes a chunk from
the pinned prefetch ring), a fatal fault or exhausted retries quarantine
the owning session only (``_fail_sessions``: its queued rows discarded,
its result ``poisoned``), and any other exception fails the serve as a
``ServeError`` naming the bucket, sessions and round, with the results
of the sessions that had drained. ``max_pending_rows`` sheds ingest
chunks above a queue bound; an injected stall syncs the stream and sleeps
(the watchdog's target). Without a spec there is no injector: every seam
is an ``if injector is not None`` check, with no sync and no host copy.
``serve(max_rounds=n)`` pauses after n rounds (the next ``serve()``
resumes at the same cursors); ``checkpoint`` snapshots every live
session (ingest cursor, mask cache, accounting, deferred predictions,
queued rows copied to the host) with the DriftState and the loop's
cursors, every ``checkpoint_every`` rounds or on demand, through
``checkpoint.save`` (the reference's format). ``restore_checkpoint``
rebuilds them in a fresh server, whose queued rows go back on its device
and whose first noisy stage rewrites the state tensor, so the remaining
predictions are bitwise the uninterrupted serve's;
``serving.faults.serve_with_restarts`` drives that across crashes.
``export_session`` / ``adopt_session`` move one live stream between
servers mid-stream. A restored or adopting server serves through the
graphs of its own warm start, over its own cache: no graph crosses
servers.

Several servers behind one router (placement, migration, drain) are
``serving/fleet.py``'s ``FleetRouter``.

CLI (the card; ``--device cpu`` runs the plain PyTorch versions):

    PYTHONPATH=src python -m repro_torch.serving.server --streams 2 --frames 32
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --one-shape --max-wait 1 --trim-dead-buckets
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --bit-plan 8,6,4,8 --json        # or --bit-budget 6
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --attn-backend flash --ffn-backend xla --attn-impl decomposed
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.serving.server \\
        --smoke --device cpu --model-shards 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.serving.server \\
        --smoke --device cpu            # the 1-D data mesh (--mesh auto)
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --backend photonic_sim --ffn-backend xla --noise \\
        --drift-rate-nm 0.01 --recal-bound-nm 0.08
    PYTHONPATH=src python -m repro_torch.serving.server --variant tiny \\
        --img-size 96 --device cpu    # the reference's default model
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --autotune --retune-every 4 --assert-converged
    PYTHONPATH=src python -m repro_torch.serving.server --smoke --device cpu \\
        --streams 3 --frames 24 --flush-fault-rate 0.1 --hard-fail-session 1 \\
        --checkpoint-dir /tmp/ckpt --checkpoint-every 1 --json
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import time
import warnings

import numpy as np
import torch

from repro_torch.bridge import from_jax_params, init_vit, to_device
from repro_torch.checkpoint.checkpoint import latest_step, restore_flat
from repro_torch.checkpoint.checkpoint import save as _ckpt_save
from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.core import bitalloc
from repro_torch.core.backend import ExecPolicy, prepare_params
from repro_torch.core.mgnet import mask_budget, mgnet_scores
from repro_torch.core.noise import DriftState, NoiseSpec, noise_scope
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.device import full_precision_matmuls, resolve_device
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.distributed.sharding import (ShardingCtx, rules_for_mesh,
                                              use_sharding)
from repro_torch.kernels import _build
from repro_torch.launch.mesh import init_from_env, make_serving_mesh
from repro_torch.models.sharded_encoder import \
    sharded_encode_ineligible_reason
from repro_torch.models.vit import (_fused_encoder_ineligible_reason,
                                    embed_patches, forward_vit_masked,
                                    forward_vit_tokens, mgnet_config,
                                    serving_cache)
from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.mask_cache import TemporalMaskCache
from repro_torch.serving.control import (Controller, ControllerConfig,
                                         EncodeCostModel, FlushTelemetry,
                                         TunedKnobs)
from repro_torch.serving.faults import (CheckpointFault, FatalFault,
                                        FaultInjector, FaultSpec,
                                        ServeError, ServerCrash,
                                        SessionFailure, TransientFault)
from repro_torch.serving.scheduler import FrameBatch, MicroBatcher
from repro_torch.serving.session import (ServingConfig, StreamResult,
                                         StreamSession)

__all__ = ["StreamServer", "ServerConfig", "EncodeGraph", "serving_cfg",
           "smoke_cfg", "interleave_rounds", "with_backends", "build_parser",
           "config_from_args", "main"]


@dataclasses.dataclass(frozen=True)
class ServerConfig(ServingConfig):
    """ServingConfig + the multi-stream knobs."""

    max_wait_chunks: int = 0     # > 0: pad-flush a partial micro-batch after
    #                              this many scheduling rounds (0 keeps
    #                              frames queued until the bucket fills or
    #                              the stream ends: the bitwise-reproducible
    #                              default)
    mix_streams: bool = False    # fill one bucket's micro-batch from several
    #                              sessions (couples the w8a8 activation
    #                              scales of co-batched streams)
    warm_start: bool = True      # warm every stage at startup; on the card
    #                              (unsharded) capture one CUDA graph per
    #                              bucket encode
    mesh: str = "auto"           # "auto": on a world of > 1 ranks, split
    #                              the encode batch over the 1-D data mesh
    #                              (or the 2-D mesh of model_shards);
    #                              "off": never build a mesh
    model_shards: int = 0        # > 1: 2-D ("data", "model") serving mesh —
    #                              attention heads + d_ff shard over "model"
    #                              (MODEL_RULES), the fused encode runs
    #                              sharded (models/sharded_encoder.py),
    #                              bitwise-equal to unsharded with the FFN's
    #                              twin. 0/1 = unsharded
    interleave_depth: int = 1    # ready-flush launches per session per
    #                              rotation pass
    bit_plan: tuple = ()         # mixed-precision bit plan for the shared
    #                              weight cache (per-layer tuple or the dict
    #                              form, core/bitalloc.py); () = the
    #                              config's plan, else uniform quant_bits.
    #                              ``calibrate_bits`` derives one instead
    autotune: bool = False       # serving control plane: route-probe the
    #                              ladder, price the hit buckets on the
    #                              H100 roofline (pricing captures their
    #                              graphs), then run the online controller
    #                              (serving/control/); the constructor skips
    #                              the full-ladder warm start
    retune_every: int = 32       # frames between controller evaluations
    telemetry_window: int = 256  # flush-observation ring-buffer size
    watchdog: bool = False       # time every flush (one sync a flush, as
    #                              autotune) and feed a StragglerDetector
    #                              through the telemetry ring: anomalously
    #                              slow flushes land in ``straggler_flags``
    faults: FaultSpec | None = None  # deterministic fault injection
    #                              (serving/faults.py); None: no injector,
    #                              the fault-free instruction stream
    retry_limit: int = 3         # transient-fault retries a flush before
    #                              the owning session is quarantined
    retry_backoff_s: float = 0.002  # base of the bounded exponential
    #                              backoff between flush retries (doubles
    #                              an attempt, capped at 1 s; 0 disables)
    max_pending_rows: int = 0    # > 0: bound on the batcher's queued rows;
    #                              an ingest chunk arriving above it is
    #                              shed (dropped, counted per session)
    checkpoint_dir: str = ""     # root of the periodic snapshots
    checkpoint_every: int = 0    # > 0: snapshot every N scheduling rounds
    #                              (needs checkpoint_dir)
    checkpoint_keep: int = 3     # newest snapshots kept under the root

    @staticmethod
    def from_serving(sc: ServingConfig, **overrides) -> "ServerConfig":
        """ServerConfig carrying ``sc``'s fields plus ``overrides``; an
        ``sc`` that already is a ServerConfig keeps its server knobs."""
        src = type(sc) if isinstance(sc, ServerConfig) else ServingConfig
        base = {f.name: getattr(sc, f.name)
                for f in dataclasses.fields(src)}
        base.update(overrides)
        return ServerConfig(**base)


def _gather_topk_rows(tokens: torch.Tensor, order: torch.Tensor,
                      keep: int) -> torch.Tensor:
    """(C, N, d) tokens + (C, N) descending score order -> (C, keep, d): the
    top-``keep`` prefix of the shared order, what ``select_topk_patches``
    would select, without re-sorting per bucket."""
    idx = order[:, :keep, None].expand(-1, -1, tokens.shape[-1])
    return torch.gather(tokens, 1, idx)


def interleave_rounds(groups, depth: int = 1) -> list:
    """Round-robin merge, ``depth`` elements from each list per pass:
    [[a1, a2, a3], [b1]] -> [a1, b1, a2, a3] at depth 1. The order ready
    flushes run in: a session with a backlog yields to every other session
    with one ready after ``depth`` launches."""
    if depth < 1:
        raise ValueError("interleave depth must be >= 1")
    out, i = [], 0
    while True:
        row = [x for g in groups for x in g[i: i + depth]]
        if not row:
            return out
        out.extend(row)
        i += depth


def serving_cfg(variant: str = "base", img_size: int = 224) -> ArchConfig:
    """A ViT + MGNet config on the fused serving point (int8 photonic
    matmul + flash attention + fused FFN)."""
    from repro_torch.configs.opto_vit import get_config
    return get_config(variant, img_size=img_size, mgnet=True).with_(
        matmul_backend="photonic_pallas", attn_backend="flash",
        ffn_backend="fused")


def smoke_cfg() -> ArchConfig:
    """The reference's serving smoke config on the fused serving point:
    4 layers, d=64, 32x32 frames in 8x8 patches, MGNet embed 32 / 2 heads."""
    return smoke_variant(serving_cfg("tiny")).with_(
        mgnet_keep_ratio=0.5, mgnet_embed=32, mgnet_heads=2)


@dataclasses.dataclass
class EncodeGraph:
    """One bucket's encode captured as a CUDA graph: ``tokens`` is its
    static input, ``logits`` its static output (overwritten by the next
    replay: clone what must outlive it), ``launches`` the kernel launches
    one replay makes (``_build.captured_launches``). ``params`` is the
    weight cache the graph reads: held here so its memory lives as long as
    the graph, which replays that cache whatever the server holds now.
    The dense baseline's graph takes a chunk's frames as ``tokens`` and
    its RoI mask as ``mask``."""

    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor
    logits: torch.Tensor
    launches: collections.Counter
    params: dict
    mask: torch.Tensor | None = None

    def replay(self, tokens: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
        """Encode ``tokens`` (and ``mask``, the static inputs' shapes):
        copy, replay, return the static logits."""
        self.tokens.copy_(tokens)
        if mask is not None:
            self.mask.copy_(mask)
        self.graph.replay()
        _build.add_replay(self.launches)
        return self.logits


class StreamServer:
    """Shared serving resources + the multi-stream scheduling loop.

    ``params`` is the port's raw param tree (``bridge.from_jax_params``,
    on any device), or None to draw one with ``bridge.init_vit(seed, ...)``
    on the host. It is kept as ``_raw_params``. Under a photonic policy
    every matmul weight is quantized from it once, on ``device`` (default:
    the card), under ``serve_cfg.bit_plan`` (or ``cfg.bit_plan``) before
    any stream starts; under ``bf16`` or ``qat`` the raw weights are
    served, moved to ``device``, as the reference serves them. On the
    card the matmuls are set to full precision
    (``device.full_precision_matmuls``).
    ``serve_cfg`` is a ``ServerConfig`` (a plain ``ServingConfig`` takes
    its defaults, warm start included). With ``model_shards`` > 1 this
    process is one rank of a model-sharded mesh: it serves on
    ``cuda:(LOCAL_RANK % device_count)`` (or the CPU) and keeps only its
    shard of the cache on the fused point (the whole cache under any other
    policy). On a world of several ranks without model shards
    (``mesh="auto"``) it is one rank of the 1-D data mesh, on that device,
    with the whole cache.
    """

    def __init__(self, cfg: ArchConfig, serve_cfg: ServingConfig | None = None,
                 params: dict | None = None, n_classes: int = 10,
                 seed: int = 0, device=None):
        if not cfg.mgnet:
            raise ValueError("serving needs cfg.mgnet=True (the RoI gate is "
                             "the pipeline's first stage)")
        self.cfg = cfg
        sc = serve_cfg or ServerConfig()
        if not isinstance(sc, ServerConfig):
            sc = ServerConfig.from_serving(sc)
        self.serve_cfg = sc
        dev = resolve_device(device)
        if dev.type == "cuda":
            full_precision_matmuls()
        if sc.mesh not in ("auto", "off"):
            raise ValueError(f"mesh must be 'auto' or 'off', got {sc.mesh!r}")
        # mesh "auto": the 2-D mesh when model_shards > 1, the 1-D data
        # mesh on a world of more ranks, None on a world of one rank
        self.mesh = (make_serving_mesh(model=max(1, sc.model_shards),
                                       device=dev)
                     if sc.mesh == "auto" else None)
        self.device = self.mesh.device if self.mesh is not None else dev
        self._ctx = (ShardingCtx(self.mesh, rules_for_mesh(self.mesh))
                     if self.mesh is not None else None)
        self.policy = ExecPolicy.from_cfg(cfg, training=False)
        # calibrated device noise: the server's DriftState and the device
        # state tensor every noisy stage reads (written before each one)
        self.noise: NoiseSpec | None = cfg.noise
        self.drift = (DriftState.init(self.noise.seed)
                      if self.noise is not None else None)
        self._state_t = (torch.zeros(4, dtype=torch.int32,
                                     device=self.device)
                         if self.noise is not None else None)
        self._written: np.ndarray | None = None
        self._host_drift_nm = 0.0
        self.recalibrations = 0
        self.n_patches = (cfg.img_size // cfg.patch) ** 2
        self.ladder = BucketLadder.from_fractions(
            self.n_patches, self.serve_cfg.bucket_fractions)
        self.mcfg = mgnet_config(cfg)
        if params is None:
            params = from_jax_params(init_vit(seed, cfg, n_classes), "cpu")
        # the raw weights are kept: calibrate_bits re-quantizes from them
        self._raw_params = params
        self.layer_bits: tuple | None = None
        self.params = self._maybe_place(
            self._prepare(sc.bit_plan or cfg.bit_plan or None)
            if self.policy.is_photonic()
            else to_device(params, self.device))
        self._sessions: list[StreamSession] = []
        self._next_sid = 0
        self.batcher: MicroBatcher | None = None
        self.flush_log: list[tuple] = []   # (owner sids, bucket k, n_real)
        # the newest flush and its logits, for spot checks of the served
        # numbers against another execution of the same encode
        self.last_flush: FrameBatch | None = None
        self.last_logits: torch.Tensor | None = None
        self.last_drift: DriftState | None = None   # its noise state
        self.graphs: dict[int, EncodeGraph] = {}
        self.dense_graph: EncodeGraph | None = None   # run_dense's encode
        self.warmed: set[int] = set()      # buckets whose encode was warmed
        self.warm_s = 0.0
        self.calibrate_s = 0.0             # the last calibrate_bits' scoring
        self.recapture_s = 0.0             # and its graphs' re-capture
        self._graphed = False              # encodes warm into CUDA graphs
        # the control plane (autotune_prepare) and the flush watchdog
        self.cost_model = None
        self.controller = None
        self.telemetry = None
        self._watchdog = bool(sc.watchdog)
        if self._watchdog and not sc.autotune:
            self.telemetry = self._make_telemetry()
        self._round = 0                    # the scheduling round a flush ran in
        # faults: an injector only under a FaultSpec (the fault-free loop
        # runs the instruction stream it runs without one)
        self.faults: FaultSpec | None = sc.faults
        self._injector = (FaultInjector(sc.faults)
                          if sc.faults is not None else None)
        self.checkpoint_failures = 0
        self._inflight: dict | None = None  # a paused serve's loop state
        self._resume: tuple | None = None   # (rnd, offset) of a restore
        # autotune warms only the buckets its probe finds (pricing a bucket
        # captures its graph): a full-ladder warm start would capture the
        # dead buckets the probe exists to skip
        if sc.warm_start and not sc.autotune:
            self.warm_start()

    def _maybe_place(self, params):
        """The cache as this rank's encode reads it (``vit.serving_cache``):
        on a model-sharded mesh the fused point's "model" shard, prepared
        whole first so every per-out-channel scale is the unsharded one;
        everywhere else the whole cache (every other policy, noisy ones
        included, and the fused point on the data mesh run the data-split
        encode, replicated over "model"). A policy that asks for the fused
        FFN raises with the reason where the mesh's fused encode cannot
        take the weights, as one device raises at its first encode: a mesh
        never serves another encode quietly."""
        if self._ctx is None:
            return params
        sharded = self.mesh.axis_names == ("data", "model")
        if self.policy.resolve_ffn_backend() == "fused":
            reason = _fused_encoder_ineligible_reason(params, self.cfg,
                                                      self.policy)
            if reason is None and sharded:
                reason = sharded_encode_ineligible_reason(
                    params, self.cfg, self.policy, self._ctx)
            if reason is not None and sharded:
                raise ValueError(
                    f"model_shards={self.serve_cfg.model_shards} asks for "
                    f"the model-sharded encode, which cannot run: {reason}")
            if reason is not None:
                raise ValueError(
                    f"mesh='auto' on {self.mesh.world} ranks asks for the "
                    f"data-split encode, which cannot run: {reason}")
        return serving_cache(params, self.cfg, self.policy, self._ctx)

    def _prepare(self, plan) -> dict:
        """The cache quantized from the raw weights under ``plan`` (None:
        uniform ``quant_bits``). Sets ``policy.bit_plan`` to the plan's
        key, so the encode accepts the widths it differs from
        ``quant_bits`` by, and ``layer_bits`` (each layer's width, which
        the sessions' accounting bills)."""
        bits = self.cfg.quant_bits or 8
        n_layers = self.cfg.n_layers
        nplan = bitalloc.normalize_bit_plan(plan, n_layers, default=bits)
        self.policy.bit_plan = bitalloc.plan_key(nplan)
        self.layer_bits = (bitalloc.plan_layer_bits(nplan, n_layers)
                           if nplan is not None else None)
        return prepare_params(to_device(self._raw_params, self.device),
                              bits=bits, bit_plan=plan, n_layers=n_layers)

    def _install(self, params: dict) -> None:
        """Serve from ``params`` from now on. The graphs replay the cache
        they were captured over, so they are dropped, their memory handed
        back, and each bucket warmed before is captured again over the new
        cache (``recapture_s``); an eager warm start reads no cache and
        stands. A cost model (``autotune_prepare``) re-prices its buckets
        at the new cache's widths."""
        warmed = sorted(self.warmed)
        self.graphs = {}
        self.dense_graph = None
        self.params = params
        if self._graphed:
            self.warmed = set()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            for k in warmed:
                self._warm_bucket(k)
            torch.cuda.synchronize(self.device)
            self.recapture_s = time.perf_counter() - t0
        if self.cost_model is not None:
            # the prices follow the cache's widths (its layer_bits)
            self.cost_model = EncodeCostModel.from_server(
                self, buckets=tuple(self.cost_model.costs))
            if self.controller is not None:
                self.controller.cost_model = self.cost_model

    def add_session(self, stream: VideoStream, n_frames: int = 64,
                    start: int = 0) -> StreamSession:
        """Register a stream for the next ``serve()``; returns its session."""
        s = self._new_session(self._next_sid, stream, n_frames, start)
        self._next_sid += 1
        self._sessions.append(s)
        return s

    def _new_session(self, sid, stream, n_frames, start) -> StreamSession:
        return StreamSession(sid, stream, n_frames, start, self.serve_cfg,
                             self.cfg, ladder=self.ladder,
                             device=self.device, layer_bits=self.layer_bits)

    def _score_fn(self, frames: np.ndarray) -> np.ndarray:
        f = torch.from_numpy(frames).to(self.device)
        gpol = self.policy.gate_policy()
        with self._noise_ctx(gpol):
            s = mgnet_scores(self.params["mgnet"], f, self.mcfg, gpol)
        return s.float().cpu().numpy()

    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        with self._noise_ctx(self.policy):
            return embed_patches(self.params, frames, self.cfg, self.policy)

    # -- calibrated device noise + drift-triggered recalibration ------------

    def _write_state(self) -> None:
        """Write the current DriftState into the device state tensor (in
        stream order, after every launch queued before), unless it holds
        it already. Never called inside a graph capture."""
        if self.noise is None:
            return
        words = self.drift.words()
        if self._written is None or not np.array_equal(words,
                                                       self._written):
            self.drift.write(self._state_t)
            self._written = words

    def _scope(self):
        """A fresh noise scope of the current DriftState over the state
        tensor (which the caller has written), or nothing when clean."""
        if self.noise is None:
            return contextlib.nullcontext()
        return noise_scope(self.drift, self._state_t)

    def _noise_ctx(self, policy: ExecPolicy):
        """Write the state and open a scope for an eager noisy stage under
        ``policy`` (nothing when ``policy`` is clean)."""
        if policy.noise is None:
            return contextlib.nullcontext()
        self._write_state()
        return self._scope()

    def inject_drift(self, nm: float) -> None:
        """Add ``nm`` of resonance drift on top of the accumulated state (a
        thermal step for robustness experiments)."""
        if self.noise is None:
            raise ValueError("inject_drift needs cfg.noise set")
        self.drift = self.drift.with_drift(self.drift.drift_nm
                                           + np.float32(nm))
        self._host_drift_nm += float(nm)

    def _advance_drift(self, frames: int, extra_sessions=()) -> None:
        """Age the device by ``frames`` served frames; recalibrate once the
        drift (its host mirror, no device read) reaches the bound."""
        if self.noise is None or frames <= 0:
            return
        self.drift = self.drift.advance(self.noise, frames)
        self._host_drift_nm += frames * self.noise.drift_rate_nm
        if (self.noise.recal_bound_nm > 0.0
                and self._host_drift_nm >= self.noise.recal_bound_nm):
            self.recalibrate(extra_sessions)

    def recalibrate(self, extra_sessions=()) -> None:
        """Online MR re-tuning: the drift reset to zero, billed to every
        live session as one full-model tuning pass. The reference re-derives
        the cache from the raw weights under the active plan; the same
        weights and plan give bitwise the same codes, so the live cache
        already is that re-derivation and stays as it is (every CUDA graph
        reads it, so the graphs stay valid, as the reference keeps its AOT
        executables)."""
        if self.drift is not None:
            self.drift = self.drift.reset_drift()
        self._host_drift_nm = 0.0
        self.recalibrations += 1
        for s in list(self._sessions) + list(extra_sessions):
            if not s.finished:
                s.acct.add_recalibration()

    # -- encode: eager, or one CUDA graph per bucket -------------------------

    def _encode_eager(self, k: int, tokens: torch.Tensor) -> torch.Tensor:
        """Logits of one flush at bucket ``k``: (microbatch, k, d) tokens,
        or under ``one_shape`` (microbatch, cap, d) with ``kv_len`` k."""
        kv = k if self.serve_cfg.one_shape else None
        with use_sharding(self.mesh), self._scope():
            return forward_vit_tokens(self.params, tokens, self.cfg,
                                      self.policy, kv_len=kv,
                                      device=self.device)[0]

    def _encode(self, k: int, tokens: torch.Tensor) -> torch.Tensor:
        """One flush's logits: the bucket's graph once warm start captured
        graphs (a bucket without one yet is captured now, as the
        reference's jit compiles a bucket it meets first), else eager.
        Under noise the current DriftState is written first."""
        self._write_state()
        if k not in self.graphs and self._graphed:
            self._warm_bucket(k)
        g = self.graphs.get(k)
        return g.replay(tokens) if g is not None else self._encode_eager(
            k, tokens)

    def _flush_shape(self, k: int) -> tuple:
        t = self.ladder.cap if self.serve_cfg.one_shape else k
        return (self.serve_cfg.microbatch, t, self.cfg.d_model)

    def _capture(self, k: int) -> EncodeGraph:
        """Capture bucket ``k``'s encode as a CUDA graph (under noise, over
        the server's state tensor)."""
        self._write_state()
        static = torch.zeros(self._flush_shape(k), device=self.device)
        return self._capture_fn(f"k={k}", lambda: self._encode_eager(
            k, static), static)

    def _capture_fn(self, tag: str, fn, static: torch.Tensor,
                    mask: torch.Tensor | None = None) -> EncodeGraph:
        """Capture ``fn()``, which reads the static inputs ``static`` (and
        ``mask``), as a CUDA graph. It first runs eagerly on a side stream,
        so nothing runs for the first time inside the capture: the kernel
        library's load, each kernel's shared-memory attribute, the cached
        key masks of the flash attention wrapper. Raises with the reason
        if the capture fails (a composed policy whose encode cannot be
        captured too: it never serves eagerly instead), leaving the device
        out of capture mode and on the stream it was on (``torch.cuda.
        graph`` does not restore the stream when ending a broken capture
        raises), so the server can capture and serve again."""
        dev = self.device
        prev = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a graph held only by a dead reference cycle (a dropped server) is
        # destroyed when the cycle is collected, which inside a capture
        # invalidates it: no automatic collection runs during the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with _build.captured_launches() as launches, \
                    torch.cuda.graph(graph):
                logits = fn()
        except Exception as e:
            if torch.cuda.is_current_stream_capturing():
                with contextlib.suppress(Exception):
                    graph.capture_end()
            torch.cuda.set_stream(prev)
            raise RuntimeError(f"capturing the {tag} encode as a CUDA graph "
                               f"failed ({self.policy}): {e}") from e
        finally:
            if gc_on:
                gc.enable()
        return EncodeGraph(graph, static, logits, launches, self.params, mask)

    # -- warm start ----------------------------------------------------------

    def warm_start(self, buckets: tuple | None = None) -> float:
        """Run every stage the serving loop can hit once before a stream
        starts: the gate, the embed, the order and the gathers, and each
        bucket's encode at its flush shape (``buckets`` restricts the
        encodes to those ladder sizes). On the card and unsharded, each
        bucket's encode is captured as a CUDA graph (``self.graphs``) and
        later flushes replay it; on the CPU and on a mesh (gloo collectives
        through the host, which a graph cannot hold) the encodes run
        eagerly and nothing is captured. Returns the wall
        seconds, also kept as ``self.warm_s``. A bucket warmed already (an
        earlier warm start, or the control plane's pricing) is kept."""
        sc, cfg, dev = self.serve_cfg, self.cfg, self.device
        targets = tuple(k for k in self.ladder.sizes
                        if buckets is None or k in buckets)
        t0 = time.perf_counter()
        zf = np.zeros((sc.chunk, cfg.img_size, cfg.img_size, 3), np.float32)
        self._score_fn(zf)
        toks = self._embed(torch.from_numpy(zf).to(dev))
        order = torch.argsort(torch.zeros(sc.chunk, self.n_patches,
                                          device=dev),
                              dim=-1, descending=True, stable=True)
        for k in ((self.ladder.cap,) if sc.one_shape else targets):
            _gather_topk_rows(toks, order, k)
        for k in targets:
            self._warm_bucket(k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.warm_s = time.perf_counter() - t0
        return self.warm_s

    def _warm_bucket(self, k: int) -> None:
        """Warm bucket ``k``'s encode once (a bucket warmed already is left
        as it is): on the card and unsharded, capture its CUDA graph into
        ``self.graphs``, after which the server serves through graphs;
        on the CPU and on a mesh run its eager encode at the flush shape. The control plane's cost model prices a bucket
        through here, so pricing a bucket warms it."""
        if k in self.warmed:
            return
        self._graphed = self.device.type == "cuda" and self.mesh is None
        if self._graphed:
            self.graphs[k] = self._capture(k)
        else:
            self._write_state()
            self._encode_eager(k, torch.zeros(self._flush_shape(k),
                                              device=self.device))
        self.warmed.add(k)

    # -- dead-bucket trimming ------------------------------------------------

    def trim(self, dead, keep_cap: bool = True) -> tuple[int, ...]:
        """Drop ladder sizes (``StreamAccounting.dead_buckets()`` output)
        and their graphs; sessions not started yet are re-made on the
        trimmed ladder. ``keep_cap=False`` lets the cap go too (only safe
        under a ``force_bucket`` pin). Returns the sizes removed."""
        new = self.ladder.trim(dead, keep_cap=keep_cap)
        removed = tuple(sorted(set(self.ladder.sizes) - set(new.sizes)))
        self.ladder = new
        for k in removed:
            self.graphs.pop(k, None)
            self.warmed.discard(k)
        self._renew_unstarted()
        return removed

    def _renew_unstarted(self) -> None:
        """Re-make the sessions that have not started, so their histogram
        and accounting key the current ladder and bit plan (sids stay)."""
        self._sessions = [
            s if s.finished or s.frames_seen > 0
            else self._new_session(s.sid, s.stream, s.n_frames, s.start)
            for s in self._sessions]

    def _route_probe(self, calib_frames: int | None = None) -> set[int]:
        """The ladder buckets the registered sessions' leading frames route
        to: host-side scoring through throwaway mask caches, sessions
        untouched. Under a ``force_bucket`` pin the answer is exact by
        construction."""
        sc = self.serve_cfg
        if sc.force_bucket > 0:
            return {self.ladder.route(
                int(round(sc.force_bucket * self.n_patches)))}
        calib = calib_frames or 2 * sc.chunk
        calib = ((calib + sc.chunk - 1) // sc.chunk) * sc.chunk
        hit: set[int] = set()
        for s in self._sessions:
            if s.finished:
                continue
            cache = TemporalMaskCache(sc.mask_refresh, sc.delta_threshold)
            for ofs in range(0, calib, sc.chunk):
                sub = s.stream.frames_at(s.start + ofs, sc.chunk)
                scores, _ = cache.gate(sub["frames"], sub["frame_idx"],
                                       self._score_fn)
                hit |= set(int(k) for k in self.ladder.route_many(
                    mask_budget(scores, self.mcfg.t_reg)))
        return hit

    def calibrate_trim(self, calib_frames: int | None = None
                       ) -> tuple[int, ...]:
        """Route-only calibration: score the first ``calib_frames`` of every
        registered session (default two chunks), collect which buckets get
        hit, and ``trim`` the rest. Run before ``warm_start()`` so fewer
        encodes are warmed (on the card, fewer graphs captured).

        Calibration sees only its window: frames that later route to a
        trimmed bucket route up to the next surviving size (more tokens,
        possibly other predictions than an untrimmed run), so the
        interleaved-vs-sequential bitwise contract holds only against an
        equally trimmed solo server. A ``UserWarning`` says so whenever
        something is trimmed without a ``force_bucket`` pin."""
        sc = self.serve_cfg
        if not any(not s.finished for s in self._sessions):
            # nothing to calibrate against: an empty pass would declare
            # every non-cap bucket dead and collapse the ladder
            return ()
        hit = self._route_probe(calib_frames)
        dead = tuple(k for k in self.ladder.sizes if k not in hit)
        if not dead:
            return ()
        removed = self.trim(dead)
        if removed and sc.force_bucket <= 0:
            warnings.warn(
                f"calibrate_trim dropped buckets {list(removed)} from a "
                f"calibration window the streams may outgrow: budgets that "
                f"later route to a dropped size will route up to the next "
                f"surviving bucket (more tokens, possibly different "
                f"predictions than an untrimmed run)", stacklevel=2)
        return removed

    # -- sensitivity-driven bit allocation -----------------------------------

    def calibrate_bits(self, target_mean_bits: float,
                       calib_frames: int | None = None,
                       candidates: tuple = (6, 4)) -> tuple:
        """Derive a per-layer bit plan whose mean width is <=
        ``target_mean_bits`` and re-quantize the shared cache under it
        (``core.bitalloc.calibrate_bit_plan``). The calibration batch is
        the first unfinished session's leading ``calib_frames`` (default
        one chunk), embedded on the server's cache. Each layer is scored on
        the device, one at a time. The new cache replaces the old one
        (``_install``: graphs captured again); sessions not started yet are
        re-made so their accounting bills the plan's widths. Returns the
        plan; ``calibrate_s`` and ``recapture_s`` keep the wall seconds of
        the scoring and of the re-capture."""
        if not self.policy.is_photonic():
            raise ValueError("bit allocation needs a photonic backend (the "
                             "plan drives the quantize-once cache)")
        src = next((s for s in self._sessions if not s.finished), None)
        if src is None:
            raise ValueError("register at least one session before "
                             "calibrate_bits (it provides the calibration "
                             "frames)")
        n = calib_frames or self.serve_cfg.chunk
        frames = torch.from_numpy(
            src.stream.frames_at(src.start, n)["frames"]).to(self.device)
        t0 = time.perf_counter()
        # scored clean even under noise: the plan ranks layers by their
        # quantization sensitivity, not by one noise draw
        cpol = self.policy.without_noise()
        tokens = embed_patches(self.params, frames, self.cfg, cpol)
        plan = bitalloc.calibrate_bit_plan(
            self._raw_params, tokens, self.cfg, cpol,
            target_mean_bits=target_mean_bits, candidates=candidates,
            default=self.cfg.quant_bits or 8)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibrate_s = time.perf_counter() - t0
        self._install(self._maybe_place(self._prepare(plan)))
        self._renew_unstarted()
        return plan

    # -- serving control plane -----------------------------------------------

    def autotune_prepare(self, calib_frames: int | None = None):
        """Stand up the serving control plane (``serving/control/``):

        1. **Route probe** — host-side scoring of each session's leading
           frames finds which ladder buckets the workload can hit. Under
           a ``force_bucket`` pin the unreachable sizes are trimmed
           outright (route-invariant: every frame routes to the pin either
           way; without ``one_shape`` even the cap can go). Otherwise the
           ladder is left intact: the probe only decides which buckets are
           priced and warmed now, never where frames route, so predictions
           stay those of a statically-knobbed run wherever the knobs leave
           the flushes alone.
        2. **Cost model** — each probed bucket is priced on the H100
           roofline (``EncodeCostModel``); pricing warms it (on the card,
           unsharded, its CUDA graph is captured), so dead buckets are
           never captured. Then ``warm_start(buckets=)`` warms the gate,
           the embed and the gathers.
        3. **Controller** — the telemetry ring + the calibrating, clamped
           knob tuner; the serve loop reads ``controller.knobs`` every
           round and calls ``controller.step`` every ``retune_every``
           frames.

        Run it after ``calibrate_bits`` (as the CLI does); a later
        ``calibrate_bits`` re-prices the buckets at the new widths.
        Returns the controller."""
        sc = self.serve_cfg
        probed = self._route_probe(calib_frames)
        if sc.force_bucket > 0:
            dead = tuple(k for k in self.ladder.sizes if k not in probed)
            if dead:
                self.trim(dead, keep_cap=not sc.one_shape)
        self.cost_model = EncodeCostModel.from_server(
            self, buckets=tuple(sorted(probed & set(self.ladder.sizes))))
        self.warm_start(buckets=tuple(sorted(probed)))
        self.telemetry = self._make_telemetry()
        defaults = TunedKnobs(max_wait_chunks=sc.max_wait_chunks,
                              interleave_depth=sc.interleave_depth)
        self.controller = Controller(
            self.cost_model, self.telemetry, defaults,
            ControllerConfig(retune_every=sc.retune_every))
        return self.controller

    def _make_telemetry(self):
        """Flush-observation ring; with the watchdog on it carries a
        ``StragglerDetector``, so every timed flush feeds the median+MAD
        slow-flush estimate (``straggler_flags``)."""
        det = StragglerDetector() if self._watchdog else None
        return FlushTelemetry(self.serve_cfg.telemetry_window,
                              straggler=det)

    @property
    def straggler_flags(self) -> list:
        """Flush observations the watchdog flagged as anomalously slow
        (empty without ``watchdog=True``)."""
        return (list(self.telemetry.straggler_flags)
                if self.telemetry is not None else [])

    # -- the serving loop ----------------------------------------------------

    def serve(self, verbose: bool = False,
              max_rounds: int = 0) -> dict[int, StreamResult]:
        """Serve every registered session to completion, interleaved
        round-robin; returns ``{sid: StreamResult}``. Every result's
        ``wall_s`` is the loop's span (device work included), so the
        aggregate frames/s is ``sum(frames) / wall``. Under the control
        plane the loop reads ``controller.knobs`` every round and steps
        the controller every ``retune_every`` frames.

        ``max_rounds > 0`` pauses after that many scheduling rounds and
        returns ``{}``, holding the loop state (sessions, queued rows, the
        round and rotation cursors) in flight: the deterministic stop the
        checkpoint and migration surfaces work at. The next ``serve()``
        resumes where it paused. A paused segment's wall time includes its
        device work (the device is synced before the clock is read).

        Failures: a transient flush fault retries with bounded
        exponential backoff; a fatal fault or exhausted retries quarantine
        the owning session only (its ``StreamResult`` comes back
        ``poisoned`` with the reason) while the others serve to
        completion. Any other exception fails the serve as a
        ``ServeError`` naming the failing bucket, sessions and round, with
        the results of the sessions that had fully drained; the half-served
        sessions are abandoned, and the server serves the next sessions
        registered."""
        sc = self.serve_cfg
        if self._inflight is None:
            live = [s for s in self._sessions if not s.finished]
            if not live:
                return {}
            for s in live:
                s.open()
            self.batcher = MicroBatcher(sc.microbatch)
            self.flush_log = []
            rnd, offset = self._resume if self._resume else (0, 0)
            self._resume = None
            st = {"live": live, "rnd": rnd, "offset": offset,
                  "wall_s": 0.0, "retuned_at": 0,
                  "early": self._restore_pending(live)}
            self._inflight = st
        else:
            st = self._inflight
        live = st["live"]
        by_sid = {s.sid: s for s in live}
        t0 = time.perf_counter()
        try:
            done = self._serve_loop(st, by_sid, t0, verbose, max_rounds)
        except BaseException as e:
            # the half-served sessions are abandoned (re-opening them would
            # re-ingest and double-count); the drained ones lose nothing:
            # their results ride out on the ServeError
            st["wall_s"] += time.perf_counter() - t0
            wall = st["wall_s"]
            partial = {s.sid: s.finish(wall) for s in live
                       if s.drained and (s.failed_reason
                                         or s.acct.frames == s.frames_seen)}
            for s in live:
                s.finished = True
            self._inflight = None
            self._sessions = [s for s in self._sessions if not s.finished]
            if isinstance(e, ServeError):
                e.partial_results.update(partial)
                raise
            if not isinstance(e, Exception):
                raise               # an interrupt or exit stays what it is
            ctx = {"round": st["rnd"],
                   "sessions": [s.sid for s in live if not s.drained]}
            raise ServeError(
                f"serve() died at round {ctx['round']} (sessions "
                f"{ctx['sessions']} mid-stream): {e}", context=ctx,
                partial_results=partial) from e
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        st["wall_s"] += time.perf_counter() - t0
        if not done:
            return {}           # paused by max_rounds; serve() resumes
        wall = st["wall_s"]
        results = {s.sid: s.finish(wall) for s in live}
        self._inflight = None
        self._sessions = [s for s in self._sessions if not s.finished]
        return results

    def _serve_loop(self, st: dict, by_sid: dict, t0: float, verbose: bool,
                    max_rounds: int) -> bool:
        """Scheduling rounds until every live session drains (True) or
        ``max_rounds`` rounds ran (False: paused). The cursors (round,
        rotation offset) persist in ``st`` across pauses and checkpoints."""
        sc = self.serve_cfg
        ctl = self.controller
        inj = self._injector
        live = st["live"]
        rounds = 0
        early, st["early"] = st.get("early") or [], []
        if early:
            # flushes that filled while a snapshot's queued rows were
            # pushed back (none for a snapshot that kept each queue below
            # the micro-batch, but no frame is lost either way)
            self._round = st["rnd"]
            for fb in early:
                self._safe_finish(fb, by_sid)
        while any(not s.drained for s in live):
            if max_rounds and rounds >= max_rounds:
                return False
            rnd = st["rnd"]
            # the controller owns the re-timing knobs when present, re-read
            # every round so a step lands at once
            kn = ctl.knobs if ctl is not None else None
            max_wait = (kn.max_wait_chunks if kn is not None
                        else sc.max_wait_chunks)
            depth = (kn.interleave_depth if kn is not None
                     else sc.interleave_depth)
            offset = st["offset"]
            rot = live[offset:] + live[:offset]
            st["offset"] = (offset + 1) % len(live)
            per = {s.sid: [] for s in rot}
            late: list = []
            for s in rot:
                if s.ingest_done:
                    continue
                if (sc.max_pending_rows > 0
                        and self.batcher.pending >= sc.max_pending_rows):
                    # load shedding: the queue bound is hit, so this chunk
                    # is pulled off the sensor and dropped whole (deferring
                    # it could deadlock: without a deadline a partial queue
                    # fills only from its own session's later chunks)
                    batch = s.next_batch()
                    if batch is not None:
                        s.shed(int((np.asarray(batch["frame_idx"])
                                    < s.limit).sum()))
                    continue
                if inj is not None:
                    # checked before next_batch: a raised fault never
                    # consumes a chunk from the prefetch ring
                    try:
                        inj.ingest(s.sid, s.chunks_done,
                                   attempt=s.ingest_attempts)
                    except TransientFault:
                        s.ingest_attempts += 1
                        s.retries += 1
                        continue          # the same chunk, next round
                    except FatalFault as e:
                        self._fail_sessions((s.sid,), str(e), by_sid)
                        continue
                    s.ingest_attempts = 0
                batch = s.next_batch()
                if batch is not None:
                    per[s.sid].extend(self._ingest_chunk(s, batch, rnd))
            if sc.mix_streams:
                if all(s.ingest_done for s in live):
                    late.extend(self.batcher.drain())
                    for s in live:
                        s.drained = True
            else:
                for s in rot:
                    if s.ingest_done and not s.drained:
                        per[s.sid].extend(self.batcher.drain(
                            select=lambda key, sid=s.sid: key[1] == sid))
                        s.drained = True
            if max_wait > 0:
                late.extend(self.batcher.flush_stale(rnd - max_wait))
            if kn is not None and kn.flush_threshold:
                late.extend(self.batcher.flush_filled(
                    lambda key: kn.flush_threshold.get(
                        key[0] if isinstance(key, tuple) else key,
                        self.batcher.microbatch)))
            self._round = rnd
            for fb in interleave_rounds([per[s.sid] for s in rot], depth):
                self._safe_finish(fb, by_sid)
            for fb in late:
                self._safe_finish(fb, by_sid)
            st["rnd"] = rnd + 1
            rounds += 1
            if inj is not None:
                inj.round_tick(rnd)           # may raise ServerCrash
            if (sc.checkpoint_every > 0 and sc.checkpoint_dir
                    and st["rnd"] % sc.checkpoint_every == 0):
                try:
                    self.checkpoint()
                except CheckpointFault as e:
                    # checkpoint I/O loss degrades: serving goes on from
                    # the last good snapshot
                    self.checkpoint_failures += 1
                    warnings.warn(f"checkpoint skipped: {e}", stacklevel=2)
            if ctl is not None:
                done = sum(s.acct.frames for s in live)
                if done - st["retuned_at"] >= sc.retune_every:
                    ctl.step(self.batcher.queue_stats(), done,
                             time.perf_counter() - t0)
                    st["retuned_at"] = done
            if verbose and st["rnd"] % sc.report_every == 0:
                done = sum(s.acct.frames for s in live)
                print(f"[server] round {st['rnd']:>4d}  {done:>5d} frames  "
                      f"{done / (time.perf_counter() - t0):7.1f} frames/s "
                      f"aggregate (pending {self.batcher.pending})")
        return True

    def _ingest_chunk(self, s: StreamSession, batch: dict, rnd: int) -> list:
        """Gate one chunk through the session's mask cache, embed it, route
        it on the ladder and push per-bucket groups into the batcher,
        stamped with the scheduling round ``rnd``. Returns the flushes that
        became ready."""
        sc = self.serve_cfg
        frames = batch["frames"]                            # on the device
        idxs = batch["frame_idx"]
        valid = idxs < s.limit
        scores_np, n_scored = s.cache.gate(batch["frames_host"], idxs,
                                           self._score_fn, eligible=valid)
        s.acct.add_mgnet(n_scored)
        toks = self._embed(frames)                          # (C, N, d)
        if sc.force_bucket > 0:
            pin = self.ladder.route(
                int(round(sc.force_bucket * self.n_patches)))
            routes = np.full(frames.shape[0], pin)
        else:
            routes = self.ladder.route_many(mask_budget(scores_np,
                                                        self.mcfg.t_reg))
        order = torch.argsort(torch.from_numpy(scores_np).to(self.device),
                              dim=-1, descending=True, stable=True)
        # one-shape mode ships the shared cap-size permutation and prunes
        # by the static per-bucket kv_len at encode time
        permuted = (_gather_topk_rows(toks, order, self.ladder.cap)
                    if sc.one_shape else None)              # (C, cap, d)
        out = []
        for k in np.unique(routes[valid]):
            k = int(k)
            sel = np.flatnonzero((routes == k) & valid)
            pruned = (permuted if sc.one_shape
                      else _gather_topk_rows(toks, order, k))
            s.record_route(k, len(sel))
            group = (pruned if len(sel) == frames.shape[0]
                     else pruned[torch.from_numpy(sel).to(self.device)])
            key = k if sc.mix_streams else (k, s.sid)
            out.extend(self.batcher.push_many(
                key, group, [(s.sid, int(idxs[i])) for i in sel], now=rnd))
        s.frames_seen += int(valid.sum())
        return out

    def _safe_finish(self, fb: FrameBatch,
                     by_sid: dict[int, StreamSession]) -> None:
        """Run one flush with per-session failure isolation. A
        ``SessionFailure`` (an injected fatal fault, exhausted retries)
        quarantines only the owning sessions; any other exception means the
        shared machinery broke, and is raised again as a ``ServeError``
        naming the bucket, sessions, frames and round."""
        owners = sorted({sid for sid, _ in fb.frame_idx})
        if owners and all(by_sid[sid].failed_reason for sid in owners
                          if sid in by_sid):
            return            # a stale flush of quarantined sessions
        k = fb.bucket[0] if isinstance(fb.bucket, tuple) else fb.bucket
        try:
            self._finish(fb, by_sid)
        except SessionFailure as e:
            self._fail_sessions(e.sids, e.reason, by_sid)
        except ServerCrash:
            raise
        except Exception as e:
            rnd = self._round
            frames = [f"{sid}:{fi}" for sid, fi in fb.frame_idx]
            raise ServeError(
                f"flush failed at bucket k={k} (sessions {owners}, frames "
                f"{frames}, round {rnd}): {e}",
                context={"bucket": k, "sessions": owners,
                         "n_real": fb.n_real, "round": rnd}) from e

    def _fail_sessions(self, sids, reason: str,
                       by_sid: dict[int, StreamSession]) -> None:
        """Quarantine ``sids``: mark them failed (their results come back
        ``poisoned`` with ``reason``), drop their queued rows so no further
        launch is billed to them, and let every other session serve on.
        Under ``mix_streams`` the queues are shared, so their rows stay
        queued (a flush whose owners all failed is skipped)."""
        fresh = [sid for sid in sids
                 if sid in by_sid and not by_sid[sid].failed_reason]
        if not fresh:
            return
        for sid in fresh:
            by_sid[sid].fail(reason)
        if not self.serve_cfg.mix_streams:
            doomed = set(fresh)
            self.batcher.discard(
                lambda key: isinstance(key, tuple) and key[1] in doomed)
        warnings.warn(f"quarantined session(s) {fresh}: {reason}; the "
                      f"remaining sessions keep serving", stacklevel=3)

    def _finish(self, fb: FrameBatch, by_sid: dict[int, StreamSession]) -> None:
        """Encode one flush and hand each owning session its rows'
        predictions. The encode is billed at bucket k for the live rows
        only; padded rows are never predicted or accounted. Under the
        control plane or the watchdog the flush is timed from before the
        encode until its predictions are materialized (one sync of the
        current stream) into the telemetry and each owner's accounting;
        an untimed server adds no sync. Under a FaultSpec an injected
        transient fault (raised before the encode, so never inside a
        capture) retries the flush after a bounded backoff, a fatal one or
        the retry limit raises ``SessionFailure``, and an injected stall
        syncs the stream and sleeps."""
        sc = self.serve_cfg
        k = fb.bucket[0] if isinstance(fb.bucket, tuple) else fb.bucket
        timed = self.controller is not None or self._watchdog
        inj = self._injector
        tag = fb.frame_idx[0] if fb.frame_idx else (0, 0)
        attempt = 0
        while True:
            try:
                if inj is not None:
                    inj.flush(k, tag, attempt=attempt)
                t0 = time.perf_counter() if timed else 0.0
                logits = self._encode(k, fb.tokens)
                preds = torch.argmax(logits[:fb.n_real], dim=-1)
                if inj is not None:
                    stall = inj.stall_s(k, tag)
                    if stall > 0:
                        # an injected straggler: the flush completes, slowly
                        if preds.is_cuda:
                            torch.cuda.current_stream(
                                preds.device).synchronize()
                        time.sleep(stall)
                break
            except TransientFault as e:
                attempt += 1
                sids = sorted({sid for sid, _ in fb.frame_idx})
                for sid in sids:
                    if sid in by_sid:
                        by_sid[sid].retries += 1
                if attempt > sc.retry_limit:
                    raise SessionFailure(
                        sids, f"retry limit ({sc.retry_limit}) exhausted: "
                              f"{e}") from e
                time.sleep(min(sc.retry_backoff_s * 2 ** (attempt - 1),
                               1.0))
            except FatalFault as e:
                raise SessionFailure(sorted({sid for sid, _ in fb.frame_idx}),
                                     str(e)) from e
        owners: dict[int, tuple[list, list]] = {}
        for row, (sid, fidx) in enumerate(fb.frame_idx):
            rows, fidxs = owners.setdefault(sid, ([], []))
            rows.append(row)
            fidxs.append(fidx)
        if timed:
            # the sync costs the timed server its asynchronous overlap: it
            # is what makes each observation one flush's own seconds
            if preds.is_cuda:
                torch.cuda.current_stream(preds.device).synchronize()
            wall = time.perf_counter() - t0
            if self.controller is not None:
                self.controller.record_flush(k, fb.n_real, len(owners), wall,
                                             self._round)
            else:
                # watchdog only: feed the straggler detector directly
                self.telemetry.record(k, fb.n_real, sc.microbatch,
                                      len(owners), wall, self._round)
        for sid, (rows, fidxs) in owners.items():
            sess = by_sid[sid]
            sess.record_flush(k, len(rows))
            if timed:
                sess.acct.add_flush_wall(k, wall)
            sess.add_deferred(fidxs, preds if len(owners) == 1
                              else preds[rows])
        self.flush_log.append((tuple(sorted(owners)), k, fb.n_real))
        # a graph's logits are overwritten by its next replay
        self.last_flush = fb
        self.last_logits = logits.clone() if k in self.graphs else logits
        # the flush saw the state before it; the device then ages by the
        # frames it pushed through
        self.last_drift = self.drift
        self._advance_drift(fb.n_real)

    # -- checkpoint / restore / migration ------------------------------------

    def _compat(self) -> dict:
        """The configuration a snapshot is valid under only: a mismatch
        between writer and reader changes routing, shapes or numerics, so
        a restore refuses rather than diverging."""
        sc = self.serve_cfg
        return {
            "img_size": self.cfg.img_size, "patch": self.cfg.patch,
            "ladder": [int(k) for k in self.ladder.sizes],
            "chunk": sc.chunk, "microbatch": sc.microbatch,
            "mask_refresh": sc.mask_refresh,
            "delta_threshold": sc.delta_threshold,
            "one_shape": bool(sc.one_shape),
            "fingerprint": str(self.policy.fingerprint()),
            "noise": repr(self.noise),
        }

    def _check_compat(self, compat: dict) -> None:
        mine = self._compat()
        diffs = [f"{k}: snapshot={compat.get(k)!r} server={mine[k]!r}"
                 for k in mine if compat.get(k) != mine[k]]
        if diffs:
            raise ValueError("snapshot is incompatible with this server "
                             "(restore would not be bitwise): "
                             + "; ".join(diffs))

    def _pending_of(self, sid: int, remove: bool = False) -> list:
        """This session's queued, unflushed batcher entries as plain
        descriptors, tokens copied to the host. Exported, not
        pad-flushed: the flushes they later join keep their activation
        absmax scopes, which keeps a resumed serve bitwise."""
        if self.batcher is None:
            return []
        sel = lambda key: isinstance(key, tuple) and key[1] == sid
        out = []
        for key, t, ix, now, is_row in self.batcher.export(sel):
            out.append({"bucket": int(key[0]), "now": int(now),
                        "is_row": bool(is_row),
                        "fidx": [int(f) for _, f in ix],
                        "tokens": t.detach().cpu().numpy()})
        if remove and out:
            self.batcher.discard(sel)
        return out

    def _snapshot(self, live, rnd: int, offset: int) -> tuple[dict, dict]:
        """Server and session state flattened into (arrays, extra) for
        ``checkpoint.save``. The control plane's state is not captured: a
        restored server warms and calibrates its own; only the state the
        predictions depend on must round-trip bitwise."""
        arrays: dict = {}
        metas = []
        for s in live:
            s_arrays, meta = s.state_dict()
            pend = self._pending_of(s.sid)
            for j, p in enumerate(pend):
                arrays[f"s{s.sid}/pend{j}"] = p.pop("tokens")
            meta["pending"] = pend
            for key, a in s_arrays.items():
                arrays[f"s{s.sid}/{key}"] = a
            metas.append(meta)
        if self.drift is not None:
            arrays["drift/key"] = np.asarray(self.drift.key)
            arrays["drift/frame"] = np.asarray(self.drift.frame)
            arrays["drift/nm"] = np.asarray(self.drift.drift_nm)
        extra = {"sessions": metas, "rnd": int(rnd), "offset": int(offset),
                 "recalibrations": int(self.recalibrations),
                 "host_drift_nm": float(self._host_drift_nm),
                 "next_sid": int(self._next_sid),
                 "compat": self._compat()}
        return arrays, extra

    def checkpoint(self, root: str | None = None,
                   step: int | None = None) -> str:
        """Snapshot every live session (ingest cursor, mask cache,
        accounting, deferred predictions, queued rows) with the server's
        DriftState and the loop's cursors to ``root/step_<n>`` (atomic,
        ``checkpoint.save``). Valid between rounds of a serve
        (``serve(max_rounds=...)`` or the ``checkpoint_every`` cadence) or
        between serves. One sync of the device (the deferred predictions
        and queued rows come to the host). Returns the path written."""
        sc = self.serve_cfg
        root = root or sc.checkpoint_dir
        if not root:
            raise ValueError("checkpoint needs a root (checkpoint_dir "
                             "config or the root argument)")
        if sc.mix_streams:
            raise ValueError(
                "checkpoint is unsupported under mix_streams: queued rows "
                "are cross-session, so per-session state cannot be "
                "snapshotted without changing absmax scopes")
        if self._inflight is not None:
            st = self._inflight
            live, rnd, offset = st["live"], st["rnd"], st["offset"]
        else:
            live = [s for s in self._sessions if not s.finished]
            rnd, offset = 0, 0
        arrays, extra = self._snapshot(live, rnd, offset)
        step = int(rnd if step is None else step)
        if self._injector is not None:
            self._injector.checkpoint_io(step)   # may raise CheckpointFault
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, f"step_{step}")
        _ckpt_save(path, arrays, step=step, extra=extra)
        self._ckpt_gc(root)
        return path

    def _ckpt_gc(self, root: str) -> None:
        keep = self.serve_cfg.checkpoint_keep
        if keep <= 0:
            return
        steps = sorted((int(d.split("_", 1)[1]), d)
                       for d in os.listdir(root)
                       if d.startswith("step_")
                       and d.split("_", 1)[1].isdigit())
        for _, d in steps[:-keep]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    def restore_checkpoint(self, path_or_root: str,
                           streams: dict | None = None) -> dict:
        """Rebuild the sessions of a ``checkpoint()`` snapshot in this
        (fresh) server; the next ``serve()`` resumes at the snapshot's
        round and rotation cursors and gives the remaining predictions
        bitwise the uninterrupted serve's. The server's own warm start
        captured its graphs over its own cache; under noise the restored
        DriftState is written into the state tensor before the first noisy
        stage reads it.

        ``path_or_root`` is a ``step_<n>`` directory or a root (its newest
        step is taken). ``streams`` maps sid -> VideoStream for sources
        that did not serialize (a plain ``VideoStream`` restores without).
        Returns the restored ``{sid: StreamSession}``."""
        if self._inflight is not None:
            raise ValueError("cannot restore into a mid-serve server")
        if any(not s.finished for s in self._sessions):
            raise ValueError("cannot restore into a server with live "
                             "sessions (their sids would collide)")
        path = path_or_root
        if not os.path.exists(os.path.join(path, "meta.json")):
            step = latest_step(path_or_root)
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {path_or_root}")
            path = os.path.join(path_or_root, f"step_{step}")
        arrays, _, extra = restore_flat(path)
        self._check_compat(extra.get("compat", {}))
        streams = streams or {}
        sessions: dict[int, StreamSession] = {}
        for meta in extra["sessions"]:
            sid = int(meta["sid"])
            pre = f"s{sid}/"
            sub = {k[len(pre):]: v for k, v in arrays.items()
                   if k.startswith(pre)}
            s = StreamSession.from_state(
                sub, meta, self.serve_cfg, self.cfg, ladder=self.ladder,
                layer_bits=self.layer_bits,
                stream=streams.get(sid, streams.get(str(sid))),
                device=self.device)
            sessions[sid] = s
            self._sessions.append(s)
        self._next_sid = max(int(extra.get("next_sid", 0)),
                             max(sessions, default=-1) + 1)
        if self.noise is not None and "drift/key" in arrays:
            self.drift = DriftState(arrays["drift/key"].numpy(),
                                    arrays["drift/frame"].numpy(),
                                    arrays["drift/nm"].numpy())
            self._host_drift_nm = float(extra.get("host_drift_nm", 0.0))
            self._written = None     # the state tensor holds another state
        self.recalibrations = int(extra.get("recalibrations", 0))
        self._resume = (int(extra["rnd"]), int(extra["offset"]))
        return sessions

    def _restore_pending(self, live) -> list:
        """Push restored sessions' queued rows back into the batcher on
        this server's device (the same groups with the same ``now`` ticks:
        ``MicroBatcher.export``). A flush that fills at once is returned to
        run before the first resumed round."""
        early = []
        for s in live:
            pend = s._pending_restore
            if not pend:
                continue
            for bucket, toks, fidx, now, is_row in pend:
                key = (bucket, s.sid)
                pairs = [(s.sid, int(f)) for f in fidx]
                toks = (toks if isinstance(toks, torch.Tensor)
                        else torch.from_numpy(np.asarray(toks))
                        ).to(self.device)
                if is_row:
                    early.extend(self.batcher.push(key, toks, pairs[0],
                                                   now=now))
                else:
                    early.extend(self.batcher.push_many(key, toks, pairs,
                                                        now=now))
            s._pending_restore = None
        return early

    # -- session migration ---------------------------------------------------

    def export_session(self, sid: int) -> dict:
        """Take one live session out of this server with its full state
        and its queued rows (copied to the host), as a snapshot for
        ``adopt_session`` on another server. The session leaves this
        server (its queues discarded, marked finished). Mid-serve only
        while paused (``serve(max_rounds=...)`` returned ``{}``)."""
        if self.serve_cfg.mix_streams:
            raise ValueError("migration is unsupported under mix_streams")
        s = next((s for s in self._sessions
                  if s.sid == sid and not s.finished), None)
        if s is None:
            raise KeyError(f"no live session {sid}")
        arrays, meta = s.state_dict()
        meta["pending"] = self._pending_of(sid, remove=True)
        if self._inflight is not None:
            self._inflight["live"] = [x for x in self._inflight["live"]
                                      if x.sid != sid]
        self._sessions = [x for x in self._sessions if x.sid != sid]
        s.finished = True
        return {"arrays": arrays, "meta": meta, "compat": self._compat()}

    def adopt_session(self, snapshot: dict, stream=None) -> StreamSession:
        """Adopt a session another server exported mid-stream. The
        remaining predictions are bitwise those of staying put: the
        micro-batches are session-pure, so the numerics depend only on the
        session's own frames and the (compat-checked) weights, not on the
        server that launches them; this server replays its own graphs.
        Under noise the DriftState is the server's shared thermal history,
        so a migrated session sees the destination's drift."""
        if self._inflight is not None:
            raise ValueError("cannot adopt mid-serve (pause first)")
        if self.serve_cfg.mix_streams:
            raise ValueError("migration is unsupported under mix_streams")
        self._check_compat(snapshot["compat"])
        meta = snapshot["meta"]
        sid = int(meta["sid"])
        if any(s.sid == sid and not s.finished for s in self._sessions):
            raise ValueError(f"sid {sid} already live on this server")
        s = StreamSession.from_state(snapshot["arrays"], meta,
                                     self.serve_cfg, self.cfg,
                                     ladder=self.ladder,
                                     layer_bits=self.layer_bits,
                                     stream=stream, device=self.device)
        self._sessions.append(s)
        self._next_sid = max(self._next_sid, sid + 1)
        return s

    # -- the single-stream dense baseline -----------------------------------

    def _encode_dense(self, frames: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """Logits of one ingest chunk encoded at all N patches, the RoI
        ``mask`` on the key axis: through one CUDA graph on a graphed
        server (captured at the first chunk), else eagerly."""
        def eager(f=frames, m=mask):
            with use_sharding(self.mesh), self._scope():
                return forward_vit_masked(self.params, f, m, self.cfg,
                                          self.policy, device=self.device)[0]
        self._write_state()
        if not self._graphed:
            return eager()
        g = self.dense_graph
        if g is None or g.tokens.shape != frames.shape:
            sf, sm = torch.zeros_like(frames), torch.zeros_like(mask)
            g = self.dense_graph = self._capture_fn(
                "dense", lambda: eager(sf, sm), sf, sm)
        return g.replay(frames, mask)

    def run_dense(self, stream: VideoStream, n_frames: int = 64,
                  start: int = 0) -> StreamResult:
        """The mask-mode dense baseline: the gating of ``serve`` (the mask
        cache, MGNet), but every chunk is encoded at all N patches with the
        binary RoI mask sigmoid(score) > t_reg on the attention key axis.
        Compute is not reduced; each frame is billed at N patches and
        ``bucket_hits`` is ``{N: frames}``."""
        s = StreamSession(-1, stream, n_frames, start, self.serve_cfg,
                          self.cfg, ladder=None, device=self.device,
                          layer_bits=self.layer_bits)
        t0 = time.perf_counter()
        while True:
            batch = s.next_batch()
            if batch is None:
                break
            idxs = batch["frame_idx"]
            valid = idxs < s.limit
            scores_np, n_scored = s.cache.gate(batch["frames_host"], idxs,
                                               self._score_fn,
                                               eligible=valid)
            s.acct.add_mgnet(n_scored)
            mask = (torch.sigmoid(torch.from_numpy(scores_np).float())
                    > self.mcfg.t_reg).float().to(self.device)
            logits = self._encode_dense(batch["frames"], mask)
            s.acct.add_encode(self.n_patches, int(valid.sum()))
            s.add_deferred([int(i) for i in idxs], torch.argmax(logits, -1))
            self._advance_drift(int(valid.sum()), extra_sessions=(s,))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        res = s.finish(time.perf_counter() - t0)
        res.bucket_hits = {self.n_patches: res.frames}
        return res


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def with_backends(cfg: ArchConfig, args) -> ArchConfig:
    """``cfg`` with the CLI's ``--backend`` / ``--attn-backend`` /
    ``--ffn-backend`` / ``--attn-impl`` (a flag left out keeps the
    config's own)."""
    kw = {"attn_impl": args.attn_impl}
    for field, val in (("matmul_backend", args.backend),
                       ("attn_backend", args.attn_backend),
                       ("ffn_backend", args.ffn_backend)):
        if val is not None and (val or field != "matmul_backend"):
            kw[field] = val
    return cfg.with_(**kw)


def build_parser() -> argparse.ArgumentParser:
    """The server CLI's flags: the reference's names and meanings
    (src/repro/serving/server.py::main), except that without ``--smoke``
    the model defaults to opto-vit-base-224 (the reference: tiny-96) and
    the backends to the fused serving point."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (32x32 frames, 4 layers, d=64)")
    ap.add_argument("--variant", default="base",
                    help="opto-vit variant (tiny, small, base, large); "
                         "ignored under --smoke")
    ap.add_argument("--img-size", type=int, default=224,
                    help="frame side in pixels; ignored under --smoke")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per stream")
    ap.add_argument("--phase", type=int, default=16,
                    help="per-stream start offset (stream i starts at i*phase)")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--mask-refresh", type=int, default=8,
                    help="re-score MGNet at least every this many frames")
    ap.add_argument("--delta-threshold", type=float, default=0.15,
                    help="frame-difference threshold that forces a re-score")
    ap.add_argument("--buckets", default="0.25,0.5,0.75,1.0",
                    help="bucket ladder as fractions of the patch count")
    ap.add_argument("--cut-every", type=int, default=32,
                    help="scene cut every this many frames of each stream")
    ap.add_argument("--one-shape", action="store_true",
                    help="encode every flush at the ladder cap with a static "
                         "packed kept-count per bucket")
    ap.add_argument("--max-wait", type=int, default=0,
                    help="pad-flush partial micro-batches after this many "
                         "scheduling rounds (0: wait for fill or stream end)")
    ap.add_argument("--mix-streams", action="store_true",
                    help="fill micro-batches across sessions (couples w8a8 "
                         "activation scales across streams)")
    ap.add_argument("--trim-dead-buckets", action="store_true",
                    help="route-only calibration pass, then drop ladder "
                         "buckets no stream hits before the warm start")
    ap.add_argument("--calib-frames", type=int, default=0,
                    help="frames per stream for --trim-dead-buckets "
                         "calibration (default 2 chunks)")
    ap.add_argument("--bit-plan", default="",
                    help="mixed-precision bit plan: comma per-layer widths "
                         "('8,6,4,8'), a JSON literal, or a JSON file path "
                         "(core/bitalloc.py formats)")
    ap.add_argument("--bit-budget", type=float, default=0.0,
                    help="> 0: calibrate a per-layer plan to this target "
                         "mean bit width before the warm start "
                         "(sensitivity-driven, overrides --bit-plan)")
    ap.add_argument("--backend", default="",
                    help="matmul backend (bf16, qat, photonic_sim, "
                         "photonic_pallas); default: the serving point's "
                         "photonic_pallas")
    ap.add_argument("--attn-backend", default=None,
                    choices=["", "xla", "flash"],
                    help="attention core: xla (materialized scores) or "
                         "flash (the RoI-masked flash kernel, the "
                         "default); '' resolves to xla")
    ap.add_argument("--ffn-backend", default=None,
                    choices=["", "xla", "fused"],
                    help="GELU-MLP: xla (composed two-linear) or fused (the "
                         "fused int8 FFN kernel, the default); '' resolves "
                         "to xla")
    ap.add_argument("--attn-impl", default="standard",
                    choices=["standard", "decomposed"],
                    help="attention dataflow: standard or the paper's Eq. 2 "
                         "decomposition")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary line last")
    ap.add_argument("--no-warm-start", action="store_true",
                    help="no warm start: every flush runs eagerly (on the "
                         "card: no CUDA graphs)")
    ap.add_argument("--autotune", action="store_true",
                    help="serving control plane: route-probe the ladder, "
                         "price the hit buckets on the H100 roofline "
                         "(pricing captures their CUDA graphs), then re-tune "
                         "the scheduling knobs online with hysteresis + "
                         "safety clamp")
    ap.add_argument("--retune-every", type=int, default=32,
                    help="frames between controller evaluations")
    ap.add_argument("--assert-converged", action="store_true",
                    help="exit nonzero unless the controller calibrated "
                         "and settled (the CI smoke gate)")
    ap.add_argument("--watchdog", action="store_true",
                    help="flush watchdog: median+MAD straggler detection "
                         "over per-flush wall times")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (bridge.init_vit)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--mesh", default="auto", choices=["auto", "off"],
                    help="auto: under torchrun (> 1 ranks) split each "
                         "flush's encode over the 1-D data mesh; off: "
                         "every rank serves on its own")
    ap.add_argument("--model-shards", type=int, default=0,
                    help="> 1: 2-D (data, model) serving mesh over the "
                         "torchrun world: attention heads + d_ff shard over "
                         "the model axis (needs n_heads and d_ff divisible)")
    ap.add_argument("--noise", action="store_true",
                    help="run with calibrated device noise (FPV + shot + "
                         "MR drift, core/noise.py NoiseSpec); needs composed "
                         "backends (e.g. --backend photonic_sim "
                         "--ffn-backend xla)")
    ap.add_argument("--fpv-sigma", type=float, default=0.01,
                    help="fabrication process variation sigma (static "
                         "per-call-site multiplicative weight noise)")
    ap.add_argument("--shot-sigma", type=float, default=0.005,
                    help="per-readout shot/thermal noise sigma")
    ap.add_argument("--q-factor", type=float, default=5000.0,
                    help="MR quality factor of the noise operating point")
    ap.add_argument("--drift-rate-nm", type=float, default=0.0,
                    help="resonance drift accumulated per served frame (nm)")
    ap.add_argument("--wander-sigma-nm", type=float, default=0.0,
                    help="per-element resonance wander sigma around the "
                         "common-mode drift (nm)")
    ap.add_argument("--recal-bound-nm", type=float, default=0.0,
                    help="> 0: recalibrate (re-tune the cache, reset the "
                         "drift, billed as an MR re-tune) when the "
                         "accumulated drift reaches this bound")
    ap.add_argument("--adc-quant", action="store_true",
                    help="quantize noisy readouts through the 8-bit ADC "
                         "transfer function")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="seed of the device-noise RNG lineage")
    ap.add_argument("--flush-fault-rate", type=float, default=0.0,
                    help="probability a flush site raises a (retryable) "
                         "transient device fault")
    ap.add_argument("--flush-fatal-rate", type=float, default=0.0,
                    help="probability a flush site raises a fatal fault "
                         "(quarantines the owning session)")
    ap.add_argument("--ingest-fault-rate", type=float, default=0.0,
                    help="probability an ingest chunk raises a transient "
                         "fault (chunk retried next round)")
    ap.add_argument("--stall-rate", type=float, default=0.0,
                    help="probability a flush stalls (injected straggler)")
    ap.add_argument("--stall-s", type=float, default=0.05,
                    help="injected stall duration (seconds)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault-injection RNG lineage")
    ap.add_argument("--hard-fail-session", type=int, default=-1,
                    help=">= 0: hard-fail this session id at its first "
                         "ingest (isolation demo)")
    ap.add_argument("--retry-limit", type=int, default=3,
                    help="transient-fault retries per flush before the "
                         "owning session is quarantined")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="> 0: bound on queued micro-batch rows; ingest "
                         "chunks arriving over the bound are shed")
    ap.add_argument("--checkpoint-dir", default="",
                    help="root directory for session checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="> 0: snapshot every N scheduling rounds to "
                         "--checkpoint-dir")
    return ap


def config_from_args(args) -> tuple[ArchConfig, ServerConfig]:
    """The model config and the ServerConfig the CLI serves (warm start
    off: ``main`` warms after the optional trim and bit calibration, as
    the reference does)."""
    cfg = with_backends(smoke_cfg() if args.smoke
                        else serving_cfg(args.variant, args.img_size), args)
    if args.noise:
        cfg = cfg.with_(noise=NoiseSpec(
            q_factor=args.q_factor, fpv_sigma=args.fpv_sigma,
            shot_sigma=args.shot_sigma, drift_rate_nm=args.drift_rate_nm,
            wander_sigma_nm=args.wander_sigma_nm,
            recal_bound_nm=args.recal_bound_nm,
            adc_quantize_output=args.adc_quant, seed=args.noise_seed))
    bit_plan = (bitalloc.parse_bit_plan(args.bit_plan) or ()
                if args.bit_plan else ())
    faults = None
    if (args.flush_fault_rate > 0 or args.flush_fatal_rate > 0
            or args.ingest_fault_rate > 0 or args.stall_rate > 0
            or args.hard_fail_session >= 0):
        faults = FaultSpec(flush_fault_rate=args.flush_fault_rate,
                           flush_fatal_rate=args.flush_fatal_rate,
                           ingest_fault_rate=args.ingest_fault_rate,
                           stall_rate=args.stall_rate, stall_s=args.stall_s,
                           hard_fail_session=args.hard_fail_session,
                           seed=args.fault_seed)
    sc = ServerConfig(
        bucket_fractions=tuple(float(f) for f in args.buckets.split(",")),
        microbatch=args.microbatch, chunk=args.chunk,
        mask_refresh=args.mask_refresh,
        delta_threshold=args.delta_threshold, one_shape=args.one_shape,
        max_wait_chunks=args.max_wait, mix_streams=args.mix_streams,
        warm_start=False, mesh=args.mesh, model_shards=args.model_shards,
        bit_plan=bit_plan, autotune=args.autotune,
        retune_every=args.retune_every, watchdog=args.watchdog,
        faults=faults, retry_limit=args.retry_limit,
        max_pending_rows=args.max_pending,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    return cfg, sc


def main(argv=None):
    args = build_parser().parse_args(argv)

    joined = init_from_env(device=args.device) is not None
    try:
        return _serve_cli(args)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _serve_cli(args):
    rank0 = (not torch.distributed.is_initialized()
             or torch.distributed.get_rank() == 0)
    say = print if rank0 else (lambda *a, **k: None)
    cfg, sc = config_from_args(args)
    server = StreamServer(cfg, sc, seed=args.seed, device=args.device)
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "cpu")
    mesh = ("x".join(str(n) for n in server.mesh.shape.values())
            if server.mesh is not None else "off")
    bits = (list(server.layer_bits) if server.layer_bits
            else cfg.quant_bits or 8)
    noise = server.noise
    say(f"[server] {cfg.name} {cfg.img_size}x{cfg.img_size} on {where}: "
        f"{server.policy} attn_impl={cfg.attn_impl} "
        f"bits={bits} ladder={list(server.ladder.sizes)} of "
        f"{server.n_patches} patches mesh={mesh}"
        + (f" noise=Q{noise.q_factor:g}/fpv{noise.fpv_sigma:g}"
           f"/shot{noise.shot_sigma:g}" if noise is not None else ""))
    streams = video_fleet(args.streams, img_size=cfg.img_size,
                          patch=cfg.patch, cut_every=args.cut_every)
    sessions = [server.add_session(st, n_frames=args.frames,
                                   start=i * args.phase)
                for i, st in enumerate(streams)]
    if args.trim_dead_buckets:
        removed = server.calibrate_trim(args.calib_frames or None)
        say(f"[server] calibration trimmed buckets {list(removed)} -> "
            f"ladder {list(server.ladder.sizes)}")
    if args.bit_budget > 0:
        plan = server.calibrate_bits(args.bit_budget,
                                     args.calib_frames or None)
        say(f"[server] bit calibration -> per-layer plan {list(plan)} "
            f"(mean {sum(plan) / len(plan):.2f} bits, target "
            f"{args.bit_budget:g}) in {server.calibrate_s:.2f}s")
    if args.autotune:
        server.autotune_prepare(args.calib_frames or None)
        say(f"[server] autotune: priced buckets "
            f"{sorted(server.cost_model.costs)} (ladder "
            f"{list(server.ladder.sizes)}), {len(server.graphs)} CUDA graphs, "
            f"warmed in {server.warm_s:.2f}s")
        say(server.cost_model.render())
    elif not args.no_warm_start:
        server.warm_start()
        say(f"[server] warm start in {server.warm_s:.2f}s "
            f"({len(server.warmed)} bucket encodes, {len(server.graphs)} "
            f"CUDA graphs)")
    results = server.serve(verbose=rank0)
    total = sum(r.frames for r in results.values())
    wall = max((r.wall_s for r in results.values()), default=0.0)
    for s in sessions:
        r = results[s.sid]
        say(f"[server] session {s.sid}:", r.summary()
            + (f" POISONED ({r.failure})" if r.poisoned else ""))
    say(f"[server] aggregate: {total} frames over {len(sessions)} streams "
        f"in {wall:.3f}s -> {total / wall if wall else 0.0:.1f} frames/s "
        f"(warm-up {server.warm_s:.2f}s, {len(server.flush_log)} encode "
        f"launches, {where})")
    if noise is not None:
        say(f"[server] noise: drift {server._host_drift_nm:.3f} nm "
            f"residual, {server.recalibrations} recalibrations")
    if server._injector is not None:
        say(f"[server] faults: {server._injector.report()}")
    if server._watchdog:
        say(f"[server] watchdog: {len(server.straggler_flags)} straggler "
            f"flushes flagged")
    if server.controller is not None:
        say("[server]", server.controller.report())
        assert server.controller.clamp_violations == 0, (
            "controller applied knobs outside the safety clamp: "
            f"{server.controller.clamp_violations} violations")
        if args.assert_converged:
            assert server.controller.converged, (
                "controller did not converge: "
                + server.controller.report())
    if args.json:
        say(json.dumps({
            "streams": len(sessions), "frames_total": total,
            "aggregate_fps": total / wall if wall else 0.0,
            "warm_s": server.warm_s, "ladder": list(server.ladder.sizes),
            "layer_bits": (list(server.layer_bits) if server.layer_bits
                           else None),
            "kfps_per_watt": [results[s.sid].kfps_per_watt
                              for s in sessions],
            "noise": (None if noise is None else {
                "q_factor": noise.q_factor, "fpv_sigma": noise.fpv_sigma,
                "shot_sigma": noise.shot_sigma,
                "drift_rate_nm": noise.drift_rate_nm,
                "recal_bound_nm": noise.recal_bound_nm,
                "recalibrations": server.recalibrations}),
            "recalibrations": [results[s.sid].recalibrations
                               for s in sessions],
            "faults": (None if server._injector is None
                       else dict(server._injector.injected)),
            "poisoned": [results[s.sid].poisoned for s in sessions],
            "failure": [results[s.sid].failure for s in sessions],
            "retries": [results[s.sid].retries for s in sessions],
            "shed_frames": [results[s.sid].shed_frames
                            for s in sessions]}))
    return results


if __name__ == "__main__":
    main()
