"""Rank bodies for the port's multi-rank tests (``test_torch_sharding.py``,
``test_torch_data_mesh.py``, ``test_torch_gpu.py``), run by
``repro_torch.launch.mesh.spawn_ranks``.

A spawned rank imports this module by name to find its function, so it
imports neither JAX nor the reference package: the ranks are the port
alone. Inputs arrive as numpy arrays; results go back as numpy arrays and
plain Python values.
"""

import contextlib
import sys

import numpy as np
import torch

from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core.backend import ExecPolicy, place_params, prepare_params
from repro_torch.data.pipeline import video_fleet
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import (MODEL_RULES, ShardingCtx,
                                              absmax_scope, rules_for_mesh,
                                              use_sharding)
from repro_torch.kernels import _build
from repro_torch.kernels.fused_ffn import fused_ffn
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import sharded_encoder
from repro_torch.models.sharded_encoder import fused_ffn_sharded
from repro_torch.models.vit import (data_split_calls, encode_tokens,
                                    vit_logical_axes)
from repro_torch.serving.server import ServerConfig, StreamServer, smoke_cfg


def _raises(fn) -> str:
    """The message of the ValueError or NotImplementedError ``fn()`` raises
    ("" if none)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return ""


def absmax_halves(x: np.ndarray, bits_list) -> dict:
    """Each of 2 ranks holds half of x's rows; the replicated scale per
    bit width."""
    mesh = make_serving_mesh(model=2, device="cpu")
    half = x.shape[0] // 2
    local = torch.from_numpy(x[mesh.m * half:(mesh.m + 1) * half])
    return {b: collectives.replicated_absmax_scale(
        local, b, mesh.group(("data", "model"))).numpy() for b in bits_list}


def ffn_sharded(cases: list, device: str = "cpu") -> list:
    """``fused_ffn_sharded`` on this rank's d_ff shard of each case's whole
    operands (x, w1q, sw1, b1, w2q, sw2, b2, bits, live_rows)."""
    mesh = make_serving_mesh(model=2, device=device)
    m, n_model = mesh.m, mesh.model
    out = []
    for x, w1q, sw1, b1, w2q, sw2, b2, bits, live in cases:
        f = w1q.shape[1] // n_model
        cols = slice(m * f, (m + 1) * f)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

        y = fused_ffn_sharded(
            t(x), t(w1q[:, cols]), t(sw1[cols]), t(b1[cols]), t(w2q[cols]),
            t(sw2), t(b2), bits=bits, live_rows=live,
            model_group=mesh.group("model"),
            scale_group=mesh.group(("data", "model")))
        out.append(y.cpu().numpy())
    return out


def encode_sharded(raw: dict, cfg, requests: list, model: int = 2) -> dict:
    """The sharded encode of each request (tokens, kv_len, patch_mask) on
    this rank's shard of the prepared ``raw`` tree; also what the mesh
    refuses."""
    mesh = make_serving_mesh(model=model, device="cpu")
    ctx = ShardingCtx(mesh, MODEL_RULES)
    params = place_params(prepare_params(from_jax_params(raw, "cpu"), bits=8),
                          vit_logical_axes(cfg), ctx)
    policy = ExecPolicy.from_cfg(cfg)
    before = sharded_encoder.sharded_encode_calls()
    logits = []
    with use_sharding(mesh):
        for toks, kv_len, mask in requests:
            logits.append(encode_tokens(
                params, torch.from_numpy(toks), cfg, policy, kv_len=kv_len,
                patch_mask=None if mask is None else torch.from_numpy(mask),
                device="cpu").numpy())
    world = mesh.world
    return {"logits": logits, "coords": (mesh.d, mesh.m),
            "calls": sharded_encoder.sharded_encode_calls() - before,
            "wq_cols": tuple(params["blocks"]["attn"]["wq"].wq.shape),
            "w2_rows": tuple(params["blocks"]["ffn"]["w2"].wq.shape),
            "too_many": _raises(lambda: make_serving_mesh(model=world + 1)),
            "not_dividing": _raises(lambda: make_serving_mesh(model=3))}


@contextlib.contextmanager
def local_absmax_scopes():
    """A planted fault: every absmax scope left local to the rank (the
    wrappers see no scope group, so each quantizes at its own rows'
    scale)."""
    saved = sharding.absmax_group
    sharding.absmax_group = lambda: None
    try:
        yield
    finally:
        sharding.absmax_group = saved


def log_flushes(server) -> dict:
    """Keep every flush's logits (on the host) as ``server`` serves, keyed
    by the flush's (sid, frame index) pairs."""
    logged, finish = {}, server._finish

    def finish_and_log(fb, by_sid):
        finish(fb, by_sid)
        logged[tuple(fb.frame_idx)] = server.last_logits.float().cpu().numpy()
    server._finish = finish_and_log
    return logged


def serve_streams(server, n_streams: int, n_frames: int, phase: int,
                  cut_every: int = 16) -> dict:
    """``n_streams`` smoke streams (stream i from frame ``phase * i``)
    served by ``server``: predictions per stream, every flush's logits,
    the flush log."""
    cfg = server.cfg
    logged = log_flushes(server)
    sessions = [server.add_session(st, n_frames=n_frames, start=phase * i)
                for i, st in enumerate(video_fleet(n_streams, cfg.img_size,
                                                   cfg.patch,
                                                   cut_every=cut_every))]
    res = server.serve()
    return {"predictions": [res[s.sid].predictions for s in sessions],
            "logits": logged,
            "flush_log": [(k, n) for _, k, n in server.flush_log]}


def serve_data_mesh(raw: dict, n_streams: int, n_frames: int, phase: int,
                    device: str = "cpu", plant: bool = False,
                    microbatch: int = 4) -> dict:
    """The smoke config served on the 1-D data mesh over every rank
    (``mesh="auto"``, no model shards), eagerly: predictions, flush logits
    and log (``serve_streams``), the mesh, the data-split encodes and the
    kernel launches of the serve; ``plant`` leaves every absmax scope
    local to the rank."""
    cfg = smoke_cfg()
    server = StreamServer(cfg, ServerConfig(microbatch=microbatch, chunk=8),
                          params=from_jax_params(raw, "cpu"), device=device)
    before = data_split_calls()
    _build.LAUNCHES.clear()
    with local_absmax_scopes() if plant else contextlib.nullcontext():
        out = serve_streams(server, n_streams, n_frames, phase)
    calls = data_split_calls()
    out.update(axis_names=server.mesh.axis_names,
               shape=server.mesh.shape, d=server.mesh.d,
               rules=rules_for_mesh(server.mesh),
               graphs=len(server.graphs),
               launches=dict(_build.LAUNCHES),
               calls={k: calls[k] - before[k] for k in calls})
    return out


def ffn_data_split(cases: list, device: str = "cpu") -> list:
    """``fused_ffn`` on this rank's half of each case's token rows (x,
    w1q, sw1, b1, w2q, sw2, b2, bits, live_rows) inside an absmax scope
    over "data", the halves all-gathered; and the launches of B3's
    host-split binding (on the card)."""
    mesh = make_serving_mesh(model=1, device=device)
    group = mesh.group("data")
    out = []
    _build.LAUNCHES.clear()
    for x, w1q, sw1, b1, w2q, sw2, b2, bits, live in cases:

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

        w1, w2 = t(w1q), t(w2q)
        half = x.shape[0] // mesh.data
        with use_sharding(mesh), absmax_scope(group):
            y = fused_ffn(t(x[mesh.d * half:(mesh.d + 1) * half]), w1,
                          t(sw1), t(b1), w2, t(sw2), t(b2), bits=bits,
                          live_rows=live, w1t=w1.t().contiguous(),
                          w2t=w2.t().contiguous())
        out.append(collectives.all_gather_cat(y, group, 0).cpu().numpy())
    return {"ffn": out, "launches": dict(_build.LAUNCHES)}


def mesh_facts() -> dict:
    """What ``make_serving_mesh`` builds with and without model shards."""
    one = make_serving_mesh(model=1, device="cpu")
    two = make_serving_mesh(model=2, device="cpu")
    return {m: {"axis_names": mesh.axis_names, "shape": mesh.shape,
                "coords": (mesh.d, mesh.m), "world": mesh.world,
                "rules": rules_for_mesh(mesh)}
            for m, mesh in ((1, one), (2, two))}


def data_mesh_suite(raw: dict, cases: list, n_streams: int, n_frames: int,
                    phase: int) -> dict:
    """Everything the 2-rank CPU data-mesh tests read, from one spawn."""
    return {"modules": sorted(m.split(".")[0] for m in sys.modules),
            "mesh": mesh_facts(),
            "ffn": ffn_data_split(cases)["ffn"],
            "serve": serve_data_mesh(raw, n_streams, n_frames, phase),
            "planted": serve_data_mesh(raw, n_streams, n_frames, phase,
                                       plant=True),
            "odd_batch": serve_data_mesh(raw, n_streams, n_frames, phase,
                                         microbatch=3),
            "ineligible": _raises(lambda: StreamServer(
                smoke_cfg().with_(matmul_backend="bf16"),
                ServerConfig(microbatch=4, chunk=8),
                params=from_jax_params(raw, "cpu"), device="cpu"))}


def serve_sharded(raw: dict, n_streams: int, n_frames: int,
                  phase: int) -> dict:
    """The smoke config served model-sharded over every rank (2 streams by
    default), what ``model_shards=2`` on an ineligible config raises, and
    a server without model shards on this multi-rank world: the 1-D data
    mesh's serve of the same traffic, and what it raises under a policy
    the data-split encode cannot take."""
    cfg = smoke_cfg()
    sc = ServerConfig(microbatch=4, chunk=8, model_shards=2)
    server = StreamServer(cfg, sc, params=from_jax_params(raw, "cpu"),
                          device="cpu")
    before = sharded_encoder.sharded_encode_calls()
    sessions = [server.add_session(st, n_frames=n_frames, start=phase * i)
                for i, st in enumerate(video_fleet(n_streams, cfg.img_size,
                                                   cfg.patch, cut_every=16))]
    res = server.serve()
    bad = cfg.with_(n_heads=1)
    return {"predictions": [res[s.sid].predictions for s in sessions],
            "flush_log": [(k, n) for _, k, n in server.flush_log],
            "calls": sharded_encoder.sharded_encode_calls() - before,
            "ineligible": _raises(lambda: StreamServer(
                bad, sc, params=from_jax_params(init_vit(0, bad, 10), "cpu"),
                device="cpu")),
            "unsharded": serve_streams(StreamServer(
                cfg, ServerConfig(microbatch=4, chunk=8),
                params=from_jax_params(raw, "cpu"), device="cpu"),
                n_streams, n_frames, phase, cut_every=16)["predictions"],
            "unsharded_ineligible": _raises(lambda: StreamServer(
                cfg.with_(ffn_backend="xla"),
                ServerConfig(microbatch=4, chunk=8),
                params=from_jax_params(raw, "cpu"), device="cpu"))}


def suite(x_halves: np.ndarray, ffn_cases: list, raw: dict, cfg,
          requests: list, n_streams: int, n_frames: int, phase: int) -> dict:
    """Everything the 2-rank CPU tests read, from one spawn."""
    return {"modules": sorted(m.split(".")[0] for m in sys.modules),
            "absmax": absmax_halves(x_halves, (8, 4)),
            "ffn": ffn_sharded(ffn_cases),
            "encode": encode_sharded(raw, cfg, requests),
            "serve": serve_sharded(raw, n_streams, n_frames, phase)}
