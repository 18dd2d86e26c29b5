"""Rank bodies for the port's multi-rank tests (``test_torch_sharding.py``,
``test_torch_gpu.py``), run by ``repro_torch.launch.mesh.spawn_ranks``.

A spawned rank imports this module by name to find its function, so it
imports neither JAX nor the reference package: the ranks are the port
alone. Inputs arrive as numpy arrays; results go back as numpy arrays and
plain Python values.
"""

import sys

import numpy as np
import torch

from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core.backend import ExecPolicy, place_params, prepare_params
from repro_torch.data.pipeline import video_fleet
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (MODEL_RULES, ShardingCtx,
                                              use_sharding)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import sharded_encoder
from repro_torch.models.sharded_encoder import fused_ffn_sharded
from repro_torch.models.vit import encode_tokens, vit_logical_axes
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


def serve_sharded(raw: dict, n_streams: int, n_frames: int,
                  phase: int) -> dict:
    """The smoke config served model-sharded over every rank (2 streams by
    default), what ``model_shards=2`` on an ineligible config raises, and
    what a server without model shards raises on this multi-rank world."""
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
            "unsharded": _raises(lambda: StreamServer(
                cfg, ServerConfig(microbatch=4, chunk=8),
                params=from_jax_params(raw, "cpu"), device="cpu"))}


def suite(x_halves: np.ndarray, ffn_cases: list, raw: dict, cfg,
          requests: list, n_streams: int, n_frames: int, phase: int) -> dict:
    """Everything the 2-rank CPU tests read, from one spawn."""
    return {"modules": sorted(m.split(".")[0] for m in sys.modules),
            "absmax": absmax_halves(x_halves, (8, 4)),
            "ffn": ffn_sharded(ffn_cases),
            "encode": encode_sharded(raw, cfg, requests),
            "serve": serve_sharded(raw, n_streams, n_frames, phase)}
