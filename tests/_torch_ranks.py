"""Rank bodies for the port's multi-rank tests (``test_torch_sharding.py``,
``test_torch_data_mesh.py``, ``test_torch_lm_mesh.py``,
``test_torch_lm_fsdp.py``, ``test_torch_lm_multipod.py``,
``test_torch_vit_mesh.py``, ``test_torch_hybrid_mesh.py``,
``test_torch_hybrid.py``, ``test_torch_hybrid_fsdp.py``,
``test_torch_gpu.py``), run by
``repro_torch.launch.mesh.spawn_ranks``.

A spawned rank imports this module by name to find its function, so it
imports neither JAX nor the reference package: the ranks are the port
alone. Inputs arrive as numpy arrays; results go back as numpy arrays and
plain Python values.
"""

import contextlib
import dataclasses
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
    mesh's serve of the same traffic, and its serve under a composed
    policy (the xla FFN) beside the same policy served on one rank alone
    (``mesh="off"``)."""
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
            "unsharded_composed": {
                mesh: serve_streams(StreamServer(
                    cfg.with_(ffn_backend="xla"),
                    ServerConfig(microbatch=4, chunk=8, mesh=mesh),
                    params=from_jax_params(raw, "cpu"), device="cpu"),
                    n_streams, n_frames, phase, cut_every=16)
                for mesh in ("auto", "off")}}


def suite(x_halves: np.ndarray, ffn_cases: list, raw: dict, cfg,
          requests: list, n_streams: int, n_frames: int, phase: int) -> dict:
    """Everything the 2-rank CPU tests read, from one spawn."""
    return {"modules": sorted(m.split(".")[0] for m in sys.modules),
            "absmax": absmax_halves(x_halves, (8, 4)),
            "ffn": ffn_sharded(ffn_cases),
            "encode": encode_sharded(raw, cfg, requests),
            "serve": serve_sharded(raw, n_streams, n_frames, phase)}


# --------------------------------------------------------------------------
# the tensor- and data-parallel LM (test_torch_lm_mesh.py)
# --------------------------------------------------------------------------

def _np32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np32(tree)


def _lm_grads(cfg, local, batch, ctx) -> tuple:
    """(global loss, the logical gradient tree as f32 numpy, grad norm):
    this rank's blocks' mesh gradient gathered over "model"."""
    from repro_torch.launch import steps

    from repro_torch.models import api
    from repro_torch.optim.adamw import clip_by_global_norm

    loss, g = steps.make_grad_fn(cfg)(local, batch)
    axes = steps.placement_axes(cfg, api.model_logical_axes(cfg))
    whole = steps.gather_tree(g, axes, ctx)
    _, _, split, model_g = steps._mesh_facts(cfg)
    _, gn = clip_by_global_norm(g, 1.0, split, model_g)
    return float(loss), _np_tree(whole), float(gn)


def lm_mesh_suite(tree: dict, cfg, prompt: np.ndarray, forced: np.ndarray,
                  batch: dict, cache_len: int, extra: dict,
                  ckpt_dir: str) -> dict:
    """One rank of the (2, 2) ("data", "model") mesh on the CPU: the
    tensor- and data-parallel LM's prefill and teacher-forced decode
    logits (this rank's rows), one train step's gradient (logical), the
    int8 prefill against the unsharded one, the extra configs
    (``extra``: name -> (cfg, params)) against their unsharded runs, a
    planted fault, and a checkpoint of 2 sharded train steps."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, transformer
    from repro_torch.models.attention import kv_runs
    from repro_torch.optim.adamw import tree_leaves

    mesh = make_host_mesh(2, 2, device="cpu")
    out = {"coords": (mesh.d, mesh.m), "shape": mesh.shape,
           "jax_loaded": "jax" in sys.modules,
           "repro_loaded": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}
    with use_sharding(mesh) as ctx:
        rows = sharding.named_sharding(prompt.shape, ("batch", "seq"), ctx)

        def mine(a):
            return rows.block(torch.from_numpy(np.ascontiguousarray(a)))

        local = transformer.place_lm_params(tree, cfg)
        out["wq_shape"] = tuple(local["blocks"]["attn"]["wq"].shape)
        out["w_down_shape"] = tuple(local["blocks"]["ffn"]["w_down"].shape)
        with torch.no_grad():
            out["prefill"] = _np32(api.prefill_fn(
                local, {"tokens": mine(prompt)}, cfg))
            # teacher-forced decode: the prompt through the decode step,
            # then the given tokens, so a near-tie cannot cascade
            cache = serve.init_cache(cfg, prompt.shape[0], cache_len, "cpu")
            out["cache_shape"] = tuple(cache["k"].shape)
            lg, cache = serve.prefill_into_cache(local, cache, mine(prompt),
                                                 cfg)
            steps_ = [lg]
            f = mine(forced)
            for t in range(f.shape[1]):
                lg, cache = api.decode_fn(local, cache, f[:, t:t + 1],
                                          prompt.shape[1] + t, cfg)
                steps_.append(lg)
            out["decode"] = _np32(torch.stack(steps_, 1))
            # greedy generation: the ranks of a model group must agree
            gcache = serve.init_cache(cfg, prompt.shape[0], cache_len, "cpu")
            out["greedy"] = serve.generate(local, gcache, mine(prompt), 4,
                                           cfg)[0].numpy()

        tb = {k: mine(v) for k, v in batch.items()}
        out["loss"], out["grads"], out["gnorm"] = _lm_grads(cfg, local, tb,
                                                            ctx)
        saved = collectives.copy_to_model
        collectives.copy_to_model = lambda x, group: x
        try:
            _, out["grads_planted"], _ = _lm_grads(cfg, local, tb, ctx)
        finally:
            collectives.copy_to_model = saved

        # int8: the tensor- and data-parallel prefill on the prepared cache
        # against the unsharded one on the whole batch (no context)
        cfg8 = cfg.with_(matmul_backend="photonic_pallas")
        cache8 = prepare_params(tree, bits=8)
        with torch.no_grad():
            tp8 = api.prefill_fn(transformer.place_lm_params(cache8, cfg8),
                                 {"tokens": mine(prompt)}, cfg8)
            with sharding._installed(None):
                whole8 = api.prefill_fn(cache8, {"tokens": torch.from_numpy(
                    prompt)}, cfg8)
        out["int8_bitwise"] = torch.equal(tp8, rows.block(whole8))
        out["int8_maxdiff"] = float((tp8.float() - rows.block(
            whole8).float()).abs().max())

        # the extra configs (straddling GQA groups, a model axis that does
        # not divide the heads or d_ff) against their unsharded runs
        out["extra"] = {}
        for name, (xcfg, xtree) in extra.items():
            xl = transformer.place_lm_params(xtree, xcfg)
            with torch.no_grad():
                tp = api.prefill_fn(xl, {"tokens": mine(prompt)}, xcfg)
                with sharding._installed(None):
                    one = api.prefill_fn(xtree, {"tokens": torch.from_numpy(
                        prompt)}, xcfg)
            loss, grads, _ = _lm_grads(xcfg, xl, tb, ctx)
            with sharding._installed(None):
                l1, g1 = steps.make_grad_fn(xcfg)(
                    xtree, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
            out["extra"][name] = {
                "prefill": _np32(tp), "unsharded": _np32(rows.block(one)),
                "loss": loss, "loss1": float(l1), "grads": grads,
                "grads1": _np_tree(g1),
                "runs": kv_runs(xcfg.n_heads, xcfg.kv_heads,
                                transformer.heads_split(xcfg)),
                "wq_shape": tuple(xl["blocks"]["attn"]["wq"].shape),
                "w_gate_shape": tuple(xl["blocks"]["ffn"]["w_gate"].shape)}

        # 2 sharded train steps with a checkpoint each step; the state
        # gathered; the checkpoint restored into this rank's blocks
        shape = ShapeConfig("mesh", prompt.shape[1], prompt.shape[0],
                            "train")
        state0 = train.init_state(cfg, 0, "cpu")
        final, losses, _ = train.train_loop(
            cfg, shape, 2, device="cpu", state=state0,
            ckpt=CheckpointManager(ckpt_dir, every=1))
        axes = steps.placement_axes(cfg, steps.state_logical_axes(cfg))
        out["losses"] = losses
        out["final"] = _np_tree(steps.gather_tree(final, axes, ctx))
        back, step = restore(f"{ckpt_dir}/step_2", final, ctx, axes)
        out["restored_step"] = step
        out["restored_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                              tree_leaves(final)))
    return out


def lm_tp_prefill(params: dict, cfg, prompt, device: str) -> dict:
    """One rank of a (1, 2) mesh: the tensor-parallel prefill's logits
    (f32 numpy) and this rank's kernel launches."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, transformer
    from repro_torch.optim.adamw import tree_map

    mesh = make_host_mesh(1, 2, device=device)
    whole = tree_map(lambda t: t.to(mesh.device), params)
    with use_sharding(mesh), torch.no_grad():
        local = transformer.place_lm_params(whole, cfg)
        api.prefill_fn(local, {"tokens": prompt[:, :8].to(mesh.device)}, cfg)
        _build.LAUNCHES.clear()
        logits = api.prefill_fn(local, {"tokens": prompt.to(mesh.device)},
                                cfg)
    return {"logits": _np32(logits), "launches": dict(_build.LAUNCHES)}


# --------------------------------------------------------------------------
# the dense LM under DEFAULT_RULES / MULTIPOD_RULES (test_torch_lm_fsdp.py,
# test_torch_lm_multipod.py)
# --------------------------------------------------------------------------

def _fsdp_mesh(pod: bool):
    """(mesh, rules): the (2, 2) ("data", "model") mesh under
    DEFAULT_RULES, or the (2, 1, 2) ("pod", "data", "model") mesh, whose
    rules_for_mesh choice is MULTIPOD_RULES."""
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh

    if pod:
        mesh = _build_mesh(1, 2, "cpu", _AXES, n_pod=2)
        return mesh, rules_for_mesh(mesh)
    return make_host_mesh(2, 2, device="cpu"), sharding.DEFAULT_RULES


def lm_fsdp_suite(tree: dict, cfg, prompt: np.ndarray, forced: np.ndarray,
                  batch: dict, cache_len: int, ckpt_dir: str | None,
                  pod: bool = False) -> dict:
    """One rank of the dense LM on a mesh under DEFAULT_RULES ((2, 2)) or
    MULTIPOD_RULES ((2, 1, 2), ``pod``): this rank's block (its batch rows,
    its vocab block) of the prefill and teacher-forced decode logits, its
    greedy tokens, one train step's loss, logical gradient and clip norm,
    its blocks' and cache's shapes, the int8 prefill against the
    unsharded one; and with a ``ckpt_dir`` the planted faults (an FSDP
    backward with no reduce-scatter, a vocab loss with the max of the
    local block, a decode merge that drops the last rank's partial) and a
    checkpoint of 2 train steps."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import api, attention, transformer
    from repro_torch.optim.adamw import tree_leaves

    mesh, rules = _fsdp_mesh(pod)
    out = {"shape": mesh.shape, "jax_loaded": "jax" in sys.modules,
           "repro_loaded": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}
    with use_sharding(mesh, rules) as ctx:
        out["rules"] = dict(ctx.rules)
        rows = sharding.named_sharding(prompt.shape, ("batch", "seq"), ctx)
        out["coords"] = (sharding._axis_coord(mesh, rules["batch"]), mesh.m)

        def mine(a):
            return rows.block(torch.from_numpy(np.ascontiguousarray(a)))

        local = transformer.place_lm_params(tree, cfg)
        out["shapes"] = {k: tuple(v.shape) for k, v in (
            ("embed", local["embed"]), ("wq", local["blocks"]["attn"]["wq"]),
            ("wk", local["blocks"]["attn"]["wk"]),
            ("wo", local["blocks"]["attn"]["wo"]),
            ("w_up", local["blocks"]["ffn"]["w_up"]),
            ("w_down", local["blocks"]["ffn"]["w_down"]),
            ("ln1", local["blocks"]["ln1"]))}

        def teacher_forced():
            cache = serve.init_cache(cfg, prompt.shape[0], cache_len, "cpu")
            lg, cache = serve.prefill_into_cache(local, cache, mine(prompt),
                                                 cfg)
            lgs, f = [lg], mine(forced)
            for t in range(f.shape[1]):
                lg, cache = api.decode_fn(local, cache, f[:, t:t + 1],
                                          prompt.shape[1] + t, cfg)
                lgs.append(lg)
            return _np32(torch.stack(lgs, 1)), cache

        with torch.no_grad():
            out["prefill"] = _np32(api.prefill_fn(
                local, {"tokens": mine(prompt)}, cfg))
            out["decode"], cache = teacher_forced()
            out["cache_shape"] = tuple(cache["k"].shape)
            gcache = serve.init_cache(cfg, prompt.shape[0], cache_len, "cpu")
            out["greedy"] = serve.generate(local, gcache, mine(prompt),
                                           forced.shape[1], cfg)[0].numpy()
            scache = serve.init_cache(cfg, prompt.shape[0], cache_len, "cpu")
            out["sampled"] = serve.generate(
                local, scache, mine(prompt), 2, cfg, greedy=False,
                generator=torch.Generator().manual_seed(0))[0].numpy()

        tb = {k: mine(v) for k, v in batch.items()}
        out["loss"], out["grads"], out["gnorm"] = _lm_grads(cfg, local, tb,
                                                            ctx)

        # int8: the prefill on the prepared cache against the unsharded
        # one on the whole batch (no context), this rank's block of it
        cfg8 = cfg.with_(matmul_backend="photonic_pallas")
        cache8 = prepare_params(tree, bits=8)
        with torch.no_grad():
            got8 = api.prefill_fn(transformer.place_lm_params(cache8, cfg8),
                                  {"tokens": mine(prompt)}, cfg8)
            with sharding._installed(None):
                whole8 = api.prefill_fn(cache8, {"tokens": torch.from_numpy(
                    prompt)}, cfg8)
        want8 = sharding.local_shard(
            whole8, sharding.logical_spec(whole8.shape, ("batch", None,
                                                         "p_vocab"), ctx),
            mesh)
        out["int8_bitwise"] = torch.equal(got8, want8)
        out["int8_maxdiff"] = float((got8.float() - want8.float()).abs()
                                    .max())
        if ckpt_dir is None:
            return out

        # the planted faults, each on every rank (their collectives pair up)
        n = transformer.fsdp_split(cfg).n

        def fsdp_no_reduce(g, group, dim):
            step = g.shape[dim] // n
            part = g.narrow(dim, torch.distributed.get_rank(group) * step,
                            step)
            return (part.float() / n).to(g.dtype)

        merge = attention.merge_partials
        planted = {"fsdp backward without its reduce-scatter": (
                       collectives, "reduce_scatter_mean", fsdp_no_reduce),
                   "vocab loss with the local block's max": (
                       collectives, "vocab_max", lambda x, group: x.detach()),
                   "decode merge without the last rank's partial": (
                       attention, "merge_partials",
                       lambda o, lse: merge(o[:-1], lse[:-1]))}
        out["planted"] = {}
        for tag, (mod, name, fn) in planted.items():
            saved = getattr(mod, name)
            setattr(mod, name, fn)
            try:
                if tag.startswith("decode"):
                    with torch.no_grad():
                        out["planted"][tag] = teacher_forced()[0]
                else:
                    out["planted"][tag] = _lm_grads(cfg, local, tb, ctx)
            finally:
                setattr(mod, name, saved)

        # 2 train steps with a checkpoint each step; the state gathered;
        # the checkpoint restored into this rank's blocks
        shape = ShapeConfig("fsdp", prompt.shape[1], prompt.shape[0],
                            "train")
        final, losses, _ = train.train_loop(
            cfg, shape, 2, device="cpu", state=train.init_state(cfg, 0,
                                                                "cpu"),
            ckpt=CheckpointManager(ckpt_dir, every=1))
        axes = steps.placement_axes(cfg, steps.state_logical_axes(cfg))
        out["losses"] = losses
        out["final"] = _np_tree(steps.gather_tree(final, axes, ctx))
        out["m_shape"] = tuple(final["opt"]["m"]["blocks"]["attn"]["wq"]
                               .shape)
        back, step = restore(f"{ckpt_dir}/step_2", final, ctx, axes)
        out["restored_step"] = step
        out["restored_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                              tree_leaves(final)))
    return out


# --------------------------------------------------------------------------
# ViT training on every mesh (test_torch_vit_mesh.py)
# --------------------------------------------------------------------------

VIT_FAULTS = {"data": "rank-local activation scales",
              "model": "w2's weight absmax without its MAX over model",
              "default": "the FSDP backward without its reduce-scatter"}


def _vit_meshes() -> dict:
    """The four tables' meshes over the same 4 ranks: ("data",) 4 under
    DATA_RULES, (2, 2) under MODEL_RULES and DEFAULT_RULES, (2, 1, 2)
    ("pod", "data", "model") under MULTIPOD_RULES."""
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh

    data = _build_mesh(4, 1, "cpu", axis_names=("data",))
    dm = make_host_mesh(2, 2, device="cpu")
    pod = _build_mesh(1, 2, "cpu", _AXES, n_pod=2)
    return {"data": (data, sharding.DATA_RULES),
            "model": (dm, sharding.MODEL_RULES),
            "default": (dm, sharding.DEFAULT_RULES),
            "multipod": (pod, sharding.MULTIPOD_RULES)}


def _vit_step(cfg, state, batch, ctx) -> dict:
    """One mesh train step on this rank's blocks of ``state`` and rows of
    ``batch`` (whole, numpy): the global loss, the clip norm and the new
    first moment (logical: 0.1 x the clipped gradient with f32 moments),
    and the shapes this rank holds."""
    from repro_torch.launch import steps
    from repro_torch.models import api

    st_axes = steps.placement_axes(cfg, steps.state_logical_axes(cfg))
    local = place_params(state, st_axes, ctx)
    rows = {k: named_sharding_rows(v, ctx) for k, v in batch.items()}
    new, m = steps.make_train_fn(cfg)(local, rows)
    p_axes = steps.placement_axes(cfg, api.model_logical_axes(cfg))
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "m": _np_tree(steps.gather_tree(new["opt"]["m"], p_axes, ctx)),
            "local": {k: tuple(v.shape) for k, v in (
                ("wq", local["params"]["blocks"]["attn"]["wq"]),
                ("wo", local["params"]["blocks"]["attn"]["wo"]),
                ("w1", local["params"]["blocks"]["ffn"]["w1"]),
                ("w2", local["params"]["blocks"]["ffn"]["w2"]),
                ("patch_w", local["params"]["patch_embed"]["w"]),
                ("head", local["params"]["head"]),
                ("images", rows["images"]))}}


def named_sharding_rows(a: np.ndarray, ctx) -> torch.Tensor:
    """This rank's rows of a whole batch array (its block along "batch")."""
    spec = sharding.named_sharding(a.shape, ("batch",) + (None,) * (
        a.ndim - 1), ctx)
    return spec.block(torch.from_numpy(np.ascontiguousarray(a))).contiguous()


def _row_parallel_cases(cases: list, ctx) -> list:
    """``row_parallel_linear`` on this rank's rows of x and block of the
    contraction (rows split over the batch axes, K over "model") inside
    the mesh's scope, the outputs' rows gathered, as f32: one array a case
    (x, w, policy kwargs, "f32" or "bf16")."""
    from repro_torch.launch.steps import gather_tree
    from repro_torch.models.layers import row_parallel_linear

    mesh = ctx.mesh
    out = []
    for x, w, kw, dt in cases:
        k = w.shape[0] // mesh.model
        ks = slice(mesh.m * k, (mesh.m + 1) * k)
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        xl = named_sharding_rows(x, ctx)[:, ks].to(dtype)
        wl = torch.from_numpy(np.ascontiguousarray(w[ks])).to(dtype)
        with sharding.mesh_scope(), torch.no_grad():
            y = row_parallel_linear(xl, wl, ExecPolicy(**kw),
                                    mesh.group("model"))
        out.append(_np32(gather_tree(y, ("batch", None), ctx)))
    return out


def fused_serve(whole: dict, cfg, tokens: np.ndarray, ctx) -> dict:
    """The fused serving encode of ``tokens`` under ``ctx`` on a cache
    prepared from ``whole`` (a train state's params) as a trainer holds
    it: placed as blocks, gathered back (``steps.gather_tree``), prepared,
    and put in the form the encode reads (``vit.serving_cache``); beside
    it the one-device encode of the same cache, and the same mesh encode
    with every absmax scope left local to the rank (a planted fault)."""
    from repro_torch.launch import steps
    from repro_torch.models import api, vit

    fused = cfg.with_(matmul_backend="photonic_pallas", attn_backend="flash",
                      ffn_backend="fused")
    pol = ExecPolicy.from_cfg(fused, training=False)
    axes = steps.placement_axes(cfg, api.model_logical_axes(cfg))
    blocks = place_params(whole, axes, ctx)
    cache = prepare_params(steps.gather_tree(blocks, axes, ctx), bits=8)
    served = vit.serving_cache(cache, fused, pol, ctx)
    toks = torch.from_numpy(tokens)
    before = (sharded_encoder.sharded_encode_calls(), data_split_calls())
    with torch.no_grad():
        mesh = encode_tokens(served, toks, fused, pol, device="cpu")
        with local_absmax_scopes():
            planted = encode_tokens(served, toks, fused, pol, device="cpu")
        with sharding._installed(None):
            one = encode_tokens(cache, toks, fused, pol, device="cpu")
    return {"mesh": mesh.numpy(), "one": one.numpy(),
            "planted": planted.numpy(),
            "sharded": sharded_encoder.sharded_encode_calls() - before[0],
            "split": data_split_calls()["split"] - before[1]["split"],
            "wq": tuple(served["blocks"]["attn"]["wq"].wq.shape)}


def vit_mesh_suite(states: dict, cfgs: dict, batch: dict, rp_cases: list,
                   lm: tuple, ckpt_dir: str, tokens: np.ndarray) -> dict:
    """One rank of the ViT's training on all four tables (``_vit_meshes``):
    each case of ``cfgs`` (name -> cfg, its whole train state in
    ``states``) one mesh step on ``batch``; the planted faults
    (``VIT_FAULTS``, on the "plain" case); ``rp_cases`` through
    ``row_parallel_linear`` and the "plain" step under remat under
    MODEL_RULES; the dense LM ``lm`` =
    (cfg, whole params, numpy batch) one qat gradient under MODEL_RULES;
    2 train steps under DEFAULT_RULES checkpointed each step into
    ``ckpt_dir``, gathered; and under DEFAULT_RULES and MULTIPOD_RULES the
    "plain" params served on the fused point (``fused_serve`` of
    ``tokens``)."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps, train
    from repro_torch.optim.adamw import tree_leaves

    meshes = _vit_meshes()
    out = {"jax_loaded": "jax" in sys.modules,
           "repro_loaded": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules),
           "steps": {}, "planted": {}, "fused": {}}

    def fsdp_no_reduce(g, group, dim):
        n = torch.distributed.get_world_size(group)
        step = g.shape[dim] // n
        part = g.narrow(dim, torch.distributed.get_rank(group) * step, step)
        return (part.float() / n).to(g.dtype)

    whole_scale = collectives.replicated_absmax_scale

    def local_weight_scale(x, bits, group, eps=1e-8, axis=None):
        # an activation's MAX kept, a row-split weight's per-column one not
        if axis is None:
            return whole_scale(x, bits, group, eps)
        from repro_torch.core import quant
        return quant.absmax_scale(x, bits=bits, axis=axis)

    planted = {"data": (sharding, "absmax_group", lambda: None),
               "model": (collectives, "replicated_absmax_scale",
                         local_weight_scale),
               "default": (collectives, "reduce_scatter_mean",
                           fsdp_no_reduce)}
    for table, (mesh, rules) in meshes.items():
        with use_sharding(mesh, rules) as ctx:
            for name, cfg in cfgs.items():
                out["steps"][(table, name)] = _vit_step(cfg, states[name],
                                                        batch, ctx)
            if table in planted:
                mod, attr, fn = planted[table]
                saved = getattr(mod, attr)
                setattr(mod, attr, fn)
                try:
                    out["planted"][table] = _vit_step(
                        cfgs["plain"], states["plain"], batch, ctx)["m"]
                finally:
                    setattr(mod, attr, saved)
            if table == "model":
                out["remat"] = _vit_step(cfgs["plain"].with_(remat=True),
                                         states["plain"], batch, ctx)
                out["row_parallel"] = _row_parallel_cases(rp_cases, ctx)
                lcfg, ltree, lbatch = lm
                from repro_torch.models import transformer
                loss, g, _ = _lm_grads(lcfg, transformer.place_lm_params(
                    ltree, lcfg), {k: named_sharding_rows(v, ctx)
                                   for k, v in lbatch.items()}, ctx)
                out["lm_qat"] = (loss, g)
            if table in ("default", "multipod"):
                out["fused"][table] = fused_serve(
                    states["plain"]["params"], cfgs["plain"], tokens, ctx)
            if table == "default":
                cfg = cfgs["plain"]
                shape = ShapeConfig("vit_mesh", 0, batch["labels"].shape[0],
                                    "train")
                axes = steps.placement_axes(cfg, steps.state_logical_axes(cfg))
                final, losses, _ = train.train_loop(
                    cfg, shape, 2, device="cpu",
                    state=place_params(states["plain"], axes, ctx),
                    ckpt=CheckpointManager(ckpt_dir, every=1))
                out["losses"] = losses
                out["final"] = _np_tree(steps.gather_tree(final, axes, ctx))
                back, step = restore(f"{ckpt_dir}/step_2", final, ctx, axes)
                out["restored"] = (step, all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                      tree_leaves(final))))
    return out


def vit_mesh_card(params: dict, cfg, batch: dict,
                  device: str = "cuda") -> dict:
    """One rank of the (data 1, model 2) mesh under MODEL_RULES on
    ``device``: one step's global loss and logical gradient (numpy) on
    this rank's blocks of the whole ``params`` and ``batch``, and whether
    the photonic_sim row-parallel entry at w2's shape is bitwise the
    unsharded entry."""
    from repro_torch.device import full_precision_matmuls
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.layers import row_parallel_linear
    from repro_torch.optim.adamw import tree_map

    mesh = make_host_mesh(1, 2, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        full_precision_matmuls()
    whole = tree_map(lambda t: t.to(dev), params)
    out = {}
    with use_sharding(mesh, sharding.MODEL_RULES) as ctx:
        axes = steps.placement_axes(cfg, api.model_logical_axes(cfg))
        local = place_params(whole, axes, ctx)
        rows = {k: named_sharding_rows(v, ctx).to(dev)
                for k, v in batch.items()}
        loss, g = steps.make_grad_fn(cfg)(local, rows)
        out["loss"] = float(loss)
        out["grads"] = _np_tree(steps.gather_tree(g, axes, ctx))
        gen = torch.Generator(device=dev).manual_seed(3)
        h = torch.randn(6304, cfg.d_ff, generator=gen, device=dev)
        w2 = whole["blocks"]["ffn"]["w2"][0]
        k = cfg.d_ff // 2
        ks = slice(mesh.m * k, (mesh.m + 1) * k)
        pol = ExecPolicy(8, "photonic_sim", training=False)
        with sharding.mesh_scope(), torch.no_grad():
            y = row_parallel_linear(h[:, ks], w2[ks], pol,
                                    mesh.group("model"))
            with sharding._installed(None):
                y1 = pol.matmul_fn(h, w2, pol)
        out["sim_bitwise"] = bool(torch.equal(y, y1))
    return out


# --------------------------------------------------------------------------
# every serving policy on the serving meshes and microbatched quantizing
# steps over batch ranks (test_torch_serve_mesh.py)
# --------------------------------------------------------------------------

def scale_recorder(rec: list):
    """A ``quant.fake_quant_ste`` that appends each per-tensor call's scale
    (as numpy) to ``rec``: a step's activation scales in call order."""
    from repro_torch.core import quant
    real = quant.fake_quant_ste

    def fq(x, bits=8, axis=None, scale=None):
        if scale is None:
            scale = quant.absmax_scale(x, bits=bits, axis=axis)
        if axis is None:
            rec.append(scale.detach().float().cpu().numpy().reshape(-1))
        return real(x, bits, axis, scale)
    return fq


@contextlib.contextmanager
def patched(owner, name: str, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def serve_logged(cfg, sc, raw: dict, n_streams: int, n_frames: int,
                 phase: int) -> dict:
    """``serve_streams`` on a server of (cfg, sc) over the raw ``raw``
    tree, with each flush's DriftState words and tokens, and the server's
    recalibrations and final state."""
    server = StreamServer(cfg, sc, params=from_jax_params(raw, "cpu"),
                          device="cpu")
    states, tokens, finish = {}, {}, server._finish

    def finish_and_log(fb, by_sid):
        finish(fb, by_sid)
        key = tuple(fb.frame_idx)
        states[key] = server.last_drift.words()
        tokens[key] = fb.tokens.cpu().numpy()
    server._finish = finish_and_log
    out = serve_streams(server, n_streams, n_frames, phase, cut_every=16)
    out.update(states=states, tokens=tokens,
               recalibrations=server.recalibrations,
               final=server.drift.words(),
               mesh=None if server.mesh is None else dict(server.mesh.shape))
    return out


def microbatched_steps(cases: dict, lm: dict) -> dict:
    """One quantizing train step of each ViT case (name -> (cfg with
    ``microbatch_steps`` 2, whole numpy train state, whole numpy batch))
    and one gradient of each dense LM case of ``lm`` (name -> (cfg, whole
    params, numpy batch)) under DATA_RULES on the ("data",) mesh of every
    rank, each rank's rows its share of every global microbatch
    (``pipeline._rank_rows``): the global loss, the new first moment (ViT)
    or gradient and its norm (LM) and the activation scales in call order;
    and the ViT's "plain" step on the rank-local row split of one
    microbatch (a planted fault)."""
    from repro_torch.data.pipeline import _rank_rows
    from repro_torch.launch import steps
    from repro_torch.core import quant

    mesh = make_serving_mesh(model=1, device="cpu")
    out = {}
    with use_sharding(mesh, sharding.DATA_RULES) as ctx:
        def step(cfg, state, batch, k):
            rows = {n: torch.from_numpy(v) for n, v in
                    _rank_rows(batch, ctx, k).items()}
            st = place_params(state, steps.placement_axes(
                cfg, steps.state_logical_axes(cfg)), ctx)
            rec = []
            with patched(quant, "fake_quant_ste", scale_recorder(rec)):
                new, m = steps.make_train_fn(cfg)(st, rows)
            return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
                    "m": _np_tree(new["opt"]["m"]), "scales": rec,
                    "rows": tuple(rows["labels"].shape)}
        for name, (cfg, state, batch) in cases.items():
            out[name] = step(cfg, state, batch, cfg.microbatch_steps)
        cfg, state, batch = cases["plain"]
        out["planted"] = step(cfg, state, batch, 1)
        out["lm"] = {}
        for name, (lcfg, ltree, lbatch) in lm.items():
            rows = {n: torch.from_numpy(v) for n, v in
                    _rank_rows(lbatch, ctx, lcfg.microbatch_steps).items()}
            rec = []
            with patched(quant, "fake_quant_ste", scale_recorder(rec)):
                loss, g, gn = _lm_grads(lcfg, ltree, rows, ctx)
            out["lm"][name] = {"loss": loss, "grads": g, "gnorm": gn,
                               "scales": rec}
        out["uneven"] = _raises(lambda: _rank_rows(
            {"labels": np.zeros(6, np.int32)}, ctx, 2))
    return out


def serve_mesh_suite(raw: dict, noisy_cfgs: dict, n_streams: int,
                     n_frames: int, phase: int, mb_cases: dict,
                     lm: dict) -> dict:
    """Everything the 2-rank CPU tests of ``test_torch_serve_mesh.py``
    read, from one spawn: each noisy config of ``noisy_cfgs`` served on the
    data mesh ("data" 2) and on this rank alone (``mesh="off"``), "pallas"
    also on the model_shards mesh (1, 2); the data mesh's serve with every
    readout drawn at offset 0 (a planted fault); ``microbatched_steps``."""
    sc = ServerConfig(microbatch=4, chunk=8, warm_start=False)
    out = {"modules": sorted(m.split(".")[0] for m in sys.modules)}
    for tag, cfg in noisy_cfgs.items():
        meshes = {"data": {}, "off": {"mesh": "off"}}
        if tag == "pallas":
            meshes["model"] = {"model_shards": 2}
        out[tag] = {mesh: serve_logged(cfg, dataclasses.replace(sc, **kw),
                                       raw, n_streams, n_frames, phase)
                    for mesh, kw in meshes.items()}
    with patched(sharding, "draw_offset", lambda n: 0):
        out["offset0"] = serve_logged(noisy_cfgs["sim"], sc, raw, n_streams,
                                      n_frames, phase)
    out["steps"] = microbatched_steps(mb_cases, lm)
    return out


# --------------------------------------------------------------------------
# the hybrid LM on the ("data", "model") mesh (test_torch_hybrid_mesh.py)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def hybrid_tp_arithmetic(params: dict, cfg, n: int = 2, vocab: bool = False):
    """The unsharded hybrid forward computing on one device what each rank
    of a (1, n) mesh under MODEL_RULES computes: the column-parallel
    weights (wq, w_gate, w_up, in_proj, gate_proj) in their n contiguous
    column blocks, the attention one call a rank's query heads, the
    row-parallel wo / w_down / out_proj in their n row blocks, and the
    RG-LRU's gate GEMMs over the rank's u block and w_a / w_x rows, each
    block's product in f32, summed in f32 in rank order and rounded once;
    with ``vocab`` also the head in its n vocab (column) blocks. Where
    each GEMM depends only on its own operands, the mesh's logits are
    bitwise these. The blocks are cut from ``params``' leaves at each
    call (found by storage, so a detached copy's too), so a gradient
    reaches them: differentiated, it is the mesh step's order control."""
    from repro_torch.distributed.sharding import Split
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import transformer

    def key(w):
        return w.data_ptr(), tuple(w.shape)

    cols, rows = set(), set()

    def note(layers, col_names, row_names):
        for name in col_names:
            cols.update(key(w) for w in layers[name])
        for name in row_names:
            rows.update(key(w) for w in layers[name])

    layers = list(params["blocks"].values())
    if "tail_blocks" in params:
        layers.append(params["tail_blocks"])
    for sub in layers:
        if "rec" in sub:
            note(sub["rec"], ("in_proj", "gate_proj"), ("out_proj",))
        else:
            note(sub["attn"], ("wq",), ("wo",))
        note(sub["ffn"], ("w_gate", "w_up"), ("w_down",))
    if vocab:
        cols.add(key(params["lm_head"]))
    real = (transformer.linear, ffn_mod.linear, rglru_mod.linear,
            transformer._attend, transformer._decode,
            rglru_mod._gate_preacts)

    def linear(x, w, b=None, policy=None):
        if key(w) in cols:
            s = w.shape[-1] // n
            return torch.cat([real[0](x, w[:, j * s:(j + 1) * s].contiguous(),
                                      None if b is None else
                                      b[j * s:(j + 1) * s], policy)
                              for j in range(n)], -1)
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


def _hybrid_serve(params, cfg, prompt, forced, ring: int, rows: int,
                  dev="cpu"):
    """(prefill logits, the decode logits at every position: the prompt
    stepped through the decode, then ``forced``) of the port on
    ``params`` under the installed context (none: one device); ``rows``
    the whole batch's, of which ``prompt`` holds this rank's."""
    from repro_torch.launch import serve
    from repro_torch.models import api

    with torch.no_grad():
        pre = api.prefill_fn(params, {"tokens": prompt}, cfg)
        cache = serve.init_cache(cfg, rows, ring, dev)
        toks = torch.cat([prompt, forced], 1)
        lgs = []
        for pos in range(toks.shape[1]):
            lg, cache = api.decode_fn(params, cache, toks[:, pos:pos + 1],
                                      pos, cfg)
            lgs.append(lg)
    return pre, torch.stack(lgs, 1)


def _b_a_on_every_rank(p, uf, split):
    """A planted fault: each rank adds the biases to its partial before the
    reduce, so the reduced sum carries them n times."""
    from repro_torch.models import rglru as rglru_mod

    partial = torch.stack([uf @ p["w_a"].float() + p["b_a"],
                           uf @ p["w_x"].float() + p["b_x"]])
    if split is None:
        return partial[0], partial[1]
    whole = rglru_mod._reduce_gates(partial, split.group)
    c0, c1 = split.block(whole.shape[-1])
    return whole[0, ..., c0:c1], whole[1, ..., c0:c1]


HYBRID_FAULTS = {"gate partials not reduced": ("_reduce_gates",
                                               lambda partial, group: partial),
                 "b_a added on every rank": ("_gate_preacts",
                                             _b_a_on_every_rank)}
HYBRID_WHOLE = ("conv_w", "lambda", "b_a", "b_x", "ln1", "ln2", "final_ln",
                "embed", "lm_head", "wk", "wv")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def hybrid_mesh_suite(tree: dict, cfg, prompt: np.ndarray,
                      forced: np.ndarray, batch: dict, ring: int,
                      steps: int) -> dict:
    """One of 2 CPU ranks: the hybrid under MODEL_RULES on (data 1, model
    2) and under DATA_RULES on (data 2). For each: this rank's rows of the
    prefill logits and of the decode logits at every position over a
    ``ring``-slot ring, greedy tokens, one train step's logical gradient
    and global loss, ``steps`` steps through ``train_loop`` (its losses and
    the whole leaves after them, as numpy); under MODEL_RULES also the
    prefill and decode on one device under ``hybrid_tp_arithmetic`` (the
    rank's rows), the placed shapes, and two planted faults' prefills."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, steps as steps_mod, train
    from repro_torch.launch.mesh import _build_mesh, make_host_mesh
    from repro_torch.models import api, transformer
    from repro_torch.models import rglru as rglru_mod

    meshes = {"model": (make_host_mesh(1, 2, device="cpu"),
                        sharding.MODEL_RULES),
              "data": (_build_mesh(2, 1, "cpu", axis_names=("data",)),
                       sharding.DATA_RULES)}
    out = {"jax_loaded": "jax" in sys.modules,
           "repro_loaded": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}
    for name, (mesh, rules) in meshes.items():
        r = out[name] = {"coords": (mesh.d, mesh.m)}
        with use_sharding(mesh, rules) as ctx:
            rows = sharding.named_sharding(prompt.shape, ("batch", "seq"),
                                           ctx)

            def mine(a):
                return rows.block(torch.from_numpy(np.ascontiguousarray(a)))

            local = transformer.place_lm_params(tree, cfg)
            rec = local["blocks"]["rec0"]["rec"]
            r["shapes"] = {k: tuple(v.shape) for k, v in (
                ("in_proj", rec["in_proj"]), ("w_a", rec["w_a"]),
                ("out_proj", rec["out_proj"]), ("conv_w", rec["conv_w"]),
                ("wq", local["blocks"]["attn"]["attn"]["wq"]),
                ("w_down", local["blocks"]["attn"]["ffn"]["w_down"]))}
            cache = serve.init_cache(cfg, prompt.shape[0], ring, "cpu")
            r["cache"] = {k: tuple(v.shape) for k, v in cache.items()}
            b = prompt.shape[0]
            pre, dec = _hybrid_serve(local, cfg, mine(prompt), mine(forced),
                                     ring, b)
            r["prefill"], r["decode"] = _np32(pre), _np32(dec)
            with torch.no_grad():
                r["greedy"] = serve.generate(local, serve.init_cache(
                    cfg, prompt.shape[0], ring, "cpu"), mine(prompt), 4,
                    cfg)[0].numpy()
            with sharding._installed(None):
                arith = (hybrid_tp_arithmetic(tree, cfg) if name == "model"
                         else contextlib.nullcontext())
                with arith:
                    one = _hybrid_serve(tree, cfg, mine(prompt),
                                        mine(forced), ring, pre.shape[0])
            r["arith_prefill"], r["arith_decode"] = map(_np32, one)
            tb = {k: mine(v) for k, v in batch.items()}
            r["loss"], r["grads"], r["gnorm"] = _lm_grads(cfg, local, tb, ctx)
            if name == "model":
                r["planted"] = {}
                for tag, (attr, fn) in HYBRID_FAULTS.items():
                    with patched(rglru_mod, attr, fn), torch.no_grad():
                        r["planted"][tag] = _np32(api.prefill_fn(
                            local, {"tokens": mine(prompt)}, cfg))
            state = train.init_state(cfg, 0, "cpu")
            final, losses, _ = train.train_loop(
                cfg, ShapeConfig("hy", prompt.shape[1], prompt.shape[0],
                                 "train"), steps, device="cpu", state=state,
                log_every=10 ** 9)
            r["losses"] = losses
            named = _named_leaves(final["params"])
            r["whole"] = {k: _np32(v) for k, v in named.items()
                          if k.rsplit("/", 1)[-1] in HYBRID_WHOLE}
            p_axes = steps_mod.placement_axes(
                cfg, steps_mod.state_logical_axes(cfg))["params"]
            r["final"] = _np_tree(steps_mod.gather_tree(final["params"],
                                                        p_axes, ctx))
    return out


def hybrid_tp_card(tree: dict, cfg, prompt, forced, ring: int) -> dict:
    """One rank of a (1, 2) mesh on the card under MODEL_RULES: the
    hybrid's prefill and decode logits at every position (f32 numpy,
    ``_hybrid_serve``) and this rank's kernel launches."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_map

    mesh = make_host_mesh(1, 2, device="cuda")
    whole = tree_map(lambda t: t.to(mesh.device), tree)
    with use_sharding(mesh):
        local = transformer.place_lm_params(whole, cfg)
        _build.LAUNCHES.clear()
        pre, dec = _hybrid_serve(local, cfg, prompt.to(mesh.device),
                                 forced.to(mesh.device), ring,
                                 prompt.shape[0], mesh.device)
    return {"prefill": _np32(pre), "decode": _np32(dec),
            "launches": dict(_build.LAUNCHES)}


# --------------------------------------------------------------------------
# the hybrid LM under DEFAULT_RULES / MULTIPOD_RULES (test_torch_hybrid.py,
# test_torch_hybrid_fsdp.py)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def hybrid_fsdp_arithmetic(params: dict, cfg, n: int = 2):
    """What each rank of a mesh with n ranks on "model" computes under
    DEFAULT_RULES / MULTIPOD_RULES, on one device from the whole params
    and the rank's rows: ``hybrid_tp_arithmetic`` with the head in its n
    vocab blocks (the FSDP gathers and the vocab-split lookup move bits
    only), and each ring read as n blocks of its slots, B6's partial
    entry over each block at the ring's length (min(pos + 1, W)), merged
    in rank order (``attention.merge_partials``)."""
    from repro_torch.kernels.flash_decode import flash_decode_partial
    from repro_torch.models import attention, transformer

    with hybrid_tp_arithmetic(params, cfg, n, vocab=True):
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


def _ring_at_rank0(transformer):
    """A planted fault: every rank writes a ring slot as rank 0 would (the
    owner's row offset taken as 0), so rank 0's block is written on every
    rank and the later blocks on none."""
    real = transformer.update_kv_cache

    def write(kc, vc, k, v, pos, seq=None):
        if seq is not None:
            seq = dataclasses.replace(seq, index=0)
        return real(kc, vc, k, v, pos, seq)
    return write


def loop_cfg(cfg, mesh: str):
    """The FSDP suite's ``train_loop`` config on ``mesh``: under
    DEFAULT_RULES ("default") the smoke config with the full config's
    remat (the gathers recomputed in the backward) and 2 microbatches,
    under MULTIPOD_RULES the smoke config (its steps cost a third)."""
    return cfg.with_(remat=True, microbatch_steps=2) if mesh == "default" \
        else cfg


HYBRID_FSDP_FAULTS = ("fsdp backward without its reduce-scatter",
                      "ring written at rank 0's slot on every rank",
                      "decode merge without the last rank's partial")


def _hybrid_fsdp_faults(tree, cfg, local, mine, prompt, forced, ring, tb,
                        ctx) -> dict:
    """The three planted faults on this rank (every rank plants them, so
    their collectives pair up): the train step's logical gradient with
    the FSDP backward keeping its own block of the gradient (no
    reduce-scatter), and the decode logits at the first ``ring`` / 2 + 1
    positions (the last with its key in model rank 1's slots) with the
    ring written at rank 0's slot, and with the merge dropping the last
    rank's partial."""
    from repro_torch.models import attention, transformer

    n = transformer.fsdp_split(cfg).n

    def no_reduce(g, group, dim):
        step = g.shape[dim] // n
        part = g.narrow(dim, torch.distributed.get_rank(group) * step, step)
        return (part.float() / n).to(g.dtype)

    merge = attention.merge_partials
    out = {}
    with patched(collectives, "reduce_scatter_mean", no_reduce):
        out[HYBRID_FSDP_FAULTS[0]] = _lm_grads(cfg, local, tb, ctx)[1]
    for tag, (owner, name, fn) in (
            (HYBRID_FSDP_FAULTS[1], (transformer, "update_kv_cache",
                                     _ring_at_rank0(transformer))),
            (HYBRID_FSDP_FAULTS[2], (attention, "merge_partials",
                                     lambda o, lse: merge(o[:-1],
                                                          lse[:-1])))):
        with patched(owner, name, fn):
            out[tag] = _np32(_hybrid_serve(
                local, cfg, mine(prompt[:, :ring // 2 + 1]),
                mine(forced[:, :0]), ring, prompt.shape[0])[1])
    return out


def _hybrid_fsdp_serve(tree, cfg, local, mine, prompt, forced, ring) -> dict:
    """This rank's (rows, vocab block) of the prefill logits and of the
    decode logits at every position, and the same on one device under
    ``hybrid_fsdp_arithmetic`` from the whole ``tree`` on the rank's rows,
    cut to its vocab block."""
    from repro_torch.models import transformer

    pre, dec = _hybrid_serve(local, cfg, mine(prompt), mine(forced), ring,
                             prompt.shape[0])
    v0, v1 = transformer.vocab_split(cfg).block(cfg.vocab)
    with sharding._installed(None), hybrid_fsdp_arithmetic(tree, cfg):
        one = _hybrid_serve(tree, cfg, mine(prompt), mine(forced), ring,
                            pre.shape[0])
    return {"prefill": _np32(pre), "decode": _np32(dec),
            "arith_prefill": _np32(one[0][..., v0:v1]),
            "arith_decode": _np32(one[1][..., v0:v1])}


def hybrid_fsdp_suite(tree: dict, cfg, prompt: np.ndarray,
                      forced: np.ndarray, batch: dict, ring: int, steps: int,
                      ckpt_dir: str, wide: tuple) -> dict:
    """One of 4 CPU ranks: the hybrid under DEFAULT_RULES on (data 2,
    model 2) and MULTIPOD_RULES on (pod 2, data 1, model 2). For each:
    this rank's blocks' shapes and whether ``bridge.init_lm(place=True)``
    drew them bitwise ``place_lm_params``'s, its cache's shapes, its
    (rows, vocab block) of the prefill and ring decode logits (and of the
    split's arithmetic on one device), one train step's
    logical gradient, global loss and clip norm, and ``steps`` steps
    through ``train_loop`` under ``loop_cfg`` (under DEFAULT_RULES with
    remat and 2 microbatches) checkpointed every step (the losses, the whole leaves, the gathered
    params, the restored blocks bitwise). Under
    DEFAULT_RULES also greedy tokens, the planted faults and ``wide``
    (cfg, tree: an LRU width other than d_model) served over the first
    ``ring`` / 2 + 2 positions and stepped."""
    from repro_torch import bridge
    from repro_torch.checkpoint.checkpoint import CheckpointManager, restore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, steps as steps_mod, train
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_leaves

    # smoke-sized work on 4 ranks: one thread each, so that the ranks'
    # idle intra-op threads do not spin on the cores of other test workers
    torch.set_num_threads(1)
    out = {"jax_loaded": "jax" in sys.modules,
           "repro_loaded": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}
    for name, pod in (("default", False), ("multipod", True)):
        mesh, rules = _fsdp_mesh(pod)
        r = out[name] = {}
        with use_sharding(mesh, rules) as ctx:
            r["coords"] = (sharding._axis_coord(mesh, rules["batch"]),
                           mesh.m)
            rows = sharding.named_sharding(prompt.shape, ("batch", "seq"),
                                           ctx)

            def mine(a):
                return rows.block(torch.from_numpy(np.ascontiguousarray(a)))

            local = transformer.place_lm_params(tree, cfg)
            with sharding._installed(None):
                whole = bridge.init_lm(0, cfg, "cpu")
            r["drawn_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(bridge.init_lm(0, cfg, "cpu", place=True)),
                tree_leaves(transformer.place_lm_params(whole, cfg))))
            rec = local["blocks"]["rec0"]["rec"]
            r["shapes"] = {k: tuple(v.shape) for k, v in (
                ("in_proj", rec["in_proj"]), ("out_proj", rec["out_proj"]),
                ("w_a", rec["w_a"]), ("conv_w", rec["conv_w"]),
                ("tail_in_proj", local["tail_blocks"]["rec"]["in_proj"]),
                ("wq", local["blocks"]["attn"]["attn"]["wq"]),
                ("w_down", local["blocks"]["attn"]["ffn"]["w_down"]),
                ("embed", local["embed"]), ("lm_head", local["lm_head"]))}
            r["cache"] = {k: tuple(v.shape) for k, v in serve.init_cache(
                cfg, prompt.shape[0], ring, "cpu").items()}
            r.update(_hybrid_fsdp_serve(tree, cfg, local, mine, prompt,
                                        forced, ring))
            tb = {k: mine(v) for k, v in batch.items()}
            r["loss"], r["grads"], r["gnorm"] = _lm_grads(cfg, local, tb, ctx)
            if name == "default":
                with torch.no_grad():
                    r["greedy"] = serve.generate(local, serve.init_cache(
                        cfg, prompt.shape[0], ring, "cpu"),
                        mine(prompt[:, :2]), 2, cfg)[0].numpy()
                r["planted"] = _hybrid_fsdp_faults(tree, cfg, local, mine,
                                                   prompt, forced, ring, tb,
                                                   ctx)
                wcfg, wtree = wide
                wlocal = transformer.place_lm_params(wtree, wcfg)
                w = r["wide"] = _hybrid_fsdp_serve(
                    wtree, wcfg, wlocal, mine, prompt[:, :ring // 2 + 2],
                    forced[:, :0], ring)
                w["in_proj"] = tuple(wlocal["blocks"]["rec0"]["rec"]
                                     ["in_proj"].shape)
                w["loss"], w["grads"], _ = _lm_grads(wcfg, wlocal, tb, ctx)
            final, losses, _ = train.train_loop(
                loop_cfg(cfg, name), ShapeConfig("hy", prompt.shape[1],
                                                 prompt.shape[0], "train"),
                steps, device="cpu", state=train.init_state(cfg, 0, "cpu"),
                ckpt=CheckpointManager(f"{ckpt_dir}/{name}", every=1),
                log_every=10 ** 9)
            r["losses"] = losses
            r["m_in_proj"] = tuple(final["opt"]["m"]["blocks"]["rec0"]["rec"]
                                   ["in_proj"].shape)
            named = _named_leaves(final["params"])
            r["whole"] = {k: _np32(v) for k, v in named.items()
                          if k.rsplit("/", 1)[-1] in HYBRID_WHOLE[:7]}
            axes = steps_mod.placement_axes(
                cfg, steps_mod.state_logical_axes(cfg))
            r["final"] = _np_tree(steps_mod.gather_tree(final, axes, ctx))
            back, step = restore(f"{ckpt_dir}/{name}/step_{steps}", final,
                                 ctx, axes)
            r["restored_step"] = step
            r["restored_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(final)))
    return out


def hybrid_table_calls(tree: dict, cfg, toks: np.ndarray, ring_cases: list
                       ) -> dict:
    """One of 2 CPU ranks: the hybrid's entry points under the FSDP tables
    on three meshes, DEFAULT_RULES on (data 1, model 2) ("kv_seq", the
    vocab, the heads, d_ff and the LRU width split over "model") and on
    (data 2, model 1) ("p_embed" and the batch split over "data"), and
    MULTIPOD_RULES on (pod 2, data 1, model 1): this rank's block of
    ``prefill_fn``'s logits, its rows' ``loss_fn``, its blocks' shapes
    and the params gathered back (``place_lm_params``), its cache's local
    shapes (``cache_axes_spec``); on (1, 2) also the attention layer's
    ``attn_decode`` under "kv_seq" on its half of each ring of
    ``ring_cases`` ((x, k ring, v ring, pos), numpy): the output and the
    rank's half of the written ring."""
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import _AXES, _build_mesh, make_host_mesh
    from repro_torch.models import api, transformer
    from repro_torch.models.layers import layer_view
    from repro_torch.optim.adamw import tree_leaves

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    torch.set_num_threads(1)          # as hybrid_fsdp_suite's ranks
    meshes = {"default (1, 2)": (make_host_mesh(1, 2, device="cpu"),
                                 sharding.DEFAULT_RULES),
              "default (2, 1)": (make_host_mesh(2, 1, device="cpu"),
                                 sharding.DEFAULT_RULES),
              "multipod": (_build_mesh(1, 1, "cpu", _AXES, n_pod=2),
                           sharding.MULTIPOD_RULES)}
    out = {}
    for name, (mesh, rules) in meshes.items():
        r = out[name] = {}
        with use_sharding(mesh, rules) as ctx:
            sharding.check_model_rules(ctx, "hybrid")
            rows = sharding.named_sharding(toks.shape, ("batch", "seq"), ctx)
            mine = rows.block(torch.from_numpy(toks))
            local = transformer.place_lm_params(tree, cfg)
            axes = steps.placement_axes(cfg, api.model_logical_axes(cfg))
            r["gathered"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(steps.gather_tree(local, axes, ctx)),
                tree_leaves(tree)))
            r["in_proj"] = tuple(local["blocks"]["rec0"]["rec"]["in_proj"]
                                 .shape)
            r["lm_head"] = tuple(local["lm_head"].shape)
            r["coords"] = (sharding._axis_coord(mesh, rules["batch"]),
                           mesh.m)
            with torch.no_grad():
                r["prefill"] = _np32(api.prefill_fn(local, {"tokens": mine},
                                                    cfg))
                r["loss"] = float(api.loss_fn(local, {
                    "tokens": mine, "labels": torch.roll(mine, -1, 1)}, cfg))
            r["cache"] = {k: tuple(v.shape) for k, v in serve.init_cache(
                cfg, toks.shape[0], 12, "cpu").items()}
            if name != "default (1, 2)":
                continue
            lp = layer_view(local["blocks"], 0)["attn"]
            policy = ExecPolicy.from_cfg(cfg, training=False)
            r["ring"] = []
            for x, kr, vr, pos in ring_cases:
                seq = transformer.seq_split(kr.shape[1] // 2)
                h0, h1 = seq.block(kr.shape[1])
                k, v = t(kr[:, h0:h1]), t(vr[:, h0:h1])
                with torch.no_grad():
                    o, k, v = transformer.attn_decode(
                        lp["attn"], t(x), k, v, pos, cfg, policy,
                        transformer.decode_rope(pos, cfg, "cpu"),
                        transformer.heads_split(cfg), seq, window=cfg.window)
                r["ring"].append((_np32(o), _np32(k), _np32(v)))
    return out
