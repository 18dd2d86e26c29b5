"""Dense-LM training and the train mesh's tables in the port, on one
device, held against the reference outside any mesh (its
``test_train_integration.py`` is red: its ``use_sharding`` refuses its own
host mesh).

The model is the reference's qwen2-1.5b smoke config cut to 2 layers
(d 64, 4 heads, 2 KV heads, d_ff 128, vocab 256, bf16 weights) with a
2-step warmup so a few steps move the loss; the reference's params and
train state reach the port through ``bridge``. Tolerances:

  * ``TokenStream`` batches, under a context this rank's rows: bitwise;
  * ``lm_loss`` / ``loss_fn`` on one batch: within 2e-4 relative (measured
    4.8e-5: the reference's scanned forward differs from its own eager
    layers by 1.5-2.5 bf16 ulps of the logits, test_torch_lm.py);
  * the losses of 6 steps of the port's ``train_loop`` against the
    reference's ``make_train_fn`` under ``jax.jit`` in a loop: within 2e-4
    relative each (measured 5.0e-5), the clip's norms within 2%
    (measured 0.7%: bf16 gradients of the two forwards);
  * a run resumed from its checkpoint: bitwise the straight run;
  * the rule tables, ``rules_for_mesh``'s choice, ``make_host_mesh``'s
    clamp, ``batch_shard_count``, the logical-axis trees, ``batch_specs``,
    ``abstract_state`` and ``state_logical_axes``: equal to the
    reference's.

Every reference run is served from the module fixture ``ref``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import ffn as jffn
from repro.models import transformer as jtf

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import ExecPolicy
from repro_torch.optim.adamw import tree_leaves, tree_map

STEP = dict(lr_warmup=2, lr_total=100)
SEQ, BATCH, STEPS = 16, 4, 6
LOSS_REL = 2e-4
NORM_REL = 2e-2


def _jcfg(**kw):
    return jsmoke(jget("qwen2-1.5b")).with_(n_layers=2, **{**STEP, **kw})


def _tcfg(**kw):
    return tsmoke(tget("qwen2-1.5b")).with_(n_layers=2, **{**STEP, **kw})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """Every reference run of this file, once."""
    jcfg = _jcfg()
    st = jtrain.init_state(jcfg, 0)
    ts = jpipe.TokenStream(jcfg.vocab, SEQ, BATCH, seed=0)
    loss0 = float(jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        st["params"], ts.batch_at(0)))
    lm0 = float(jtf.lm_loss(st["params"], ts.batch_at(0), jcfg))
    fn = jax.jit(jsteps.make_train_fn(jcfg))
    s, losses, norms = st, [], []
    for i in range(STEPS):
        s, m = fn(s, ts.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"state0": _np(st), "loss0": loss0, "lm0": lm0,
            "losses": losses, "norms": norms}


def _tstate(ref):
    return bridge.from_jax_state(ref["state0"], "cpu")


def _fake_mesh(axes, **shape):
    return types.SimpleNamespace(axis_names=axes, shape=shape)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (256, 16, 4, 0, 0), (256, 16, 4, 3, 7), (151936, 128, 8, 0, 2),
    (1000, 5, 3, 1, 0)])
def test_token_stream_bitwise(vocab, seq, batch, seed, step):
    want = jpipe.TokenStream(vocab, seq, batch, seed=seed).batch_at(step)
    got = tpipe.TokenStream(vocab, seq, batch, seed=seed).batch_at(step)
    on = tpipe.TokenStream(vocab, seq, batch, seed=seed,
                           device="cpu").batch_at(step)
    assert set(got) == set(want) == set(on)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == np.int32
        np.testing.assert_array_equal(got[k], w)
        assert on[k].dtype == torch.int32
        np.testing.assert_array_equal(on[k].numpy(), w)


@pytest.mark.parametrize("data,d,batch", [(2, 0, 4), (2, 1, 4), (4, 3, 8),
                                          (3, 1, 4)])
def test_token_stream_rows_under_a_context(data, d, batch):
    """Rank d of "data" takes rows [d B / D, (d + 1) B / D): the block
    ``named_sharding(("batch", "seq"))`` gives; all rows where D does not
    divide B."""
    mesh = tmesh.ServingMesh(data, 1, d, 0, torch.device("cpu"), "gloo", {})
    ctx = tsharding.ShardingCtx(mesh, tsharding.MODEL_RULES)
    whole = tpipe.TokenStream(256, 8, batch, seed=2).batch_at(1)
    mine = tpipe.TokenStream(256, 8, batch, seed=2, ctx=ctx).batch_at(1)
    rows = (slice(d * batch // data, (d + 1) * batch // data)
            if batch % data == 0 else slice(None))
    for k in whole:
        np.testing.assert_array_equal(mine[k], whole[k][rows])


def test_lm_batch_specs_match_reference():
    sc = ShapeConfig("t", 16, 4, "train")
    want = jpipe.lm_batch_specs(JShape("t", 16, 4, "train"))
    got = tpipe.lm_batch_specs(sc)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.int32 and got[k].device.type == "meta"


# --------------------------------------------------------------------------
# the loss and the train loop
# --------------------------------------------------------------------------

def test_lm_loss_and_loss_fn_match_reference(ref):
    st = _tstate(ref)
    b = tpipe.TokenStream(256, SEQ, BATCH, seed=0, device="cpu").batch_at(0)
    cfg = _tcfg()
    got = float(ttf.lm_loss(st["params"], b, cfg))
    via_api = float(tapi.loss_fn(st["params"], b, cfg))
    assert got == via_api
    for want in (ref["loss0"], ref["lm0"]):
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    # aux_weight scales the forward's aux loss, 0 for dense
    assert float(ttf.lm_loss(st["params"], b, cfg, aux_weight=5.0)) == got


def test_serving_policy_with_grad_operands_raises():
    """The flash attention kernel has no backward: a serving forward whose
    weights need a gradient (no ``torch.no_grad``) raises where it reaches
    ``blockwise_attention``, on the CPU as on the card, rather than run
    some other attention. A training policy takes the plain attention and
    gives every weight a gradient."""
    cfg = _tcfg()
    live = tree_map(lambda t: t.detach().float().requires_grad_(True),
                    ttrain.init_state(cfg, 0, "cpu")["params"])
    tokens = torch.zeros(1, 4, dtype=torch.long)
    serving = ExecPolicy.from_cfg(cfg, training=False)
    with pytest.raises(ValueError, match="no backward"):
        ttf.forward_lm(live, tokens, cfg, serving)
    with pytest.raises(ValueError, match="no backward"):
        tapi.prefill_fn(live, {"tokens": tokens}, cfg)
    with torch.no_grad():
        assert torch.isfinite(tapi.prefill_fn(live, {"tokens": tokens},
                                              cfg)).all()
    ttf.forward_lm(live, tokens, cfg)[0].float().sum().backward()
    grads = tree_leaves(tree_map(lambda t: t.grad, live))
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert float(live["blocks"]["attn"]["wk"].grad.abs().sum()) > 0


def test_train_loop_matches_reference_steps(ref, capsys):
    cfg = _tcfg()
    _, losses, _ = ttrain.train_loop(cfg, ShapeConfig("t", SEQ, BATCH,
                                                      "train"),
                                     STEPS, device="cpu", state=_tstate(ref),
                                     log_every=1)
    norms = [float(line.split("gnorm")[1]) for line in
             capsys.readouterr().out.splitlines() if "gnorm" in line]
    assert len(losses) == len(norms) == STEPS
    for got, want in zip(losses, ref["losses"]):
        assert abs(got - want) <= LOSS_REL * abs(want), (losses,
                                                        ref["losses"])
    for got, want in zip(norms, ref["norms"]):
        assert abs(got - want) <= NORM_REL * want, (norms, ref["norms"])


def test_resume_from_checkpoint_is_bitwise(ref, tmp_path):
    cfg = _tcfg()
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    final, losses, _ = ttrain.train_loop(cfg, shape, 4, device="cpu",
                                         state=_tstate(ref))
    _, first, _ = ttrain.train_loop(
        cfg, shape, 2, device="cpu", state=_tstate(ref),
        ckpt=CheckpointManager(str(tmp_path), every=2))
    st, rest, _ = ttrain.train_loop(
        cfg, shape, 4, device="cpu", state=_tstate(ref),
        ckpt=CheckpointManager(str(tmp_path), every=100))
    assert first + rest == losses
    for a, b in zip(tree_leaves(st), tree_leaves(final)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_state_and_stream_are_the_lm_s():
    cfg = _tcfg()
    st = ttrain.init_state(cfg, 0, "cpu")
    assert st["params"]["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert st["opt"]["m"]["embed"].dtype == torch.bfloat16
    b = ttrain.make_stream(cfg, ShapeConfig("t", 8, 2, "train"), 1,
                           "cpu")(3)
    want = jpipe.TokenStream(256, 8, 2, seed=1).batch_at(3)
    for k in want:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(want[k]))


def test_train_cli_trains_the_lm_on_the_cpu(capsys, monkeypatch):
    ttrain.main(["--arch", "qwen2-1.5b", "--smoke", "--layers", "1",
                 "--steps", "2", "--batch", "2", "--seq", "8", "--device",
                 "cpu"])
    assert "[train] 2 steps in" in capsys.readouterr().out
    # --model-par starts its ranks through spawn_ranks (the mesh test
    # file runs a real spawn)
    seen = {}

    def spawn(fn, world, *args, **kw):
        seen.update(fn=fn, world=world, args=args, kw=kw)
        return [([1.0, 0.5], [], 0.1)] * world

    monkeypatch.setattr(ttrain, "spawn_ranks", spawn)
    ttrain.main(["--arch", "qwen2-1.5b", "--smoke", "--model-par", "2",
                 "--data-par", "2", "--device", "cpu", "--steps", "2"])
    assert seen["world"] == 4 and seen["fn"] is ttrain._train_ranks
    assert seen["args"][6:8] == (2, 2) and seen["kw"]["device"] == "cpu"


# --------------------------------------------------------------------------
# tables, meshes, axes and abstract state
# --------------------------------------------------------------------------

def test_rule_tables_equal_the_reference():
    for name in ("DEFAULT_RULES", "MULTIPOD_RULES", "DATA_RULES",
                 "MODEL_RULES"):
        assert getattr(tsharding, name) == getattr(jsharding, name), name


@pytest.mark.parametrize("mesh", [
    _fake_mesh(("pod", "data", "model"), pod=2, data=2, model=2),
    _fake_mesh(("pod", "data", "model"), pod=2, data=16, model=16),
    _fake_mesh(("data", "model"), data=16, model=16),
    _fake_mesh(("x",), x=1), _fake_mesh(("x", "model"), x=1, model=2),
    _fake_mesh(("x",), x=2), _fake_mesh(("pod", "data"), pod=2, data=1)],
    ids=["pod222", "pod-prod", "prod", "x1", "x1-model2", "x2-unmapped",
         "pod-data"])
def test_rules_for_mesh_picks_the_reference_table(mesh):
    import _torch_ranks
    want = _torch_ranks._raises(lambda: jsharding.rules_for_mesh(mesh))
    got = _torch_ranks._raises(lambda: tsharding.rules_for_mesh(mesh))
    assert got == want
    if not want:
        assert tsharding.rules_for_mesh(mesh) == \
            jsharding.rules_for_mesh(mesh)


@pytest.mark.parametrize("data,model,n", [
    (1, 1, 1), (1, 2, 1), (4, 2, 1), (1, 2, 2), (2, 2, 4), (3, 2, 4),
    (2, 8, 4), (8, 1, 4), (1, 8, 4), (2, 16, 256)])
def test_make_host_mesh_clamps_as_the_reference(monkeypatch, data, model,
                                                n):
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: shape)
    assert tmesh.host_mesh_shape(data, model, n) == \
        tuple(jmesh.make_host_mesh(data, model))


def test_make_host_mesh_on_one_rank_and_what_it_refuses():
    m = tmesh.make_host_mesh(1, 2, device="cpu")     # clamped to (1, 1)
    assert (m.shape, m.world, m.group("model")) == (
        {"data": 1, "model": 1}, 1, None)
    with tsharding.use_sharding(m):
        assert tsharding.split_of("p_heads", 4) is None
    with pytest.raises(ValueError, match="production mesh"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("mesh", [
    _fake_mesh(("data", "model"), data=4, model=2),
    _fake_mesh(("pod", "data", "model"), pod=2, data=16, model=16),
    _fake_mesh(("data",), data=3)])
def test_batch_shard_count_matches_reference(mesh):
    assert tmesh.batch_shard_count(mesh) == jmesh.batch_shard_count(mesh)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-1.5b", {}), ("qwen2-1.5b", dict(tie_embeddings=False)),
    ("qwen2-1.5b", dict(qkv_bias=False)), ("opto-vit-tiny", {}),
    ("opto-vit-tiny", dict(mgnet=True))])
def test_logical_axes_equal_the_reference(arch, kw):
    jcfg = jsmoke(jget(arch)).with_(**kw)
    tcfg = tsmoke(tget(arch)).with_(**kw)
    assert tapi.model_logical_axes(tcfg) == japi.model_logical_axes(jcfg)
    assert tsteps.state_logical_axes(tcfg) == jsteps.state_logical_axes(jcfg)
    if jcfg.family == "dense":
        assert ttf.lm_logical_axes(tcfg) == jtf.lm_logical_axes(jcfg)
        assert ttf.dense_layer_axes(tcfg) == jtf.dense_layer_axes(jcfg)
        assert ttf.attention_logical_axes(tcfg) == \
            jtf.attention_logical_axes(jcfg)
    assert tffn.swiglu_logical_axes() == jffn.swiglu_logical_axes()
    assert tapi.BATCH_AXES == japi.BATCH_AXES


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-1.5b", {}), ("qwen2-1.5b", dict(use_fp32_master=True)),
    ("qwen2-1.5b", dict(tie_embeddings=False)), ("opto-vit-tiny", {}),
    ("opto-vit-tiny", dict(mgnet=True)),
    ("recurrentgemma-9b", dict(n_layers=5))])
def test_abstract_state_equals_the_reference(arch, kw):
    jcfg = jsmoke(jget(arch)).with_(**kw)
    tcfg = tsmoke(tget(arch)).with_(**kw)
    assert _shape_tree(tsteps.abstract_state(tcfg)) == \
        _shape_tree(jsteps.abstract_state(jcfg))
    assert all(t.device.type == "meta"
               for t in tree_leaves(tsteps.abstract_params(tcfg)))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "opto-vit-tiny"])
def test_batch_specs_equal_the_reference(arch, kind):
    jcfg, tcfg = jsmoke(jget(arch)), tsmoke(tget(arch))
    want = japi.batch_specs(jcfg, JShape("c", 16, 4, kind))
    got = tapi.batch_specs(tcfg, ShapeConfig("c", 16, 4, kind))
    assert set(got) == set(want)
    for k, (shp, dt, axes) in want.items():
        assert got[k][0] == shp and got[k][2] == axes
        assert str(got[k][1]).split(".")[-1] == jnp.dtype(dt).name


def test_named_sharding_and_step_specs_are_local_blocks():
    """(2, 2) fake mesh at rank (1, 0): the batch splits over "data", the
    heads and d_ff over "model"; wk and the embedding stay whole."""
    groups = dict.fromkeys([("data",), ("model",), ("data", "model")])
    mesh = tmesh.ServingMesh(2, 2, 1, 0, torch.device("cpu"), "gloo",
                             groups)
    ctx = tsharding.ShardingCtx(mesh, tsharding.MODEL_RULES)
    bs = tsharding.named_sharding((8, 16), ("batch", "seq"), ctx)
    assert bs.spec == ("data", None) and bs.local_shape((8, 16)) == (4, 16)
    np.testing.assert_array_equal(bs.block(torch.arange(8 * 16).reshape(
        8, 16)).numpy(), np.arange(8 * 16).reshape(8, 16)[4:])
    cfg = _tcfg()
    _, (st, b) = tsteps.make_train_step(cfg, ShapeConfig("t", 16, 8,
                                                         "train"), ctx)
    a = st["params"]["blocks"]["attn"]
    assert tuple(a["wq"].shape) == (2, 64, 32)
    assert tuple(a["wo"].shape) == (2, 32, 64)
    assert tuple(a["wk"].shape) == (2, 64, 32)
    assert tuple(st["opt"]["m"]["blocks"]["ffn"]["w_down"].shape) == \
        (2, 64, 64)
    assert tuple(st["params"]["embed"].shape) == (256, 64)
    assert tuple(b["tokens"].shape) == (4, 16)
    _, (p, c, t, pos) = tsteps.make_serve_step(cfg, ShapeConfig(
        "d", 32, 8, "decode"), ctx)
    assert tuple(c["k"].shape) == (2, 4, 32, 2, 16)
    assert tuple(t.shape) == (4, 1) and tuple(pos.shape) == ()


@pytest.mark.parametrize("pod", [False, True])
def test_fsdp_step_specs_split_embed_vocab_and_kv_seq(pod):
    """A (2, 2) fake mesh under DEFAULT_RULES, or a (2, 1, 2) pod mesh under
    MULTIPOD_RULES: every "p_embed" dim (d 64) is halved over the batch
    axes, the vocab, query heads and d_ff over "model", the moments as
    their params, the decode cache's batch over the batch axes and its
    sequence over "model"."""
    keys = [("data",), ("model",), ("data", "model"), ("pod",),
            ("pod", "data"), ("pod", "model"), ("pod", "data", "model")]
    groups = dict.fromkeys(keys)
    if pod:
        mesh = tmesh.ServingMesh(1, 2, 0, 1, torch.device("cpu"), "gloo",
                                 groups, ("pod", "data", "model"), 2, 1)
        rules = tsharding.rules_for_mesh(mesh)
        assert rules is tsharding.MULTIPOD_RULES
    else:
        mesh = tmesh.ServingMesh(2, 2, 1, 1, torch.device("cpu"), "gloo",
                                 groups)
        rules = tsharding.DEFAULT_RULES
    ctx = tsharding.ShardingCtx(mesh, rules)
    cfg = _tcfg()
    _, (st, b) = tsteps.make_train_step(cfg, ShapeConfig("t", 16, 8,
                                                         "train"), ctx)
    p = st["params"]
    assert tuple(p["embed"].shape) == (128, 32)
    assert tuple(p["blocks"]["attn"]["wq"].shape) == (2, 32, 32)
    assert tuple(p["blocks"]["attn"]["wk"].shape) == (2, 32, 32)
    assert tuple(p["blocks"]["attn"]["wo"].shape) == (2, 32, 32)
    assert tuple(p["blocks"]["ffn"]["w_down"].shape) == (2, 64, 32)
    assert tuple(p["blocks"]["ln1"].shape) == (2, 64)
    assert tuple(st["opt"]["v"]["embed"].shape) == (128, 32)
    assert tuple(b["tokens"].shape) == (4, 16)
    _, (pp, c, t, _) = tsteps.make_serve_step(cfg, ShapeConfig(
        "d", 32, 8, "decode"), ctx)
    assert tuple(c["k"].shape) == (2, 4, 16, 2, 16)
    assert tuple(t.shape) == (4, 1)
    assert tuple(pp["embed"].shape) == (128, 32)
    _, (pf, bf) = tsteps.make_prefill_step(cfg, ShapeConfig(
        "p", 16, 8, "prefill"), ctx)
    assert tuple(pf["blocks"]["ffn"]["w_up"].shape) == (2, 32, 64)
    assert tuple(bf["tokens"].shape) == (4, 16)
    # a cache length the "kv_seq" axis does not divide is refused
    with pytest.raises(ValueError, match="does not split"):
        tsteps.make_serve_step(cfg, ShapeConfig("d", 31, 8, "decode"), ctx)


def test_default_and_multipod_rules_raise_for_experts_and_the_vit():
    """The tables are chosen and read; the dense LM and the ViT run under
    them (tests/test_torch_lm_fsdp.py, test_torch_lm_multipod.py,
    test_torch_vit_mesh.py), while a size > 1 axis that maps the experts
    raises for any other family, naming A15. The ViT's fused serving
    encode, which raised where "p_embed" splits, takes the reference's
    route: the data-split encode over the batch axes on these meshes
    (model 1, or no "data" axis), the model-sharded encode on ("data",
    "model") with model > 1, whatever the table (its runs:
    test_torch_vit_mesh.py). The reference's param_spec raises, and the
    port's."""
    from repro_torch.core.backend import ExecPolicy, prepare_params
    from repro_torch.launch.train import init_state
    from repro_torch.models.vit import _mesh_route

    vit = tsmoke(tget("opto-vit-tiny"))
    cache = prepare_params(init_state(vit, 0, "cpu")["params"], bits=8)
    fused = ExecPolicy(8, "photonic_pallas", "flash", "fused",
                       training=False)
    for axes, shape in ((("data", "model"), dict(data=2, model=1)),
                        (("x", "model"), dict(x=1, model=2)),
                        (("pod", "data", "model"),
                         dict(pod=2, data=1, model=1))):
        mesh = types.SimpleNamespace(axis_names=axes, shape=shape,
                                     world=2, coord=lambda ax: 0,
                                     group=lambda axes: None)
        rules = (tsharding.DEFAULT_RULES if "pod" not in axes
                 else tsharding.MULTIPOD_RULES)
        ctx = tsharding.ShardingCtx(mesh, rules)
        tsharding.check_model_rules(ctx)
        tsharding.check_model_rules(ctx, "vit")
        assert _mesh_route(cache, vit, fused, ctx) == "split"
        if shape.get("model", 1) > 1:
            with pytest.raises(NotImplementedError, match="A15"):
                tsharding.check_model_rules(ctx, "moe")
        else:
            tsharding.check_model_rules(ctx, "moe")
    # a (1, 1) default mesh splits nothing and runs every family; a
    # (2, 2) one runs the fused encode model-sharded under DEFAULT_RULES
    mesh = _fake_mesh(("x", "model"), x=1, model=1)
    for family in ("dense", "vit", "moe"):
        tsharding.check_model_rules(tsharding.ShardingCtx(
            mesh, tsharding.DEFAULT_RULES), family)
    two = types.SimpleNamespace(axis_names=("data", "model"),
                                shape=dict(data=2, model=2), world=4,
                                coord=lambda ax: 0, group=lambda axes: None)
    assert _mesh_route(cache, vit, fused, tsharding.ShardingCtx(
        two, tsharding.DEFAULT_RULES)) == "sharded"
    for mod in (tsharding, jsharding):
        with pytest.raises(NotImplementedError):
            mod.param_spec("blocks/attn/wq", (64, 64), None)
