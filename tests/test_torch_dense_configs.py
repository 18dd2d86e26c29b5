"""The dense family's other configs in the port, held against the JAX
reference on the CPU: stablelm-12b (head dim 160, four query heads a KV
head), qwen2.5-3b (head dim 128, G 8, QKV bias, tied) and llama3-405b
(head dim 128, G 16).

The configs are the reference's, field for field. The models run at
narrow widths that keep each config's head dim and group, as the
reference's ``smoke_variant`` (d 64, 4 heads: head dim 16) would not:
stablelm-12b at d 640 on 4 heads over 1 KV head, qwen2.5-3b at d 1024 on
8 over 1, llama3-405b at d 2048 on 16 over 1; 2 layers, d_ff 128, vocab
256, each config's own ``microbatch_steps`` and ``use_fp32_master`` (the
same ``with_`` on both packages). The train state is the reference's
``init_state`` (its ``init_model`` draw), bridged to the port; the
serving runs take those params with the norm gains (and qwen2.5-3b's QKV
biases) perturbed from a numpy seed. Every reference run is made once,
in the module fixture. Tolerances:

  * B5's plain version at D 160 / G 4 against the reference's Pallas
    kernel in interpret mode, bf16, causal and under a window: 1 bf16 ulp
    of the largest |o| (tests/test_torch_lm_attention.py's class); B6's
    plain version at D 160 / G 4 against the reference's flash decode
    kernel: the same;
  * ``prefill_fn`` logits of an 8-token prompt, and the teacher-forced
    ``decode_fn`` logits at each of its positions: correlation > 0.999,
    and the argmax equal wherever the reference's top two logits are more
    than 1 bf16 ulp apart (``_torch_lm_ref.argmax_outside_ties``);
  * STEPS ``make_train_fn`` steps on ``TokenStream`` batches of 8 x 16,
    each from the reference's state before it (its ``init_state``, then
    its ``make_train_fn`` steps under ``jax.jit``), against the
    reference's step from that state on the same batch: AdamW with bf16
    moments for llama3-405b, the microbatch mean of 2 and 8 steps for
    stablelm-12b and llama3-405b. Each within twice the reference's
    distance from itself, measured here:
      - the step's loss: as in tests/test_torch_hybrid_train.py, the
        largest over the steps of the scanned loss against the same layer
        functions called one by one, unjitted (``_eager_loss``, the
        composition the port's forward mirrors; 7.0e-4 to 1.4e-3 here);
      - the params and the two moments after the step (relative L2 over
        the tree): the reference's step against its own update
        (``adamw_update`` after the clip, at the step's learning rate)
        applied to the whole batch's gradient of the same layers unrolled
        under ``jax.jit`` (``_unrolled_loss``, which rounds the bf16 chain
        otherwise than the scan; an unjitted gradient takes ~10 s a
        config on the CPU);
    and the clip's norm within 2% (the class of
    tests/test_torch_lm_train.py).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.backend import ExecPolicy as JPolicy
from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import PORTED_ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flash_attention import TC_HEAD_DIMS
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.flash_decode import flash_decode as t_decode
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi

from _torch_lm_ref import argmax_outside_ties, corr

BF16 = ml_dtypes.bfloat16
ARCHS = ("stablelm-12b", "qwen2.5-3b", "llama3-405b")
# d_model, n_heads, kv_heads at which each config keeps its head dim and
# group: (head dim, G) = (160, 4), (128, 8), (128, 16)
NARROW = {"stablelm-12b": dict(d_model=640, n_heads=4, kv_heads=1),
          "qwen2.5-3b": dict(d_model=1024, n_heads=8, kv_heads=1),
          "llama3-405b": dict(d_model=2048, n_heads=16, kv_heads=1)}
HEAD_GROUP = {"stablelm-12b": (160, 4), "qwen2.5-3b": (128, 8),
              "llama3-405b": (128, 16)}
PROMPT, CACHE = 8, 16
SEQ, BATCH = 16, 8          # the train batch: 8 divides llama3's microbatches
STEPS = 3
STEP = dict(lr_warmup=2, lr_total=100)
NORM_REL = 2e-2


def _narrow(smoke, get, arch):
    full = get(arch)
    return smoke(full).with_(n_layers=2, microbatch_steps=full.microbatch_steps,
                             use_fp32_master=full.use_fp32_master,
                             **NARROW[arch], **STEP)


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _within_ulp(got, want):
    """1 bf16 ulp of the largest |want|."""
    g, w = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(g, w, rtol=0, atol=ulp)


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    return [tree]


def _leaves(tree) -> list:
    return [t.float().numpy() if isinstance(t, torch.Tensor) else
            np.asarray(t, np.float32) for t in _tensors(tree)]


def _rel_l2(a, b) -> float:
    """Relative L2 of tree ``a`` against tree ``b`` (f64)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    num = sum(float(((x.astype(np.float64) - y) ** 2).sum())
              for x, y in zip(la, lb))
    den = sum(float((y.astype(np.float64) ** 2).sum()) for y in lb)
    return (num / den) ** 0.5


def _eager_loss(params, batch, cfg) -> float:
    """The reference's ``lm_loss`` composed eagerly from its own layer
    functions, called one by one as the port runs them."""
    return float(_unrolled_loss(cfg)(params, batch))


def _unrolled_loss(cfg):
    """The reference's ``lm_loss`` from its own layer functions in a Python
    loop over the layers (no ``lax.scan``): under ``jax.jit`` it rounds
    the bf16 chain otherwise than the scanned ``loss_fn`` (at
    stablelm-12b's narrow width 9.1e-4 apart on the first batch)."""
    pol = JPolicy.from_cfg(cfg, training=True)

    def loss(params, batch):
        x = jlayers.embedding_lookup(params["embed"], batch["tokens"])
        for i in range(cfg.n_layers):
            x = jtf.dense_layer_fwd(jax.tree_util.tree_map(
                lambda a: a[i], params["blocks"]), x, cfg, pol)
        x = jlayers.rmsnorm(x, params["final_ln"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        lf = jlayers.linear(x, head, policy=pol).astype(jnp.float32)
        gold = jnp.take_along_axis(lf, batch["labels"][..., None],
                                   axis=-1)[..., 0]
        return (jax.scipy.special.logsumexp(lf, axis=-1) - gold).mean()
    return loss


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(arch: str) -> dict:
    """One config's reference runs and the inputs they were made from."""
    jcfg = _narrow(jsmoke, jget, arch)
    st = jtrain.init_state(jcfg, 0)
    out = {"state0": _np_tree(st)}
    stream = jpipe.TokenStream(jcfg.vocab, SEQ, BATCH, seed=0)
    step = jax.jit(jsteps.make_train_fn(jcfg))
    unrolled = jax.jit(jax.grad(_unrolled_loss(jcfg)))
    ocfg = jadamw.AdamWConfig(low_mem=not jcfg.use_fp32_master)

    @jax.jit
    def update(g, state):
        g, _ = jadamw.clip_by_global_norm(g, 1.0)
        lr = jadamw.warmup_cosine(state["step"] + 1, warmup=jcfg.lr_warmup,
                                  total=jcfg.lr_total)
        return jadamw.adamw_update(g, state["opt"], state["params"], ocfg, lr)

    states, losses, norms, selves = [out["state0"]], [], [], []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        eager = _eager_loss(st["params"], batch, jcfg)
        pu, ou = update(unrolled(st["params"], batch), st)
        st, m = step(st, batch)
        states.append(_np_tree(st))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        selves.append({"loss": abs(losses[-1] - eager),
                       "params": _rel_l2(pu, st["params"]),
                       "m": _rel_l2(ou["m"], st["opt"]["m"]),
                       "v": _rel_l2(ou["v"], st["opt"]["v"])})
    out.update(states=states, losses=losses, norms=norms, selves=selves)
    # the serving runs: the same draw, the norm gains (and the QKV biases)
    # perturbed so their paths carry numbers
    tree = jax.tree_util.tree_map(np.array, out["state0"]["params"])
    rng = np.random.default_rng(0)
    blocks = tree["blocks"]
    if jcfg.qkv_bias:
        for k in ("bq", "bk", "bv"):
            blocks["attn"][k] = (rng.standard_normal(
                blocks["attn"][k].shape) * 0.5).astype(BF16)
    for k in ("ln1", "ln2"):
        blocks[k] = (1.0 + 0.1 * rng.standard_normal(blocks[k].shape)).astype(
            BF16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    prompt = rng.integers(0, jcfg.vocab, (2, PROMPT))
    prefill = np.asarray(jax.jit(lambda p, t: japi.prefill_fn(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(prompt, jnp.int32)).astype(
            jnp.float32))
    cache = {k: jnp.zeros(s, d) for k, (s, d) in
             japi.cache_axes_spec(jcfg, 2, CACHE)[0].items()}
    decode = jax.jit(lambda p, c, t, pos: japi.decode_fn(p, c, t, pos, jcfg))
    steps = []
    for pos in range(PROMPT):
        lg, cache = decode(jp, cache, jnp.asarray(prompt[:, pos:pos + 1],
                                                  jnp.int32), jnp.int32(pos))
        steps.append(np.asarray(lg.astype(jnp.float32)))
    out.update(tree=tree, prompt=prompt, prefill=prefill,
               decode=np.stack(steps, 1))
    return out


@pytest.fixture(scope="module")
def ref():
    """Every reference run of this file, once: the three configs' on
    three threads (most of their time is XLA compiling, which runs
    outside the GIL)."""
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        return dict(zip(ARCHS, pool.map(_reference, ARCHS)))


# --------------------------------------------------------------------------
# the configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    """Every field the port's ArchConfig has, value for value, resolved
    through the registry."""
    assert arch in PORTED_ARCH_IDS
    want, got = jget(arch), tget(arch)
    assert isinstance(got, ArchConfig) and got.name == arch
    for f in dataclasses.fields(ArchConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    # the narrow widths keep the head dim and the group
    for cfg in (got, _narrow(tsmoke, tget, arch)):
        assert (cfg.head_dim, cfg.n_heads // cfg.kv_heads) == \
            HEAD_GROUP[arch]


def test_llama3_tile_knobs_are_the_reference_defaults():
    """llama3-405b's attn_block_q / attn_block_kv, which the port has no
    field for (its attention runs the kernel's own tiles), are the
    reference ArchConfig's defaults: leaving them out changes nothing."""
    ref_cfg = jget("llama3-405b")
    defaults = {f.name: f.default for f in dataclasses.fields(JArchConfig)}
    for knob in ("attn_block_q", "attn_block_kv"):
        assert getattr(ref_cfg, knob) == defaults[knob], knob
        assert not hasattr(tget("llama3-405b"), knob)
    assert 160 in TC_HEAD_DIMS


# --------------------------------------------------------------------------
# B5 / B6's plain versions at head dim 160, four query heads a KV head
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_head_dim_160_matches_pallas_interpret(window):
    rng = np.random.default_rng(160 + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32).astype(BF16)
               for s in ((1, 4, 64, 160), (1, 1, 64, 160), (1, 1, 64, 160)))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=window, bq=32, bkv=32, interpret=True)
    got = t_flash(_t(q), _t(k), _t(v), causal=True, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    _within_ulp(got, want)


@pytest.mark.parametrize("length", [1, 37, 64])
def test_flash_decode_head_dim_160_matches_pallas_interpret(length):
    rng = np.random.default_rng(length)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32).astype(BF16)
                 for s in ((2, 1, 4, 160), (2, 64, 1, 160), (2, 64, 1, 160)))
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), length,
                    bs=32, interpret=True)
    got = t_decode(_t(q), _t(kc), _t(vc), length)
    assert got.dtype == torch.bfloat16
    _within_ulp(got, want)


# --------------------------------------------------------------------------
# each config at its narrow widths
# --------------------------------------------------------------------------

def _held(got: np.ndarray, want: np.ndarray) -> None:
    assert corr(got, want) > 0.999
    assert argmax_outside_ties(got, want) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref, arch):
    r = ref[arch]
    tcfg = _narrow(tsmoke, tget, arch)
    tp = bridge.from_jax_params(r["tree"], "cpu")
    prompt = torch.from_numpy(r["prompt"])
    with torch.no_grad():
        pre = tapi.prefill_fn(tp, {"tokens": prompt}, tcfg)
        cache = tserve.init_cache(tcfg, 2, CACHE, "cpu")
        steps = []
        for pos in range(PROMPT):
            lg, cache = tapi.decode_fn(tp, cache, prompt[:, pos:pos + 1], pos,
                                       tcfg)
            steps.append(lg)
    assert tuple(pre.shape) == (2, PROMPT, tcfg.vocab)
    _held(pre.float().numpy(), r["prefill"])
    _held(torch.stack(steps, 1).float().numpy(), r["decode"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref, arch):
    r = ref[arch]
    tcfg = _narrow(tsmoke, tget, arch)
    assert (tcfg.microbatch_steps, tcfg.use_fp32_master) == (
        tget(arch).microbatch_steps, tget(arch).use_fp32_master)
    stream = tpipe.TokenStream(tcfg.vocab, SEQ, BATCH, seed=0, device="cpu")
    step = tsteps.make_train_fn(tcfg)
    self_loss = max(lim["loss"] for lim in r["selves"])
    for i in range(STEPS):
        state, m = step(bridge.from_jax_state(r["states"][i], "cpu"),
                        stream.batch_at(i))
        want, lim = r["states"][i + 1], r["selves"][i]
        assert int(state["step"]) == i + 1
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        assert abs(loss - r["losses"][i]) <= 2 * self_loss, (
            i, loss, r["losses"][i], self_loss)
        assert abs(norm - r["norms"][i]) <= NORM_REL * r["norms"][i], (
            i, norm, r["norms"][i])
        for what, got, ref_tree in (
                ("params", state["params"], want["params"]),
                ("m", state["opt"]["m"], want["opt"]["m"]),
                ("v", state["opt"]["v"], want["opt"]["v"])):
            assert _rel_l2(got, ref_tree) <= 2 * lim[what], (
                i, what, _rel_l2(got, ref_tree), lim)
            assert [str(t.dtype).split(".")[-1] for t in _tensors(got)] \
                == [np.asarray(x).dtype.name for x in _tensors(ref_tree)]
