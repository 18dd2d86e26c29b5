"""Parity of the port's hybrid-LM serving path (RecurrentGemma: RG-LRU
layers, a local-attention layer every third, a ring-buffer window cache)
with the JAX reference.

The reference's recurrentgemma-9b smoke config at 5 layers
(``smoke_variant(get_config("recurrentgemma-9b")).with_(n_layers=5)``:
one (rec, rec, attn) super-block and two tail recurrent layers, d=64, 4
heads on 1 KV head, LRU width 64, window 16, vocab 256, bf16 weights with
f32 ``lambda`` / ``b_a`` / ``b_x``) runs in both packages on the CPU from
one param tree bridged across: drawn by the port's ``init_lm``, ``lambda``
the reference's own expression, norm gains and the gate biases perturbed
from a numpy seed so they carry numbers. Every reference run is made
once, in the module fixture. Tolerances:

  * ``causal_conv1d`` (prefill and a stateful decode step), the config
    fields, the bridged leaves and their dtypes: bitwise;
  * the RG-LRU's h and final state, f32: within 1e-5 relative (the
    port's doubling scan associates differently from the reference's
    ``associative_scan``, and XLA's f32 exp / sigmoid are not PyTorch's);
    its y and conv state bitwise;
  * ``init_lm``: the reference's tree by shape and dtype; the linspace
    under ``lambda`` within 1 f32 ulp of ``jnp.linspace`` and ``lambda``
    within what that ulp moves it by (~25 of its own ulps near 0.999);
  * one decode step from the reference's own cache, at every position of
    a 12-slot ring that wraps (26 positions, prompt 20 longer than the
    window): logits and every bf16 leaf of the new cache bitwise the
    reference's layer functions composed eagerly (as the port runs them),
    the f32 states within 1e-5 relative; greedy ``generate`` tokens equal
    the reference's generate loop composed eagerly;
  * against the reference's scanned ``prefill_fn`` / ``decode_fn``: the
    reference's compilation context (under ``lax.scan`` XLA fuses the
    bf16 conv and the f32 gate and GELU chain differently, and the
    recurrence carries the difference) puts its own eager composition up
    to 5 bf16 ulps (prefill) and 6 ulps / corr 0.9996 (decode) from them,
    more than dense's 1.5 and 2.5 (tests/test_torch_lm.py): held to corr
    > 0.999 and within 8 ulps of the largest |logit|; the attention layer
    with its window, eagerly, within 1 ulp of the reference's (the plain
    attention against its ``full_attention``);
  * photonic_pallas, one decode step at one super-block against the
    reference's eager composition (its Pallas kernel in interpret mode):
    corr > 0.999 and equal argmax (measured: bitwise).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_variant as j_smoke
from repro.configs.registry import get_config as j_get
from repro.core.backend import ExecPolicy as JPolicy
from repro.core.backend import prepare_params as j_prepare
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtf
from repro_torch.bridge import from_jax_params, init_lm
from repro_torch.configs.base import smoke_variant as t_smoke
from repro_torch.configs.registry import get_config as t_get
from repro_torch.core.backend import ExecPolicy as TPolicy
from repro_torch.core.backend import prepare_params as t_prepare
from repro_torch.distributed.sharding import use_sharding
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttf

BF16 = ml_dtypes.bfloat16
PROMPT, GEN, RING = 20, 6, 12     # 26 positions on a 12-slot ring


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == BF16 else a


def _ulp(x):
    """1 bf16 ulp of the largest |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(_f32(x)).max())) - 7)


def _assert_logits_close(got, want, ulps):
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=ulps * _ulp(w))
    assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.9999


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _np_cache(c):
    return {k: np.asarray(v) for k, v in c.items()}


def _j_rec_step(lp, x, h, c, cfg, pol):
    y, st = jrglru.rglru_decode_step(
        lp["rec"], jlayers.rmsnorm(x, lp["ln1"], cfg.norm_eps),
        {"h": h, "conv": c}, cfg, pol)
    x = x + y
    return x + jffn.swiglu(lp["ffn"], jlayers.rmsnorm(
        x, lp["ln2"], cfg.norm_eps), pol), st


def _j_rec_fwd(lp, x, cfg, pol):
    y, _ = jrglru.rglru_forward(
        lp["rec"], jlayers.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, pol)
    x = x + y
    return x + jffn.swiglu(lp["ffn"], jlayers.rmsnorm(
        x, lp["ln2"], cfg.norm_eps), pol)


def _j_layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _j_forward_eager(jp, toks, cfg):
    """The reference's ``forward_lm`` hybrid branch composed eagerly from
    its own layer functions (without the lax.scan)."""
    pol = JPolicy.from_cfg(cfg, training=False)
    x = jlayers.embedding_lookup(jp["embed"], toks)
    for i in range(cfg.n_layers // 3):
        sb = _j_layer(jp["blocks"], i)
        x = _j_rec_fwd(sb["rec0"], x, cfg, pol)
        x = _j_rec_fwd(sb["rec1"], x, cfg, pol)
        x = jtf.dense_layer_fwd(sb["attn"], x, cfg, pol, window=cfg.window)
    for i in range(cfg.n_layers % 3):
        x = _j_rec_fwd(_j_layer(jp["tail_blocks"], i), x, cfg, pol)
    x = jlayers.rmsnorm(x, jp["final_ln"], cfg.norm_eps)
    return np.asarray(jlayers.linear(x, jp["lm_head"], policy=pol))


def _j_decode_eager(jp, jc, tok, pos, cfg):
    """The reference's ``decode_step`` hybrid branch composed eagerly from
    its own layer functions: (logits, new cache)."""
    pol = JPolicy.from_cfg(cfg, training=False)
    x = jlayers.embedding_lookup(jp["embed"], tok)
    out = {k: [] for k in jc}
    for i in range(cfg.n_layers // 3):
        sb = _j_layer(jp["blocks"], i)
        hs, cs = [], []
        for j, name in enumerate(("rec0", "rec1")):
            x, st = _j_rec_step(sb[name], x, jc["rec_h"][i, j],
                                jc["rec_conv"][i, j], cfg, pol)
            hs.append(st["h"])
            cs.append(st["conv"])
        lp = sb["attn"]
        o, ak, av = jtf.attn_decode(
            lp["attn"], jlayers.rmsnorm(x, lp["ln1"], cfg.norm_eps),
            jc["attn_k"][i], jc["attn_v"][i], jnp.int32(pos), cfg, pol,
            window=cfg.window)
        x = x + o
        x = x + jffn.swiglu(lp["ffn"], jlayers.rmsnorm(
            x, lp["ln2"], cfg.norm_eps), pol)
        for k, v in (("rec_h", jnp.stack(hs)), ("rec_conv", jnp.stack(cs)),
                     ("attn_k", ak), ("attn_v", av)):
            out[k].append(v)
    for i in range(cfg.n_layers % 3):
        x, st = _j_rec_step(_j_layer(jp["tail_blocks"], i), x,
                            jc["tail_h"][i], jc["tail_conv"][i], cfg, pol)
        out["tail_h"].append(st["h"])
        out["tail_conv"].append(st["conv"])
    x = jlayers.rmsnorm(x, jp["final_ln"], cfg.norm_eps)
    logits = jlayers.linear(x, jp["lm_head"], policy=pol)[:, 0]
    return np.asarray(logits), {k: jnp.stack(v) for k, v in out.items()}


def _np_tree(tp):
    """The port's torch tree as numpy leaves (bf16 as ml_dtypes)."""
    if isinstance(tp, dict):
        return {k: _np_tree(v) for k, v in tp.items()}
    if tp.dtype == torch.bfloat16:
        return tp.view(torch.int16).numpy().view(BF16)
    return tp.numpy()


@pytest.fixture(scope="module")
def hy():
    jcfg = j_smoke(j_get("recurrentgemma-9b")).with_(n_layers=5)
    tcfg = t_smoke(t_get("recurrentgemma-9b")).with_(n_layers=5)
    # the reference's tree, shaped by its own init (eval_shape: no draws),
    # drawn from the port's init_lm, lambda the reference's own expression
    # (its init_rglru's, evaluated by JAX), norm gains and the gate biases
    # perturbed from a numpy seed so they carry numbers
    tree = _np_tree(init_lm(0, tcfg, "cpu"))
    lam = np.asarray(jnp.log(jnp.expm1(-jnp.log(jnp.linspace(
        0.9, 0.999, jcfg.lru_dim)) / 8.0)).astype(jnp.float32))
    rng = np.random.default_rng(0)

    def perturb(layer):
        for k in ("ln1", "ln2"):
            layer[k] = (1.0 + 0.1 * rng.standard_normal(
                layer[k].shape)).astype(BF16)
        if "rec" in layer:
            rec = layer["rec"]
            rec["lambda"] = np.broadcast_to(lam, rec["lambda"].shape).copy()
            for k in ("b_a", "b_x"):
                rec[k] = (0.5 * rng.standard_normal(rec[k].shape)).astype(
                    np.float32)

    for name in ("rec0", "rec1", "attn"):
        perturb(tree["blocks"][name])
    perturb(tree["tail_blocks"])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax_params(tree, "cpu")

    # every reference run of the file, once: the prefill; the decode step
    # composed eagerly along the sequence (its caches are the steps'
    # inputs), the scanned decode_fn from each of those caches, the
    # generate loop composed eagerly, and one photonic step
    toks = rng.integers(0, jcfg.vocab, (2, PROMPT + GEN))
    prefill = np.asarray(japi.prefill_fn(
        jp, {"tokens": jnp.asarray(toks[:, :24], jnp.int32)}, jcfg))
    step = jax.jit(lambda p, c, t, pos: japi.decode_fn(p, c, t, pos, jcfg))
    cache = jserve.init_cache(jcfg, 2, RING)
    caches, scanned, eager = [_np_cache(cache)], [], []
    for pos in range(PROMPT + GEN):
        tok = jnp.asarray(toks[:, pos:pos + 1], jnp.int32)
        scanned.append(np.asarray(step(jp, cache, tok, jnp.int32(pos))[0]))
        lg, cache = _j_decode_eager(jp, cache, tok, pos, jcfg)
        eager.append(lg)
        caches.append(_np_cache(cache))
    # the reference's generate (prefill_into_cache's decode steps over the
    # prompt, then greedy steps fed their own argmax) composed eagerly
    cache = jserve.init_cache(jcfg, 2, RING)
    for pos in range(PROMPT):
        lg, cache = _j_decode_eager(jp, cache, jnp.asarray(
            toks[:, pos:pos + 1], jnp.int32), pos, jcfg)
    gen_toks = []
    for i in range(GEN):
        tok = jnp.asarray(lg.argmax(-1)[:, None], jnp.int32)
        gen_toks.append(np.asarray(tok))
        lg, cache = _j_decode_eager(jp, cache, tok, PROMPT + i, jcfg)
    # photonic at one super-block (the tail cut: interpret mode is slow)
    pos_pp, pcfg = 14, jcfg.with_(n_layers=3,
                                  matmul_backend="photonic_pallas")
    jpp = j_prepare({k: v for k, v in jp.items() if k != "tail_blocks"},
                    bits=8)
    pp_cache = {k: v for k, v in caches[pos_pp].items() if "tail" not in k}
    pp_logits, _ = _j_decode_eager(
        jpp, {k: jnp.asarray(v) for k, v in pp_cache.items()},
        jnp.asarray(toks[:, pos_pp:pos_pp + 1], jnp.int32), pos_pp, pcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tree=tree, toks=toks,
                prefill=prefill, scanned=scanned, eager=eager, caches=caches,
                gen=np.concatenate(gen_toks, 1), pp_logits=pp_logits,
                pp_cache=pp_cache, pos_pp=pos_pp)


def test_config_matches_reference(hy):
    jcfg, tcfg = hy["jcfg"], hy["tcfg"]
    fields = ("name", "family", "n_layers", "d_model", "n_heads", "kv_heads",
              "d_ff", "vocab", "qkv_bias", "rope_theta", "tie_embeddings",
              "window", "attn_every", "lru_width", "lru_dim", "conv_kernel",
              "norm_eps", "head_dim", "microbatch_steps", "remat")
    for f in fields:
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    full_j, full_t = j_get("recurrentgemma-9b"), t_get("recurrentgemma-9b")
    for f in fields:
        assert getattr(full_j, f) == getattr(full_t, f), f
    assert full_t.head_dim == 256 and full_t.n_heads // full_t.kv_heads == 16


def test_bridge_carries_the_tree_bitwise(hy):
    """Every leaf of the hybrid tree crosses with its dtype and bits: bf16
    projections and norms, f32 lambda, b_a and b_x."""
    tree, tp = hy["tree"], hy["tp"]
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        got = flat_t[jax.tree_util.keystr(path)]
        np.testing.assert_array_equal(_bits(got), _bits(leaf))
        name = jax.tree_util.keystr(path[-1:])
        want = (torch.float32 if any(k in name for k in (
            "lambda", "b_a", "b_x")) else torch.bfloat16)
        assert got.dtype == want, name


def test_init_lm_matches_reference_tree(hy):
    """``init_lm`` draws the reference's tree (its ``eval_shape``): the
    same keys, shapes and dtypes, He / N(0, 0.1) scales, the linspace
    under lambda within 1 f32 ulp of ``jnp.linspace`` and lambda within
    what that ulp moves it by."""
    jcfg, tcfg, tree = hy["jcfg"], hy["tcfg"], hy["tree"]
    jshapes = jax.eval_shape(lambda k: japi.init_model(k, jcfg),
                             jax.random.PRNGKey(0))
    mine = init_lm(0, tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(flat_j) == len(flat_t)
    for path, sd in flat_j:
        t = flat_t[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == sd.shape
        assert str(t.dtype)[6:] == str(np.dtype(sd.dtype)), path
    w = tcfg.lru_dim
    lin_j = np.asarray(jnp.linspace(0.9, 0.999, w))
    lin_t = trglru.lru_linspace(w).numpy()
    assert np.all(np.abs(lin_t - lin_j) <= np.spacing(lin_j))
    # lambda = log(expm1(-log(lin) / 8)): 1 ulp of lin moves it by
    # |d lambda / d lin| ulp(lin); held to that plus 2 of its own ulps
    want = tree["tail_blocks"]["rec"]["lambda"]
    got = mine["tail_blocks"]["rec"]["lambda"].numpy()
    y = -np.log(lin_j.astype(np.float64)) / 8.0
    slope = np.exp(y) / np.expm1(y) / (8.0 * lin_j)
    bound = slope * np.spacing(lin_j) + 2 * np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= bound)
    conv = mine["blocks"]["rec0"]["rec"]["conv_w"].float()
    assert abs(float(conv.std()) - 0.1) < 0.02
    w_a = mine["blocks"]["rec1"]["rec"]["w_a"].float()
    assert abs(float(w_a.std()) - (2.0 / tcfg.lru_dim) ** 0.5) < 0.03
    assert torch.equal(init_lm(0, tcfg, "cpu")["embed"], mine["embed"])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_causal_conv1d_bitwise(mode):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 64)).astype(BF16)
    if mode == "prefill":
        x = rng.standard_normal((2, 9, 64)).astype(BF16)
        jy, js = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
        ty, ts = tlayers.causal_conv1d(_t(x), _t(w))
    else:
        x = rng.standard_normal((2, 1, 64)).astype(BF16)
        st = rng.standard_normal((2, 3, 64)).astype(BF16)
        jy, js = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(st))
        ty, ts = tlayers.causal_conv1d(_t(x), _t(w), _t(st))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_rglru_scan_and_state(hy):
    """The doubling scan against ``jax.lax.associative_scan`` (jitted) on
    the same f32 (a, b), and ``rglru_forward`` from a state (so the fold
    of h0 carries numbers) against the reference's, eager: h and the
    final state within 1e-5 relative, the conv state and y bitwise."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, (2, 37, 64)).astype(np.float32)
    b = rng.standard_normal((2, 37, 64)).astype(np.float32)

    @jax.jit
    def scan(a, b):
        def combine(lhs, rhs):
            return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]
        return jax.lax.associative_scan(combine, (a, b), axis=1)[1]

    got = trglru.lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got, scan(a, b)) < 1e-5
    jcfg, tcfg = hy["jcfg"], hy["tcfg"]
    jl = jax.tree_util.tree_map(lambda t: t[0],
                                hy["jp"]["blocks"]["rec1"]["rec"])
    tl = tlayers.layer_view(hy["tp"]["blocks"]["rec1"]["rec"], 0)
    x = rng.standard_normal((2, 8, 64)).astype(BF16)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 64)).astype(BF16)
    jy, js = jrglru.rglru_forward(jl, jnp.asarray(x), jcfg,
                                  JPolicy.from_cfg(jcfg, training=False),
                                  {"h": jnp.asarray(h0),
                                   "conv": jnp.asarray(c0)})
    ty, ts = trglru.rglru_forward(tl, _t(x), tcfg,
                                  TPolicy.from_cfg(tcfg, training=False),
                                  {"h": _t(h0), "conv": _t(c0)})
    assert ts["h"].dtype == torch.float32
    assert _rel(ts["h"], js["h"]) < 1e-5
    np.testing.assert_array_equal(_bits(ts["conv"]), _bits(js["conv"]))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


def _assert_scanned_class(got, want):
    """Against the reference's scanned forward or decode step (see the
    module note): corr > 0.999 and within 8 bf16 ulps."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=8 * _ulp(w))
    assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.999


def test_prefill_fn_matches_reference(hy):
    """24 tokens, beyond the 16-token window: B5's window binds. The whole
    forward against the reference's scanned prefill_fn; its attention
    layer with the window, eagerly, against the reference's within 1 bf16
    ulp (the port's plain attention against its ``full_attention``)."""
    tcfg, jcfg = hy["tcfg"], hy["jcfg"]
    toks = hy["toks"][:, :24]
    got = tapi.prefill_fn(hy["tp"], {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tuple(got.shape) == (2, 24, tcfg.vocab)
    assert got.dtype == torch.bfloat16
    _assert_scanned_class(got, hy["prefill"])
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(BF16)
    want = jtf.dense_layer_fwd(_j_layer(hy["jp"]["blocks"]["attn"], 0),
                               jnp.asarray(x), jcfg,
                               JPolicy.from_cfg(jcfg, training=False),
                               window=jcfg.window)
    mine = ttf.dense_layer_fwd(tlayers.layer_view(
        hy["tp"]["blocks"]["attn"], 0), _t(x), tcfg,
        TPolicy.from_cfg(tcfg, training=False), window=tcfg.window)
    np.testing.assert_allclose(_f32(mine), _f32(want), rtol=0,
                               atol=_ulp(want))
    causal = ttf.dense_layer_fwd(tlayers.layer_view(
        hy["tp"]["blocks"]["attn"], 0), _t(x), tcfg,
        TPolicy.from_cfg(tcfg, training=False))
    assert np.abs(_f32(causal) - _f32(want)).max() > 8 * _ulp(want)


def test_decode_fn_on_a_wrapping_ring(hy):
    """One port decode step from the reference's cache before it, at every
    position 0..25 of a 12-slot ring (the ring wraps at 12 and 24): the
    logits and every bf16 leaf of the new cache (the written ring slot,
    the conv states, every slot the step did not write) bitwise the
    reference's eager composition, its f32 recurrent states within 1e-5
    relative (XLA's f32 exp and sigmoid against PyTorch's); the logits
    against the reference's scanned decode_fn in the scanned class."""
    tcfg = hy["tcfg"]
    for pos in range(PROMPT + GEN):
        before, after = hy["caches"][pos], hy["caches"][pos + 1]
        cache = {k: _t(v) for k, v in before.items()}
        tok = torch.from_numpy(hy["toks"][:, pos:pos + 1])
        lg, cache = tapi.decode_fn(hy["tp"], cache, tok, pos, tcfg)
        np.testing.assert_array_equal(_bits(lg), _bits(hy["eager"][pos]))
        _assert_scanned_class(lg, hy["scanned"][pos])
        assert set(cache) == set(after)
        for name, v in after.items():
            if name.endswith("_h"):
                assert _rel(cache[name], v) < 1e-5, (pos, name)
            else:
                np.testing.assert_array_equal(_bits(cache[name]), _bits(v),
                                              (pos, name))
        keep = np.arange(RING) != pos % RING
        for name in ("attn_k", "attn_v"):
            np.testing.assert_array_equal(_bits(cache[name])[:, :, keep],
                                          _bits(before[name])[:, :, keep])


def test_generate_greedy_on_a_wrapping_ring(hy):
    """Batch 2, prompt 20, 6 greedy tokens on a 12-slot ring against the
    reference's generate loop composed eagerly: the same tokens
    (--cache-len below prompt + gen is the ring's case)."""
    prompt = torch.from_numpy(hy["toks"][:, :PROMPT])
    got, tps = tserve.generate(hy["tp"], tserve.init_cache(
        hy["tcfg"], 2, RING, "cpu"), prompt, GEN, hy["tcfg"])
    np.testing.assert_array_equal(got.numpy(), hy["gen"])
    assert tps > 0


def test_ring_plain_version_is_b6_over_the_first_slots():
    """``ring_decode_ref`` (the reference's ring decode) is B6's plain
    version over the first min(pos + 1, W) slots, bitwise, before and
    after the ring wraps; the linear cache's window is B6 over its last
    ``window`` rows."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 8, 16, generator=gen).bfloat16()
    kr, vr = (torch.randn(2, 12, 2, 16, generator=gen).bfloat16()
              for _ in range(2))
    for pos in (0, 5, 11, 12, 30):
        want = ref.flash_decode_ref(q, kr, vr, min(pos + 1, 12))
        assert torch.equal(ref.ring_decode_ref(q, kr, vr, pos), want)
        assert torch.equal(tattn.ring_decode_attention(q, kr, vr, pos), want)
    length, window = 10, 4
    masked = ref.flash_attention_ref(
        q.transpose(1, 2), kr[:, :length].transpose(1, 2),
        vr[:, :length].transpose(1, 2), causal=False)
    got = tattn.decode_attention(q, kr, vr, length, window=window)
    want = ref.flash_decode_ref(q, kr[:, length - window:length],
                                vr[:, length - window:length], window)
    assert torch.equal(got, want)
    assert not torch.equal(got, masked.transpose(1, 2))


def test_cache_spec_matches_reference(hy):
    jcfg, tcfg = hy["jcfg"], hy["tcfg"]
    for seq in (12, 16, 40):
        js, jax_axes = japi.cache_axes_spec(jcfg, 2, seq)
        ts, t_axes = tapi.cache_axes_spec(tcfg, 2, seq)
        assert {k: tuple(s) for k, (s, _) in ts.items()} == \
            {k: tuple(s) for k, (s, _) in js.items()}
        assert {k: str(d)[6:] for k, (_, d) in ts.items()} == \
            {k: str(np.dtype(d)) for k, (_, d) in js.items()}
        assert t_axes == jax_axes
    assert ttf.lm_logical_axes(tcfg) == jtf.lm_logical_axes(jcfg)


def test_photonic_pallas_decode_step_matches_reference(hy):
    """--backend photonic_pallas: the rec projections and the attention
    and SwiGLU weights cached (w_a, w_x and conv_w stay raw, as in the
    reference); one decode step against the reference's eager composition
    (its Pallas kernel in interpret mode), from the same cache, at one
    super-block (the tail cut: interpret mode is slow)."""
    tcfg = hy["tcfg"].with_(n_layers=3, matmul_backend="photonic_pallas")
    tpp = t_prepare({k: v for k, v in hy["tp"].items()
                     if k != "tail_blocks"}, bits=8)
    assert not isinstance(tpp["blocks"]["rec0"]["rec"]["w_a"],
                          tlayers.QuantizedWeight)
    assert isinstance(tpp["blocks"]["rec0"]["rec"]["in_proj"],
                      tlayers.QuantizedWeight)
    pos = hy["pos_pp"]
    cache = {k: _t(v) for k, v in hy["pp_cache"].items()}
    tl, _ = tapi.decode_fn(tpp, cache, torch.from_numpy(
        hy["toks"][:, pos:pos + 1]), pos, tcfg)
    g, w = _f32(tl), _f32(hy["pp_logits"])
    assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.999
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def _fake_ctx(axes, rules, **shape):
    import types

    from repro_torch.distributed import sharding
    mesh = types.SimpleNamespace(axis_names=axes, shape=shape,
                                 world=int(np.prod(list(shape.values()))),
                                 coord=lambda ax: 0, group=lambda ax: None)
    return sharding._installed(sharding.ShardingCtx(mesh, rules))


@pytest.mark.parametrize("case", ["decomposed", "experts"])
def test_hybrid_refusals_name_their_roadmap_item(hy, case):
    """What the hybrid still refuses raises naming queue A15: the
    decomposed attention, and an experts split (the moe family's) on a
    table that maps one; the hybrid itself passes every table there.
    Training and a one-rank mesh run."""
    from repro_torch.distributed import sharding

    tcfg, tp = hy["tcfg"], hy["tp"]
    toks = torch.from_numpy(hy["toks"][:, :8])
    if case == "experts":
        for axes, rules, shape in (
                (("data", "model"), sharding.DEFAULT_RULES,
                 dict(data=2, model=2)),
                (("pod", "data", "model"), sharding.MULTIPOD_RULES,
                 dict(pod=2, data=1, model=2))):
            with _fake_ctx(axes, rules, **shape) as ctx:
                sharding.check_model_rules(ctx, "hybrid")
                ttf.check_family(tcfg)
                with pytest.raises(NotImplementedError, match="A15"):
                    sharding.check_model_rules(ctx, "moe")
        return
    with pytest.raises(NotImplementedError, match="A15"):
        tapi.prefill_fn(tp, {"tokens": toks},
                        tcfg.with_(attn_impl="decomposed"))
    # a training policy and a one-rank mesh run
    loss = tapi.loss_fn(tp, {"tokens": toks, "labels": toks}, tcfg)
    assert torch.isfinite(loss)
    with use_sharding(make_host_mesh(1, 1, device="cpu")):
        out = tapi.prefill_fn(tp, {"tokens": toks}, tcfg)
    assert torch.equal(out, tapi.prefill_fn(tp, {"tokens": toks}, tcfg))


TABLES = ("default (1, 2)", "default (2, 1)", "multipod")
RING_POSITIONS = (3, 8, 17, 20)


@pytest.fixture(scope="module")
def tables(hy):
    """The calls that raised under the FSDP tables, on 2 gloo ranks (one
    spawn for the module; their body is ``_torch_ranks.
    hybrid_table_calls``): ``prefill_fn``, ``loss_fn``, ``place_lm_params``
    and ``cache_axes_spec`` under DEFAULT_RULES on (1, 2) and (2, 1) and
    MULTIPOD_RULES on (2, 1, 1), and the attention layer's ring
    ``attn_decode`` split along "kv_seq" at ``RING_POSITIONS`` from the
    reference's caches; with the reference's loss and ring decode of the
    same inputs."""
    import _torch_ranks
    from repro_torch.launch.mesh import spawn_ranks

    jcfg, jp, tcfg = hy["jcfg"], hy["jp"], hy["tcfg"]
    toks = hy["toks"][:, :24].astype(np.int32)
    rng = np.random.default_rng(17)
    cases = [(rng.standard_normal((2, 1, 64)).astype(BF16),
              hy["caches"][pos]["attn_k"][0], hy["caches"][pos]["attn_v"][0],
              pos) for pos in RING_POSITIONS]
    ranks = spawn_ranks(_torch_ranks.hybrid_table_calls, 2, hy["tp"], tcfg,
                        toks, cases, device="cpu", timeout_s=600)
    labels = np.roll(toks, -1, 1)
    loss = float(japi.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}, jcfg))
    loss1 = float(tapi.loss_fn(hy["tp"], {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)},
                               tcfg))
    pol = JPolicy.from_cfg(jcfg, training=False)
    lp = _j_layer(jp["blocks"]["attn"], 0)["attn"]
    ring = [jtf.attn_decode(lp, jnp.asarray(x), jnp.asarray(k),
                            jnp.asarray(v), jnp.int32(pos), jcfg, pol,
                            window=jcfg.window) for x, k, v, pos in cases]
    return {"ranks": ranks, "loss": loss, "loss1": loss1,
            "ring": [tuple(np.asarray(a) for a in r) for r in ring]}


@pytest.mark.parametrize("table", TABLES)
def test_hybrid_under_the_fsdp_tables_matches_reference(hy, tables, table):
    """prefill_fn, loss_fn, place_lm_params and cache_axes_spec, which
    raised under these tables, run: each rank's blocks of the params
    gather back to the whole tree bitwise; the logits assembled from the
    ranks' (rows, vocab) blocks in the reference's scanned class (8 bf16
    ulps, corr > 0.999, as the one-device prefill); the loss (the
    vocab-parallel cross-entropy, meaned over the ranks' rows) within
    1e-6 relative of the port's unsharded loss and 5e-4 of the
    reference's (its scanned forward puts the unsharded port's 2.8e-4
    away); the cache's local shapes those of its "batch", "mlp" and
    "kv_seq" splits."""
    r0, r1 = (r[table] for r in tables["ranks"])
    for r in (r0, r1):
        assert r["gathered"]
    split_vocab = table == "default (1, 2)"
    if split_vocab:
        assert (r0["coords"], r1["coords"]) == ((0, 0), (0, 1))
        got = np.concatenate([r0["prefill"], r1["prefill"]], -1)
        assert r0["loss"] == r1["loss"]
        loss = r0["loss"]
    else:
        assert (r0["coords"], r1["coords"]) == ((0, 0), (1, 0))
        got = np.concatenate([r0["prefill"], r1["prefill"]], 0)
        loss = (r0["loss"] + r1["loss"]) / 2
    assert got.shape == (2, 24, 256)
    _assert_scanned_class(got, hy["prefill"])
    assert abs(loss - tables["loss1"]) <= 1e-6 * tables["loss1"]
    assert abs(loss - tables["loss"]) <= 5e-4 * tables["loss"]
    d, w, b = (64, 32, 2) if split_vocab else (32, 64, 1)
    assert r0["in_proj"] == (1, d, w)
    assert r0["lm_head"] == ((64, 128) if split_vocab else (32, 256))
    ring = (1, b, 6 if split_vocab else 12, 1, 16)
    assert r0["cache"] == {"rec_h": (1, 2, b, w), "rec_conv": (1, 2, b, 3, w),
                           "attn_k": ring, "attn_v": ring,
                           "tail_h": (2, b, w), "tail_conv": (2, b, 3, w)}


@pytest.mark.parametrize("case", range(len(RING_POSITIONS)))
def test_ring_decode_split_along_kv_seq_matches_reference(tables, case):
    """The attention layer's decode on a 12-slot ring split along its
    slots over model 2 (6 a rank; B6's partial entry over each rank's
    slots of the valid prefix, merged, the heads split too), from the
    reference's cache at position 3 (rank 1's slots all empty), 8 (both
    ranks'), 17 and 20 (wrapped: slot 5 on rank 0, slot 8 on rank 1):
    the written ring halves bitwise the reference's new ring, the output
    within 2 bf16 ulps of its largest |value| and corr > 0.9999."""
    o, k, v = tables["ring"][case]
    r0, r1 = (r["default (1, 2)"]["ring"][case] for r in tables["ranks"])
    np.testing.assert_array_equal(r0[0], r1[0])
    np.testing.assert_array_equal(np.concatenate([r0[1], r1[1]], 1), _f32(k))
    np.testing.assert_array_equal(np.concatenate([r0[2], r1[2]], 1), _f32(v))
    _assert_logits_close(r0[0], o, 2)
