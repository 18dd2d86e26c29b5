"""The Hopper designs of the ViT serving kernels, emulated on the CPU and
held against the JAX reference.

* B2, the RoI-masked flash attention: ``kernels/ref.py::
  flash_attention_masked_tc_ref`` emulates the tensor-core entry (every
  matmul operand split into TF32 hi + lo, rounded as ``cvt.rna`` rounds,
  three passes lo.hi + hi.lo + hi.hi; 32-key tiles under an online
  softmax; dead tiles skipped). It is held to rtol = atol = 2e-5 (the card
  check's limit) against the reference's Pallas kernel in interpret mode
  and against the port's plain version; one TF32 pass must miss that
  limit, which shows the lo terms are needed.
* B1, the photonic matmul: the quantize-once cache keeps the codes'
  K-major copy ``QuantizedWeight.wt`` that the kernel's K-major entry
  reads. It must equal ``wq`` transposed bitwise wherever a cache entry is
  made or moved, and a layer's copy must be a view of the stacked one.

Inputs are made with numpy from a seed; widths B 2, H 4, D 64.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_masked as j_masked
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core import backend as tbackend
from repro_torch.distributed.sharding import MODEL_RULES, ShardingCtx
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import masked_entry_for
from repro_torch.kernels.photonic_matmul import entry_for, photonic_matmul_int8
from repro_torch.models import vit as tvit
from repro_torch.serving import server as tserver

B, H, D = 2, 4, 64
MODES = ("ones", "mask", "dead", "kv_len")

_j_masked = jax.jit(functools.partial(j_masked, interpret=True),
                    static_argnames=("kv_len",))


def _operands(s: int, mode: str, seed: int):
    """q, k, v (B, H, s, D) and the mask keyword of ``mode``, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, s, D)).astype(np.float32)
               for _ in range(3))
    kw = {}
    if mode in ("mask", "dead"):
        m = (rng.random((B, s)) > 0.5).astype(np.float32)
        if mode == "dead":
            m[-1] = 0.0
        kw["key_mask"] = m
    elif mode == "kv_len":
        kw["kv_len"] = s // 2 + 1
    return q, k, v, kw


def _torch_kw(kw):
    return {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for n, a in kw.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", [50, 99])
def test_flash_attention_masked_tc_matches_reference(s, mode):
    q, k, v, kw = _operands(s, mode, seed=s + len(mode))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_masked_tc_ref(tq, tk, tv, **_torch_kw(kw))
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    pallas = np.asarray(_j_masked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **jkw))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    plain = ref.flash_attention_masked_ref(tq, tk, tv, **_torch_kw(kw))
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("s", [31, 32, 33, 65])
def test_flash_attention_masked_tc_tile_edges(s):
    """The 32-key tile's edges, a random mask: the same limit against the
    plain version."""
    q, k, v, kw = _operands(s, "mask", seed=s)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    torch.testing.assert_close(
        ref.flash_attention_masked_tc_ref(tq, tk, tv, **_torch_kw(kw)),
        ref.flash_attention_masked_ref(tq, tk, tv, **_torch_kw(kw)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["ones", "mask"])
def test_one_tf32_pass_misses_the_f32_class(mode):
    """hi.hi alone (one TF32 pass, 10-bit mantissas) is ~10x outside the
    2e-5 limit that three passes hold: the lo terms are needed."""
    q, k, v, kw = _operands(99, mode, seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = ref.flash_attention_masked_ref(tq, tk, tv, **_torch_kw(kw))
    one = ref.flash_attention_masked_tc_ref(tq, tk, tv, passes=1,
                                            **_torch_kw(kw))
    three = ref.flash_attention_masked_tc_ref(tq, tk, tv, **_torch_kw(kw))
    excess = ((one - want).abs() - 2e-5 * want.abs()).max().item()
    assert excess > 5 * 2e-5
    assert torch.allclose(three, want, rtol=2e-5, atol=2e-5)


def test_tf32_rna_rounds_like_cvt_rna():
    """Nearest TF32 value, ties away from zero, the low 13 bits zero."""
    one = 1.0
    half_ulp = 2.0 ** -11
    x = torch.tensor([one, one + half_ulp, -(one + half_ulp),
                      one + half_ulp / 2, one + 3 * half_ulp / 2, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 2 * half_ulp, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(ref.tf32_rna(x), want)
    r = ref.tf32_rna(torch.from_numpy(np.random.default_rng(0)
                                      .standard_normal(4096)
                                      .astype(np.float32)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert bool(((ref.tf32_rna(x) - x).abs() <= ulp / 2).all())


# --------------------------------------------------------------------------
# B1: the K-major copy of the quantize-once cache
# --------------------------------------------------------------------------

def _is_k_major_copy(qw) -> bool:
    return (qw.wt.is_contiguous()
            and torch.equal(qw.wt, qw.wq.transpose(-1, -2)))


def test_quantize_weight_keeps_a_k_major_copy():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 48, 80))
                         .astype(np.float32))
    qw = tbackend.quantize_weight(w, bits=8)
    assert tuple(qw.wt.shape) == (3, 80, 48)
    assert _is_k_major_copy(qw)
    assert _is_k_major_copy(qw.to("cpu"))


def test_layer_slices_the_stacked_copy_without_new_storage():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 32, 64))
                         .astype(np.float32))
    qw = tbackend.quantize_weight(w, bits=8)
    for i in range(4):
        li = qw.layer(i)
        assert _is_k_major_copy(li)
        assert li.wt.untyped_storage().data_ptr() == \
            qw.wt.untyped_storage().data_ptr()
        assert li.wt.data_ptr() == qw.wt.data_ptr() + i * 32 * 64


@pytest.fixture(scope="module")
def bridged():
    """A prepared smoke ViT (+ MGNet) crossing the bridge as cached-weight
    (wq, scale, bits) triples, the form the reference's cache takes."""
    cfg = tserver.smoke_cfg()
    prepared = tbackend.prepare_params(
        from_jax_params(init_vit(0, cfg, 10), "cpu"), bits=8)

    def triples(t):
        if isinstance(t, dict):
            return {k: triples(v) for k, v in t.items()}
        if isinstance(t, tbackend.QuantizedWeight):
            return (t.wq.numpy(), t.scale.numpy(), t.bits)
        return t.numpy()
    return SimpleNamespace(cfg=cfg,
                           params=from_jax_params(triples(prepared), "cpu"))


def _cached(tree):
    if isinstance(tree, dict):
        return [w for v in tree.values() for w in _cached(v)]
    return [tree] if isinstance(tree, tbackend.QuantizedWeight) else []


def test_bridge_makes_the_k_major_copy(bridged):
    ws = _cached(bridged.params)
    assert len(ws) == 16              # as test_torch_quant counts them
    assert all(_is_k_major_copy(w) for w in ws)


def test_place_params_shards_the_copy_as_its_codes(bridged):
    """Rank (0, 1) of a (1, 2) mesh: a column shard of wq (wq/wk/wv, w1)
    is a row shard of wt, a row shard (w2) a column shard; each still wq's
    transpose, contiguous."""
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": 2},
                           coord=lambda ax: {"data": 0, "model": 1}[ax])
    placed = tbackend.place_params(bridged.params,
                                   tvit.vit_logical_axes(bridged.cfg),
                                   ShardingCtx(mesh, MODEL_RULES))
    p, q = bridged.params["blocks"], placed["blocks"]
    h, f = bridged.cfg.d_model // 2, bridged.cfg.d_ff // 2
    assert torch.equal(q["attn"]["wk"].wt, p["attn"]["wk"].wt[:, h:])
    assert torch.equal(q["ffn"]["w1"].wt, p["ffn"]["w1"].wt[:, f:])
    assert torch.equal(q["ffn"]["w2"].wt, p["ffn"]["w2"].wt[..., f:])
    assert all(_is_k_major_copy(w) for w in _cached(placed))


def test_entries_are_chosen_by_shape_only():
    """B1: K a multiple of 16 takes the K-major entry (every K of the
    serving path but MGNet's 196-wide score head); B2: (D, Dv) = (64, 64)
    takes the tensor cores, Eq. 2's (192, 64) the wide tensor-core entry,
    (32, 48) the SIMT kernel."""
    assert [entry_for(k) for k in (768, 1024, 192, 32, 96, 196, 37)] == \
        ["kmajor"] * 5 + ["nmajor"] * 2
    assert masked_entry_for(64, 64) == "tc"
    assert masked_entry_for(192, 64) == "wide"
    assert masked_entry_for(32, 48) == "simt"


def test_cpu_wrapper_takes_the_copy_and_checks_it():
    """On the CPU the wrapper runs the plain version on wq whether or not
    the K-major copy comes along; a copy of the wrong shape raises."""
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, (9, 64), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 24), dtype=np.int8))
    sx, sw = torch.tensor(0.01), torch.from_numpy(
        rng.random(24).astype(np.float32))
    want = ref.photonic_matmul_ref(xq, wq, sx, sw)
    assert torch.equal(photonic_matmul_int8(xq, wq, sx, sw,
                                            wt=wq.t().contiguous()), want)
    with pytest.raises(ValueError, match="K-major copy"):
        photonic_matmul_int8(xq, wq, sx, sw, wt=wq)
