"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
(decided inside the fixture). The file imports neither JAX nor the
reference package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: photonic matmul accumulate bitwise, dequant <= 1e-6 relative;
flash attention rtol = atol = 2e-5; fused FFN one hidden quant step;
causal flash attention and flash decode f32 rtol = atol = 2e-5, bf16
within 1 bf16 ulp of the largest |o|; end-to-end logits card vs CPU
correlation > 0.999; the dequant epilogue bitwise; the model-sharded FFN
over 2 ranks on the one card bitwise against the unsharded twin on the
card (an exact int32 accumulate and the same elementwise ops).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.bridge import (from_jax_params, init_lm, init_vit,  # noqa: E402
                                to_device)
from repro_torch.configs.base import smoke_variant  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.backend import prepare_params  # noqa: E402
from repro_torch.data.pipeline import VideoStream  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_masked  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.fused_ffn import (dequant_epilogue,  # noqa: E402
                                           fused_ffn, fused_ffn_xla)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.launch.serve import init_cache, prefill_into_cache  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.kernels.photonic_matmul import \
    photonic_matmul_int8  # noqa: E402
from repro_torch.models.vit import forward_vit  # noqa: E402
from repro_torch.serving.server import smoke_cfg  # noqa: E402

import _torch_ranks  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _qweight(gen, k, n, bits, device):
    w = torch.randn(k, n, generator=gen, device=device) * (2.0 / k) ** 0.5
    s = quant.absmax_scale(w, bits=bits, axis=-2)
    return quant.quantize(w, s, bits=bits), s.reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(788, 768, 768), (4, 768, 10),
                                   (1576, 192, 576), (37, 768, 192),
                                   (8, 196, 196)])
def test_photonic_matmul_kernel(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    before = _build.LAUNCHES["photonic_matmul"]
    acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                               torch.ones(n, device=dev))
    assert _build.LAUNCHES["photonic_matmul"] == before + 1
    assert torch.equal(acc.long(), ref.int_accumulate_ref(xq, wq).long())
    sx = torch.rand((), generator=g, device=dev)
    sw = torch.rand(n, generator=g, device=dev)
    got = photonic_matmul_int8(xq, wq, sx, sw)
    want = ref.photonic_matmul_ref(xq, wq, sx, sw)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hk,hv,s,d,dv,mode,scale", [
    (4, 12, 12, 12, 197, 64, 64, "ones", None),
    (4, 12, 12, 12, 99, 64, 64, "dead", None),
    (4, 3, 3, 3, 148, 64, 64, "kv_len", None),
    (2, 12, 1, 12, 99, 192, 64, "mask", 1.0),
])
def test_flash_attention_kernel(dev, b, h, hk, hv, s, d, dv, mode, scale):
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, h, s, d, generator=g, device=dev)
    k = torch.randn(b, hk, s, d, generator=g, device=dev)
    v = torch.randn(b, hv, s, dv, generator=g, device=dev)
    kw = {"scale": scale}
    if mode in ("mask", "dead"):
        m = (torch.rand(b, s, generator=g, device=dev) > 0.5).float()
        if mode == "dead":
            m[-1] = 0.0
        kw["key_mask"] = m
    elif mode == "kv_len":
        kw["kv_len"] = 50
    got = flash_attention_masked(q, k, v, **kw)
    want = ref.flash_attention_masked_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [None, 70])
def test_flash_attention_constant_mask_path(dev, kv_len):
    """No key mask (and an int ``kv_len``) take the cached constant mask:
    the same numbers as passing the equivalent keep-mask."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(4, 12, 99, 64, generator=g, device=dev)
               for _ in range(3))
    mask = (torch.ones(4, 99, device=dev) if kv_len is None
            else ref.prefix_key_mask(kv_len, 4, 99, dev))
    for _ in range(2):          # the second call reads the cache
        got = flash_attention_masked(q, k, v, kv_len=kv_len)
        assert torch.equal(got, flash_attention_masked(q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dff,bits,live", [(197, 768, 3072, (8, 8), None),
                                               (99, 192, 768, (8, 4), 60)])
def test_fused_ffn_kernel(dev, n, d, dff, bits, live):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(4, n, d, generator=g, device=dev)
    w1q, s1 = _qweight(g, d, dff, bits[0], dev)
    w2q, s2 = _qweight(g, dff, d, bits[1], dev)
    b1 = torch.randn(dff, generator=g, device=dev) * 0.1
    b2 = torch.randn(d, generator=g, device=dev) * 0.1
    args = (x, w1q, s1, b1, w2q, s2, b2)
    got = fused_ffn(*args, bits=bits, live_rows=live)
    want = ref.fused_ffn_ref(*args, bits=bits, live_rows=live)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    c = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1]
    assert c > 0.9999
    if live is not None:
        assert bool((got[:, live:] == 0).all())


@pytest.mark.gpu
def test_forward_vit_card_matches_cpu(dev):
    cfg = smoke_cfg()
    cpu = prepare_params(from_jax_params(init_vit(0, cfg, 10), "cpu"))
    frames = torch.from_numpy(VideoStream(img_size=32, patch=8).frames_at(
        0, 8)["frames"])
    gl, _ = forward_vit(to_device(cpu, dev), frames, cfg)
    cl, _ = forward_vit(cpu, frames, cfg, device="cpu")
    a, b = gl.double().cpu().flatten(), cl.double().flatten()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999
    assert np.array_equal(gl.cpu().argmax(-1).numpy(), cl.argmax(-1).numpy())


def _assert_held(got, want):
    """f32: rtol = atol = 2e-5; bf16: 1 bf16 ulp of the largest |want|."""
    assert got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,dtype", [
    (4, 12, 2, 128, 128, 128, True, 0, torch.bfloat16),    # qwen2 prefill
    (4, 12, 2, 128, 128, 128, True, 0, torch.float32),
    (2, 12, 2, 77, 77, 128, True, 0, torch.float32),       # ragged
    (2, 12, 2, 100, 100, 128, True, 32, torch.float32),    # window
    (2, 12, 2, 1, 1, 128, True, 0, torch.bfloat16),        # Sq = 1
    (1, 4, 2, 19, 45, 32, False, 0, torch.float32),        # non-causal
])
def test_flash_attention_causal_kernel(dev, b, h, hkv, sq, skv, d, causal,
                                       window, dtype):
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, hkv, skv, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = _build.LAUNCHES["flash_attention_causal"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert _build.LAUNCHES["flash_attention_causal"] == before + 1
    _assert_held(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                              window=window))


@pytest.mark.gpu
def test_fused_attention_reads_the_models_layout(dev):
    """(B, S, H, D) projections go in as strided views and come out in the
    same layout: the same numbers as contiguous (B, H, S, D) inputs."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(4, 128, 12, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(4, 128, 2, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    got = blockwise_attention(q, k, v)
    assert tuple(got.shape) == (4, 128, 12, 128)
    want = flash_attention(*(t.transpose(1, 2).contiguous()
                             for t in (q, k, v))).transpose(1, 2)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d,length,dtype", [
    (4, 512, 12, 2, 128, 160, torch.bfloat16),     # qwen2 decode
    (4, 512, 12, 2, 128, 160, torch.float32),
    (4, 512, 12, 2, 128, 1, torch.bfloat16),
    (4, 512, 12, 2, 128, 512, torch.float32),
    (2, 45, 12, 2, 128, 33, torch.float32),        # S not a tile multiple
])
def test_flash_decode_kernel(dev, b, s, h, hkv, d, length, dtype):
    g = torch.Generator(device=dev).manual_seed(s + length)
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
              for _ in range(2))
    before = _build.LAUNCHES["flash_decode"]
    got = flash_decode(q, kc, vc, length)
    assert _build.LAUNCHES["flash_decode"] == before + 1
    _assert_held(got, ref.flash_decode_ref(q, kc, vc, length))
    # a layer's slice of a stacked cache, and a head-major store, by strides
    stacked = torch.stack([kc, kc]), torch.stack([vc, vc])
    assert torch.equal(flash_decode(q, stacked[0][1], stacked[1][1], length),
                       got)
    hm = (kc.transpose(1, 2).contiguous().transpose(1, 2),
          vc.transpose(1, 2).contiguous().transpose(1, 2))
    assert torch.equal(flash_decode(q, *hm, length), got)


@pytest.mark.gpu
def test_decode_step_card_matches_cpu(dev):
    """qwen2-1.5b at smoke width (2 layers): the decode-loop prefill of an
    8-token prompt on the card (B5-free, B6 every layer) against the CPU's
    plain versions; and prefill_fn (B5) on the card against the same."""
    cfg = smoke_variant(get_config("qwen2-1.5b")).with_(n_layers=2)
    cpu = init_lm(0, cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    cl, _ = prefill_into_cache(cpu, init_cache(cfg, 2, 16, "cpu"), prompt,
                               cfg)
    before = _build.LAUNCHES["flash_decode"]
    gl, _ = prefill_into_cache(to_device(cpu, dev),
                               init_cache(cfg, 2, 16, dev), prompt.to(dev),
                               cfg)
    assert _build.LAUNCHES["flash_decode"] == before + 8 * cfg.n_layers
    a, b = gl.double().cpu().flatten(), cl.double().flatten()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999
    full = model_api.prefill_fn(to_device(cpu, dev),
                                {"tokens": prompt.to(dev)}, cfg)[:, -1]
    a = full.double().cpu().flatten()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(788, 2048), (788, 1024), (37, 1003),
                                 (1, 1024)])
def test_dequant_epilogue_kernel(dev, m, n):
    """Bitwise against the plain version, on the 16-byte path (N % 4 == 0,
    aligned) and, from an acc that starts 4 bytes into its buffer, on the
    scalar path."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    buf = torch.randint(-2 ** 30, 2 ** 30, (m * n + 1,), generator=g,
                        device=dev, dtype=torch.int32)
    sx = torch.rand((), generator=g, device=dev) * 1e-3
    sw = torch.rand(n, generator=g, device=dev)
    for acc in (buf[:-1].view(m, n), buf[1:].view(m, n)):
        before = _build.LAUNCHES["dequant_epilogue"]
        got = dequant_epilogue(acc, sx, sw)
        assert _build.LAUNCHES["dequant_epilogue"] == before + 1
        assert torch.equal(got, ref.dequant_epilogue_ref(acc, sx, sw))


@pytest.mark.gpu
def test_fused_ffn_sharded_two_ranks_on_one_card(dev):
    """opto-vit-large's FFN widths (d 1024, d_ff 4096) at a 4 x 197 flush
    and a live-row prefix, split over 2 gloo ranks on the one card."""
    rng = np.random.default_rng(0)
    cases = []
    for bits, live in ((8, None), ((8, 6), 60)):
        b1, b2 = bits if isinstance(bits, tuple) else (bits, bits)
        g = torch.Generator().manual_seed(b2)
        w1q, s1 = _qweight(g, 1024, 4096, b1, "cpu")
        w2q, s2 = _qweight(g, 4096, 1024, b2, "cpu")
        cases.append((rng.standard_normal((4, 197, 1024)).astype(np.float32),
                      w1q.numpy(), s1.numpy(),
                      (rng.standard_normal(4096) * 0.1).astype(np.float32),
                      w2q.numpy(), s2.numpy(),
                      (rng.standard_normal(1024) * 0.1).astype(np.float32),
                      bits, live))
    out = spawn_ranks(_torch_ranks.ffn_sharded, 2, cases, "cuda",
                      device="cuda", timeout_s=300)
    for i, (*ops, bits, live) in enumerate(cases):
        whole = fused_ffn_xla(*(torch.from_numpy(a).to(dev) for a in ops),
                              bits=bits, live_rows=live).cpu().numpy()
        for r in out:
            np.testing.assert_array_equal(r[i], whole)
