"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
(decided inside the fixture). The file imports neither JAX nor the
reference package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: photonic matmul accumulate bitwise, dequant <= 1e-6 relative;
flash attention rtol = atol = 2e-5; fused FFN one hidden quant step;
end-to-end logits card vs CPU correlation > 0.999.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.bridge import from_jax_params, init_vit, to_device  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.backend import prepare_params  # noqa: E402
from repro_torch.data.pipeline import VideoStream  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_masked  # noqa: E402
from repro_torch.kernels.fused_ffn import fused_ffn  # noqa: E402
from repro_torch.kernels.photonic_matmul import \
    photonic_matmul_int8  # noqa: E402
from repro_torch.models.vit import forward_vit  # noqa: E402
from repro_torch.serving.server import smoke_cfg  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
