"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
(decided inside the fixture). The file imports neither JAX nor the
reference package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: photonic matmul accumulate bitwise, dequant <= 1e-6 relative;
flash attention rtol = atol = 2e-5 (its two tensor-core entries also
against their 3xTF32 emulation); fused FFN one hidden quant step, its K-major entry
bitwise against its first design (both also at bit-plan widths 6 and
4); the int32 accumulate bitwise;
causal flash attention and flash decode f32 rtol = atol = 2e-5, bf16
within 1 bf16 ulp of the largest |o|, and each bitwise from call to call
(flash decode's partial entry: o and lse f32 within 2e-5 of its plain
version, an empty range exactly o = 0 and lse = NEG_INF, the ranges
merged within flash decode's tolerance); end-to-end logits card vs CPU
correlation > 0.999; the dequant epilogue bitwise; the model-sharded FFN
over 2 ranks on the one card bitwise against the unsharded twin on the
card (an exact int32 accumulate and the same elementwise ops); a CUDA
graph replay of a bucket encode bitwise against the eager encode of the
same flush, with the same launch counts (also under a per-layer bit plan,
after ``calibrate_bits`` re-quantized the cache, and under Eq. 2's
composed policy), and a graphed interleaved serve bitwise, per stream,
against solo eager runs. The composed and Eq. 2 base-224 encodes against
the CPU: correlation > 0.999, equal argmax. The noise-draw kernel against
its plain version on the card: the generator's bits bitwise, the
transmission multiplier (the f32 entry on unit weights) within 1e-6
absolute, the int8 codes times it within 1e-6 of the largest code, the
shot-noise readout within 1e-6 relative (the plain version's FMAs are
emulated in float64, the kernel's are one rounding); a noisy graphed
encode (photonic_sim + flash + xla FFN, drift and wander) replays the
eager encode of the same DriftState bitwise with equal launch counts,
draws anew at the next frame, and stays valid across a recalibration.
The serving control plane: the graphs ``autotune_prepare`` captures while
pricing replay the eager encode bitwise; every timed flush lands in the
telemetry and each hit bucket reports a positive measured flush time; an
untimed server records none; the watchdog flags a flush delayed by 50 ms;
a capture survives a dropped server's graphs held by a reference cycle.
Faults, checkpoints and migration: a graphed server's checkpoint restored
into a fresh graphed server, and a session exported to another, serve the
remaining predictions bitwise (the new server's graphs replay its eager
encode bitwise); a restored noisy server holds the snapshot's DriftState
in its state tensor at its first replay (a planted stale restore does
not); an exception inside a capture leaves the device out of capture mode
on its default stream, and the server serves again. The 1-D data mesh
and the fleet: B3 under an absmax scope (its K-major host-split binding,
and the N-major design's two launches) bitwise the call outside one; a
2-rank data-mesh serve on the one card bitwise the unsharded eager serve,
every B3 launch on the host-split binding; a graphed 2-worker fleet on
one shared cache bitwise, job by job, solo serves; two spawned workers
serve through their own graphs and compile no kernel. ViT training: a
train step on the card against the same step on the CPU (the loss
within 1%, the gradients within 0.25 relative L2, each leaf corr > 0.95:
the gate's top-k routing, the rounding and the STE's gradient at the
clip bound are discontinuous, so rounding differences move whole
leaves),
a run resumed from a checkpoint and after an injected fault bitwise the
straight run under deterministic algorithms, and a training policy that
names a kernel raising with the reason. The dense family's other
configs: B5's bf16 entry at head dim 160 and B6 at D 160 / G 4
(stablelm-12b) against their plain versions, and each config at narrow
widths that keep its head dim and group, card against CPU. The hybrid
LM: B5 / B6 at a
recurrentgemma-9b rank's shapes under MODEL_RULES against their plain
versions (1 bf16 ulp of the largest |o|); the split RG-LRU's prefill and
ring decode on 2 gloo ranks of the card bitwise the split's arithmetic on
one card; the train step's backward under full-precision matmuls.
"""

import gc
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

# the training tests run under deterministic algorithms, which need
# cuBLAS's fixed workspace, set before the first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.bridge import (from_jax_params, init_lm, init_vit,  # noqa: E402
                                to_device)
from repro_torch.checkpoint.checkpoint import load_meta  # noqa: E402
from repro_torch.configs.base import smoke_variant  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.backend import (int_accumulate_pallas,  # noqa: E402
                                      prepare_params)
from repro_torch.data.pipeline import VideoStream  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_masked, masked_entry_for)
from repro_torch.kernels.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import (flash_decode,  # noqa: E402
                                               flash_decode_partial)
from repro_torch.kernels.fused_ffn import (  # noqa: E402
    dequant_epilogue, ffn_entry_for, fused_ffn, fused_ffn_nmajor,
    fused_ffn_xla, int_accumulate)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.attention import (blockwise_attention,  # noqa: E402
                                          decode_attention, merge_partials,
                                          ring_decode_attention)
from repro_torch.launch.serve import init_cache, prefill_into_cache  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.kernels.ops import photonic_matmul_prequant  # noqa: E402
from repro_torch.core import noise  # noqa: E402
from repro_torch.kernels import noise_draw  # noqa: E402
from repro_torch.kernels.photonic_matmul import (  # noqa: E402
    entry_for, photonic_matmul_int8)
from repro_torch.models.layers import layer_view  # noqa: E402
from repro_torch.models.vit import (embed_patches,  # noqa: E402
                                    encode_tokens, encoder_layer_step,
                                    forward_vit, forward_vit_tokens)
from repro_torch.data.pipeline import (prefetch_to_device,  # noqa: E402
                                       video_fleet)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.session import ServingConfig  # noqa: E402
from repro_torch.serving.server import (ServerConfig,  # noqa: E402
                                        StreamServer, _gather_topk_rows,
                                        serving_cfg, smoke_cfg)

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
    """The entry the shape names (the weight's K-major copy given, as the
    quantize-once cache holds it): accumulate bitwise, dequant 1e-6."""
    _check_photonic_matmul(dev, m, k, n)


def _check_photonic_matmul(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    wt = wq.t().contiguous()
    entry = "photonic_matmul." + entry_for(k)
    before = (_build.LAUNCHES["photonic_matmul"], _build.LAUNCHES[entry])
    acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                               torch.ones(n, device=dev), wt=wt)
    assert (_build.LAUNCHES["photonic_matmul"],
            _build.LAUNCHES[entry]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(acc.long(), ref.int_accumulate_ref(xq, wq).long())
    sx = torch.rand((), generator=g, device=dev)
    sw = torch.rand(n, generator=g, device=dev)
    got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
    want = ref.photonic_matmul_ref(xq, wq, sx, sw)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [32, 64, 96, 768])
@pytest.mark.parametrize("m", [1, 63, 65, 1568])
def test_photonic_matmul_kmajor_ring_edges(dev, m, k):
    """The K-major entry at its 4-stage ring's edges (K = 32 and 64: one
    step; 96: a half-filled second step; 768: twelve) and its 64-row
    tile's (M = 1, 63, 65, 1568), N = 768 (N = 100 at M = 65: a ragged
    n-tile)."""
    _check_photonic_matmul(dev, m, k, 100 if m == 65 else 768)


@pytest.mark.gpu
@pytest.mark.parametrize("m,bits", [(788, 6), (788, 4), (200, 4)])
def test_photonic_matmul_at_plan_widths(dev, m, bits):
    """B1 as a bit plan runs it: x quantized at the weight's width (codes
    within its range), the K-major entry's accumulate bitwise and its
    dequant within 1e-6 of the plain version, and the whole prequant call
    within 1e-6 of the same call on the CPU."""
    g = torch.Generator(device=dev).manual_seed(m + bits)
    x = torch.randn(m, 768, generator=g, device=dev)
    wq, sw = _qweight(g, 768, 768, bits, dev)
    wt = wq.t().contiguous()
    qmax = quant.quant_range(bits)[1]
    sx = quant.absmax_scale(x, bits=bits)
    xq = quant.quantize(x, sx, bits=bits)
    assert int(xq.abs().max()) <= qmax and int(wq.abs().max()) <= qmax
    before = _build.LAUNCHES["photonic_matmul.kmajor.K768"]
    acc = photonic_matmul_int8(xq, wq, torch.ones((), device=dev),
                               torch.ones(768, device=dev), wt=wt)
    assert _build.LAUNCHES["photonic_matmul.kmajor.K768"] == before + 1
    assert torch.equal(acc.long(), ref.int_accumulate_ref(xq, wq).long())
    want = ref.photonic_matmul_ref(xq, wq, sx, sw)
    got = photonic_matmul_int8(xq, wq, sx, sw, wt=wt)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    got = photonic_matmul_prequant(x, wq, sw, bits=bits, wt=wt)
    cpu = photonic_matmul_prequant(x.cpu(), wq.cpu(), sw.cpu(), bits=bits)
    assert (got.cpu() - cpu).abs().max() <= 1e-6 * cpu.abs().max()


@pytest.mark.gpu
def test_photonic_matmul_kmajor_rejects_what_it_does_not_take(dev):
    """The K-major entry raises without the weight's K-major copy and on a
    16-byte misaligned xq, instead of taking another path."""
    xq = torch.zeros(8, 64, dtype=torch.int8, device=dev)
    wq = torch.zeros(64, 64, dtype=torch.int8, device=dev)
    one, ones = torch.ones((), device=dev), torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="K-major copy"):
        photonic_matmul_int8(xq, wq, one, ones)
    buf = torch.zeros(8 * 64 + 4, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        photonic_matmul_int8(buf[4:].view(8, 64), wq, one, ones,
                             wt=wq.t().contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hk,hv,s,d,dv,mode,scale", [
    (4, 12, 12, 12, 197, 64, 64, "ones", None),
    (4, 12, 12, 12, 99, 64, 64, "dead", None),
    (4, 3, 3, 3, 148, 64, 64, "kv_len", None),
    (2, 12, 1, 12, 99, 192, 64, "mask", 1.0),
])
def test_flash_attention_kernel(dev, b, h, hk, hv, s, d, dv, mode, scale):
    """Each entry against the plain version evaluated in float64 (the exact
    function), rtol = atol = 2e-5. With unscaled N(0, 1) q at D = 192 and
    scale 1.0 the scores' spread is ~14, where the plain version in f32
    is itself 2-3e-5 from the exact output (measured on an H100): an f32
    reference would grade its own rounding, not the kernel's."""
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
    want = ref.flash_attention_masked_ref(q.double(), k.double(), v.double(),
                                          **kw)
    torch.testing.assert_close(got, want.float(), rtol=2e-5, atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,mode", [
    (4, 12, 197, "ones"), (4, 12, 197, "mask"), (4, 12, 99, "dead"),
    (4, 12, 197, "kv_len"), (4, 12, 50, "ones"), (4, 12, 99, "mask"),
    (4, 8, 197, "mask"), (2, 4, 1, "ones"), (2, 4, 33, "mask"),
    (2, 4, 65, "mask"), (2, 4, 128, "kv_len"), (2, 4, 129, "mask")])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_attention_masked_tc_follows_its_emulation(dev, b, h, s, mode,
                                                         layout):
    """The tensor-core entry (D = Dv = 64) against its 3xTF32 emulation
    ``kernels/ref.py::flash_attention_masked_tc_ref`` and the plain version,
    rtol = atol = 2e-5 each, for all-live keys, a random mask, a dead batch
    row (exactly 0), kv_len, ragged S and the 32-key / 64-row tile edges,
    with q, k, v contiguous or as (B, S, H, D) tensors viewed (B, H, S, D)
    (read by strides). The output is a (B, H, S, Dv) view of a (B, S, H,
    Dv) tensor."""
    g = torch.Generator(device=dev).manual_seed(s * 7 + h)

    def rnd():
        if layout == "bhsd":
            return torch.randn(b, h, s, 64, generator=g, device=dev)
        return torch.randn(b, s, h, 64, generator=g,
                           device=dev).transpose(1, 2)
    q, k, v = rnd(), rnd(), rnd()
    kw = {}
    if mode in ("mask", "dead"):
        kw["key_mask"] = (torch.rand(b, s, generator=g, device=dev)
                          > 0.5).float()
        if mode == "dead":
            kw["key_mask"][-1] = 0.0
    elif mode == "kv_len":
        kw["kv_len"] = s // 2 + 1
    before = _build.LAUNCHES["flash_attention_masked.tc"]
    got = flash_attention_masked(q, k, v, **kw)
    assert _build.LAUNCHES["flash_attention_masked.tc"] == before + 1
    assert got.shape == (b, h, s, 64)
    assert got.transpose(1, 2).is_contiguous()
    cpu = {n: (t.cpu() if torch.is_tensor(t) else t) for n, t in kw.items()}
    emu = ref.flash_attention_masked_tc_ref(q.cpu(), k.cpu(), v.cpu(), **cpu)
    torch.testing.assert_close(got.cpu(), emu, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        got, ref.flash_attention_masked_ref(q, k, v, **kw), rtol=2e-5,
        atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.gpu
def test_flash_attention_masked_tc_rejects_misaligned_views(dev):
    """A (B, H, S, 64) view whose row stride is not 16-byte aligned raises
    instead of taking another path."""
    base = torch.randn(1, 2, 8, 66, device=dev)
    view = base[..., 1:65]                    # D 64, row stride 66
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_masked(view, view, view)


@pytest.mark.gpu
def test_vit_kernels_dispatch_by_shape(dev):
    """Each wrapper picks its entry by shape only: B2 (64, 64) the tensor
    cores, (192, 64) the wide tensor-core entry, (32, 48) the SIMT kernel;
    B1 K = 768 the K-major entry, K = 196 the N-major one. Each launch
    counts under its entry and no other."""
    entries = ("tc", "wide", "simt")
    for (d, dv), entry in (((64, 64), "tc"), ((192, 64), "wide"),
                           ((32, 48), "simt")):
        assert masked_entry_for(d, dv) == entry
        q = torch.randn(2, 4, 37, d, device=dev)
        v = torch.randn(2, 4, 37, dv, device=dev)
        before = dict(_build.LAUNCHES)
        flash_attention_masked(q, q, v)
        for key in ("flash_attention_masked",
                    "flash_attention_masked." + entry):
            assert _build.LAUNCHES[key] == before.get(key, 0) + 1
        for other in entries:
            if other != entry:
                key = "flash_attention_masked." + other
                assert _build.LAUNCHES[key] == before.get(key, 0)
    for k, entry in ((768, "kmajor"), (196, "nmajor")):
        assert entry_for(k) == entry
        before = _build.LAUNCHES[f"photonic_matmul.{entry}.K{k}"]
        _check_photonic_matmul(dev, 8, k, 196)
        assert _build.LAUNCHES[f"photonic_matmul.{entry}.K{k}"] == before + 2


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
@pytest.mark.parametrize("b,n,d,dff,bits,live", [
    (4, 197, 768, 3072, (8, 8), None),     # base-224, largest bucket
    (4, 99, 192, 768, (8, 4), 60),         # tiny, mixed widths, live rows
    (1, 37, 768, 3072, (8, 8), None),      # ragged M: one 64-row tile
    (1, 1, 768, 3072, (8, 8), None),       # M = 1
    (4, 197, 768, 3072, (6, 6), None),     # base-224 at bit-plan widths
    (4, 197, 768, 3072, (4, 4), None),
    (4, 197, 768, 3072, (6, 4), None)])
def test_fused_ffn_kernel(dev, b, n, d, dff, bits, live):
    """The K-major entry (the weights' K-major copies given, as the cache
    holds them) is bitwise equal to the first design called directly and
    within one quant step of the plain version; dead rows exact zeros."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(b, n, d, generator=g, device=dev)
    w1q, s1 = _qweight(g, d, dff, bits[0], dev)
    w2q, s2 = _qweight(g, dff, d, bits[1], dev)
    b1 = torch.randn(dff, generator=g, device=dev) * 0.1
    b2 = torch.randn(d, generator=g, device=dev) * 0.1
    args = (x, w1q, s1, b1, w2q, s2, b2)
    assert ffn_entry_for(d, dff) == "kmajor"
    before = _build.LAUNCHES["fused_ffn.kmajor"]
    got = fused_ffn(*args, bits=bits, live_rows=live,
                    w1t=w1q.t().contiguous(), w2t=w2q.t().contiguous())
    assert _build.LAUNCHES["fused_ffn.kmajor"] == before + 1
    assert torch.equal(got, fused_ffn_nmajor(*args, bits=bits,
                                             live_rows=live))
    want = ref.fused_ffn_ref(*args, bits=bits, live_rows=live)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    c = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1]
    assert c > 0.9999
    if live is not None:
        assert bool((got[:, live:] == 0).all())


@pytest.mark.gpu
def test_fused_ffn_kmajor_rejects_what_it_does_not_take(dev):
    """The K-major entry raises without the weights' K-major copies and on
    a non-contiguous copy, instead of taking another path."""
    x = torch.randn(1, 8, 64, device=dev)
    w1q = torch.zeros(64, 128, dtype=torch.int8, device=dev)
    w2q = torch.zeros(128, 64, dtype=torch.int8, device=dev)
    args = (x, w1q, torch.ones(128, device=dev), torch.zeros(128, device=dev),
            w2q, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="K-major copies"):
        fused_ffn(*args, w1t=w1q.t().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fused_ffn(*args, w1t=w1q.t().contiguous(), w2t=w2q.t())


@pytest.mark.gpu
def test_vit_encode_takes_the_kmajor_ffn(dev):
    """A 4a-shaped encode (opto-vit-base-224 widths, 2 layers, 4 frames at
    the largest bucket) through the quantize-once cache launches B3 once a
    layer, every launch on the K-major entry."""
    cfg = serving_cfg("base", 224).with_(n_layers=2)
    params = to_device(prepare_params(from_jax_params(init_vit(0, cfg, 10),
                                                      "cpu")), dev)
    toks = torch.randn(4, 196, cfg.d_model,
                       generator=torch.Generator().manual_seed(0)).to(dev)
    before = {k: _build.LAUNCHES[k] for k in
              ("fused_ffn", "fused_ffn.kmajor", "fused_ffn.nmajor")}
    logits, _ = forward_vit_tokens(params, toks, cfg)
    assert bool(torch.isfinite(logits).all())
    got = {k: _build.LAUNCHES[k] - v for k, v in before.items()}
    assert got == {"fused_ffn": 2, "fused_ffn.kmajor": 2,
                   "fused_ffn.nmajor": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(5, 37, 1003), (37, 196, 13), (1, 9, 7),
                                   (788, 768, 3072), (788, 64, 1024),
                                   (33, 120, 40), (17, 128, 4096)])
def test_int_accumulate_any_shape(dev, m, k, n):
    """``torch._int_mm`` takes K and N multiples of 8 only, and below K =
    128 with N > 16 only M a multiple of 32: the padded accumulate is
    bitwise equal to the plain version at ragged shapes and there."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    got = int_accumulate(xq, wq)
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, ref.int_accumulate_ref(xq, wq))


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
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 6, 8, 16])
@pytest.mark.parametrize("length", [1, 7, 8, 9, 63, 64, 65, 159, 160, 511,
                                    512])
def test_flash_decode_cluster_boundaries(dev, length, g, d):
    """The cluster split at its edges: lengths below, at and above the
    split and lane-group sizes (splits with no row among them), G rows
    below, at and above one 8-row pass; bf16 and f32. Two calls on the
    same inputs are bitwise equal (the merge runs in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(length * 100 + g + d)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(2, 1, 2 * g, d, generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn(2, 512, 2, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(2))
        got = flash_decode(q, kc, vc, length)
        _assert_held(got, ref.flash_decode_ref(q, kc, vc, length))
        assert torch.equal(flash_decode(q, kc, vc, length), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ranges,length", [
    (2, 1), (2, 128), (2, 129), (2, 256), (2, 160),   # 4k's rank shape
    (4, 1), (4, 64), (4, 65), (4, 200), (4, 256)])
def test_flash_decode_partial_kernel(dev, ranges, length, dtype):
    """B6's partial entry over each of ``ranges`` row ranges of a 256-row
    cache (qwen2-1.5b's H 12, Hkv 2, D 128, batch 2: 4k's per-rank rows
    at 2 ranges), against ``flash_decode_partial_ref``: o and lse f32,
    rtol = atol = 2e-5; a range with no valid row o = 0 and lse = NEG_INF
    exactly; each call bitwise from call to call and counted once; the
    ranges merged against ``flash_decode_ref`` on the whole cache within
    B6's tolerance."""
    gen = torch.Generator(device=dev).manual_seed(ranges * 1000 + length)
    q = torch.randn(2, 1, 12, 128, generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn(2, 256, 2, 128, generator=gen, device=dev)
              .to(dtype) for _ in range(2))
    rows = 256 // ranges
    os_, lses = [], []
    for r in range(ranges):
        kr, vr = kc[:, r * rows:(r + 1) * rows], vc[:, r * rows:(r + 1) * rows]
        before = _build.LAUNCHES["flash_decode_partial"]
        o, lse = flash_decode_partial(q, kr, vr, r * rows, length)
        assert _build.LAUNCHES["flash_decode_partial"] == before + 1
        assert o.dtype == lse.dtype == torch.float32
        want_o, want_lse = ref.flash_decode_partial_ref(q, kr, vr, r * rows,
                                                        length)
        if r * rows >= length:
            assert torch.equal(o, torch.zeros_like(o))
            assert bool((lse == ref.NEG_INF).all())
        torch.testing.assert_close(o, want_o, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
        again = flash_decode_partial(q, kr, vr, r * rows, length)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
        os_.append(o)
        lses.append(lse)
    merged = merge_partials(torch.stack(os_), torch.stack(lses)).to(dtype)
    _assert_held(merged, ref.flash_decode_ref(q, kc, vc, length))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 16, 17, 25, 32])
def test_flash_decode_partial_ring_block(dev, length, dtype):
    """B6's partial entry at D 256 / G 16 (recurrentgemma-9b's 16 query
    heads, gathered over "model", on its one KV head) over each half of a
    32-slot ring split along "kv_seq", a layer's view of the stacked
    rings, at ring lengths min(pos + 1, 32): only rank 0's slots valid (1,
    16), one of rank 1's (17), the ring full (32); against
    ``flash_decode_partial_ref``: o and lse within 2e-5, an empty range o
    = 0 and lse = NEG_INF exactly, each call bitwise from call to call and
    counted once; the halves merged against ``flash_decode_ref`` over the
    whole ring within B6's tolerance."""
    gen = torch.Generator(device=dev).manual_seed(length * 7 + 5)
    q = torch.randn(2, 1, 16, 256, generator=gen, device=dev).to(dtype)
    stacked = [torch.randn(2, 2, 2, 16, 1, 256, generator=gen,
                           device=dev).to(dtype) for _ in range(2)]
    os_, lses = [], []
    for r in range(2):
        kr, vr = stacked[0][r, 1], stacked[1][r, 1]
        before = _build.LAUNCHES["flash_decode_partial"]
        o, lse = flash_decode_partial(q, kr, vr, 16 * r, length)
        assert _build.LAUNCHES["flash_decode_partial"] == before + 1
        want_o, want_lse = ref.flash_decode_partial_ref(q, kr, vr, 16 * r,
                                                        length)
        if 16 * r >= length:
            assert torch.equal(o, torch.zeros_like(o))
            assert bool((lse == ref.NEG_INF).all())
        torch.testing.assert_close(o, want_o, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
        again = flash_decode_partial(q, kr, vr, 16 * r, length)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
        os_.append(o)
        lses.append(lse)
    merged = merge_partials(torch.stack(os_), torch.stack(lses)).to(dtype)
    whole = [torch.cat([t[0, 1], t[1, 1]], 1) for t in stacked]
    _assert_held(merged, ref.flash_decode_ref(q, whole[0], whole[1], length))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [0, 8, 64])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 256])
def test_flash_attention_tensor_core_boundaries(dev, s, window, d):
    """The bf16 tensor-core kernel at the 64-key tile's and the 64-row
    query tile's edges, causal, with windows, G = 1; two calls bitwise
    equal."""
    gen = torch.Generator(device=dev).manual_seed(s * 10 + window + d)
    q, k, v = (torch.randn(2, 2, s, d, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=window)
    _assert_held(got, ref.flash_attention_ref(q, k, v, causal=True,
                                              window=window))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)


def _excess_over_rounding(got, want):
    """Largest (|got - want| - half a bf16 ulp of got) / (1 + |want|): the
    error left in a bf16 ``got`` once its own rounding is taken off."""
    g, w = got.float(), want.float()
    exp = torch.frexp(g).exponent               # |g| in [2^(e-1), 2^e)
    half_ulp = torch.where(g == 0, 0.0,
                           torch.ldexp(torch.ones_like(g), exp - 9))
    return ((g - w).abs() - half_ulp).div(1 + w.abs()).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("window,d", [(0, 128), (8, 128), (0, 64)])
def test_flash_attention_bf16_follows_its_emulation(dev, window, d):
    """The bf16 tensor-core kernel against ``flash_attention_tc_ref`` (its
    numerics in f32: 64-key tiles, the scale after the product, P as bf16
    hi + lo) at the prefill shape q (4, 12, 128, D), KV 2 heads, in the
    path's (B, S, H, D) layout. Once o's own rounding to bf16 is taken off,
    the kernel is within the f32 limit 2e-5 (1 + |o|) of it. P rounded
    once to bf16, without its lo part, is not: the limit tells the two
    apart, as the same check of that variant shows."""
    gen = torch.Generator(device=dev).manual_seed(window + d)
    q, k, v = (torch.randn(4, 128, hh, d, generator=gen, device=dev)
               .bfloat16().transpose(1, 2) for hh in (12, 2, 2))
    got = flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                      causal=True, window=window)
    assert _excess_over_rounding(got, want) <= 2e-5
    # P in bf16 alone: o = bf16(exp(s - m)) V / l
    qf, kf, vf = (ref.expand_kv_heads(t, 12).float() for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) / d ** 0.5
    vis = torch.ones(128, 128, dtype=torch.bool, device=dev).tril()
    if window:
        vis &= ~torch.ones_like(vis).tril(-window)
    p = torch.exp(s - s.masked_fill(~vis, -1e30).amax(-1, keepdim=True))
    p = p.masked_fill(~vis, 0.0)
    hi_only = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    assert _excess_over_rounding(hi_only.bfloat16(), want) > 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("length", [7, 160, 512])
def test_flash_decode_follows_its_split_emulation(dev, length):
    """B6 against ``flash_decode_split_ref(splits=8)``, the split of the
    cache rows over the cluster's 8 blocks and their merge in rank order,
    at the decode shape q (4, 1, 12, 128), cache (4, 512, 2, 128); length
    7 leaves a block with no row. f32 within 4e-6 (1 + |o|); bf16 within
    that once o's own rounding to bf16 is taken off."""
    gen = torch.Generator(device=dev).manual_seed(length)
    q = torch.randn(4, 1, 12, 128, generator=gen, device=dev)
    kc, vc = (torch.randn(4, 512, 2, 128, generator=gen, device=dev)
              for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dtype) for t in (q, kc, vc))
        got = flash_decode(qd, kd, vd, length)
        want = ref.flash_decode_split_ref(qd.float(), kd.float(), vd.float(),
                                          length, 8)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=4e-6, atol=4e-6)
        else:
            assert _excess_over_rounding(got, want) <= 4e-6


@pytest.mark.gpu
def test_flash_attention_bf16_rejects_what_the_kernel_does_not_take(dev):
    """A bf16 head dim outside the instantiated set, and a view whose row
    stride is not 16-byte aligned, raise instead of taking another path."""
    q = torch.randn(1, 2, 8, 96, device=dev).bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    base = torch.randn(1, 2, 8, 132, device=dev).bfloat16()
    view = base[..., 2:130]                   # D 128, row stride 132
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(view, view, view)
    before = _build.LAUNCHES["flash_attention_causal"]
    flash_attention(view.contiguous(), view.contiguous(), view.contiguous())
    assert _build.LAUNCHES["flash_attention_causal"] == before + 1


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
@pytest.mark.parametrize("b,h,hkv,s,window,layout", [
    (1, 16, 1, 4096, 2048, "bshd"),     # recurrentgemma-9b's prefill
    (1, 16, 1, 1024, 256, "bhsd"),
    (2, 16, 1, 1, 2048, "bhsd"),        # ragged
    (2, 16, 1, 63, 2048, "bhsd"),
    (2, 16, 1, 65, 2048, "bhsd"),
    (2, 16, 1, 129, 2048, "bshd"),
    (1, 2, 2, 200, 8, "bhsd"),          # window 8, G = 1
    (1, 2, 2, 64, 0, "bhsd"),           # tile edges, no window
    (1, 2, 2, 127, 0, "bhsd"),
    (1, 2, 2, 256, 64, "bhsd"),
])
def test_flash_attention_head_dim_256(dev, b, h, hkv, s, window, layout):
    """B5's bf16 tensor-core entry at head dim 256 (Q re-read from shared
    memory each k-step) against its plain version, 1 bf16 ulp of the
    largest |o|, causal with and without a window, in both layouts; one
    launch a call and two calls bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(s + window + h)
    if layout == "bshd":
        q, k, v = (torch.randn(b, s, hh, 256, generator=gen, device=dev)
                   .bfloat16().transpose(1, 2) for hh in (h, hkv, hkv))
    else:
        q, k, v = (torch.randn(b, hh, s, 256, generator=gen, device=dev)
                   .bfloat16() for hh in (h, hkv, hkv))
    before = _build.LAUNCHES["flash_attention_causal"]
    got = flash_attention(q, k, v, causal=True, window=window)
    assert _build.LAUNCHES["flash_attention_causal"] == before + 1
    _assert_held(got, ref.flash_attention_ref(q, k, v, causal=True,
                                              window=window))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_head_dim_256_follows_its_emulation(dev, window):
    """At D 256 the kernel keeps the other head dims' numerics: within the
    f32 limit 2e-5 (1 + |o|) of ``flash_attention_tc_ref`` once o's own
    rounding is taken off, q (1, 16, 320, 256) on one KV head."""
    gen = torch.Generator(device=dev).manual_seed(256 + window)
    q, k, v = (torch.randn(1, hh, 320, 256, generator=gen, device=dev)
               .bfloat16() for hh in (16, 1, 1))
    got = flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                      causal=True, window=window)
    assert _excess_over_rounding(got, want) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 128, 160, 512])
def test_flash_decode_head_dim_256_on_the_ring(dev, length):
    """B6 at D 256 / G 16 (recurrentgemma-9b's decode): on a layer's view
    of a stacked 512-slot ring over its first min(pos + 1, W) slots
    against the reference's ring decode (``ring_decode_ref``), and on the
    strided view of a linear cache's last ``length`` rows against the
    plain version on those rows; 1 bf16 ulp, each bitwise from call to
    call."""
    gen = torch.Generator(device=dev).manual_seed(length + 256)
    q = torch.randn(4, 1, 16, 256, generator=gen, device=dev).bfloat16()
    ring, vring = (torch.randn(3, 4, 512, 1, 256, generator=gen,
                               device=dev).bfloat16()[2] for _ in range(2))
    pos = length - 1 if length < 512 else 900
    before = _build.LAUNCHES["flash_decode"]
    got = ring_decode_attention(q, ring, vring, pos)
    assert _build.LAUNCHES["flash_decode"] == before + 1
    _assert_held(got, ref.ring_decode_ref(q, ring, vring, pos))
    assert torch.equal(ring_decode_attention(q, ring, vring, pos), got)
    kc, vc = (torch.randn(4, 1024, 1, 256, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    n = length + 300
    got = decode_attention(q, kc, vc, n, window=length)
    _assert_held(got, ref.flash_decode_ref(q, kc[:, n - length:n],
                                           vc[:, n - length:n], length))
    assert torch.equal(decode_attention(q, kc, vc, n, window=length), got)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s,window,layout,dtype", [
    (4, 32, 8, 128, 0, "bshd", torch.bfloat16),   # stablelm-12b's prefill
    (4, 32, 8, 128, 0, "bhsd", torch.float32),
    (2, 8, 2, 200, 64, "bhsd", torch.bfloat16),   # a window
    (1, 8, 2, 129, 8, "bshd", torch.bfloat16),
] + [(1, 2 * g, 2, s, 0, "bhsd", torch.bfloat16)  # tile edges, G 1 and 4
     for s in (63, 64, 65, 127, 129) for g in (1, 4)])
def test_flash_attention_head_dim_160(dev, b, h, hkv, s, window, layout,
                                      dtype):
    """B5's bf16 tensor-core entry at head dim 160 (20 16-byte chunks a
    row, the last 4 swizzled within their own group) against its plain
    version: 1 bf16 ulp of the largest |o| (f32: 2e-5), causal, with and
    without a window, in both layouts; at the 64-key / 64-row tile edges,
    where a row overwritten through the swizzle would show; one launch a
    call and two calls bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(s * 10 + window + h)
    if layout == "bshd":
        q, k, v = (torch.randn(b, s, hh, 160, generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for hh in (h, hkv, hkv))
    else:
        q, k, v = (torch.randn(b, hh, s, 160, generator=gen, device=dev)
                   .to(dtype) for hh in (h, hkv, hkv))
    before = _build.LAUNCHES["flash_attention_causal"]
    got = flash_attention(q, k, v, causal=True, window=window)
    assert _build.LAUNCHES["flash_attention_causal"] == before + 1
    _assert_held(got, ref.flash_attention_ref(q, k, v, causal=True,
                                              window=window))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_head_dim_160_follows_its_emulation(dev, window):
    """At D 160 the kernel keeps the other head dims' numerics: within the
    f32 limit 2e-5 (1 + |o|) of ``flash_attention_tc_ref`` once o's own
    rounding is taken off, q (2, 8, 200, 160) on 2 KV heads."""
    gen = torch.Generator(device=dev).manual_seed(160 + window)
    q, k, v = (torch.randn(2, hh, 200, 160, generator=gen, device=dev)
               .bfloat16() for hh in (8, 2, 2))
    got = flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                      causal=True, window=window)
    assert _excess_over_rounding(got, want) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 7, 8, 9, 65, 159, 160, 511, 512])
def test_flash_decode_head_dim_160(dev, length):
    """B6 at stablelm-12b's decode, D 160 / G 4 (20 16-byte vectors a
    row on 32 lanes), q (4, 1, 32, 160) over a (4, 512, 8, 160) cache, at
    lengths around its cluster split: bf16 within 1 bf16 ulp of the
    plain version, f32 within 2e-5, each bitwise from call to call."""
    gen = torch.Generator(device=dev).manual_seed(length + 160)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(4, 1, 32, 160, generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn(4, 512, 8, 160, generator=gen, device=dev)
                  .to(dtype) for _ in range(2))
        got = flash_decode(q, kc, vc, length)
        _assert_held(got, ref.flash_decode_ref(q, kc, vc, length))
        assert torch.equal(flash_decode(q, kc, vc, length), got)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,d,h", [("stablelm-12b", 640, 4),
                                      ("qwen2.5-3b", 1024, 8),
                                      ("llama3-405b", 2048, 16)])
def test_dense_configs_card_match_cpu(dev, arch, d, h):
    """The dense family's other configs at narrow widths that keep their
    head dim and group (2 layers, one KV head): the decode-loop prefill
    of an 8-token prompt on the card (B6 every layer) and ``prefill_fn``
    (B5; at head dim 160 for stablelm-12b) against the CPU's plain
    versions, correlation > 0.999."""
    cfg = smoke_variant(get_config(arch)).with_(n_layers=2, d_model=d,
                                                n_heads=h, kv_heads=1)
    cpu = init_lm(0, cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    cl, _ = prefill_into_cache(cpu, init_cache(cfg, 2, 16, "cpu"), prompt,
                               cfg)
    before = dict(_build.LAUNCHES)
    gp = to_device(cpu, dev)
    gl, _ = prefill_into_cache(gp, init_cache(cfg, 2, 16, dev),
                               prompt.to(dev), cfg)
    full = model_api.prefill_fn(gp, {"tokens": prompt.to(dev)}, cfg)[:, -1]
    assert _build.LAUNCHES["flash_decode"] == before.get(
        "flash_decode", 0) + 8 * cfg.n_layers
    assert _build.LAUNCHES["flash_attention_causal"] == before.get(
        "flash_attention_causal", 0) + cfg.n_layers
    b = cl.double().flatten()
    for got in (gl, full):
        a = got.double().cpu().flatten()
        assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999


@pytest.mark.gpu
def test_hybrid_decode_and_prefill_card_match_cpu(dev):
    """recurrentgemma-9b at smoke width (5 layers, window 16): the
    decode-loop prefill of a 20-token prompt on a 12-slot ring (which
    wraps; B6 on the ring every attention layer) on the card against the
    CPU's plain versions, and prefill_fn (B5 under the window) against
    the same; launch counts, corr > 0.999."""
    cfg = smoke_variant(get_config("recurrentgemma-9b")).with_(n_layers=5)
    cpu = init_lm(0, cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    cl, _ = prefill_into_cache(cpu, init_cache(cfg, 2, 12, "cpu"), prompt,
                               cfg)
    before = dict(_build.LAUNCHES)
    gl, _ = prefill_into_cache(to_device(cpu, dev),
                               init_cache(cfg, 2, 12, dev), prompt.to(dev),
                               cfg)
    assert _build.LAUNCHES["flash_decode"] == before.get("flash_decode",
                                                         0) + 20
    a, b = gl.double().cpu().flatten(), cl.double().flatten()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999
    full = model_api.prefill_fn(to_device(cpu, dev),
                                {"tokens": prompt.to(dev)}, cfg)
    cpu_full = model_api.prefill_fn(cpu, {"tokens": prompt}, cfg)
    assert _build.LAUNCHES["flash_attention_causal"] == before.get(
        "flash_attention_causal", 0) + 1
    a, b = full.double().cpu().flatten(), cpu_full.double().flatten()
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


def _flush_tokens(server, k_gather: int, n: int = 4):
    """(n, k_gather, d) tokens of a real chunk, gathered as the server
    gathers them."""
    frames = video_fleet(1, img_size=server.cfg.img_size,
                         patch=server.cfg.patch)[0].frames_at(0, 8)["frames"]
    toks = embed_patches(server.params, torch.from_numpy(frames).to(
        server.device), server.cfg, server.policy)
    order = torch.argsort(torch.from_numpy(server._score_fn(frames)).to(
        server.device), dim=-1, descending=True, stable=True)
    return _gather_topk_rows(toks, order, k_gather)[:n].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("one_shape", [False, True])
def test_graph_replay_is_the_eager_encode(dev, one_shape):
    """opto-vit-base-224: ``StreamServer(...)`` on the card captures one
    graph per ladder bucket; each replay gives the eager encode's logits
    bitwise and counts the eager call's launches."""
    cfg = serving_cfg("base", 224)
    server = StreamServer(cfg, ServerConfig(one_shape=one_shape),
                          params=from_jax_params(init_vit(0, cfg, 10), dev))
    assert sorted(server.graphs) == list(server.ladder.sizes)
    for k in server.ladder.sizes:
        t = _flush_tokens(server, server.ladder.cap if one_shape else k)
        _build.LAUNCHES.clear()
        eager = forward_vit_tokens(server.params, t, cfg, server.policy,
                                   kv_len=k if one_shape else None)[0]
        eager_counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        graphed = server.graphs[k].replay(t).clone()
        assert dict(_build.LAUNCHES) == eager_counts
        assert eager_counts["fused_ffn"] == cfg.n_layers
        assert torch.equal(graphed, eager), k


@pytest.mark.gpu
def test_graphed_interleaved_serve_matches_solo_eager_runs(dev):
    """Two streams served interleaved through the graphs equal, per stream
    and per flush, two solo ``ServingEngine`` runs (eager), bitwise."""
    cfg = smoke_cfg()
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    sc = ServerConfig(microbatch=4, chunk=8)
    fleet = video_fleet(2, img_size=32, patch=8, cut_every=16)

    def logged(server):
        out, finish = {}, server._finish

        def wrap(fb, by_sid):
            finish(fb, by_sid)
            out[tuple(fb.frame_idx)] = server.last_logits
        server._finish = wrap
        return out

    server = StreamServer(cfg, sc, params=params)
    assert sorted(server.graphs) == list(server.ladder.sizes)
    got = logged(server)
    sessions = [server.add_session(st, n_frames=32, start=4 * i)
                for i, st in enumerate(fleet)]
    res = server.serve()
    eng = ServingEngine(cfg, ServingConfig(microbatch=4, chunk=8),
                        params=params)
    assert eng.server.graphs == {}
    want = logged(eng.server)
    for i, (s, st) in enumerate(zip(sessions, fleet)):
        solo = eng.run(st, n_frames=32, start=4 * i)
        assert res[s.sid].predictions == solo.predictions
        assert res[s.sid].bucket_launches == solo.bucket_launches
        assert res[s.sid].mean_frame_uj == solo.mean_frame_uj
    # stream i is session i on both servers, so the flushes key alike
    assert got.keys() == want.keys()
    for key, logits in want.items():
        assert torch.equal(got[key], logits), key


@pytest.mark.gpu
def test_prefetch_to_device_on_the_card(dev):
    st = video_fleet(1, img_size=32, patch=8, seed=2)[0]
    chunks = [st.frames_at(8 * i, 8) for i in range(7)]
    out = list(prefetch_to_device(iter(chunks), depth=2, device=dev))
    for got, want in zip(out, chunks):
        assert got["frames"].device.type == "cuda"
        assert got["frames_host"] is want["frames"]
        assert torch.equal(got["frames"].cpu(),
                           torch.from_numpy(want["frames"]))


# opto-vit-base-224's mixed-precision plan: 8-bit head and tail, 6-bit
# shoulders, one 4-bit middle layer, mean 7.0 bits (the reference's
# benchmarks/mixed_precision_bench.py::T224_PLAN)
T224_PLAN = (8, 8, 8, 6, 6, 4, 6, 6, 8, 8, 8, 8)


@pytest.mark.gpu
def test_mixed_plan_graph_replay_is_the_eager_encode(dev):
    """opto-vit-base-224 under T224_PLAN: the plan reaches the cache (layer
    5's w1 codes within +-7), every bucket's graph replays the eager
    encode bitwise with the eager launch counts (12 B3 launches, one a
    layer at its widths), and a flush agrees with the same encode on the
    CPU: each layer on the same input within one quant step (corr >
    0.9999), the logits within twice the distance (1 - corr) that one ulp
    of input moves them on either device alone (a 4-bit layer turns
    last-bit differences into code flips: corr ~0.994 for one ulp,
    scripts/bitplan_parity.py)."""
    cfg = serving_cfg("base", 224)
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    server = StreamServer(cfg, ServerConfig(bit_plan=T224_PLAN),
                          params=params)
    assert server.layer_bits == T224_PLAN
    w1 = server.params["blocks"]["ffn"]["w1"]
    assert w1.bits == T224_PLAN
    assert int(w1.wq[5].abs().max()) <= 7 < int(w1.wq[0].abs().max())
    assert sorted(server.graphs) == list(server.ladder.sizes)
    for k in server.ladder.sizes:
        t = _flush_tokens(server, k)
        _build.LAUNCHES.clear()
        eager = forward_vit_tokens(server.params, t, cfg, server.policy)[0]
        eager_counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        graphed = server.graphs[k].replay(t).clone()
        assert dict(_build.LAUNCHES) == eager_counts
        assert eager_counts["fused_ffn"] == cfg.n_layers
        assert torch.equal(graphed, eager), k
    def corr(a, b):
        a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
        return float(torch.corrcoef(torch.stack([a, b]))[0, 1])

    pol, cpu_params = server.policy, to_device(server.params, "cpu")
    cpu = forward_vit_tokens(cpu_params, t.cpu(), cfg, pol, device="cpu")[0]
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    own = min(corr(forward_vit_tokens(server.params, up, cfg, pol)[0],
                   graphed),
              corr(forward_vit_tokens(cpu_params, up.cpu(), cfg, pol,
                                      device="cpu")[0], cpu))
    assert 1 - corr(graphed, cpu) <= 2 * (1 - own)
    x = torch.cat([cpu_params["cls"].expand(4, 1, -1)
                   + cpu_params["pos"][:, :1], t.cpu()], dim=1)
    for i in range(cfg.n_layers):
        want = encoder_layer_step(x, layer_view(cpu_params["blocks"], i),
                                  cfg, pol)
        got = encoder_layer_step(x.to(dev), layer_view(
            server.params["blocks"], i), cfg, pol)
        assert corr(got, want) > 0.9999, i
        x = want


@pytest.mark.gpu
def test_calibrate_bits_recaptures_every_warmed_bucket(dev):
    """``calibrate_bits`` after the warm start: every warmed bucket gets a
    new graph over the new cache, whose replay is the eager encode
    bitwise, while each graph captured before the calibration still
    replays the old cache (so the check above can fail)."""
    cfg = smoke_cfg()
    server = StreamServer(cfg, ServerConfig(microbatch=4, chunk=8),
                          params=from_jax_params(init_vit(0, cfg, 10),
                                                 "cpu"))
    old = dict(server.graphs)
    assert sorted(old) == list(server.ladder.sizes)
    tokens = {k: _flush_tokens(server, k) for k in old}
    server.add_session(video_fleet(1, img_size=32, patch=8)[0], n_frames=8)
    plan = server.calibrate_bits(6.0)
    assert sum(plan) / len(plan) <= 6.0 and server.layer_bits == plan
    assert sorted(server.graphs) == sorted(server.warmed) == sorted(old)
    stale = 0
    for k, t in tokens.items():
        assert server.graphs[k] is not old[k]
        assert server.graphs[k].params is server.params
        eager = forward_vit_tokens(server.params, t, cfg, server.policy)[0]
        assert torch.equal(server.graphs[k].replay(t), eager), k
        stale += not torch.equal(old[k].replay(t), eager)
    assert stale == len(old)
    (res,) = server.serve().values()
    assert len(res.predictions) == 8
    assert res.mean_bits == sum(plan) / len(plan)


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,mode", [(760, 12, "ones"), (760, 12, "mask"),
                                      (1000, 16, "mask")])
def test_flash_attention_simt_at_eq2_head_dims(dev, d, h, mode):
    """Eq. 2's attention core at head dims beside ViT-Base's 768 and
    ViT-Large's 1024 that stay on the SIMT entry (D not a multiple of the
    wide entry's chunk): q (4, H, 197, D) against one shared key head
    (4, 1, 197, D), v (4, H, 197, 64), scale 1.0 (folded upstream), 2e-5
    of the plain version, rows with no live key exactly 0."""
    assert masked_entry_for(d, 64) == "simt"
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn(4, h, 197, d, generator=g, device=dev) * d ** -0.5
    k = torch.randn(4, 1, 197, d, generator=g, device=dev)
    v = torch.randn(4, h, 197, 64, generator=g, device=dev)
    kw = {"scale": 1.0}
    if mode == "mask":
        m = (torch.rand(4, 197, generator=g, device=dev) > 0.5).float()
        m[-1] = 0.0
        kw["key_mask"] = m
    before = _build.LAUNCHES["flash_attention_masked.simt"]
    got = flash_attention_masked(q, k, v, **kw)
    assert _build.LAUNCHES["flash_attention_masked.simt"] == before + 1
    torch.testing.assert_close(got, ref.flash_attention_masked_ref(q, k, v,
                                                                   **kw),
                               rtol=2e-5, atol=2e-5)
    if mode == "mask":
        assert bool((got[-1] == 0).all())


def _eq2_operands(dev, b, h, s, d, mode, seed):
    """Eq. 2's operands as ``mhsa_decomposed`` hands them over: q (B, H, s,
    D) at unit-scale scores, the one key head a view of x (B, s, D), v the
    (B, s, H * 64) projection split into heads (a strided view), and the
    mask keyword of ``mode``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=g, device=dev) * d ** -0.5
    x = torch.randn(b, s, d, generator=g, device=dev)
    v = torch.randn(b, s, h * 64, generator=g, device=dev).reshape(
        b, s, h, 64).transpose(1, 2)
    kw = {"scale": 1.0}
    if mode in ("mask", "dead"):
        m = (torch.rand(b, s, generator=g, device=dev) > 0.5).float()
        if mode == "dead":
            m[-1] = 0.0
        kw["key_mask"] = m
    elif mode == "kv_len":
        kw["kv_len"] = s // 2 + 1
    return q, x[:, None], v, kw


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ones", "mask", "dead", "kv_len"])
@pytest.mark.parametrize("s", [1, 37, 197])
@pytest.mark.parametrize("d,h", [(768, 12), (1024, 16)])
def test_flash_attention_wide_at_eq2_head_dims(dev, d, h, s, mode):
    """The wide tensor-core entry at Eq. 2's ViT-Base (768, 64), H 12, and
    ViT-Large (1024, 64), H 16, one shared key head, v a strided view:
    2e-5 of the plain version, a dead batch row exactly 0, one launch on
    the wide entry and none on the others; the output is a (B, H, Sq, Dv)
    view of a (B, Sq, H, Dv) tensor."""
    assert masked_entry_for(d, 64) == "wide"
    q, k, v, kw = _eq2_operands(dev, 4, h, s, d, mode, seed=d + s)
    assert v.stride(2) == h * 64          # the projection's row stride
    before = dict(_build.LAUNCHES)
    got = flash_attention_masked(q, k, v, **kw)
    for key in ("flash_attention_masked", "flash_attention_masked.wide"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1
    for key in ("flash_attention_masked.tc", "flash_attention_masked.simt"):
        assert _build.LAUNCHES[key] == before.get(key, 0)
    assert got.shape == (4, h, s, 64)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        got, ref.flash_attention_masked_ref(q, k, v, **kw), rtol=2e-5,
        atol=2e-5)
    if mode == "dead":
        assert bool((got[-1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ones", "mask", "dead", "kv_len"])
@pytest.mark.parametrize("d,s", [(192, 1), (192, 33), (192, 50),
                                 (768, 37), (96, 65)])
def test_flash_attention_wide_follows_its_emulation(dev, d, s, mode):
    """The wide entry against its 3xTF32 emulation in its D-chunk order
    (``flash_attention_masked_tc_ref(d_chunk=WIDE_D_CHUNK)``, on the CPU)
    and the plain version, rtol = atol = 2e-5 each; three query heads
    (a partial group of the block's heads) on one key head."""
    from repro_torch.kernels.flash_attention import WIDE_D_CHUNK
    q, k, v, kw = _eq2_operands(dev, 2, 3, s, d, mode, seed=7 * d + s)
    got = flash_attention_masked(q, k, v, **kw)
    cpu = {n: (t.cpu() if torch.is_tensor(t) else t) for n, t in kw.items()}
    emu = ref.flash_attention_masked_tc_ref(q.cpu(), k.cpu(), v.cpu(),
                                            d_chunk=WIDE_D_CHUNK, **cpu)
    torch.testing.assert_close(got.cpu(), emu, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        got, ref.flash_attention_masked_ref(q, k, v, **kw), rtol=2e-5,
        atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_wide_gqa_and_default_scale(dev):
    """The wide entry with several key and value heads (H 8, Hk 2, Hv 4)
    and the default scale 1/sqrt(D), q, k, v in the (B, S, H, D) layout
    read by strides: 2e-5 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(2, 99, hh, dd, generator=g, device=dev)
               .transpose(1, 2) for hh, dd in ((8, 256), (2, 256), (4, 64)))
    m = (torch.rand(2, 99, generator=g, device=dev) > 0.3).float()
    got = flash_attention_masked(q, k, v, m)
    torch.testing.assert_close(got, ref.flash_attention_masked_ref(q, k, v, m),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_simt_raises_above_the_shared_memory_bound(dev):
    """A head dim whose SIMT block would not fit the card's opt-in shared
    memory raises; it never falls back to the plain version. (2047, 48)
    stays on the SIMT entry (Dv != 64), whose tiles hold whole rows."""
    from repro_torch.kernels.flash_attention import (simt_smem_bytes,
                                                     simt_smem_limit)
    limit = simt_smem_limit(torch.cuda.current_device())
    assert masked_entry_for(2047, 48) == "simt"
    assert simt_smem_bytes(760, 64) == 160768 <= limit
    assert simt_smem_bytes(2047, 48) > limit
    q = torch.zeros(1, 1, 4, 2047, device=dev)
    v = torch.zeros(1, 1, 4, 48, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_masked(q, q, v)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(788, 768, 3072), (788, 3072, 768),
                                   (788, 64, 768)])
def test_photonic_matmul_at_composed_shapes(dev, m, k, n):
    """B1 at the composed FFN's w1 and w2 and at Eq. 2's per-head
    W_K^T / sqrt(dh) (K 64 -> N 768), all on the K-major entry."""
    assert entry_for(k) == "kmajor"
    _check_photonic_matmul(dev, m, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(788, 768, 768), (37, 70, 9)])
def test_int_accumulate_pallas_is_bitwise(dev, m, k, n):
    """B1 with unit scales gives the exact int32 accumulate."""
    g = torch.Generator(device=dev).manual_seed(m * k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    before = _build.LAUNCHES["photonic_matmul"]
    got = int_accumulate_pallas(xq, wq)
    assert _build.LAUNCHES["photonic_matmul"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.int_accumulate_ref(xq, wq))


def _base_tokens(cfg, params, k=49):
    """4 frames of a real stream embedded (CPU) and cut to k tokens."""
    frames = torch.from_numpy(VideoStream(img_size=224, patch=16).frames_at(
        0, 4)["frames"])
    return embed_patches(params, frames, cfg, None)[:, :k].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("backend,attn,impl", [
    ("photonic_pallas", "", "standard"), ("photonic_pallas", "flash",
                                          "decomposed"),
    ("bf16", "", "standard"), ("qat", "", "standard"),
    ("photonic_sim", "", "standard")])
def test_composed_base_encode_card_matches_cpu(dev, backend, attn, impl):
    """opto-vit-base-224 on the composed dispatch (the reference CLI's
    default, Eq. 2, and the bf16 / qat / photonic_sim encoders): the card
    against the CPU, corr > 0.999 and equal argmax."""
    cfg = serving_cfg("base", 224).with_(matmul_backend=backend,
                                         attn_backend=attn, ffn_backend="",
                                         attn_impl=impl)
    raw = from_jax_params(init_vit(0, cfg, 10), "cpu")
    cpu = prepare_params(raw) if backend.startswith("photonic") else raw
    toks = _base_tokens(cfg, cpu)
    gl = encode_tokens(to_device(cpu, dev), toks.to(dev), cfg)
    cl = encode_tokens(cpu, toks, cfg, device="cpu")
    a, b = gl.double().cpu().flatten(), cl.double().flatten()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999
    assert torch.equal(gl.cpu().argmax(-1), cl.argmax(-1))


@pytest.mark.gpu
def test_decomposed_graph_replay_is_the_eager_encode(dev):
    """Eq. 2 on photonic_pallas + flash + xla FFN, base-224: each bucket's
    replay is its eager encode bitwise, at 205 B1 (Q, V, wo, w1, w2 and
    twelve per-head W_K^T products a layer, and the head) and 12 B2
    launches a flush, every B2 launch on the wide tensor-core entry and
    none on the SIMT one."""
    cfg = serving_cfg("base", 224).with_(ffn_backend="",
                                         attn_impl="decomposed")
    server = StreamServer(cfg, ServerConfig(),
                          params=from_jax_params(init_vit(0, cfg, 10), dev))
    assert sorted(server.graphs) == list(server.ladder.sizes)
    for k in server.ladder.sizes:
        t = _flush_tokens(server, k)
        _build.LAUNCHES.clear()
        eager = forward_vit_tokens(server.params, t, cfg, server.policy)[0]
        counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        graphed = server.graphs[k].replay(t).clone()
        assert dict(_build.LAUNCHES) == counts
        assert counts["photonic_matmul"] == 17 * cfg.n_layers + 1
        assert counts["flash_attention_masked.wide"] == cfg.n_layers
        assert counts["flash_attention_masked"] == cfg.n_layers
        assert "flash_attention_masked.simt" not in counts
        assert "fused_ffn" not in counts
        assert torch.equal(graphed, eager), k


NOISE_SPEC = noise.NoiseSpec(drift_rate_nm=0.01, wander_sigma_nm=0.01,
                             recal_bound_nm=0.08)


# each branch of the multiplier: wander and FPV on; the default spec (the
# one the CLI and a no-drift serve run), wander off; FPV off
NOISE_CHECK_SPECS = {
    "wander-fpv": NOISE_SPEC, "default": noise.NoiseSpec(),
    "no-fpv": noise.NoiseSpec(drift_rate_nm=0.01, wander_sigma_nm=0.01,
                              recal_bound_nm=0.08, fpv_sigma=0.0)}


def _noise_call(dev, spec=NOISE_SPEC, salts=(3,), counter=2, frame=5,
                drift=0.037):
    """A NoiseCall under ``spec`` on a state tensor written on ``dev``."""
    state = noise.DriftState(noise.threefry.prng_key(3), frame, drift)
    with noise.noise_scope(state, state.to_tensor(dev)) as sc:
        sc.salts = tuple(salts)
        sc.counter = counter
        return noise.next_call_keys(spec)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", list(NOISE_CHECK_SPECS))
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768),
                                 (197, 50)])
def test_noise_draw_kernel(dev, k, n, spec):
    """The three entries against their plain versions on the same state
    tensor, on the card, at the noisy flush's weight shapes and a ragged
    one, under each branch of the multiplier; each launch counted."""
    spec = NOISE_CHECK_SPECS[spec]
    call = _noise_call(dev, spec)
    state = call.state_tensor(dev)
    for fold in (0, noise._WANDER_FOLD):
        before = _build.LAUNCHES["noise_draw.bits"]
        got = noise_draw.draw_bits(state, call.salts, call.counter, fold,
                                   (k, n))
        assert _build.LAUNCHES["noise_draw.bits"] == before + 1
        assert torch.equal(got, ref.draw_bits_ref(
            state, call.salts, call.counter, fold, (k, n)))
    ones = torch.ones(k, n, device=dev)
    mult = noise_draw.transmission_codes(ones, call, spec)
    want = ref.transmission_codes_ref(ones, state, call.salts, call.counter,
                                      call.fpv_key, spec.mr(),
                                      spec.fpv_sigma, spec.wander_sigma_nm)
    assert float((mult - want).abs().max()) <= 1e-6
    gen = torch.Generator(device=dev).manual_seed(k + n)
    wq, _ = _qweight(gen, k, n, 8, dev)
    before = _build.LAUNCHES["noise_draw.codes"]
    codes = noise_draw.transmission_codes(wq, call, spec)
    assert _build.LAUNCHES["noise_draw.codes"] == before + 1
    assert torch.equal(codes, wq.float() * mult)   # one product, bitwise
    y = torch.randn(k, n, generator=gen, device=dev)
    want = ref.readout_shot_ref(y, state, call.salts, call.counter,
                                spec.shot_sigma)
    # in place, as the noisy matmul's readout
    yy = y.clone()
    before = _build.LAUNCHES["noise_draw.shot"]
    assert noise_draw.readout_shot(yy, call, spec.shot_sigma) is yy
    assert _build.LAUNCHES["noise_draw.shot"] == before + 1
    assert float((yy - want).abs().max()) <= 1e-6 * float(y.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2 * 768, 3 * 768 + 5, 2 ** 32 + 3])
def test_noise_readout_shot_at_an_offset(dev, offset):
    """The shot entry at a flat-index offset (a rank's rows of a readout
    split along its batch): a block of rows drawn at its offset is bitwise
    those rows of the whole readout's draw, and within the entry's 1e-6
    relative class of its plain version at the same offset; at offset 0
    the block draws other noise."""
    spec = NOISE_SPEC
    call = _noise_call(dev, spec)
    state = call.state_tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(offset % 997)
    y = torch.randn(8, 768, generator=gen, device=dev)
    block = y[2:4].clone()
    before = _build.LAUNCHES["noise_draw.shot"]
    got = noise_draw.readout_shot(block.clone(), call, spec.shot_sigma,
                                  offset)
    assert _build.LAUNCHES["noise_draw.shot"] == before + 1
    want = ref.readout_shot_ref(block, state, call.salts, call.counter,
                                spec.shot_sigma, offset)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        block.abs().max())
    if offset == 2 * 768:
        whole = noise_draw.readout_shot(y.clone(), call, spec.shot_sigma)
        assert torch.equal(got, whole[2:4])
    if offset:
        assert not torch.equal(got, noise_draw.readout_shot(
            block.clone(), call, spec.shot_sigma))


@pytest.mark.gpu
def test_noise_readout_shot_rows_are_the_whole_draws_rows(dev):
    """Each of 4 row blocks of a (4 x 197, 768) readout drawn at its
    offset: bitwise its rows of the one-launch draw (the data-split
    encode's readouts)."""
    spec = NOISE_SPEC
    call = _noise_call(dev, spec)
    y = torch.randn(4 * 197, 768, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    whole = noise_draw.readout_shot(y.clone(), call, spec.shot_sigma)
    for j in range(4):
        rows = slice(j * 197, (j + 1) * 197)
        part = noise_draw.readout_shot(y[rows].clone(), call,
                                       spec.shot_sigma, j * 197 * 768)
        assert torch.equal(part, whole[rows])


def _noisy_server(dev):
    cfg = serving_cfg("base", 224).with_(matmul_backend="photonic_sim",
                                         ffn_backend="xla", noise=NOISE_SPEC)
    return cfg, StreamServer(cfg, ServerConfig(),
                             params=from_jax_params(init_vit(0, cfg, 10),
                                                    dev))


def _noisy_tokens(server, k):
    frames = video_fleet(1, img_size=224, patch=16)[0].frames_at(
        0, 4)["frames"]
    toks = embed_patches(server.params,
                         torch.from_numpy(frames).to(server.device),
                         server.cfg, server.policy.without_noise())
    return toks[:, :k].contiguous()


def _eager_at(server, t):
    server._write_state()
    with server._scope():
        return forward_vit_tokens(server.params, t, server.cfg,
                                  server.policy)[0]


@pytest.mark.gpu
def test_noisy_graph_replay_is_the_eager_encode(dev):
    """opto-vit-base-224 under noise on photonic_sim + flash + xla FFN:
    each bucket's graph, captured over the server's state tensor, replays
    the eager encode of the DriftState written last bitwise, at 146
    noise-draw launches (a codes and a shot draw for each of the 73
    matmuls) and 12 tensor-core B2 launches a flush, no B1 and no B3; a
    replay at the next frame differs; after ``recalibrate`` (the drift
    reset, the live cache kept) replays still equal the eager encode."""
    cfg, server = _noisy_server(dev)
    assert sorted(server.graphs) == list(server.ladder.sizes)
    state = noise.DriftState(noise.threefry.prng_key(0), 7, 0.03)
    for k in server.ladder.sizes:
        t = _noisy_tokens(server, k)
        server.drift = state
        _build.LAUNCHES.clear()
        eager = _eager_at(server, t)
        counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        server._write_state()
        graphed = server.graphs[k].replay(t).clone()
        assert dict(_build.LAUNCHES) == counts
        assert counts["noise_draw"] == 2 * (6 * cfg.n_layers + 1)
        assert counts["flash_attention_masked.tc"] == cfg.n_layers
        assert "photonic_matmul" not in counts and "fused_ffn" not in counts
        assert torch.equal(graphed, eager), k
        server.drift = state.advance(NOISE_SPEC, 4)
        server._write_state()
        assert not torch.equal(server.graphs[k].replay(t), eager), k
    server.recalibrate()
    assert server.recalibrations == 1 and server.drift.drift_nm == 0
    for k in server.ladder.sizes:
        t = _noisy_tokens(server, k)
        eager = _eager_at(server, t)
        server._write_state()
        assert torch.equal(server.graphs[k].replay(t), eager), k


# -- the serving control plane (A12) ------------------------------------------

def _control_server(dev, **knobs):
    cfg = smoke_cfg()
    server = StreamServer(cfg, ServerConfig(microbatch=4, chunk=8, **knobs),
                          params=from_jax_params(init_vit(0, cfg, 10),
                                                 "cpu"))
    sessions = [server.add_session(st, n_frames=32, start=16 * i)
                for i, st in enumerate(video_fleet(2, img_size=32,
                                                   patch=8))]
    return server, sessions


@pytest.mark.gpu
def test_autotune_graphs_replay_eager_and_every_flush_is_timed(dev):
    """``autotune_prepare`` captures a graph for each bucket it prices (and
    none before): each replays the eager encode bitwise with the same
    launch counts. Every timed flush lands in the telemetry, in flush
    order, and each hit bucket reports a positive measured flush time."""
    server, sessions = _control_server(dev, autotune=True, retune_every=8)
    assert not server.graphs and not server.warmed
    ctl = server.autotune_prepare()
    priced = sorted(server.cost_model.costs)
    assert priced and sorted(server.graphs) == sorted(server.warmed) == priced
    for k in priced:
        t = _flush_tokens(server, k)
        _build.LAUNCHES.clear()
        eager = forward_vit_tokens(server.params, t, server.cfg,
                                   server.policy)[0]
        eager_n = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        graphed = server.graphs[k].replay(t).clone()
        assert dict(_build.LAUNCHES) == eager_n
        assert torch.equal(graphed, eager), k
    res = server.serve()
    assert server.serve_cfg.telemetry_window >= len(server.flush_log)
    assert len(server.telemetry) == len(server.flush_log)
    assert [(o.bucket, o.n_real) for o in server.telemetry] == [
        (k, n) for _, k, n in server.flush_log]
    for s in sessions:
        r = res[s.sid]
        assert len(r.predictions) == 32
        hit = {k for k, n in r.bucket_launches.items() if n}
        assert set(r.flush_wall_ms) == hit
        assert all(v > 0 for v in r.flush_wall_ms.values())
    assert ctl.clamp_violations == 0 and ctl.calibrated


@pytest.mark.gpu
def test_untimed_server_records_no_flush_time(dev):
    """A warm-started server without the control plane or the watchdog
    (path 4a's) keeps no telemetry and reports no measured flush time."""
    server, sessions = _control_server(dev)
    res = server.serve()
    assert server.controller is None and server.cost_model is None
    assert server.telemetry is None and server.straggler_flags == []
    for s in sessions:
        assert res[s.sid].flush_wall_ms == {}
        assert len(res[s.sid].predictions) == 32


@pytest.mark.gpu
def test_watchdog_flags_a_delayed_flush(dev):
    """A ``watchdog=True`` server whose 13th flush the test delays by 50 ms
    (after its encode, inside the timed span) flags that flush; its
    predictions are the untimed server's."""
    server, sessions = _control_server(dev, watchdog=True)
    encode, seen = server._encode, [0]

    def delayed(k, tokens):
        logits = encode(k, tokens)
        if seen[0] == 12:
            torch.cuda.synchronize(dev)
            time.sleep(0.05)
        seen[0] += 1
        return logits

    server._encode = delayed
    res = server.serve()
    assert 12 in [o.seq for o in server.straggler_flags]
    assert len(server.telemetry) == len(server.flush_log)
    plain, psessions = _control_server(dev)
    pres = plain.serve()
    for s, p in zip(sessions, psessions):
        assert res[s.sid].predictions == pres[p.sid].predictions


@pytest.mark.gpu
def test_capture_survives_a_dead_cycle_holding_a_graph(dev):
    """A dropped server whose graphs only a reference cycle still holds is
    never collected inside a capture: the capture below runs a full
    collection wherever the interpreter may collect automatically (the
    garbage collector enabled), which would destroy the old graphs
    mid-capture and invalidate it."""
    cfg = smoke_cfg()
    params = from_jax_params(init_vit(0, cfg, 10), "cpu")
    old = StreamServer(cfg, ServerConfig(microbatch=4, chunk=8),
                       params=params)
    assert old.graphs
    old.cycle = old
    del old
    new = StreamServer(cfg, ServerConfig(microbatch=4, chunk=8,
                                         warm_start=False), params=params)
    eager = new._encode_eager

    def collecting(k, tokens):
        if torch.cuda.is_current_stream_capturing() and gc.isenabled():
            gc.collect()
        return eager(k, tokens)

    new._encode_eager = collecting
    new.warm_start()
    del new._encode_eager
    assert sorted(new.graphs) == list(new.ladder.sizes)
    t = _flush_tokens(new, new.ladder.sizes[0])
    assert torch.equal(new.graphs[new.ladder.sizes[0]].replay(t),
                       forward_vit_tokens(new.params, t, cfg,
                                          new.policy)[0])


# -- faults, checkpoints and migration (A13) ----------------------------------

def _fault_server(dev, cfg=None, **knobs):
    cfg = cfg or smoke_cfg()
    return StreamServer(cfg, ServerConfig(microbatch=4, chunk=8, **knobs),
                        params=from_jax_params(init_vit(0, cfg, 10), "cpu"))


def _fault_traffic(server, n_frames=32):
    return [server.add_session(st, n_frames=n_frames, start=16 * i)
            for i, st in enumerate(video_fleet(2, img_size=32, patch=8))]


def _replays_are_eager(server):
    for k in server.ladder.sizes:
        t = _flush_tokens(server, k)
        eager = server._encode_eager(k, t)
        assert torch.equal(server.graphs[k].replay(t), eager), k


@pytest.mark.gpu
def test_checkpoint_and_migration_on_a_graphed_server(dev, tmp_path):
    """On the graphed smoke server: pause at round 2 (queued rows in the
    snapshot), checkpoint, restore into a fresh graphed server (its own
    graphs, each replaying its eager encode bitwise): the remaining
    predictions are the uninterrupted serve's; ``export_session`` /
    ``adopt_session`` (queued rows included) between two graphed servers
    likewise."""
    base = _fault_server(dev)
    sessions = _fault_traffic(base)
    res = base.serve()
    want = [res[s.sid].predictions for s in sessions]
    srv = _fault_server(dev)
    _fault_traffic(srv)
    assert srv.serve(max_rounds=2) == {}
    meta = load_meta(srv.checkpoint(root=str(tmp_path)))
    assert any(m["pending"] for m in meta["extra"]["sessions"])
    fresh = _fault_server(dev)
    assert sorted(fresh.graphs) == list(fresh.ladder.sizes)
    fresh.restore_checkpoint(str(tmp_path))
    got = fresh.serve()
    assert [got[0].predictions, got[1].predictions] == want
    _replays_are_eager(fresh)
    srv_b = _fault_server(dev)
    snap = srv.export_session(1)
    assert snap["meta"]["pending"]           # queued rows migrate too
    srv_b.adopt_session(snap)
    res_b, res_a = srv_b.serve(), srv.serve()
    assert res_a[0].predictions == want[0] and 1 not in res_a
    assert res_b[1].predictions == want[1]


@pytest.mark.gpu
@pytest.mark.parametrize("plant", [False, True], ids=["restore", "planted"])
def test_restored_noisy_server_writes_its_state_first(dev, tmp_path, plant):
    """A noisy graphed server restored from a checkpoint holds the
    snapshot's DriftState in its state tensor at its first replay, and
    serves the rest bitwise; the planted fault (a restore that leaves
    ``_written`` claiming the state is written) replays a stale state."""
    cfg = smoke_cfg().with_(matmul_backend="photonic_sim",
                            ffn_backend="xla", noise=NOISE_SPEC)
    base = _fault_server(dev, cfg)
    sessions = _fault_traffic(base, 24)
    res = base.serve()
    want = [res[s.sid].predictions for s in sessions]
    srv = _fault_server(dev, cfg)
    _fault_traffic(srv, 24)
    assert srv.serve(max_rounds=1) == {}
    srv.checkpoint(root=str(tmp_path))
    fresh = _fault_server(dev, cfg)
    fresh.restore_checkpoint(str(tmp_path))
    assert fresh.drift == srv.drift
    if plant:
        fresh._written = fresh.drift.words()
    seen = []
    for g in fresh.graphs.values():
        def checked(tokens, mask=None, g=g, replay=g.replay):
            seen.append(np.array_equal(fresh._state_t.cpu().numpy(),
                                       fresh.drift.words()))
            return replay(tokens, mask)
        g.replay = checked
    got = fresh.serve()
    assert seen and seen[0] is (not plant)
    if not plant:
        assert all(seen)
        assert [got[0].predictions, got[1].predictions] == want


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["python", "cuda"])
def test_a_failed_capture_leaves_the_server_able_to_serve(dev, how):
    """An exception inside a capture (a Python error, or a CUDA call a
    capture does not allow) fails the serve as a ``ServeError`` and leaves
    the device out of capture mode on its default stream; the same server
    then captures and serves the next sessions as a fresh one does."""
    from repro_torch.serving.faults import ServeError

    want_srv = _fault_server(dev)
    ws = _fault_traffic(want_srv)
    wres = want_srv.serve()
    want = [wres[s.sid].predictions for s in ws]
    server = _fault_server(dev)
    server.graphs, server.warmed = {}, set()
    eager = server._encode_eager

    def broken(k, tokens):
        if torch.cuda.is_current_stream_capturing():
            if how == "python":
                raise RuntimeError("planted failure inside the capture")
            torch.cuda.synchronize()
        return eager(k, tokens)

    server._encode_eager = broken
    _fault_traffic(server)
    with pytest.raises(ServeError, match="capturing"):
        server.serve()
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    assert server._sessions == [] and server._inflight is None
    del server._encode_eager
    sessions = _fault_traffic(server)
    res = server.serve()
    assert [res[s.sid].predictions for s in sessions] == want
    assert server.graphs and set(server.graphs) == server.warmed
    for k in server.graphs:
        t = _flush_tokens(server, k)
        assert torch.equal(server.graphs[k].replay(t),
                           server._encode_eager(k, t)), k


# --------------------------------------------------------------------------
# the 1-D data mesh and the fleet router
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_scope(dev, tmp_path):
    """A gloo group of this one process and, inside the yielded callable's
    context, an absmax scope over it: the wrappers take their split paths
    (B3's host-split binding), and the MAX over one rank is the identity."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import (DATA_RULES, absmax_scope,
                                                  use_sharding)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": 1})

    class Scope:
        def __enter__(self):
            self._ctx = use_sharding(mesh, DATA_RULES)
            self._ctx.__enter__()
            self._scope = absmax_scope(dist.group.WORLD)
            self._scope.__enter__()

        def __exit__(self, *exc):
            self._scope.__exit__(*exc)
            self._ctx.__exit__(*exc)

    try:
        yield Scope
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,live,bits", [
    ((4, 197, 768), None, (8, 8)), ((4, 197, 768), 150, (8, 8)),
    ((3, 37, 768), None, (8, 6)), ((1, 1, 768), None, (8, 8))],
    ids=["base", "live", "ragged-M", "M=1"])
def test_fused_ffn_host_split_is_the_single_call(dev, one_rank_scope, shape,
                                                 live, bits):
    """B3's host-split binding (phase 0; the hidden absmax through the
    scope's MAX; requant + phase 1) against the single host call on the
    same operands: bitwise, at base-224's widths (d_ff 3072)."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    d, dff = shape[-1], 3072
    w1q, s1 = _qweight(g, d, dff, bits[0], dev)
    w2q, s2 = _qweight(g, dff, d, bits[1], dev)
    args = (torch.randn(shape, generator=g, device=dev), w1q, s1,
            torch.randn(dff, generator=g, device=dev) * 0.1, w2q, s2,
            torch.randn(d, generator=g, device=dev) * 0.1)
    kw = dict(bits=bits, live_rows=live, w1t=w1q.t().contiguous(),
              w2t=w2q.t().contiguous())
    single = fused_ffn(*args, **kw)
    before = dict(_build.LAUNCHES)
    with one_rank_scope():
        split = fused_ffn(*args, **kw)
    for key in ("fused_ffn", "fused_ffn.kmajor", "fused_ffn.kmajor.split"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1, key
    assert torch.equal(split, single)


@pytest.mark.gpu
def test_fused_ffn_nmajor_under_a_scope_is_the_single_call(dev,
                                                           one_rank_scope):
    """The N-major first design under an absmax scope (its hidden absmax
    reduced between its two launches): bitwise the call outside one, at
    widths the K-major entry does not take."""
    g = torch.Generator(device=dev).manual_seed(7)
    d, dff = 200, 300
    w1q, s1 = _qweight(g, d, dff, 8, dev)
    w2q, s2 = _qweight(g, dff, d, 8, dev)
    args = (torch.randn(2, 37, d, generator=g, device=dev), w1q, s1,
            torch.randn(dff, generator=g, device=dev) * 0.1, w2q, s2,
            torch.randn(d, generator=g, device=dev) * 0.1)
    single = fused_ffn_nmajor(*args)
    with one_rank_scope():
        split = fused_ffn_nmajor(*args)
    assert torch.equal(split, single)


@pytest.mark.gpu
def test_data_mesh_serve_is_bitwise_the_unsharded_card_serve(dev):
    """2 gloo ranks sharing the card on the 1-D data mesh (mesh "auto", no
    model shards): every flush's logits bitwise the unsharded eager serve
    of the same traffic on the card; every B3 launch through the
    host-split binding; no graphs."""
    cfg = smoke_cfg()
    raw = init_vit(0, cfg, 10)
    ranks = spawn_ranks(_torch_ranks.serve_data_mesh, 2, raw, 2, 16, 8,
                        "cuda", device="cuda", timeout_s=300)
    srv = StreamServer(cfg, ServerConfig(microbatch=4, chunk=8,
                                         warm_start=False),
                       params=from_jax_params(raw, "cpu"))
    want = _torch_ranks.serve_streams(srv, 2, 16, 8)
    for r in ranks:
        assert r["axis_names"] == ("data",) and r["graphs"] == 0
        assert r["predictions"] == want["predictions"]
        assert r["logits"].keys() == want["logits"].keys()
        for key, logits in want["logits"].items():
            np.testing.assert_array_equal(r["logits"][key], logits)
        n = len(want["flush_log"])
        assert r["calls"] == {"split": n, "whole": 0}
        b3 = r["launches"].get("fused_ffn", 0)
        assert b3 == n * cfg.n_layers
        assert r["launches"].get("fused_ffn.kmajor.split", 0) == b3


def _fleet_sc(**kw):
    return ServerConfig.from_serving(
        ServingConfig(microbatch=4, chunk=8, force_bucket=0.5), **kw)


@pytest.mark.gpu
def test_graphed_fleet_jobs_are_bitwise_their_solo_serves(dev):
    """Two in-process graphed workers on one shared cache (each with its
    own graphs over it): every job's predictions and flush logits bitwise
    the same stream served alone on a graphed server over that cache."""
    import warnings

    from repro_torch.serving.fleet import FleetRouter

    cfg = smoke_cfg()
    router = FleetRouter(cfg, _fleet_sc(), workers=2, price_per_frame=1.0)
    w0, w1 = router.workers
    assert w0.graphs and sorted(w0.graphs) == sorted(w1.graphs)
    assert w0.graphs[8].params is w0.params
    assert (w1.params["blocks"]["ffn"]["w1"].wq.data_ptr()
            == w0.params["blocks"]["ffn"]["w1"].wq.data_ptr())
    streams = video_fleet(3, img_size=32, patch=8)
    frames = [16, 48, 32]
    jobs = [router.add_job(st, n_frames=nf, start=8 * i)
            for i, (st, nf) in enumerate(zip(streams, frames))]
    logs = [_torch_ranks.log_flushes(w) for w in router.workers]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = router.serve()
    solo = StreamServer(cfg, _fleet_sc(), params=w0.params)
    for i, (j, st) in enumerate(zip(jobs, streams)):
        log = _torch_ranks.log_flushes(solo)
        s = solo.add_session(st, n_frames=j.n_frames, start=j.start)
        got = solo.serve()
        del solo._finish
        assert res[j.job_id].predictions == got[s.sid].predictions
        mine = {tuple(f for _, f in k): v
                for k, v in logs[j.worker].items() if k[0][0] == j.sid}
        alone = {tuple(f for _, f in k): v for k, v in log.items()}
        assert mine.keys() == alone.keys()
        for k, v in alone.items():
            np.testing.assert_array_equal(mine[k], v)


@pytest.mark.gpu
def test_spawned_fleet_workers_build_no_kernel(dev):
    """Two spawned workers on the one card: each serves its jobs through
    its own graphs and loads the library the parent built."""
    from repro_torch.serving.fleet import FleetRouter

    router = FleetRouter(smoke_cfg(), _fleet_sc(), workers=2, spawn=True)
    for i, st in enumerate(video_fleet(4, img_size=32, patch=8)):
        router.add_job(st, n_frames=16, start=8 * i)
    res = router.serve()
    assert sorted(res) == [0, 1, 2, 3]
    assert all(r.frames == 16 for r in res.values())
    for i in (0, 1):
        info = router.last_worker_info[i]
        assert info["device"].startswith("cuda") and info["built"] == []
        assert info["graphs"] and info["launches"].get("fused_ffn", 0) > 0


# --------------------------------------------------------------------------
# ViT training
# --------------------------------------------------------------------------

def _train_cfg():
    return smoke_variant(get_config("opto-vit-tiny")).with_(
        n_layers=2, mgnet=True, mgnet_keep_ratio=0.5, mgnet_embed=32,
        mgnet_heads=2, lr_warmup=4, lr_total=200)


def _train_state(cfg, device):
    from repro_torch.launch.train import init_state
    return init_state(cfg, 0, device)


def _grad_distance(ga, gb):
    """(global relative L2 of ga against gb, min corr over gb's moving
    leaves); a leaf gb leaves at 0 must be 0 in ga too."""
    from repro_torch.optim.adamw import tree_leaves
    num = den = 0.0
    worst = 1.0
    for a, h in zip(tree_leaves(ga), tree_leaves(gb)):
        a, h = a.double().cpu().flatten(), h.double().cpu().flatten()
        num += float(((a - h) ** 2).sum())
        den += float((h ** 2).sum())
        if float(h.norm()) > 0:
            worst = min(worst, float(torch.corrcoef(torch.stack([a, h]))[0, 1]))
        else:
            assert not a.any()
    return (num / den) ** 0.5, worst


@pytest.mark.gpu
def test_train_step_on_the_card_against_the_cpu(dev):
    """One step's loss and gradients at equal state and batch: the loss
    within 1%, the gradients within 0.25 relative L2 and each leaf corr >
    0.95 (chip_smoke.py 4i (C)'s bounds: the gate's top-k routing and the
    fake quant's rounding are discontinuous, so rounding differences move
    whole leaves); MGNet's leaves get no gradient on either device. With
    MGNet's pruning off, the tight check: relative L2 < 1e-5, the loss
    within 1e-6. The step then runs on the card."""
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.launch.steps import make_grad_fn, make_train_fn
    cfg = _train_cfg()
    state = _train_state(cfg, "cpu")
    b = {k: v for k, v in ImageStream(32, 8, n_classes=8, patch=8,
                                      seed=0, device="cpu").batch_at(0).items()
         if k in ("images", "labels")}
    grads_of = make_grad_fn(cfg)
    lh, gh = grads_of(state["params"], b)
    lc, gc_ = grads_of(to_device(state["params"], dev),
                       {k: v.to(dev) for k, v in b.items()})
    rel, corr = _grad_distance(gc_, gh)
    msg = (f"card vs CPU: rel L2 {rel:.3e}, min corr {corr:.6f}, loss "
           f"{float(lc):.6f} vs {float(lh):.6f}")
    assert abs(float(lc) - float(lh)) <= 1e-2 * abs(float(lh)), msg
    assert rel < 0.25 and corr > 0.95, msg
    # the tight check, MGNet's pruning off: no fake-quant code flips, so
    # the GEMMs' summation order is the whole difference (measured
    # 7.7e-7, scripts/qat_grad_gap.py)
    off = cfg.with_(mgnet=False)
    p_off = _train_state(off, "cpu")["params"]
    lh, gh = make_grad_fn(off)(p_off, b)
    lc, gc_ = make_grad_fn(off)(to_device(p_off, dev),
                                {k: v.to(dev) for k, v in b.items()})
    rel, corr = _grad_distance(gc_, gh)
    assert rel < 1e-5, rel
    assert abs(float(lc) - float(lh)) <= 1e-6 * abs(float(lh))
    new, m = make_train_fn(cfg)(to_device(state, dev),
                                {k: v.to(dev) for k, v in b.items()})
    assert torch.isfinite(m["loss"]) and int(new["step"]) == 1


@pytest.mark.gpu
def test_train_resume_is_bitwise_under_deterministic_algorithms(dev,
                                                                tmp_path):
    """A straight 6-step run, one resumed from its step-3 checkpoint and
    one resumed after a fault injected at step 4: equal losses and final
    state, bit for bit, under ``torch.use_deterministic_algorithms``."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = _train_cfg()
    shape = ShapeConfig("t", 0, 8, "train")
    state0 = _train_state(cfg, dev)
    clone = lambda st: tree_map(torch.clone, st)  # noqa: E731
    torch.use_deterministic_algorithms(True)
    try:
        final, losses, _ = train_loop(cfg, shape, 6, device=dev,
                                      state=clone(state0))
        _, first, _ = train_loop(cfg, shape, 3, device=dev,
                                 state=clone(state0),
                                 ckpt=CheckpointManager(str(tmp_path / "a"),
                                                        every=3))
        with pytest.raises(RuntimeError, match="injected fault"):
            train_loop(cfg, shape, 6, device=dev, state=clone(state0),
                       ckpt=CheckpointManager(str(tmp_path / "b"), every=3),
                       inject_fault_at=4)
        for root, want in (("a", first), ("b", losses[:3])):
            st, rest, _ = train_loop(cfg, shape, 6, device=dev,
                                     state=clone(state0),
                                     ckpt=CheckpointManager(
                                         str(tmp_path / root), every=100))
            assert want + rest == losses
            for x, y in zip(tree_leaves(st), tree_leaves(final)):
                assert torch.equal(x, y)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.gpu
@pytest.mark.parametrize("backends", [("photonic_pallas", "xla", "xla"),
                                      ("qat", "flash", "xla"),
                                      ("photonic_pallas", "flash", "fused")])
def test_training_policy_on_a_kernel_raises_on_the_card(dev, backends):
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.launch.steps import make_train_fn
    mm, at, ff = backends
    cfg = _train_cfg().with_(matmul_backend=mm, attn_backend=at,
                             ffn_backend=ff)
    state = _train_state(cfg, dev)
    b = {k: v for k, v in ImageStream(32, 4, n_classes=8, patch=8,
                                      seed=0, device=dev).batch_at(0).items()
         if k in ("images", "labels")}
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="which has no backward"):
        make_train_fn(cfg)(state, b)
    # raised before any kernel of the named entry launched a backward
    assert _build.LAUNCHES.get("fused_ffn", 0) == before.get("fused_ffn", 0)


# --------------------------------------------------------------------------
# the tensor-parallel LM (chip_smoke.py 4j)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kv", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lm_kernels_at_tensor_parallel_rank_shapes(dev, kv, dtype):
    """B5 and B6 at a qwen2-1.5b rank's shapes on make_host_mesh(1, 2):
    6 query heads reading one KV head, a view of the whole 2-head K / V
    and cache, against their plain versions (bf16: 1 ulp of max |o|;
    f32: 2e-5)."""
    gen = torch.Generator(device=dev).manual_seed(kv)
    q = torch.randn(4, 128, 6, 128, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(4, 128, 2, 128, generator=gen, device=dev)
            .to(dtype)[:, :, kv:kv + 1] for _ in range(2))
    got = blockwise_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)
    qd = torch.randn(4, 1, 6, 128, generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn(4, 512, 2, 128, generator=gen, device=dev)
              .to(dtype)[:, :, kv:kv + 1] for _ in range(2))
    got6 = flash_decode(qd, kc, vc, 160)
    want6 = ref.flash_decode_ref(qd, kc, vc, 160)
    for g, w in ((got, want), (got6, want6)):
        err = (g.float() - w.float()).abs().max().item()
        if dtype == torch.bfloat16:
            tol = 2.0 ** (np.floor(np.log2(w.float().abs().max().item())) - 7)
        else:
            tol = 2e-5 * (1 + w.abs().max().item())
        assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_tensor_parallel_prefill_on_two_ranks_of_the_card(dev):
    """qwen2-1.5b at full width cut to 2 layers on make_host_mesh(1, 2), 2
    gloo ranks on the card: each rank's logits corr > 0.999 with equal
    argmax against the unsharded card prefill, the ranks equal, B5 once a
    layer on each rank."""
    cfg = get_config("qwen2-1.5b").with_(n_layers=2)
    params = init_lm(0, cfg, "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    ranks = spawn_ranks(_torch_ranks.lm_tp_prefill, 2, params, cfg, prompt,
                        "cuda", device="cuda", timeout_s=600)
    with torch.no_grad():
        want = model_api.prefill_fn(to_device(params, dev),
                                    {"tokens": prompt.to(dev)}, cfg).float()
    want = want.cpu().numpy()
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])
    for r in ranks:
        got = r["logits"]
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
        assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99
        assert r["launches"].get("flash_attention_causal", 0) == 2


# --------------------------------------------------------------------------
# ViT QAT training on every mesh (path 4l's checks at smoke size)
# --------------------------------------------------------------------------

def _vit_mesh_smoke():
    cfg = smoke_variant(get_config("opto-vit-tiny")).with_(
        n_layers=2, quant_bits=8, mgnet=True, mgnet_keep_ratio=1.0,
        mgnet_embed=32, mgnet_heads=2)
    from repro_torch.data.pipeline import ImageStream
    from repro_torch.launch.train import init_state
    b = ImageStream(32, 8, n_classes=8, patch=8, seed=0).batch_at(0)
    return (cfg, init_state(cfg, 0, "cpu")["params"],
            {k: b[k] for k in ("images", "labels")})


def _global_rel_l2(a, b):
    from repro_torch.optim.adamw import tree_leaves
    num = sum(float(((np.float64(x) - y) ** 2).sum())
              for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float((np.float64(y) ** 2).sum()) for y in tree_leaves(b))
    return (num / den) ** 0.5


@pytest.mark.gpu
def test_vit_mesh_step_under_remat_on_the_card_against_one_device(dev):
    """One QAT step's gradient (MGNet's pruning off) under MODEL_RULES with
    ``cfg.remat`` on 2 gloo ranks sharing the card, against the one-device
    step on the card: within 4x the control (the one-device step with its
    qat products summed in another order) and under 1e-4, the loss within
    1e-6, the ranks' losses equal; the photonic_sim row-parallel entry at
    w2's shape bitwise the unsharded entry. The recompute runs on
    autograd's device thread and must re-enter the context and the
    absmax scope (``sharding.bound``). chip_smoke.py's path 4l holds the
    same step without remat under all four tables."""
    from repro_torch.core import backend
    from repro_torch.launch.steps import make_grad_fn
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from qat_grad_gap import _qat_split

    cfg, params, batch = _vit_mesh_smoke()
    ranks = spawn_ranks(_torch_ranks.vit_mesh_card, 2, params,
                        cfg.with_(remat=True), batch, "cuda",
                        device="cuda", timeout_s=600)
    on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    p = to_device(params, dev)
    loss1, g1 = make_grad_fn(cfg)(p, on)
    saved = backend.BACKENDS["qat"]
    backend.BACKENDS["qat"] = _qat_split
    try:
        _, g_ctl = make_grad_fn(cfg)(p, on)
    finally:
        backend.BACKENDS["qat"] = saved
    g1 = _torch_ranks._np_tree(g1)
    control = _global_rel_l2(_torch_ranks._np_tree(g_ctl), g1)
    rel = _global_rel_l2(ranks[0]["grads"], g1)
    assert rel <= 4 * control and rel < 1e-4, (rel, control)
    assert abs(ranks[0]["loss"] - float(loss1)) <= 1e-6 * abs(float(loss1))
    assert len({r["loss"] for r in ranks}) == 1
    assert all(r["sim_bitwise"] for r in ranks)


# --------------------------------------------------------------------------
# the hybrid LM on the ("data", "model") mesh and in training (path 4n's
# checks at a small width)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pos", [63, 127, 200])
def test_hybrid_kernels_at_tensor_parallel_rank_shapes(dev, pos):
    """B5 and B6 at a recurrentgemma-9b rank's shapes on make_host_mesh(1,
    2), bf16: B5 q (4, 128, 8, 256) on the one KV head under the 2048-key
    window, B6 q (4, 1, 8, 256) over a (4, 128, 1, 256) ring (a layer's
    view of the stacked ring) before it fills, full, and wrapped; each
    against its plain version within 1 bf16 ulp of the largest |o|."""
    gen = torch.Generator(device=dev).manual_seed(pos)
    bf = torch.bfloat16
    q = torch.randn(4, 128, 8, 256, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(4, 128, 1, 256, generator=gen, device=dev).to(bf)
            for _ in range(2))
    got = blockwise_attention(q, k, v, causal=True, window=2048)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   window=2048).transpose(1, 2)
    qd = torch.randn(4, 1, 8, 256, generator=gen, device=dev).to(bf)
    kr, vr = (torch.randn(2, 4, 128, 1, 256, generator=gen,
                          device=dev).to(bf)[1] for _ in range(2))
    got6 = ring_decode_attention(qd, kr, vr, pos)
    want6 = ref.ring_decode_ref(qd, kr, vr, pos)
    assert torch.equal(got6, ring_decode_attention(qd, kr, vr, pos))
    for g, w in ((got, want), (got6, want6)):
        err = (g.float() - w.float()).abs().max().item()
        tol = 2.0 ** (np.floor(np.log2(w.float().abs().max().item())) - 7)
        assert err <= tol, (err, tol)


def _hybrid_card_cfg():
    """recurrentgemma-9b's head dim 256, one KV head and conv, narrowed:
    d 1024 (4 heads), LRU width 1024, d_ff 2048, vocab 1024, 5 layers, a
    64-key window."""
    return get_config("recurrentgemma-9b").with_(
        n_layers=5, d_model=1024, n_heads=4, lru_width=1024, d_ff=2048,
        vocab=1024, window=64)


@pytest.mark.gpu
def test_split_rglru_on_two_ranks_of_the_card_against_its_arithmetic(dev):
    """The hybrid under MODEL_RULES on make_host_mesh(1, 2), 2 gloo ranks on
    the card: the prefill (B5 under the window) and the decode at every
    position of a 64-slot ring that wraps (B6), bitwise the split's
    arithmetic on one card (``_torch_ranks.hybrid_tp_arithmetic``: the
    column and row blocks, each rank's heads, the RG-LRU's gate GEMMs over
    each rank's rows summed in f32 in rank order); both ranks equal."""
    cfg = _hybrid_card_cfg()
    params = init_lm(0, cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (2, 80), generator=gen)
    forced = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    ranks = spawn_ranks(_torch_ranks.hybrid_tp_card, 2, params, cfg, prompt,
                        forced, 64, device="cuda", timeout_s=600)
    p = to_device(params, dev)
    with _torch_ranks.hybrid_tp_arithmetic(p, cfg):
        pre, dec = _torch_ranks._hybrid_serve(p, cfg, prompt.to(dev),
                                              forced.to(dev), 64, 2, dev)
    for r in ranks:
        np.testing.assert_array_equal(r["prefill"], _torch_ranks._np32(pre))
        np.testing.assert_array_equal(r["decode"], _torch_ranks._np32(dec))
        assert r["launches"].get("flash_attention_causal", 0) == 1
        assert r["launches"].get("flash_decode", 0) == 88


@pytest.mark.gpu
def test_hybrid_backward_runs_full_precision_matmuls(dev):
    """The train step sets full-precision matmuls on the card before its
    forward, and the process-wide setting holds on autograd's device
    thread while the backward runs the f32 gate GEMMs' gradients."""
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import rglru

    cfg = smoke_variant(get_config("recurrentgemma-9b"))
    params = init_lm(0, cfg, dev)
    toks = torch.randint(0, cfg.vocab, (2, 32), device=dev)
    seen = []
    real = rglru._gate_preacts

    def hooked(p, uf, split):
        za, zx = real(p, uf, split)
        za.register_hook(lambda g: seen.append(
            torch.backends.cuda.matmul.allow_tf32) or g)
        return za, zx

    torch.backends.cuda.matmul.allow_tf32 = True
    rglru._gate_preacts = hooked
    try:
        make_grad_fn(cfg)(params, {"tokens": toks, "labels": toks})
    finally:
        rglru._gate_preacts = real
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)
