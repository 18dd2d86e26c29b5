"""Parity of the port's serving layer with the JAX reference, and the port's
independence from JAX.

The serving smoke run (1 stream x 16 frames, the reference's
``engine._smoke_cfg("photonic_pallas", "flash", "fused")`` with its own
params bridged into the port) must make the same mask-cache decisions and
bucket routes and agree on at least 90% of the predictions; the host-side
pieces (frames, ladder, micro-batcher, mask cache) match exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.data.pipeline import VideoStream as JVideoStream
from repro.data.pipeline import video_fleet as jfleet
from repro.serving.buckets import BucketLadder as JLadder
from repro.serving.engine import _smoke_cfg
from repro.serving.mask_cache import TemporalMaskCache as JCache
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import StreamServer as JServer
from repro_torch.bridge import from_jax_params
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.serving import server as tserver
from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.mask_cache import TemporalMaskCache
from repro_torch.serving.scheduler import MicroBatcher
from repro_torch.serving.session import ServingConfig

ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def test_video_frames_bit_identical():
    for kw in ({"img_size": 32, "patch": 8, "seed": 3, "cut_every": 16},
               {"img_size": 224, "patch": 16, "seed": 0}):
        j = JVideoStream(**kw).frames_at(27, 6)
        t = VideoStream(**kw).frames_at(27, 6)
        for k in ("frames", "patch_mask", "frame_idx"):
            np.testing.assert_array_equal(j[k], t[k])
    jf, tf = jfleet(3, 32, 8, seed=1), video_fleet(3, 32, 8, seed=1)
    assert [s.seed for s in jf] == [s.seed for s in tf]


def test_ladder_routes_match():
    for n in (16, 196):
        jl = JLadder.from_fractions(n, (0.25, 0.5, 0.75, 1.0))
        tl = BucketLadder.from_fractions(n, (0.25, 0.5, 0.75, 1.0))
        assert jl.sizes == tl.sizes
        budgets = np.arange(0, n + 3)
        np.testing.assert_array_equal(jl.route_many(budgets),
                                      tl.route_many(budgets))
        assert [jl.route(b) for b in budgets] == [tl.route(b) for b in budgets]


def test_mask_cache_decisions_match():
    st = VideoStream(img_size=32, patch=8, cut_every=12)
    jc, tc = JCache(refresh=5, delta_threshold=0.05), TemporalMaskCache(5, 0.05)
    score = lambda f: f.reshape(f.shape[0], -1)[:, :16] * 3.0  # noqa: E731
    for start in range(0, 24, 8):
        ch = st.frames_at(start, 8)
        valid = ch["frame_idx"] < 21
        js, jn = jc.gate(ch["frames"], ch["frame_idx"], score, eligible=valid)
        ts, tn = tc.gate(ch["frames"], ch["frame_idx"], score, eligible=valid)
        assert jn == tn
        np.testing.assert_array_equal(js, ts)
    assert (jc.scored_frames, jc.reused_frames) == (tc.scored_frames,
                                                    tc.reused_frames)


def test_micro_batcher_pads_and_splits():
    mb = MicroBatcher(4)
    assert mb.push_many(("k", 0), torch.ones(3, 2, 5), [0, 1, 2]) == []
    ready = mb.push_many(("k", 0), torch.full((3, 2, 5), 2.0), [3, 4, 5])
    assert len(ready) == 1 and ready[0].n_real == 4
    assert ready[0].frame_idx == [0, 1, 2, 3]
    assert mb.pending == 2
    tail = mb.drain(select=lambda key: key[1] == 0)
    assert len(tail) == 1 and tail[0].n_real == 2
    assert tuple(tail[0].tokens.shape) == (4, 2, 5)
    assert torch.equal(tail[0].tokens[2:], torch.zeros(2, 2, 5))
    assert mb.pending == 0


def test_interleave_rounds():
    assert tserver.interleave_rounds([[1, 2, 3], [4], [], [5, 6]]) == [
        1, 4, 5, 2, 6, 3]


def test_stream_server_matches_reference_smoke_run():
    jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
    jsrv = JServer(jcfg, JServerConfig(microbatch=4, chunk=8, mesh="off",
                                       warm_start=False), n_classes=10, seed=0)
    stream = JVideoStream(img_size=32, patch=8, cut_every=16)
    js = jsrv.add_session(stream, n_frames=16)
    jres = jsrv.serve()[js.sid]

    tsrv = tserver.StreamServer(
        tserver.smoke_cfg(), ServingConfig(microbatch=4, chunk=8),
        params=from_jax_params(_np_tree(jsrv._raw_params), "cpu"),
        device="cpu")
    ts = tsrv.add_session(VideoStream(img_size=32, patch=8, cut_every=16),
                          n_frames=16)
    tres = tsrv.serve()[ts.sid]

    assert (tres.scored_frames, tres.reused_frames) == (jres.scored_frames,
                                                        jres.reused_frames)
    assert tres.bucket_hits == jres.bucket_hits
    assert tres.bucket_launches == jres.bucket_launches
    assert tres.frames == jres.frames == 16
    assert set(tres.predictions) == set(jres.predictions) == set(range(16))
    agree = np.mean([tres.predictions[i] == jres.predictions[i]
                     for i in range(16)])
    assert agree >= 0.9
    assert [(k, n) for _, k, n in tsrv.flush_log] == [
        (k, n) for _, k, n in jsrv.flush_log]


def test_server_cli_smoke_on_cpu(capsys):
    res = tserver.main(["--smoke", "--device", "cpu", "--streams", "2",
                        "--frames", "8", "--phase", "4"])
    assert sorted(len(r.predictions) for r in res.values()) == [8, 8]
    assert "frames/s" in capsys.readouterr().out


def test_server_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.StreamServer(tserver.smoke_cfg())


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch and chip_smoke.py import with ``jax`` and
    ``repro`` made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
