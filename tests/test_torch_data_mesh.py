"""The port's 1-D ("data",) serving mesh on the CPU: the rules tables and
their errors against the reference's (src/repro/distributed/sharding.py),
``make_serving_mesh`` with and without model shards, B3's host-split
plain path, and a 2-rank serve of the fused smoke point against the
port's unsharded serve.

The reference runs in this process; the port's ranks are gloo CPU ranks
started once for the module by ``launch.mesh.spawn_ranks`` (their bodies
are in the JAX-free ``_torch_ranks.py``).

Tolerances, and why:

  * the rules tables and every error text: equal (the same host logic);
  * B3 on half the token rows a rank inside an absmax scope over "data",
    the halves gathered, against the single call on the whole rows:
    bitwise. Both absmax scopes (x's and the hidden state's) are MAX over
    the ranks, max is exact, and every other op is row-local;
  * the data-mesh serve against the port's unsharded serve of the same
    traffic on the same params: predictions, flush log and every flush's
    logits bitwise (the reference's own anchor,
    ``tests/test_multistream.py::test_mesh_sharded_encode_matches_single_device``,
    asserts its meshed serve equals the unmeshed one exactly). The same
    serve with every absmax scope left local to the rank (a planted
    fault) must not be bitwise: the check can see a scope left local.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.distributed import sharding as jsharding
from repro.serving import server as jserver
from repro_torch.bridge import from_jax_params, init_vit
from repro_torch.core import quant
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels.fused_ffn import fused_ffn
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.serving import server as tserver

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ranks  # noqa: E402

SPAWN_TIMEOUT_S = 120.0
N_STREAMS, N_FRAMES, PHASE = 2, 16, 8
# (bits, live_rows) of B3's split cases; x has 4 frames x 17 tokens
FFN_CASES = [(8, None), (8, 9), ((8, 6), None), ((6, 4), 9)]


def _ffn_operands(seed, bits):
    """x (4, 17, 64) and B3's operands at (w1, w2) widths ``bits``."""
    b1, b2 = bits if isinstance(bits, tuple) else (bits, bits)
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((4, 17, 64)).astype(np.float32)]
    for k, n, b in ((64, 128, b1), (128, 64, b2)):
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * np.float32(np.sqrt(2.0 / k)))
        s = quant.absmax_scale(w, bits=b, axis=-2)
        out += [quant.quantize(w, s, bits=b).numpy(), s.reshape(-1).numpy(),
                (rng.standard_normal(n) * 0.1).astype(np.float32)]
    return tuple(out)


@pytest.fixture(scope="module")
def env():
    """The smoke config's raw params (one numpy tree), B3's split cases,
    the port's unsharded serve of the traffic, and one spawn of 2 gloo
    ranks on the data mesh."""
    cfg = tserver.smoke_cfg()
    raw = init_vit(0, cfg, 10)
    cases = [_ffn_operands(i, bits) + (bits, live)
             for i, (bits, live) in enumerate(FFN_CASES)]
    srv = tserver.StreamServer(cfg, tserver.ServerConfig(microbatch=4,
                                                         chunk=8),
                               params=from_jax_params(raw, "cpu"),
                               device="cpu")
    unsharded = _torch_ranks.serve_streams(srv, N_STREAMS, N_FRAMES, PHASE)
    odd = tserver.StreamServer(cfg, tserver.ServerConfig(microbatch=3,
                                                         chunk=8),
                               params=from_jax_params(raw, "cpu"),
                               device="cpu")
    odd_batch = _torch_ranks.serve_streams(odd, N_STREAMS, N_FRAMES, PHASE)
    ranks = spawn_ranks(_torch_ranks.data_mesh_suite, 2, raw, cases,
                        N_STREAMS, N_FRAMES, PHASE, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return SimpleNamespace(raw=raw, cases=cases, unsharded=unsharded,
                           odd_batch=odd_batch, ranks=ranks)


def _mesh(axes, **shape):
    return SimpleNamespace(axis_names=axes, shape=shape)


# --------------------------------------------------------------------------
# rules tables, in this process
# --------------------------------------------------------------------------

def test_rules_tables_equal_the_reference():
    assert tsharding.DATA_RULES == jsharding.DATA_RULES
    assert tsharding.MODEL_RULES == jsharding.MODEL_RULES


@pytest.mark.parametrize("mesh", [
    None, _mesh(("data",), data=2), _mesh(("data",), data=1),
    _mesh(("data", "model"), data=1, model=2),
    _mesh(("data", "model"), data=2, model=2),
    _mesh(("data", "model"), data=2, model=1)],
    ids=["none", "data2", "data1", "dm12", "dm22", "dm21"])
def test_rules_for_mesh_matches_reference(mesh):
    assert tsharding.rules_for_mesh(mesh) == jsharding.rules_for_mesh(mesh)


@pytest.mark.parametrize("mesh,rules", [
    (_mesh(("data",), data=2), {"heads": "model"}),
    (_mesh(("data", "model"), data=2, model=2), {"batch": "data"}),
    (_mesh(("data", "model"), data=1, model=4), {"batch": "data"}),
    (_mesh(("data", "model"), data=2, model=2), {}),
    (_mesh(("data", "model"), data=2, model=2),
     {"batch": ("data", "model")}),
    (_mesh(("data", "model"), data=1, model=1), {}),
], ids=["data-unmapped", "model-unmapped", "model-only", "empty",
        "tuple-rule", "size-one-exempt"])
def test_validate_rules_matches_reference(mesh, rules):
    want = _torch_ranks._raises(lambda: jsharding.validate_rules(mesh, rules))
    got = _torch_ranks._raises(lambda: tsharding.validate_rules(mesh, rules))
    assert got == want
    # use_sharding validates given rules the same way
    def install():
        with tsharding.use_sharding(mesh, rules):
            pass
    assert _torch_ranks._raises(install) == want


def test_rules_for_other_meshes_raise():
    """The reference's "pod" and default training tables wait for the
    LM half of A14: the port names the meshes it serves on instead of
    picking a table no path reads."""
    mesh = _mesh(("pod", "data", "model"), pod=2, data=2, model=2)
    assert jsharding.rules_for_mesh(mesh) is jsharding.MULTIPOD_RULES
    with pytest.raises(ValueError, match="no sharding rules for mesh axes"):
        tsharding.rules_for_mesh(mesh)


def test_absmax_scope_needs_a_context():
    with pytest.raises(RuntimeError, match="installed sharding context"):
        tsharding.absmax_scope(None)
    assert tsharding.absmax_group() is None


class _Stop(Exception):
    pass


def _parsed(monkeypatch, mod, argv):
    """The ServerConfig ``mod.main(argv)`` builds (its server stubbed)."""
    got = {}

    def stub(cfg, sc, *a, **k):
        got["sc"] = sc
        raise _Stop

    monkeypatch.setattr(mod, "StreamServer", stub)
    with pytest.raises(_Stop):
        mod.main(argv)
    return got["sc"]


@pytest.mark.parametrize("argv", [[], ["--mesh", "off"], ["--mesh", "auto"]],
                         ids=["default", "off", "auto"])
def test_mesh_flag_parses_as_the_reference(monkeypatch, argv):
    jsc = _parsed(monkeypatch, jserver, ["--smoke"] + argv)
    tsc = _parsed(monkeypatch, tserver, ["--smoke"] + argv)
    assert tsc.mesh == jsc.mesh
    assert tserver.ServerConfig().mesh == jserver.ServerConfig().mesh


def test_an_unknown_mesh_mode_raises():
    with pytest.raises(ValueError, match="mesh must be 'auto' or 'off'"):
        tserver.StreamServer(tserver.smoke_cfg(),
                             tserver.ServerConfig(mesh="of"), device="cpu")


# --------------------------------------------------------------------------
# the 2-rank data mesh
# --------------------------------------------------------------------------

def test_ranks_import_no_jax(env):
    for r in env.ranks:
        assert "repro_torch" in r["modules"]
        assert "jax" not in r["modules"] and "repro" not in r["modules"]


def test_make_serving_mesh_builds_the_data_mesh(env):
    for rank, r in enumerate(env.ranks):
        one, two = r["mesh"][1], r["mesh"][2]
        assert one["axis_names"] == ("data",)
        assert one["shape"] == {"data": 2}
        assert one["coords"] == (rank, 0) and one["world"] == 2
        assert one["rules"] == jsharding.DATA_RULES
        assert two["axis_names"] == ("data", "model")
        assert two["shape"] == {"data": 1, "model": 2}
        assert two["coords"] == (0, rank)
        assert two["rules"] == jsharding.MODEL_RULES


@pytest.mark.parametrize("case", range(len(FFN_CASES)))
def test_fused_ffn_host_split_plain_is_the_single_call(env, case):
    *ops, bits, live = env.cases[case]
    w1q, w2q = torch.from_numpy(ops[1]), torch.from_numpy(ops[4])
    whole = fused_ffn(*(torch.from_numpy(a) for a in ops), bits=bits,
                      live_rows=live, w1t=w1q.t().contiguous(),
                      w2t=w2q.t().contiguous()).numpy()
    for r in env.ranks:
        np.testing.assert_array_equal(r["ffn"][case], whole)


def test_data_mesh_serve_is_bitwise_unsharded(env):
    want = env.unsharded
    for r in env.ranks:
        served = r["serve"]
        assert served["predictions"] == want["predictions"]
        assert served["flush_log"] == want["flush_log"]
        assert served["logits"].keys() == want["logits"].keys()
        for key, logits in want["logits"].items():
            np.testing.assert_array_equal(served["logits"][key], logits)
        # every flush split over the two ranks (warm start eager, before)
        assert served["calls"] == {"split": len(want["flush_log"]),
                                   "whole": 0}
        assert served["graphs"] == 0
        assert served["rules"] == jsharding.DATA_RULES
    assert all(len(p) == N_FRAMES for p in want["predictions"])


def test_a_batch_the_mesh_does_not_divide_is_encoded_whole(env):
    """Micro-batch 3 over 2 ranks: every rank encodes each whole flush (no
    collective), bitwise the unsharded serve."""
    want = env.odd_batch
    for r in env.ranks:
        served = r["odd_batch"]
        assert served["predictions"] == want["predictions"]
        for key, logits in want["logits"].items():
            np.testing.assert_array_equal(served["logits"][key], logits)
        assert served["calls"] == {"split": 0,
                                   "whole": len(want["flush_log"])}


def test_a_planted_local_absmax_breaks_the_equality(env):
    """Each rank quantizing at its own rows' scale: the same check must
    fail (some flush's logits differ)."""
    want = env.unsharded["logits"]
    for r in env.ranks:
        planted = r["planted"]["logits"]
        assert planted.keys() == want.keys()
        differ = [k for k in want if not np.array_equal(planted[k], want[k])]
        assert differ, "a local absmax scope went unnoticed"


def test_an_ineligible_policy_raises_on_the_data_mesh(env):
    for r in env.ranks:
        assert r["ineligible"] == (
            "mesh='auto' on 2 ranks asks for the data-split encode, which "
            "cannot run: backends ('bf16', 'flash', 'fused') are not the "
            "fused serving triple ('photonic_pallas', 'flash', 'fused')")
