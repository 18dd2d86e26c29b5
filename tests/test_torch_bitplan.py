"""Mixed-precision bit plans in the port against the JAX reference, on the
CPU, at the reference's smoke sizes (tiny, 2 and 4 layers, d=64).

The reference's params are bridged into the port, and the reference runs
as its CPU tests run it (Pallas in interpret mode). Tolerances, and why:

- plan formats, precedence, ``plan_key`` and the errors: identical (pure
  Python on the same inputs).
- ``prepare_params(bit_plan=)`` codes, scales and ``bits``: bitwise
  (absmax, a pre-rounded reciprocal, round-half-even and a clip on equal
  floats); ``wt`` equal to the transposed codes.
- an encode under a per-layer plan: logits corr > 0.999 and top-1 equal
  (PyTorch's and XLA's GELU, LayerNorm and softmax differ by ulps, and a
  requantization can flip a code; ROADMAP "How parity is held"); within
  the port, bitwise against the layers prepared one at a time.
- the calibrator's scores of one layer on the same input: 1e-3 relative
  (float MSEs of that layer's output against its uniform-8 output, each
  side's layer off the other's by the ulps above); its whole table, where
  each side walks its own uniform-8 layer inputs, which drift apart by
  code flips layer after layer: 2.5e-2 relative (1.2% read at smoke
  size); its plan: equal.
- the accounting: the planned reports bitwise the reference's (the same
  float arithmetic in the same order), a stream's totals 1e-12 relative;
  a uniform-8 plan within 1e-12 relative of the unplanned report (it sums
  per layer: the reference's own two differ by the same ulps).

The reference's calibrator runs once (``ref_calibration``): its server's
``calibrate_bits`` on the serving smoke config, with the reference's
``encoder_layer_step`` recorded, so its sensitivity table is read from the
layer outputs it computed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.mixed_precision_bench import T224_PLAN
from repro.configs.base import smoke_variant as jsmoke_variant
from repro.configs.opto_vit import get_config as jget_config
from repro.core import backend as jbackend
from repro.core import bitalloc as jbitalloc
from repro.data.pipeline import video_fleet as jfleet
from repro.models import sharded_encoder as jsharded
from repro.models import vit as jvit
from repro.serving import accounting as jacct
from repro.serving.engine import _smoke_cfg
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import StreamServer as JServer
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import smoke_variant
from repro_torch.configs.opto_vit import get_config
from repro_torch.core import backend as tbackend
from repro_torch.core import bitalloc
from repro_torch.data.pipeline import VideoStream, video_fleet
from repro_torch.models import sharded_encoder as tsharded
from repro_torch.models import vit as tvit
from repro_torch.serving import accounting as tacct
from repro_torch.serving import server as tserver
from repro_torch.serving.buckets import BucketLadder

LAYER_RTOL = 1e-3
TABLE_RTOL = 2.5e-2
PLAN4 = (8, 6, 4, 8)
TARGET = 6.5
FUSED = dict(matmul_backend="photonic_pallas", attn_backend="flash",
             ffn_backend="fused")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, jbackend.QuantizedWeight):
        return (np.asarray(tree.wq), np.asarray(tree.scale), tree.bits)
    return np.asarray(tree)


def _cached(tree, path=()):
    """(path, leaf) of every cached weight of a prepared tree, by path
    (JAX's tree maps sort dict keys)."""
    if isinstance(tree, dict):
        return sorted((c for k, v in tree.items()
                       for c in _cached(v, path + (k,))),
                      key=lambda c: c[0])
    if isinstance(tree, (jbackend.QuantizedWeight,
                         tbackend.QuantizedWeight)):
        return [(path, tree)]
    return []


def _cfgs(n_layers):
    jcfg = jsmoke_variant(jget_config("tiny")).with_(n_layers=n_layers,
                                                     **FUSED)
    tcfg = smoke_variant(get_config("tiny")).with_(n_layers=n_layers,
                                                   **FUSED)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def raw4():
    """4-layer smoke params: the reference's draw and its port bridge."""
    jcfg, tcfg = _cfgs(4)
    raw = jvit.init_vit(jax.random.PRNGKey(1), jcfg, n_classes=10)
    return jcfg, tcfg, raw, from_jax_params(_np_tree(raw), "cpu")


# --------------------------------------------------------------------------
# plan formats (normalize / parse / resolve / key)
# --------------------------------------------------------------------------

_DICT_PLAN = {"layers": [8, 6], "default": 8, "attn/wq": 4, "ffn/w2": [6, 4],
              "wq": 5}
FORMAT_CASES = {
    "normalize-none": ("normalize_bit_plan", (None, 2)),
    "normalize-empty": ("normalize_bit_plan", ((), 2)),
    "normalize-seq": ("normalize_bit_plan", ([8, 4], 2)),
    "normalize-dict": ("normalize_bit_plan", (_DICT_PLAN, 2)),
    "normalize-default-only": ("normalize_bit_plan", ({"default": 6}, 2)),
    "normalize-default-arg": ("normalize_bit_plan", ((6, 4), 2, 6)),
    "normalize-too-wide": ("normalize_bit_plan", ([8, 16], 2)),
    "normalize-too-narrow": ("normalize_bit_plan", ([8, 1], 2)),
    "normalize-length": ("normalize_bit_plan", ([8, 6, 4], 2)),
    "normalize-dict-length": ("normalize_bit_plan",
                              ({"ffn/w1": [8, 6, 4]}, 2)),
    "parse-seq": ("parse_bit_plan", ("8,6,4,8",)),
    "parse-empty": ("parse_bit_plan", ("  ",)),
    "parse-json-dict": ("parse_bit_plan", ('{"layers": [8, 4]}',)),
    "parse-json-list": ("parse_bit_plan", ("[6, 4]",)),
    "resolve-longest-suffix": ("resolve_bits", ("N" + "dict",
                                                ("blocks", "attn", "wq"))),
    "resolve-short-suffix": ("resolve_bits", ("Ndict",
                                              ("blocks", "mgnet", "wq"))),
    "resolve-per-layer": ("resolve_bits", ("Ndict",
                                           ("blocks", "ffn", "w1"))),
    "resolve-per-tensor-layers": ("resolve_bits",
                                  ("Ndict", ("blocks", "ffn", "w2"))),
    "resolve-default": ("resolve_bits", ("Ndict", ("head",))),
    "resolve-none": ("resolve_bits", (None, ("head",))),
    "key": ("plan_key", ("Ndict",)),
    "key-none": ("plan_key", (None,)),
    "layer-bits-seq": ("plan_layer_bits", ("Nseq", 2)),
    "layer-bits-none": ("plan_layer_bits", (None, 3)),
    "layer-bits-default": ("plan_layer_bits", ("Ndefault", 2)),
    "mean-bits": ("plan_mean_bits", ("Nseq", 2)),
    "check-bits": ("_check_bits", ("6",)),
    "check-bits-range": ("_check_bits", (9,)),
}


def _args(mod, args):
    """Stand-ins: "Ndict" / "Nseq" / "Ndefault" are plans normalized by
    ``mod`` itself."""
    named = {"Ndict": (_DICT_PLAN, 2), "Nseq": ([8, 4], 2),
             "Ndefault": ({"default": 6}, 2)}
    return tuple(mod.normalize_bit_plan(*named[a]) if isinstance(a, str)
                 and a in named else a for a in args)


def _call(mod, name, args):
    try:
        return "ok", getattr(mod, name)(*_args(mod, args))
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_plan_format_matches_reference(case):
    name, args = FORMAT_CASES[case]
    assert _call(bitalloc, name, args) == _call(jbitalloc, name, args)


def test_parse_plan_file_and_key_canonical(tmp_path):
    f = tmp_path / "plan.json"
    f.write_text('{"layers": [6, 6], "attn/wq": 4}')
    assert (bitalloc.parse_bit_plan(str(f))
            == jbitalloc.parse_bit_plan(str(f))
            == {"layers": [6, 6], "attn/wq": 4})
    a = bitalloc.plan_key(bitalloc.normalize_bit_plan(
        {"layers": [8, 4], "attn/wq": 6, "ffn/w2": 4}, 2))
    b = bitalloc.plan_key(bitalloc.normalize_bit_plan(
        {"ffn/w2": 4, "attn/wq": 6, "layers": (8, 4)}, 2))
    assert a == b and hash(a) == hash(b)


# --------------------------------------------------------------------------
# the cache under a plan, the bridge, the stale-cache contract
# --------------------------------------------------------------------------

def _same_cache(t_prep, j_prep):
    tc, jc = _cached(t_prep), _cached(j_prep)
    assert [p for p, _ in tc] == [p for p, _ in jc]
    for (path, t), (_, j) in zip(tc, jc):
        assert t.bits == j.bits, path
        np.testing.assert_array_equal(t.wq.numpy(), np.asarray(j.wq))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        assert torch.equal(t.wt, t.wq.transpose(-1, -2)), path
        assert t.wt.is_contiguous(), path
    return {p: t for p, t in tc}


@pytest.mark.parametrize("plan", [
    PLAN4, (6, 6, 6, 6),
    {"layers": [8, 6, 6, 8], "ffn/w2": 4, "attn/wq": [6, 4, 4, 6]},
    {"default": 6, "ffn/w1": 4}])
def test_prepare_params_under_a_plan_is_bitwise_the_reference(raw4, plan):
    _, _, jraw, traw = raw4
    got = _same_cache(tbackend.prepare_params(traw, bits=8, bit_plan=plan),
                      jbackend.prepare_params(jraw, bits=8, bit_plan=plan))
    w1 = got[("blocks", "ffn", "w1")]
    if plan == (6, 6, 6, 6):
        assert w1.bits == 6                 # a uniform plan collapses
    if plan == PLAN4:
        assert w1.bits == PLAN4 and w1.uniform_bits() is None
        assert [w1.layer(i).bits for i in range(4)] == list(PLAN4)
        assert int(w1.layer(2).wq.abs().max()) <= 7
        assert got[("head",)].bits == 8


def test_bridge_carries_a_mixed_reference_cache(raw4):
    _, _, jraw, traw = raw4
    plan = {"layers": PLAN4, "ffn/w2": 4}
    jprep = jbackend.prepare_params(jraw, bits=8, bit_plan=plan)
    bridged = from_jax_params(_np_tree(jprep), "cpu")
    _same_cache(bridged, jprep)
    mine = tbackend.prepare_params(traw, bits=8, bit_plan=plan)
    for (path, a), (_, b) in zip(_cached(bridged), _cached(mine)):
        assert a.bits == b.bits, path
        assert torch.equal(a.wq, b.wq) and torch.equal(a.scale, b.scale)
        assert torch.equal(a.wt, b.wt), path


@pytest.mark.parametrize("case", ["stale", "stacked", "defer", "plan"])
def test_weight_bits_contract_matches_reference(case):
    rng = np.random.default_rng(0)
    stacked = case == "stacked"
    w = rng.standard_normal((2, 16, 16) if stacked else (16, 16), np.float32)
    x = rng.standard_normal((3, 16), np.float32)
    bits = (8, 4) if stacked else 4
    kw = {"quant_bits": 0 if case in ("stacked", "defer") else 8,
          "backend": "photonic_pallas"}
    if case == "plan":
        kw["bit_plan"] = (4,)
    jw = jbackend.quantize_weight(jnp.asarray(w), bits=bits)
    tw = tbackend.quantize_weight(torch.from_numpy(w), bits=bits)
    jpol = jbackend.ExecPolicy(training=False, **kw)
    tpol = tbackend.ExecPolicy(**kw)
    if case in ("stale", "stacked"):
        match = "disagrees with" if case == "stale" else "slice it"
        with pytest.raises(ValueError, match=match):
            jbackend.linear(jnp.asarray(x), jw, policy=jpol)
        with pytest.raises(ValueError, match=match):
            tbackend.linear(torch.from_numpy(x), tw, policy=tpol)
        return
    want = np.asarray(jbackend.linear(jnp.asarray(x), jw, policy=jpol))
    got = tbackend.linear(torch.from_numpy(x), tw, policy=tpol).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_sharded_encoder_refuses_a_mixed_cache(raw4):
    """The reference's and the port's ``_encoder_bits`` both refuse a
    stacked per-layer cache; the port's eligibility check returns that
    reason (``StreamServer`` raises with it: no spawn needed here)."""
    jcfg, tcfg, jraw, traw = raw4
    jpol = jbackend.ExecPolicy.from_cfg(jcfg.with_(bit_plan=PLAN4),
                                        training=False)
    tpol = tbackend.ExecPolicy.from_cfg(tcfg.with_(bit_plan=PLAN4))
    with pytest.raises(ValueError, match="slice it"):
        jsharded._encoder_bits(jbackend.prepare_params(
            jraw, bits=8, bit_plan=PLAN4), jpol)
    tprep = tbackend.prepare_params(traw, bits=8, bit_plan=PLAN4)
    with pytest.raises(ValueError, match="slice it"):
        tsharded._encoder_bits(tprep, tpol)

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}

    class Ctx:
        mesh = Mesh()

    reason = tsharded.sharded_encode_ineligible_reason(tprep, tcfg, tpol,
                                                       Ctx())
    assert reason is not None and "stacked mixed-bits" in reason
    # a uniform cache passes the same check
    assert tsharded.sharded_encode_ineligible_reason(
        tbackend.prepare_params(traw, bits=8), tcfg,
        tbackend.ExecPolicy.from_cfg(tcfg), Ctx()) is None


# --------------------------------------------------------------------------
# the encode under a plan
# --------------------------------------------------------------------------

def test_encode_under_a_plan(raw4):
    jcfg, tcfg, jraw, traw = raw4
    jcfg, tcfg = jcfg.with_(bit_plan=PLAN4), tcfg.with_(bit_plan=PLAN4)
    tprep = tbackend.prepare_params(traw, bits=8, bit_plan=PLAN4)
    tpol = tbackend.ExecPolicy.from_cfg(tcfg)
    frames = VideoStream(img_size=32, patch=8, cut_every=8).frames_at(
        0, 4)["frames"]
    toks = tvit.embed_patches(tprep, torch.from_numpy(frames), tcfg, tpol)
    got = tvit.encode_tokens(tprep, toks, tcfg, tpol, device="cpu")
    jprep = jbackend.prepare_params(jraw, bits=8, bit_plan=PLAN4)
    want = np.asarray(jvit.encode_tokens(
        jprep, jnp.asarray(toks.numpy()), jcfg,
        jbackend.ExecPolicy.from_cfg(jcfg, training=False)), np.float64)
    g = got.double().numpy()
    assert np.corrcoef(g.ravel(), want.ravel())[0, 1] > 0.999
    assert (g.argmax(-1) == want.argmax(-1)).all()
    # within the port: bitwise the layers prepared one at a time
    x = torch.cat([tprep["cls"].expand(4, 1, -1) + tprep["pos"][:, :1],
                   toks], dim=1)
    for i, b in enumerate(PLAN4):
        lp = tbackend.prepare_params(
            {k: (v[i] if not isinstance(v, dict) else
                 {kk: vv[i] for kk, vv in v.items()})
             for k, v in traw["blocks"].items()}, bits=b)
        x = tvit.encoder_layer_step(x, lp, tcfg, tpol)
    x = tvit.layernorm(x, tprep["final_ln_g"], tprep["final_ln_b"],
                       tcfg.norm_eps)
    assert torch.equal(got, tbackend.linear(x[:, 0], tprep["head"],
                                            policy=tpol))


def test_encode_without_the_plan_on_the_policy_is_a_stale_cache(raw4):
    """quant_bits 8 with no bit plan on the policy: the first layer at
    another width raises, as the reference's contract has it."""
    _, tcfg, _, traw = raw4
    tprep = tbackend.prepare_params(traw, bits=8, bit_plan=PLAN4)
    toks = torch.zeros(2, 4, tcfg.d_model)
    with pytest.raises(ValueError, match="no bit plan is active"):
        tvit.encode_tokens(tprep, toks, tcfg,
                           tbackend.ExecPolicy.from_cfg(tcfg), device="cpu")


# --------------------------------------------------------------------------
# the calibrator
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_calibration():
    """The reference server's ``calibrate_bits(TARGET)`` on the serving
    smoke config (4 layers), once, with its ``encoder_layer_step`` calls
    recorded: (its plan, the tokens it scored, its sensitivity table, its
    raw params bridged into the port)."""
    jsrv = JServer(_smoke_cfg("photonic_pallas", "flash", "fused"),
                   JServerConfig(microbatch=4, chunk=8, mesh="off",
                                 warm_start=False), n_classes=10, seed=0)
    jsrv.add_session(jfleet(1, img_size=32, patch=8, seed=0,
                            cut_every=16)[0], n_frames=8)
    calls = []
    step = jvit.encoder_layer_step

    def recorded(x, *a, **k):
        out = step(x, *a, **k)
        calls.append((np.asarray(x), np.asarray(out, np.float32)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "encoder_layer_step", recorded)
        plan = jsrv.calibrate_bits(TARGET)
    n_layers = jsrv.cfg.n_layers
    outs = [o for _, o in calls[:n_layers]]
    sens, probes = {}, iter(calls[n_layers:])
    for i in range(n_layers):
        ref = jnp.asarray(outs[i])
        denom = float(jnp.mean(ref * ref)) + 1e-12
        for cb in (6, 4):
            err = jnp.asarray(next(probes)[1]) - ref
            sens[(i, cb)] = float(jnp.mean(err * err)) / denom
    return {"plan": plan, "tokens": calls[0][0][:, 1:], "sens": sens,
            "ins": [x for x, _ in calls[:n_layers]], "outs": outs,
            "params": from_jax_params(_np_tree(jsrv._raw_params), "cpu"),
            "layer_bits": jsrv.layer_bits}


def test_calibrator_matches_reference(ref_calibration):
    tcfg = tserver.smoke_cfg()
    pol = tbackend.ExecPolicy.from_cfg(tcfg)
    toks = torch.from_numpy(ref_calibration["tokens"].copy())
    raw = ref_calibration["params"]
    want = ref_calibration["sens"]
    # each layer on the reference's own input to it
    spol = bitalloc._scoring_policy(pol)
    for i, x in enumerate(ref_calibration["ins"]):
        out, scores = bitalloc.score_layer(
            torch.from_numpy(x.copy()), bitalloc._slice_layer(
                raw["blocks"], i), tcfg, spol, (6, 4))
        np.testing.assert_allclose(out.numpy(), ref_calibration["outs"][i],
                                   rtol=1e-4, atol=1e-4)
        for cb, v in scores.items():
            assert v == pytest.approx(want[(i, cb)], rel=LAYER_RTOL), (i, cb)
    # the whole table, each side on its own uniform-8 walk
    sens = bitalloc.layer_sensitivities(raw, toks, tcfg, pol)
    assert sens.keys() == want.keys()
    for key in want:
        assert sens[key] == pytest.approx(want[key], rel=TABLE_RTOL), key
    plan = ref_calibration["plan"]
    assert sum(plan) / len(plan) <= TARGET and plan != (8,) * len(plan)
    assert bitalloc.calibrate_bit_plan(ref_calibration["params"], toks, tcfg,
                                       pol, TARGET) == plan
    # the greedy pass alone, on the reference's own scores
    assert bitalloc.greedy_plan(want, tcfg.n_layers, TARGET) == plan


def test_calibrator_floor_and_uniform_target(raw4):
    _, tcfg, _, traw = raw4
    pol = tbackend.ExecPolicy.from_cfg(tcfg)
    toks = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, tcfg.d_model), np.float32))
    # unreachable target: every layer bottoms out at the lowest candidate
    assert bitalloc.calibrate_bit_plan(traw, toks, tcfg, pol, 1.0,
                                       candidates=(6,)) == (6,) * 4
    # a target at (or above) the default is the uniform plan, unscored
    jcfg, _ = _cfgs(4)
    assert (bitalloc.calibrate_bit_plan(None, toks, tcfg, pol, 8.0)
            == jbitalloc.calibrate_bit_plan(
                None, None, jcfg, jbackend.ExecPolicy(), 8.0) == (8,) * 4)


def test_server_calibrate_bits_matches_reference(ref_calibration):
    srv = tserver.StreamServer(
        tserver.smoke_cfg(), tserver.ServerConfig(microbatch=4, chunk=8),
        params=ref_calibration["params"], device="cpu")
    st = video_fleet(1, img_size=32, patch=8, seed=0, cut_every=16)[0]
    srv.add_session(st, n_frames=8)
    warmed = set(srv.warmed)
    plan = srv.calibrate_bits(TARGET)
    assert plan == ref_calibration["plan"]
    assert srv.layer_bits == ref_calibration["layer_bits"] == plan
    assert srv.policy.bit_plan == bitalloc.plan_key(
        bitalloc.normalize_bit_plan(plan, 4))
    assert srv.params["blocks"]["ffn"]["w1"].bits in (plan, plan[0])
    assert srv.warmed == warmed and not srv.graphs   # eager on the CPU
    # the un-started session was re-made with the plan's widths
    res = srv.serve()
    (r,) = res.values()
    assert r.mean_bits == sum(plan) / len(plan) and len(r.predictions) == 8


# --------------------------------------------------------------------------
# accounting and the CLI
# --------------------------------------------------------------------------

def _reports_equal(t, j, rel=1e-12):
    for f in t._FIELDS:
        if rel == 0:
            assert getattr(t, f) == getattr(j, f), f
        else:
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=rel), f


@pytest.mark.parametrize("variant", ["base-224", "smoke"])
def test_width_aware_accounting_matches_reference(variant):
    if variant == "smoke":
        tcfg = tserver.smoke_cfg()
        jcfg = _smoke_cfg("photonic_pallas", "flash", "fused")
        plan = PLAN4
    else:
        tcfg = tserver.serving_cfg("base", 224)
        jcfg = jget_config("base", img_size=224, mgnet=True)
        plan = T224_PLAN
    n = (tcfg.img_size // tcfg.patch) ** 2
    ladder = BucketLadder.from_fractions(n, (0.25, 0.5, 0.75, 1.0)).sizes
    uniform = (8,) * tcfg.n_layers
    for k in ladder:
        for lb in (plan, uniform):
            _reports_equal(tacct.bucket_report(tcfg, k, lb),
                           jacct.bucket_report(jcfg, k, lb), rel=0)
        _reports_equal(tacct.bucket_report(tcfg, k, uniform),
                       tacct.bucket_report(tcfg, k))
    ta = tacct.StreamAccounting(tcfg, ladder_sizes=ladder, layer_bits=plan)
    ja = jacct.StreamAccounting(jcfg, ladder_sizes=ladder, layer_bits=plan)
    tu = tacct.StreamAccounting(tcfg, ladder_sizes=ladder)
    for a in (ta, ja, tu):
        a.add_mgnet(3)
        a.add_encode(ladder[1], 4)
        a.add_encode(ladder[-1], 2)
    _reports_equal(ta.total, ja.total)
    assert ta.kfps_per_watt == pytest.approx(ja.kfps_per_watt, rel=1e-12)
    assert ta.dense_baseline_kfps_per_watt() == pytest.approx(
        ja.dense_baseline_kfps_per_watt(), rel=1e-12)
    assert ta.kfps_per_watt > tu.kfps_per_watt
    assert ta.mean_frame.total_uj < tu.mean_frame.total_uj
    with pytest.raises(ValueError, match="entries for"):
        tacct.StreamAccounting(tcfg, layer_bits=uniform + (8,))


@pytest.mark.parametrize("flag", [("--bit-plan", "8,6,4,8"),
                                  ("--bit-budget", "6")])
def test_server_cli_with_a_bit_plan(capsys, flag):
    res = tserver.main(["--smoke", "--device", "cpu", "--streams", "2",
                        "--frames", "16", "--phase", "4", "--json", *flag])
    assert sorted(len(r.predictions) for r in res.values()) == [16, 16]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bits = summary["layer_bits"]
    assert len(bits) == 4 and all(b in (8, 6, 4) for b in bits)
    if flag[0] == "--bit-plan":
        assert bits == [8, 6, 4, 8]
    else:
        assert sum(bits) / 4 <= 6.0
    for r in res.values():
        assert r.mean_bits == sum(bits) / 4
