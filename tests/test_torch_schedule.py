"""The port's copy of the reference's five-core pipeline model (paper
Fig. 5, ``core/schedule.py``) and the backend registry's public
decorators, against the reference on the CPU.

Tolerances: the schedule is the same host arithmetic on the same floats,
so makespans and timelines are exactly equal; a user backend registered
by decorator in both packages, chosen by name through ``ExecPolicy``,
gives the same output within 1e-6 of the output's largest value (one f32
product each, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import schedule as jschedule
from repro_torch.core import backend as tbackend
from repro_torch.core import schedule as tschedule

# tests/test_energy_model.py's inputs
SCHEDULES = [(1.0, 2.0, 0.3), (0.5, 10.0, 0.1)]


@pytest.mark.parametrize("args", SCHEDULES)
@pytest.mark.parametrize("decomposed", [True, False])
def test_attention_schedule_equals_reference(args, decomposed):
    assert (tschedule.attention_schedule(*args, decomposed=decomposed)
            == jschedule.attention_schedule(*args, decomposed=decomposed))


def test_simulate_pipeline_equals_reference():
    def tasks(mod):
        return [mod.CoreTask("a", 0, 1.0, 0.5),
                mod.CoreTask("b", 1, 2.0, 0.25, deps=("a",)),
                mod.CoreTask("c", 0, 0.5, 1.0, deps=("b",),
                             tune_deps=("a",))]
    epu = {"e": (0.3, ("b",))}
    assert (tschedule.simulate_pipeline(tasks(tschedule), 2, dict(epu))
            == jschedule.simulate_pipeline(tasks(jschedule), 2, dict(epu)))
    for mod in (tschedule, jschedule):
        with pytest.raises(ValueError, match="deadlock"):
            mod.simulate_pipeline([mod.CoreTask("a", 0, 1.0, 0.1,
                                                deps=("ghost",))])


def test_built_in_entries_are_registered_by_decorator():
    assert tbackend.get_backend("bf16") is tbackend._bf16_matmul
    assert tbackend.get_backend("photonic_pallas") is (
        tbackend._photonic_pallas_matmul)
    assert tbackend.get_attention_backend("xla") is tbackend._attend_xla
    assert tbackend.get_ffn_backend("fused") is tbackend._ffn_fused
    for name in ("register_backend", "register_attention_backend",
                 "register_ffn_backend"):
        assert name in tbackend.__all__ and name in jbackend.__all__
    assert (tbackend.available_backends(), tbackend.available_ffn_backends(),
            tbackend.available_attention_backends()) == (
        ("bf16", "photonic_pallas", "photonic_sim", "qat"),
        ("fused", "xla"), ("flash", "xla"))


def test_a_user_backend_registered_the_reference_way():
    """A matmul, an attention and an FFN backend registered by decorator
    in both packages are chosen by name; the outputs agree."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    q = rng.standard_normal((2, 2, 5, 8)).astype(np.float32)
    try:
        for be in (jbackend, tbackend):
            @be.register_backend("doubled")
            def _doubled(x, w, p):
                return 2.0 * (x @ w)

            @be.register_attention_backend("values")
            def _values(q, k, v, p, mask, kv_len, scale):
                return v * scale

            @be.register_ffn_backend("skip")
            def _skip(x, w1, b1, w2, b2, p, live_rows):
                return x + b2
        jp = jbackend.ExecPolicy(backend="doubled", attn_backend="values",
                                 ffn_backend="skip")
        tp = tbackend.ExecPolicy(backend="doubled", attn_backend="values",
                                 ffn_backend="skip")
        got = [tbackend.linear(torch.from_numpy(x), torch.from_numpy(w),
                               policy=tp).numpy(),
               tbackend.attend(*(torch.from_numpy(q),) * 3,
                               policy=tp).numpy(),
               tbackend.ffn(torch.from_numpy(x), None, None, None,
                            torch.ones(16), policy=tp).numpy()]
        want = [jbackend.linear(jnp.asarray(x), jnp.asarray(w), policy=jp),
                jbackend.attend(*(jnp.asarray(q),) * 3, policy=jp),
                jbackend.ffn(jnp.asarray(x), None, None, None, jnp.ones(16),
                             policy=jp)]
        for g, wv in zip(got, want):
            wv = np.asarray(wv)
            assert np.abs(g - wv).max() <= 1e-6 * np.abs(wv).max()
    finally:
        for be in (jbackend, tbackend):
            be.BACKENDS.pop("doubled", None)
            be.ATTN_BACKENDS.pop("values", None)
            be.FFN_BACKENDS.pop("skip", None)
