"""Shared test config. NOTE: XLA_FLAGS must NOT be set here — tests and
benches run against the single real CPU device; only launch/dryrun.py
overrides the device count (and only in its own process)."""

import os

# keep hypothesis fast + deterministic in CI
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running training/convergence tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips inside a fixture without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
