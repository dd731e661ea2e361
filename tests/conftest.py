"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the 1 real CPU
device; only launch/dryrun.py forces 512 host devices (per the brief)."""

import numpy as np
import pytest

import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
