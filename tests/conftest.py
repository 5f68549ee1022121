"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only tests that need a small mesh spawn with
the forced host device count via the ``mesh_env`` marker / subprocess."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skips without one "
        "(chip_smoke.py covers the same checks on the card)")
