"""The benchmark's tests: the driver's root-level pytest collects them.
Tests that need the card carry the ``cuda`` marker and skip without one,
deciding so inside the test."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
