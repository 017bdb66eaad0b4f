"""Shared fixtures of the benchmark's tests. Imports no JAX."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skips without one",
    )


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)
