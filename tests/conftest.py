import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "transfer_guard: steady-state device-resident ticks asserted to "
        "perform zero host<->device moment transfers (tier-1)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's CUDA "
        "kernels); skips where there is no card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def normal_samplers(mu=100.0, sigma=20.0, b=10):
    """b blocks of synthetic i.i.d. N(mu, sigma) data (paper's setup:
    uniform sampling from i.i.d. data == drawing from the distribution)."""
    return [(lambda n, rng, m=mu, s=sigma: rng.normal(m, s, size=n))
            for _ in range(b)]
