"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single
real CPU device; only launch/dryrun.py forces 512 host devices."""
import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (hand-written kernels of the "
        "PyTorch port); skips without one")
