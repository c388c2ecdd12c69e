"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 device
(the 512-device override belongs exclusively to launch/dryrun.py)."""
import jax
import pytest

jax.config.update("jax_default_matmul_precision", "float32")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
