"""Test harness config: the CPU backend with 8 virtual devices, so the
sharding tests run without a cluster (SURVEY.md §4 'distributed tests
without a cluster') and Pallas kernels run in interpret mode.

The environment is set before JAX is imported; JAX_PLATFORMS may be
overridden (JAX_PLATFORMS=cuda) to run the ``gpu``-marked tests on a
card."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
