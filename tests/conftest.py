"""Test environment.

Unless JAX_PLATFORMS names another platform, the tests run on the CPU
backend with 8 virtual devices, so the sharded paths compile and execute
without an accelerator.

Tests marked `gpu` need an NVIDIA GPU; they take the `gpu_device`
fixture, which skips them where JAX finds none.  On a GPU host run them
with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips where JAX finds none)")


@pytest.fixture
def gpu_device():
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; JAX found none")
    return gpus[0]
