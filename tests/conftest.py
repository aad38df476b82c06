"""Test harness: an 8-device virtual CPU mesh, set before JAX starts.

Multi-device sharding tests run on CPU via
``--xla_force_host_platform_device_count=8`` (the reference has no
distributed tests at all; SURVEY.md §4 calls for adding these).

The one exception is ``pytest -m gpu -p no:xdist`` on a machine with an
NVIDIA GPU: that run selects the card-only tests, and JAX is left on its
default platform so they can reach the card.  Whether a card is present is
decided inside the ``gpu_device`` fixture, never here.
"""

import os

import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def rng():
    import numpy as np

    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device if it is an NVIDIA GPU; skips otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {dev.platform})")
    return dev
