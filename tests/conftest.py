"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without a card via XLA's forced
host device count (the standard JAX trick; SURVEY section 4).  Must run
before jax is imported anywhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Tests run on the virtual 8-device CPU backend, also where a GPU is
# present; a test that needs the card asks for the ``gpu`` fixture.
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU, made the default device for the test; skips where
    JAX has none.  Tests that take it are marked ``gpu`` and run on the
    card with ``python -m pytest -m gpu tests/``."""
    try:
        device = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU")
    with jax.default_device(device):
        yield device
