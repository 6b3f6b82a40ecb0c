"""Test harness: an 8-device virtual CPU platform, and the `gpu` fixture.

The suite runs on the CPU. Multi-device sharding is validated on a virtual
8-device CPU mesh (xla_force_host_platform_device_count), the JAX-native
answer to testing multi-device layouts without a cluster. The platform is
forced with jax.config.update before any backend is touched.

Tests marked `gpu` need the card: they take the `gpu` fixture, which skips
them on the CPU. chip_smoke.py runs them on the card inside its own JAX
process, after setting LSQ_TEST_PLATFORM=gpu so that this file leaves the
already-initialized GPU platform alone.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ.get("LSQ_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; otherwise the test skips
    (run the `gpu`-marked tests on the card with `python chip_smoke.py`)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first device is {dev.platform}); "
                    "chip_smoke.py runs this on the card")
    return dev
