"""Test configuration: force an 8-virtual-device CPU platform so sharding
tests exercise real multi-device lowering without accelerator hardware.

RAG_TEST_DEVICE=gpu leaves JAX on its default platform instead; chip_smoke.py
sets it to run the `gpu`-marked tests on the card. Whether a card is present
is decided in the `gpu` fixture, never while modules are imported.

Note: `import pytest` already pulls in jax via a plugin, so env vars alone
are too late — use jax.config.update (legal until the backend initializes).
"""

import os

ON_CARD = os.environ.get("RAG_TEST_DEVICE") == "gpu"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
