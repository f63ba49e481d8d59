"""Test harness config.

Runs before JAX initializes. The suite runs on the CPU with 8 virtual
devices (the multi-device island and mesh tests need them) unless the
caller names another platform. The tests that need a card are marked `gpu`
and run there with:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

_ON_CARD = os.environ.get("JAX_PLATFORMS", "cpu") not in ("", "cpu")

if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

from greyjack_tpu.compile_cache import enable_compile_cache  # noqa: E402

# compile time dominates this suite (big fused step graphs); the persistent
# cache makes repeat runs and later workers fast
enable_compile_cache()
if not _ON_CARD:
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU. Decided when the
    test runs, never at import, so every worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform}); run "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` "
                    "on the card")
    return dev
