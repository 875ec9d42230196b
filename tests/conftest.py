"""
Test configuration.

Tests run on a virtual 8-device CPU mesh (the multi-device sharding tests
need several devices) unless ``JAX_PLATFORMS`` is set explicitly: then the
tests see that platform, which is how ``chip_smoke.py`` runs the tests
marked ``gpu`` on the card. The environment must be set before JAX is
imported.

float64 is enabled globally: the reference defaults to float64
(pytassim/interface/base.py:73) and its parity oracles use
rtol=atol=1e-10 (tests/unit_tests/interface/test_letkf.py:69-70), which f32
cannot meet.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(42)


@pytest.fixture
def gpu():
    """The first GPU, or a skip when JAX's default backend has none (the
    decision is made here, at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run through chip_smoke.py")
    return jax.devices()[0]
