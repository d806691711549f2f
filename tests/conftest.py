"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding layer is exercised without accelerators (per
SURVEY.md section 4 point 7).  JAX_PLATFORMS, when set, wins: the
GPU-marked tests run on the card with JAX_PLATFORMS=cuda."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The GPU device for tests marked ``gpu``; skips where there is none.
    Decided here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated XLA:CPU compiler state.

    With 300+ tests in one process, XLA:CPU intermittently segfaults
    while COMPILING late in the run (observed twice at ~92%, inside
    backend_compile_and_load / the cache-write path, always on the first
    fresh compile of a large pipeline after ~270 prior tests).  Dropping
    live executables between modules keeps the process below the poison
    threshold; modules are compile-wise self-contained, so the cost is
    only cross-module executable reuse."""
    yield
    jax.clear_caches()
