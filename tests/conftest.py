"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without accelerators via
``xla_force_host_platform_device_count`` (the fake-backend mechanism the
reference lacks — see SURVEY.md §4).  Must run before the first jax import.

Tests marked ``gpu`` check code as XLA compiles it for an NVIDIA card; they
skip here and run on a machine with one::

    ADMM_TESTS_ON_GPU=1 python -m pytest tests -m gpu
"""

import os

_ON_GPU = os.environ.get("ADMM_TESTS_ON_GPU") == "1"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _ON_GPU else "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run with ADMM_TESTS_ON_GPU=1 on a machine with one")
