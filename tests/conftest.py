"""Test configuration: run JAX on the CPU with 8 virtual devices so the
sharding tests exercise a multi-device mesh without accelerators.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them on the CPU.  On a GPU machine run them with
``PPS_TEST_GPU=1 python -m pytest tests/ -m gpu``."""

import os

import pytest

os.environ["PPS_NO_COMPILE_CACHE"] = "1"  # CPU AOT artifacts are not portable

if os.environ.get("PPS_TEST_GPU") != "1":
    # override, not setdefault: the tests must run on the CPU even where
    # the environment selects an accelerator
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("PPS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with PPS_TEST_GPU=1 -m gpu on one)")
