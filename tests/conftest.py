"""Test harness config.

Force the CPU backend with 8 virtual devices BEFORE jax initializes: golden
tests are deterministic on CPU, and rt.dist sharding tests get an 8-device
mesh without multi-GPU hardware (the documented JAX pattern for testing
multi-device code paths on one host).

Tests that need a GPU carry the ``gpu`` marker and decide inside a fixture
whether to skip (tests/test_gpu_path.py); nothing here looks for a card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow (full 100-frame golden) tests")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: full-convergence golden tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips on CPU; chip_smoke.py covers it)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
