"""Test configuration: an 8-device virtual CPU mesh before any jax use.

Multi-card sharding is tested on virtual CPU devices (SURVEY.md §4). Tests
that need a GPU carry the ``gpu`` marker and skip here (see the ``gpu``
fixture); run them on a card with ``python -m pytest -m gpu tests/``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {devices[0].platform})")
    return devices[0]
