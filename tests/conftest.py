"""Test configuration: the JAX CPU backend with 8 virtual devices, so
multi-device sharding is exercised without accelerator hardware.

The suite runs on the CPU: JAX_PLATFORMS defaults to ``cpu`` here.
Tests marked ``gpu`` need an NVIDIA GPU: they take the ``gpu_device``
fixture, which skips them when the process's first JAX device is not a
GPU.  Run them on a machine with a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (``chip_smoke.py``
runs them in its own process, which already owns the card).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if os.environ["JAX_PLATFORMS"]:
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {device.platform}")
    return device
