"""Test env: by default run on the CPU with 8 virtual devices so the
sharding/TP tests work without accelerators (the fake-backend mechanism
the reference lacks, SURVEY.md §4). Must run before jax is imported
anywhere.

`TEAL_TESTS_ON_GPU=1` leaves the platform alone instead: `chip_smoke.py`
sets it to run the `gpu`-marked tests in its own process on the card
(`python -m pytest tests/test_gpu.py -m gpu` does the same by hand with
the variable set). The `gpu` fixture skips those tests anywhere else.
"""

import os

import pytest

ON_GPU = os.environ.get("TEAL_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", jax.devices()
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX has none. Decided here,
    at run time, never while modules are collected."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform})")
    return dev
