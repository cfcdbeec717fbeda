"""Test env: CPU backend with 8 virtual devices so sharding/collective tests
run without a device mesh (SURVEY.md §6 "Multi-device tests without a
cluster").

Tests are hermetic and run on the CPU unless JAX_PLATFORMS names another
platform: `JAX_PLATFORMS=cuda python -m pytest tests -m gpu` runs the few
checks marked `gpu` on a card (they skip elsewhere; chip_smoke.py runs the
same checks as phases).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at test time, never at
    import, so every pytest-xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
