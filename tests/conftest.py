"""Test environment: CPU backend with 8 virtual devices, f64 enabled.

Pallas kernels run in interpret mode on CPU (Config auto-detects the
backend), so the correctness suite needs no GPU — the strategy SURVEY.md §4
prescribes for upgrading the reference's eyeball-norm validation.  Tests
marked `gpu` (tests/test_gpu.py) run their checks in a child process on
the card, and skip without one.
"""

import os

# jax.config.update works as long as no backend has been initialized yet,
# even where jax was imported before this file ran.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def cfg64():
    from gpu_bench.core.config import Config
    import jax.numpy as jnp

    return Config(dtype=jnp.float64, n_tests=2)


@pytest.fixture
def cfg32():
    from gpu_bench.core.config import Config
    import jax.numpy as jnp

    return Config(dtype=jnp.float32, n_tests=2)
