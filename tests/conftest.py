"""Test configuration: JAX on CPU with 8 virtual devices.

Unit/parity tests must be hardware-independent and able to exercise
multi-device sharding logic, so JAX runs on the CPU platform with
``--xla_force_host_platform_device_count=8``.  Must run before the first
jax import.  The GPU kernels run here in Pallas interpret mode.

Tests marked ``gpu`` need a card and skip elsewhere (the ``gpu_device``
fixture decides, never at import time); on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (an explicit
non-CPU ``JAX_PLATFORMS`` is kept).  ``python chip_smoke.py`` covers the
same paths at full size.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py covers this path "
                    "on the card)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    A full-suite run accumulates hundreds of live XLA:CPU executables; on
    this machine class LLVM reliably aborts/segfaults partway through the
    suite (same spot every run — observed in test_parallel_sp after ~450
    compiles) while every module passes in isolation.  Clearing the jit
    caches between modules keeps the in-process compiler state bounded;
    within a module, caching still deduplicates compiles.
    """
    yield
    jax.clear_caches()
