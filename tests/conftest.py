"""Test harness configuration.

Runs the whole suite on the CPU with 8 virtual XLA devices, so multi-device
sharding (mesh / jit with shardings) is exercised without accelerators — the
strategy SURVEY.md §4 prescribes, since the reference repo ships no tests at
all. The CPU is forced explicitly; no test looks for a card at import time.
"""

import os

# Must be in place before the first backend initialization (lazy in jax).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

# Persistent compilation cache: identical jit programs (shared tiny-model
# fixtures across files, repeated suite runs, CLI subprocesses) skip XLA
# compilation — the dominant cost of this CPU-forced suite.
CACHE_DIR = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert jax.device_count() == 8, jax.devices()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
