"""Test harness: force an 8-fake-device CPU platform.

SURVEY.md §4 "Distributed without a cluster": all pjit/psum/mesh logic runs on
a virtual 8-device CPU mesh. What needs the GPU is marked ``gpu`` and runs on
the card through ``python chip_smoke.py`` (README "Running on the GPU").

jax.config.update (not the JAX_PLATFORMS env var) pins the platform, so the
tests stay on the CPU even where an accelerator is present.
"""

import os
import subprocess
import sys

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_matmul_precision", "highest")

# Import the package BEFORE lowering the persistent-cache threshold: the
# package __init__ sets min_compile_time to 2.0 s at import, which would
# otherwise override the 0.1 s below, so test-sized programs (0.1-2 s
# compiles — most of the suite) would never be cached.
import alphafive_tpu  # noqa: E402, F401

jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

assert jax.default_backend() == "cpu"
assert jax.device_count() == 8, jax.devices()


@pytest.fixture
def gpu():
    """Environment for a child process that runs on the GPU, for tests
    marked ``gpu``; skips where JAX finds none. This process is pinned to
    the CPU, so a fresh interpreter asks. Decided here, at run time, never
    at import or collection time."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        capture_output=True, text=True, env=env, timeout=120)
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return env
