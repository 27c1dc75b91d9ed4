"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so results
can be compared against the in-repo NumPy float64 reference
implementation (the stand-in for the reference's GPy/float64 numerics).
Tests that need the GPU carry the ``gpu`` marker and skip on the CPU;
run them on a machine with the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import os
import sys

# Make the suite runnable from any working directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The suite runs on the CPU unless a platform is named: the GPU tests
# run with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py`.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# XLA:CPU fast-math approximates sqrt/exp inside fused kernels (~1e-8
# error even in f64), which breaks golden comparisons against the NumPy
# reference. Accuracy over speed for tests.
if "xla_cpu_enable_fast_math" not in flags:
    flags += " --xla_cpu_enable_fast_math=false"
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite compiles hundreds of XLA:CPU
# programs, and the per-module clear_caches below forces recompiles of
# shared signatures. Disk persistence makes every recompile -- and every
# rerun of the suite -- a cache hit.
from safeopt_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX finds none.

    Decided here, when the test runs, never at import or collection:
    every xdist worker must collect the same tests.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform!r}); run "
                    "`JAX_PLATFORMS=cuda pytest -m gpu tests/test_gpu.py` "
                    "on the card")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    A single pytest process compiles many hundreds of distinct XLA:CPU
    programs across the suite; with everything retained in the jit
    caches, the process-lifetime accumulation has been observed to end
    in a segfault inside ``backend_compile_and_load`` on this jaxlib
    (0.9.0, 8 virtual devices) after ~150-200 tests — at a different,
    individually-green test every run. Clearing per module keeps the
    live-executable population bounded at the cost of recompiling the
    few cross-module shared signatures.
    """
    yield
    jax.clear_caches()
