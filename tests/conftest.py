"""Test configuration: an 8-device virtual CPU mesh unless told otherwise.

Tests run hardware-free on the CPU backend with 8 virtual devices, so the
`parallel/` sharding paths run as they would across 8 cards.  A process
that set `JAX_PLATFORMS` itself, or that imported JAX before pytest started
(`chip_smoke.py` runs the card-only tests in its own process this way),
keeps its platform.  Tests marked `gpu` need an NVIDIA GPU and skip
elsewhere; the decision is made in a fixture, at run time.
"""

import os
import sys

if "jax" not in sys.modules and not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ.get("JAX_PLATFORMS") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from audio_analyzer_rs_tpu.compile_cache import (  # noqa: E402
    configure_compile_cache)

# The big scan/vmap pipelines take tens of seconds to compile on the CPU;
# the persistent cache makes reruns cheap.
configure_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _card_only(request):
    """Skip a `gpu`-marked test unless JAX's first device is a GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs the "
                    "card-only tests there)")


# Every XLA:CPU compile mmaps JIT code regions that live as long as the
# compiled executable.  Across a full-suite process the ~240 tests' programs
# accumulate several tens of thousands of mappings and eventually exhaust the
# kernel's vm.max_map_count (default 65530), at which point the *next* mmap
# inside jaxlib fails and the process segfaults — always late in the run, in
# whatever happened to compile/(de)serialize next (historically test_yin.py,
# simply because it sorts last).  Dropping compiled executables after each
# test module keeps the process's mapping count bounded; the on-disk
# persistent cache makes the cross-module recompiles this forces cheap.
@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mappings():
    yield
    jax.clear_caches()
