"""Test config: a CPU backend with 8 virtual devices, so kernels (Pallas
in interpret mode) and multi-device sharding run without a GPU. Tests that
need the card carry the `gpu` marker and skip here (see the `gpu`
fixture); `python chip_smoke.py` runs their checks on the card."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# the rig is a CPU rehearsal: entry points called from tests accept the
# CPU only when JAX_PLATFORMS says so explicitly (asm_tpu.runtime)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from asm_tpu.runtime import use_compile_cache  # noqa: E402

# Persistent compile cache for the suite: a full run JIT-compiles ~200+
# CPU programs in one process, which the XLA CPU backend handles flakily
# under load (observed rare segfaults inside backend_compile_and_load;
# clean reruns pass). Cached runs compile almost nothing.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """A full suite run JIT-compiles 400+ XLA:CPU programs in ONE
    process; past ~that many live executables the LLVM JIT segfaults
    nondeterministically inside backend_compile_and_load (observed at
    ~64% of the suite; the same tests pass in half-suite runs).
    Dropping executable references between modules keeps the live set
    small; the persistent compile cache above makes the re-loads
    cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, never while modules are imported."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def random_pair(rng, length=100, error_rate=0.1, mismatch_rate=0.96):
    """One WFA-style read/ref pair (same process as the corpus generator)."""
    from asm_tpu.data.generator import generate_dataset

    seed = int(rng.integers(0, 2**31))
    reads, refs = generate_dataset(
        1, length, error_rate, mismatch_rate, exact_error_rate=True, seed=seed
    )
    return reads[0], refs[0]
