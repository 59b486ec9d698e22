"""Test configuration.  By default everything runs on the CPU backend with 8
virtual devices, so the distributed paths (shard_map, collectives,
N-vs-1-device bit-exactness) are exercised without accelerators
(SURVEY.md §4.5).  Tests marked `gpu` need the card and skip elsewhere; run
them on a GPU machine with JAX_PLATFORMS=cuda (README, Development)."""

import os
import subprocess

# Must be set before jax import anywhere in the test process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from claragenomicsanalysis_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

# XLA compilation on the CPU is slow (~tens of seconds per executable);
# the persistent cache makes re-runs fast.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never at collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture(scope="session")
def native_libs():
    """Build native/ into io/_native when a library is missing (build.sh
    renames each library into place, so concurrent workers are safe)."""
    out = os.path.join(ROOT, "claragenomicsanalysis_tpu", "io", "_native")
    libs = ("libtraceback.so", "libpack2.so", "libfasta.so")
    if not all(os.path.exists(os.path.join(out, n)) for n in libs):
        subprocess.run(["sh", os.path.join(ROOT, "native", "build.sh")],
                       capture_output=True, check=False)
    return out


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop JAX's in-memory executable caches after each test module.

    The full suite accumulates hundreds of live compiled executables in one
    process; past ~a-full-run's worth, jaxlib 0.9's CPU client segfaults
    inside a later XLA compile.  Clearing per module keeps the live set
    small; the persistent .jax_cache keeps re-compiles cheap (deserialize,
    not rebuild)."""
    yield
    jax.clear_caches()
