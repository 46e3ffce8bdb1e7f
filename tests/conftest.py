"""Test harness setup.

The suite runs on CPU with 8 virtual XLA devices so the multi-device
sharding paths (shard_map over a mesh) are exercised without hardware —
the strategy SURVEY §4 prescribes.  This must happen before the JAX
backend initializes.  A process that has already brought up the GPU
and sets ``CAF_TESTS_ON_GPU=1`` (``chip_smoke.py``, for the
``gpu``-marked tests) keeps its device.
"""

import os
import pathlib

ON_GPU = os.environ.get("CAF_TESTS_ON_GPU") == "1"
flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # The suite's many small CPU programs stay out of the persistent
    # compile cache that cli.main turns on.
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from caf_cookoff_tpu.utils.generate import ensure_fixtures  # noqa: E402
from caf_cookoff_tpu.utils.io import load_c64, parse_ground_truth  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA_DIR = REPO_ROOT / "data"


@pytest.fixture(scope="session")
def fixture_pairs():
    """[(needle_path, haystack_path)] for the 10 reference chirps."""
    return ensure_fixtures(DATA_DIR)


@pytest.fixture(scope="session")
def chirp(fixture_pairs):
    """Loader: chirp(i) -> (needle c64, truncated haystack c64, GroundTruth)."""

    def _load(idx: int):
        needle_path, haystack_path = fixture_pairs[idx]
        needle = load_c64(needle_path)
        haystack = load_c64(haystack_path, count=len(needle))
        return needle, haystack, parse_ground_truth(haystack_path)

    return _load


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_executable_accumulation():
    """Clear JAX's executable caches at module boundaries.

    The suite compiles ~350 distinct XLA:CPU programs; with every
    executable held live by the global pjit cache for the whole run,
    the process deterministically segfaults inside
    ``backend_compile_and_load`` once the accumulated count crosses a
    threshold (first seen when the suite grew past ~344 tests —
    reproducible at the same test with the full prefix, absent for any
    subset).  Executables are rarely shared ACROSS test modules, so
    clearing per-module bounds the live count without recompiling
    within a module.
    """
    yield
    jax.clear_caches()
