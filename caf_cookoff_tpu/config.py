"""Configuration dataclasses for the CAF engine.

The reference hardcodes every parameter in each ``main`` (sample rate,
file paths, frequency grids — ``caf_rust/src/main.rs:13-22``,
``caf_go/main.go:10-22``, ``caf_python/caf.py:125-134``; a CLI was a TODO
that never landed, ``caf_rust/src/main.rs:1-2``). Here configuration is
first-class and flows through the CLI, the engines, and the bench harness.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pathlib
from typing import Tuple

import numpy as np

DEFAULT_SAMPLE_RATE = 48_000.0  # Hz, the reference's fixture rate

# Every backend name an engine accepts ('auto' resolves to one of them).
BACKENDS = ("xla", "matmul", "matmul-highest", "matmul-high",
            "matmul-bf16", "stein", "stein-raw")


@dataclasses.dataclass(frozen=True)
class FreqGrid:
    """A doppler search grid: ``[start, stop)`` in ``step`` increments.

    Matches the reference's ``gen_float_shifts`` semantics
    (``caf_rust/tests/test.rs:335-352``): the grid is generated by integer
    *milli-hertz* stepping so that repeated float addition never drifts, and
    the stop value is exclusive. Resolution floor is therefore 1 mHz.
    """

    start_hz: float
    stop_hz: float
    step_hz: float

    def __post_init__(self) -> None:
        if self.step_hz <= 0:
            raise ValueError(f"step_hz must be positive, got {self.step_hz}")
        if self.stop_hz <= self.start_hz:
            raise ValueError("stop_hz must be greater than start_hz")

    @property
    def num_bins(self) -> int:
        start_mhz = int(self.start_hz * 1000.0)
        stop_mhz = int(self.stop_hz * 1000.0)
        step_mhz = int(self.step_hz * 1000.0)
        return max(0, -(-(stop_mhz - start_mhz) // step_mhz))

    def frequencies(self, dtype=np.float64) -> np.ndarray:
        """Materialize the grid as a host array (exact mHz lattice)."""
        start_mhz = int(self.start_hz * 1000.0)
        step_mhz = int(self.step_hz * 1000.0)
        mhz = start_mhz + step_mhz * np.arange(self.num_bins, dtype=np.int64)
        return (mhz.astype(np.float64) / 1e3).astype(dtype)

    def padded(self, multiple: int) -> Tuple["FreqGrid", int]:
        """Extend the grid upward so ``num_bins`` divides ``multiple``.

        Returns the padded grid and the number of valid (original) bins.
        Padding bins search real frequencies above the requested stop; they
        can only *lower* the chance of a spurious tie, and peak extraction
        masks them out.
        """
        n = self.num_bins
        target = -(-n // multiple) * multiple
        if target == n:
            return self, n
        new_stop = self.start_hz + self.step_hz * target
        return FreqGrid(self.start_hz, new_stop, self.step_hz), n


# The benchmark grid used throughout the reference README tables
# (400 bins: -100..+100 Hz step 0.5, `caf_python/caf.py:134`).
BENCH_GRID = FreqGrid(-100.0, 100.0, 0.5)


@dataclasses.dataclass(frozen=True)
class CafConfig:
    """Full configuration for one CAF computation."""

    sample_rate: float = DEFAULT_SAMPLE_RATE
    grid: FreqGrid = BENCH_GRID
    # 'c64' — complex64 compute;
    # 'c128' — complex128 parity mode (CPU / x64, matches reference exactly).
    precision: str = "c64"
    # Engine/FFT backend: 'auto' (:func:`backend_for_platform`);
    # 'xla' (complex FFT HLO behind the split facade — cuFFT on GPU);
    # 'matmul[-highest|-high|-bf16]' (split-complex four-step DFT as
    # dense matmuls at the given precision tier);
    # 'stein[-raw]' (time-segmented fast path + exact refinement —
    # doppler span must satisfy D<=fs/(4*f_max), or band cleanly).
    backend: str = "auto"

    def __post_init__(self) -> None:
        if self.precision not in ("c64", "c128"):
            raise ValueError(f"unknown precision {self.precision!r}")
        valid = ("auto",) + BACKENDS
        if self.backend not in valid:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def complex_dtype(self):
        return np.complex64 if self.precision == "c64" else np.complex128

    @property
    def real_dtype(self):
        return np.float32 if self.precision == "c64" else np.float64


# Default FFT backend per JAX platform.  On the GPU 'xla' (cuFFT on
# complex64) is golden-exact on all ten fixtures and faster than the
# 'matmul' four-step DFT at the 400x8192 headline shape (chip_smoke.py
# prints both host times).
_PLATFORM_BACKENDS = {"cpu": "xla", "gpu": "xla"}


def backend_for_platform(platform: str) -> str:
    """Backend-resolution rule as a pure function of the jax platform
    name; a platform with no entry is an error, not a default."""
    try:
        return _PLATFORM_BACKENDS[platform]
    except KeyError:
        raise ValueError(
            f"no default FFT backend for JAX platform {platform!r} "
            f"(known: {', '.join(sorted(_PLATFORM_BACKENDS))}); pass "
            "backend= explicitly") from None


def default_backend() -> str:
    """The FFT backend for the active JAX platform."""
    import jax

    return backend_for_platform(jax.default_backend())


_CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself); otherwise the cache lives at a fixed directory of the
    checkout (``.jax_cache/``, git-ignored), so later runs hit it."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_CHECKOUT_CACHE))
    return str(_CHECKOUT_CACHE)


def as_grid(freqs_hz, dtype=np.float32) -> np.ndarray:
    """Validated doppler search grid: non-empty 1-D finite array.

    Every engine converts its ``freqs_hz`` argument through this at the
    host boundary — an empty grid otherwise dies much later in a
    cryptic argmax-of-empty, and a NaN/inf bin silently reports a
    non-finite "peak frequency"."""
    g = np.asarray(freqs_hz, dtype=dtype)
    if g.ndim != 1 or g.size == 0:
        raise ValueError(
            f"frequency grid must be a non-empty 1-D array, got shape "
            f"{g.shape}")
    if not np.all(np.isfinite(g)):
        raise ValueError("frequency grid contains non-finite values")
    return g


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def xcor_length(needle_len: int) -> int:
    """Zero-padded cross-correlation length.

    The reference pads both operands to 2N (``caf_rust/src/caf/mod.rs:79-80``,
    ``caf_go/caf.go:102-103``) and its fixtures are power-of-two sized; for
    arbitrary N we round 2N up to a power of two so every backend (XLA FFT,
    matmul-FFT, segmented) sees a friendly size.
    """
    return next_pow2(2 * needle_len)


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def floor_pow2(n: int) -> int:
    """Largest power of two <= n (0 for n <= 0)."""
    if n <= 0:
        return 0
    while not is_pow2(n):
        n &= n - 1
    return n


def log2_int(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"{n} is not a power of two")
    return int(math.log2(n) + 0.5)
