"""Golden-answer integration tests.

Ports the reference's test pattern (``caf_rust/tests/test.rs``): run a full
CAF surface on a generated chirp pair whose filename encodes ground truth
and assert the recovered (freq, lag) exactly equals the nearest grid point
to the injected offset. Expected values below are the literal asserts from
``test.rs:14-316``.
"""

import numpy as np
import pytest

from caf_cookoff_tpu.config import CafConfig, FreqGrid
from caf_cookoff_tpu.models.filterbank import (
    FilterbankCAF,
    amb_surf,
    caf_peak,
    caf_surface,
    find_peak,
)

FS = 48_000.0

# (chirp index, grid, expected freq Hz, expected lag samples)
# Grids and asserts match caf_rust/tests/test.rs per chirp.
GOLDEN = [
    (0, FreqGrid(-100.0, 100.0, 0.25), 69.25, 202),
    (1, FreqGrid(-50.0, 50.0, 1.0), 36.0, 78),
    (2, FreqGrid(30.0, 35.0, 0.05), 32.15, 169),
    (3, FreqGrid(-100.0, 100.0, 0.25), -76.25, 151),
    (4, FreqGrid(80.0, 100.0, 0.1), 82.9, 70),
    (5, FreqGrid(-100.0, 100.0, 0.25), -92.75, 177),
    (6, FreqGrid(-100.0, 100.0, 0.25), -49.75, 15),
    (7, FreqGrid(-100.0, 100.0, 0.25), 68.25, 84),
    (8, FreqGrid(-100.0, 100.0, 0.25), -46.25, 80),
    (9, FreqGrid(-100.0, 100.0, 0.5), 61.5, 176),
]


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_golden_peaks(chirp, idx, grid, want_freq, want_lag):
    needle, haystack, truth = chirp(idx)
    freqs = grid.frequencies(np.float32)
    surface = caf_surface(needle, haystack, freqs, FS)
    freq, lag = find_peak(surface, freqs)
    assert freq == pytest.approx(want_freq, abs=1e-4)
    assert lag == want_lag
    # The filename-encoded truth is within one grid bin of the estimate.
    assert abs(freq - truth.freq_hz) <= grid.step_hz
    assert lag == truth.lag_samples


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_backends_agree_chirp0(chirp, backend):
    """Cross-strategy consistency, the test.rs:15-145 pattern: every
    backend must produce the identical peak."""
    needle, haystack, _ = chirp(0)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    freq, lag, _ = caf_peak(needle, haystack, freqs, FS, backend=backend)
    assert (freq, lag) == (69.25, 202)


def test_fused_peak_matches_surface_argmax(chirp):
    needle, haystack, _ = chirp(3)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    surface = np.asarray(caf_surface(needle, haystack, freqs, FS))
    k, t = np.unravel_index(surface.argmax(), surface.shape)
    freq, lag, val = caf_peak(needle, haystack, freqs, FS)
    assert (freqs[k], t) == (np.float32(freq), lag)
    assert val == pytest.approx(surface.max(), rel=1e-6)


def test_python_convention_amb_surf(chirp):
    """Parity with caf_python/caf.py __main__ (:144-146): mode='same'
    layout, tau = N//2 - argmax."""
    needle, haystack, truth = chirp(4)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    surf = np.asarray(amb_surf(needle, haystack, freqs, FS))
    assert surf.shape == (len(freqs), len(needle))
    fmax, tmax = np.unravel_index(surf.argmax(), surf.shape)
    assert len(needle) // 2 - tmax == truth.lag_samples == 70
    assert freqs[fmax] == pytest.approx(83.0)  # nearest 0.5 Hz bin to 82.89


def test_amb_surf_matches_scipy_oracle(chirp):
    """Unit-level parity the reference never had: one amb_surf row equals
    scipy.signal.correlate(shifted, haystack, mode='same') magnitudes."""
    from scipy import signal as sp_signal

    needle, haystack, _ = chirp(1)
    f = np.float32(13.5)
    shifted = needle * np.exp(2j * np.pi * f * np.arange(len(needle)) / FS)
    want = np.abs(sp_signal.correlate(shifted, haystack, mode="same", method="fft"))
    got = np.asarray(amb_surf(needle, haystack, np.array([f]), FS))[0]
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-3, atol=2e-3)


def test_c128_parity_mode(chirp):
    """complex128 reference mode matches the reference's precision regime
    and the c64 answer (SURVEY §7 'Hard parts': precision)."""
    import jax

    needle, haystack, _ = chirp(0)
    grid = FreqGrid(-100.0, 100.0, 0.25)
    engine64 = FilterbankCAF(CafConfig(grid=grid, precision="c64"))
    assert engine64.peak(needle, haystack) == (69.25, 202)
    # c128 end-to-end (the reference's native regime) under x64.
    with jax.enable_x64(True):
        engine128 = FilterbankCAF(CafConfig(grid=grid, precision="c128"))
        assert engine128.peak(needle, haystack) == (69.25, 202)


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_c128_matmul_goldens(chirp, idx, grid, want_freq, want_lag):
    """The matmul-DFT path at complex128: all ten fixtures under x64
    (the reference computes c128 end-to-end,
    caf_rust/src/utils.rs:10-35).  Constants are built in float64
    (ops/splitfft.py _dft_constants_np), so the same stacked-real-matmul
    four-step runs at full f64 — c128 is the parity regime,
    c64+rank-then-score the production one (ARCHITECTURE.md)."""
    import jax

    needle, haystack, _ = chirp(idx)
    with jax.enable_x64(True):
        engine = FilterbankCAF(CafConfig(grid=grid, precision="c128",
                                         backend="matmul"))
        freq, lag = engine.peak(needle, haystack)
    assert freq == pytest.approx(want_freq, abs=1e-9)
    assert lag == want_lag


def test_c128_matmul_is_true_f64(chirp):
    """Numerical (not just argmax) proof of the f64 matmul DFT: one
    c128 correlation row matches the scipy complex128 oracle ~1e-12
    relative — far beyond anything f32/bf16 arithmetic could produce."""
    import jax
    from scipy import signal as sp_signal

    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops import splitfft

    needle, haystack, _ = chirp(1)
    n128 = needle.astype(np.complex128)
    h128 = haystack[: len(needle)].astype(np.complex128)
    f = 13.5
    m = 8192
    shifted = n128 * np.exp(2j * np.pi * f * np.arange(len(n128)) / 48e3)
    full = sp_signal.correlate(np.pad(h128, (0, m - len(h128))),
                               np.pad(shifted, (0, m - len(shifted))),
                               mode="full", method="fft")
    # The engine's rows are circular over M: negative linear lags fold
    # onto tau in (M-N, M).
    want = full[m - 1: 2 * m - 1].copy()
    want[1:] += full[: m - 1]
    with jax.enable_x64(True):
        rows = _surface_rows_split(
            splitfft.split_array(n128), splitfft.split_array(h128),
            np.array([f], np.float64), 48e3, m, "matmul")
        got = splitfft.merge_split((rows[0][0], rows[1][0]))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9)


def test_determinism(chirp):
    """Bitwise-identical surface across runs (XLA is race-free by
    construction — the property the reference leans on language runtimes
    for, SURVEY §5)."""
    needle, haystack, _ = chirp(2)
    freqs = FreqGrid(30.0, 35.0, 0.05).frequencies(np.float32)
    s1 = np.asarray(caf_surface(needle, haystack, freqs, FS))
    s2 = np.asarray(caf_surface(needle, haystack, freqs, FS))
    np.testing.assert_array_equal(s1, s2)


def test_c128_long_capture_engines():
    """c128 parity extends to the LONG-CAPTURE family (the reference's
    native precision regime over full captures): the overlap-save scan,
    the Stein OS engine, and StreamingCAF, all under x64.  Regression:
    the scans' int32 lag carries must not widen mid-scan (a default
    arange is int64 under x64, which aborted tracing)."""
    import pathlib

    import jax

    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak
    from caf_cookoff_tpu.models.streaming import StreamingCAF
    from caf_cookoff_tpu.utils.io import load_c64

    data = pathlib.Path(__file__).resolve().parents[1] / "data"
    needle = load_c64(data / "chirp_0_raw.c64").astype(np.complex128)
    full = load_c64(data / "chirp_0_T+202samp_F+69.25Hz.c64"
                    ).astype(np.complex128)
    freqs = np.arange(-100, 100, 0.25, dtype=np.float64)
    with jax.enable_x64(True):
        assert overlap_save_peak(needle, full, freqs, FS,
                                 backend="matmul")[:2] == (69.25, 202)
        assert stein_overlap_save_peak(needle, full, freqs, FS,
                                       backend="matmul")[:2] == (69.25, 202)
        s = StreamingCAF(needle, freqs, FS, chunk_len=4096,
                         backend="matmul")
        for i in range(0, len(full), 4096):
            s.process(full[i:i + 4096])
        assert s.best()[:2] == (69.25, 202)
