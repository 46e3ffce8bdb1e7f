"""Stein time-segmented engine tests.

The algorithm from the paper the reference cites but never implements
(``README.md:159-161``): segment correlations shared across doppler
bins + one synthesis matmul, with exact top-k refinement for bin-exact
peaks.
"""

import numpy as np
import pytest

from caf_cookoff_tpu.config import FreqGrid
from caf_cookoff_tpu.models.filterbank import caf_peak, caf_surface
from caf_cookoff_tpu.models.stein import stein_caf_peak, stein_caf_surface

FS = 48_000.0


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", [
    (0, FreqGrid(-100.0, 100.0, 0.25), 69.25, 202),
    (2, FreqGrid(30.0, 35.0, 0.05), 32.15, 169),   # finest grid (0.05 Hz)
    (4, FreqGrid(80.0, 100.0, 0.1), 82.9, 70),
    (9, FreqGrid(-100.0, 100.0, 0.5), 61.5, 176),
])
@pytest.mark.parametrize("block_len", [32, 64])
def test_stein_golden(chirp, idx, grid, want_freq, want_lag, block_len):
    needle, haystack, _ = chirp(idx)
    freq, lag, _ = stein_caf_peak(needle, haystack,
                                  grid.frequencies(np.float32), FS,
                                  block_len=block_len)
    assert freq == pytest.approx(want_freq, abs=1e-4)
    assert lag == want_lag


def test_stein_surface_envelope(chirp):
    """The segmented surface equals the filterbank surface up to the
    smooth sinc(w D / 2) per-bin envelope: same peak bin, value within
    the predicted attenuation."""
    needle, haystack, _ = chirp(0)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    a = np.asarray(caf_surface(needle, haystack, freqs, FS))
    b = np.asarray(stein_caf_surface(needle, haystack, freqs, FS,
                                     block_len=64))
    ka, ta = np.unravel_index(a.argmax(), a.shape)
    kb, tb = np.unravel_index(b.argmax(), b.shape)
    assert (ka, ta) == (kb, tb)
    f_pk = float(freqs[ka])
    x = np.pi * abs(f_pk) * 64 / FS
    predicted = (np.sin(x) / x) ** 2
    assert b.max() / a.max() == pytest.approx(predicted, rel=0.02)


def test_stein_backend_dispatch(chirp):
    """caf_peak/caf_surface route backend='stein' to the engine."""
    needle, haystack, _ = chirp(0)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    assert caf_peak(needle, haystack, freqs, FS,
                    backend="stein")[:2] == (69.25, 202)
    surf = caf_surface(needle, haystack, freqs, FS, backend="stein")
    assert surf.shape == (len(freqs), 8192)


def test_stein_raw_lag_exact(chirp):
    """Unrefined Stein: lag is always exact (phase error only perturbs
    the doppler axis)."""
    needle, haystack, truth = chirp(5)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    _, lag, _ = stein_caf_peak(needle, haystack, freqs, FS, refine=False)
    assert lag == truth.lag_samples


def test_stein_overlap_save_golden(fixture_pairs):
    """Full (untruncated) haystack search via the segmented scan + exact
    window refinement."""
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak
    from caf_cookoff_tpu.utils.io import load_c64

    needle = load_c64(fixture_pairs[0][0])
    haystack = load_c64(fixture_pairs[0][1])  # full length
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    freq, lag, _ = stein_overlap_save_peak(needle, haystack, freqs, FS)
    assert (freq, lag) == (69.25, 202)


def test_stein_overlap_save_synthetic_long():
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak

    rng = np.random.default_rng(5)
    n, total, lag, f_true = 512, 65536, 51_200, -350.0
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-400.0, 400.0, 50.0, dtype=np.float32)
    freq, got_lag, _ = stein_overlap_save_peak(needle, hay, freqs, FS)
    assert (freq, got_lag) == (f_true, lag)


def test_stein_wide_span_guard():
    """Doppler spans beyond the approximation's validity raise with a
    pointer to the exact backends."""
    from caf_cookoff_tpu.models.stein import stein_caf_peak

    rng = np.random.default_rng(6)
    n = 128
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    with pytest.raises(ValueError, match="segmented"):
        stein_caf_peak(x, x, freqs, FS)


def test_stein_non_divisible_block():
    """Needle length not divisible by block_len pads cleanly."""
    rng = np.random.default_rng(9)
    n = 500  # not divisible by 64
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = np.roll(needle, 33)
    freqs = np.arange(-500.0, 500.0, 100.0, dtype=np.float32)
    freq, lag, _ = stein_caf_peak(needle, hay, freqs, FS)
    assert (freq, lag) == (0.0, 33)


def test_stein_needle_shorter_than_block():
    """A 40-sample needle (shorter than the 64-sample segment default)
    degenerates to one block and still recovers the injected offsets."""
    rng = np.random.default_rng(14)
    n = 40
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = np.zeros(n, dtype=np.complex64)
    hay[7:] = needle[: n - 7]
    freqs = np.arange(-100.0, 100.0, 25.0, dtype=np.float32)
    freq, lag, _ = stein_caf_peak(needle, hay, freqs, FS)
    assert (freq, lag) == (0.0, 7)


def test_banded_wide_span_matches_filterbank():
    """Spans far past the single-segment envelope (old guard: raise)
    run the banded path and match the exact filterbank engine."""
    rng = np.random.default_rng(12)
    n = 4096
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    for f_true, lag, g0, gs, gk in [(4300.0, 512, -6000.0, 100.0, 120),
                                    (-9750.0, 64, -10000.0, 250.0, 80)]:
        hay = np.zeros(n, np.complex64)
        hay[lag:] = (needle * np.exp(
            2j * np.pi * f_true * np.arange(n) / FS)
        ).astype(np.complex64)[: n - lag]
        freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
        from caf_cookoff_tpu.models.filterbank import caf_peak

        exact = caf_peak(needle, hay, freqs, FS, backend="matmul")
        banded = stein_caf_peak(needle, hay, freqs, FS)
        assert banded[:2] == exact[:2] == (f_true, lag)


def test_banded_emitters_in_different_bands():
    """Two emitters landing in different bands: the global top-k ranks
    across bands and the exact re-score picks the true winner."""
    rng = np.random.default_rng(13)
    n = 4096
    t = np.arange(n)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(n, np.complex64)
    strong = (needle * np.exp(2j * np.pi * 5200.0 * t / FS))
    weak = 0.7 * (needle * np.exp(2j * np.pi * -4400.0 * t / FS))
    hay[100:] = (strong + weak).astype(np.complex64)[: n - 100]
    freqs = np.arange(-6000.0, 6000.0, 200.0, dtype=np.float32)
    freq, lag, _ = stein_caf_peak(needle, hay, freqs, FS)
    assert (freq, lag) == (5200.0, 100)


def test_banded_rejected_for_nonuniform_or_explicit_fused():
    rng = np.random.default_rng(14)
    n = 1024
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    wide_nonuniform = np.array([-9000.0, -100.0, 50.0, 8000.0], np.float32)
    with pytest.raises(ValueError):
        stein_caf_peak(needle, needle, wide_nonuniform, FS)
    # Without the exact re-score the banded path does not run, and the
    # single-band engine cannot take the span.
    wide = np.arange(-9000.0, 9000.0, 500.0, dtype=np.float32)
    with pytest.raises(ValueError):
        stein_caf_peak(needle, needle, wide, FS, refine=False)


def _exact_value_at(needle, window, freq, fs):
    """True |R|^2 of ``needle`` vs the full-energy ``window`` at local
    lag 0 and one frequency — the oracle for refined peak VALUES."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.config import xcor_length
    from caf_cookoff_tpu.models.filterbank import _surface_split_jit
    from caf_cookoff_tpu.ops import splitfft

    nr, ni = splitfft.split_array(needle)
    wr, wi = splitfft.split_array(window)
    surf = _surface_split_jit(jnp.asarray(nr), jnp.asarray(ni),
                              jnp.asarray(wr), jnp.asarray(wi),
                              jnp.asarray(np.float32([freq])), fs,
                              xcor_length(len(needle)), "xla")
    return float(surf[0, 0])


def test_stein_os_refined_value_full_energy():
    """The refined VALUE matches the true exact |R|^2 at the winning
    (bin, lag): the guard-extended re-score window keeps every needle
    sample correlating against real data (a needle-length window
    zero-truncated the last ``guard`` products and biased values low)."""
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak

    rng = np.random.default_rng(17)
    n, total, lag, f_true = 2048, 16384, 9000, 250.0
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = (0.01 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    freq, got_lag, value = stein_overlap_save_peak(needle, hay, freqs, FS)
    assert (freq, got_lag) == (f_true, lag)
    oracle = _exact_value_at(needle, hay[lag:lag + n], f_true, FS)
    assert value == pytest.approx(oracle, rel=1e-4)


def test_plan_bands_picks_cost_optimal_pow2():
    """The planner must evaluate its cost model s*(1 + kb/D) at every
    pow2, not floor sqrt(fs/2g): for a 100 Hz pitch over +-6 kHz the
    floor heuristic chose D=8 (cost 19); D=16 is cheaper (15.5)."""
    from caf_cookoff_tpu.models.stein import _plan_bands

    plan = _plan_bands(FS, np.arange(-6000.0, 6000.0, 100.0, np.float32))
    assert plan["block_len"] == 16
    assert plan["bands"] * plan["kb"] >= 120
    # Fine dense grids keep the largest block the model allows.
    plan = _plan_bands(FS, np.linspace(-500, 500, 2000, endpoint=False)
                       .astype(np.float32))
    assert plan["block_len"] == 128
    # No candidate may beat the returned one under the same model.
    for g, span in [(100.0, 6000.0), (15.0, 6000.0), (0.5, 500.0),
                    (2.0, 1500.0), (250.0, 12000.0)]:
        freqs = np.arange(-span, span, g, dtype=np.float32)
        plan = _plan_bands(FS, freqs)
        cost = plan["bands"] * (1.0 + plan["kb"] / plan["block_len"])
        k = len(freqs)
        for d in (8, 16, 32, 64, 128):
            kb = max(1, int(FS / (2.0 * d * g)))
            s = -(-k // kb)
            assert cost <= s * (1.0 + kb / d) + 1e-9, (g, span, d)
