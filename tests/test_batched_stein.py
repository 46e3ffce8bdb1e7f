"""Batched Stein engine (config-2 path): direct-dot stage A + the
coarse synthesis/rank stage + batched top-k re-score.

Contract: per-pair answers bit-match the single-pair Stein engine
(which itself matches the golden filterbank) — the cross-strategy
consistency pattern of ``caf_rust/tests/test.rs:15-145`` applied to the
batch axis.
"""

import numpy as np
import pytest

from caf_cookoff_tpu.models.batched_stein import (
    _pow2_block_len,
    batched_stein_peak,
)
from caf_cookoff_tpu.models.stein import stein_caf_peak

FS = 48_000.0


@pytest.fixture(scope="module")
def grid():
    return np.arange(-100.0, 100.0, 0.5, dtype=np.float32)


def test_batched_matches_single_goldens(chirp, grid):
    idxs = [0, 2, 4, 6, 9]
    needles, hays, singles = [], [], []
    for i in idxs:
        n, h, _ = chirp(i)
        needles.append(n)
        hays.append(h)
        singles.append(stein_caf_peak(n, h, grid, FS)[:2])
    fr, lg, _ = batched_stein_peak(np.stack(needles), np.stack(hays),
                                   grid, FS)
    for b, want in enumerate(singles):
        assert (float(fr[b]), int(lg[b])) == want


def test_batched_fine_grid_golden(chirp):
    """801-bin 0.25 grid — odd K exercises the kernel's row padding."""
    freqs = np.arange(-100.0, 100.001, 0.25, dtype=np.float32)
    n0, h0, _ = chirp(0)
    n3, h3, _ = chirp(3)
    fr, lg, _ = batched_stein_peak(np.stack([n0, n3]),
                                   np.stack([h0, h3]), freqs, FS)
    assert (float(fr[0]), int(lg[0])) == (69.25, 202)
    assert (float(fr[1]), int(lg[1])) == (-76.25, 151)


def test_batched_negative_lag_circular():
    """An advanced (negative-lag) emitter lands in the circular wrap
    region tau in (N, 2N) — the conv's periodic haystack extension must
    reproduce the FFT engine's mod-M indexing exactly."""
    rng = np.random.default_rng(3)
    n = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    h = np.zeros(4096, np.complex64)
    h[: 4096 - 300] = n[300:]
    freqs = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    fr, lg, _ = batched_stein_peak(n[None], h[None], freqs, FS)
    want = stein_caf_peak(n, h, freqs, FS)
    assert (float(fr[0]), int(lg[0])) == want[:2] == (0.0, 8192 - 300)


def test_batched_wide_span_small_blocks():
    """+-1500 Hz span clamps the block length to 8 (pow2-rounded);
    group-16 super-blocks still recover the emitter exactly."""
    rng = np.random.default_rng(4)
    n = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    lag, f_true = 777, -1250.0
    h = np.zeros(4096, np.complex64)
    h[lag:] = (n * np.exp(2j * np.pi * f_true
                          * np.arange(4096) / FS))[: 4096 - lag]
    freqs = np.arange(-1500.0, 1500.0, 125.0, dtype=np.float32)
    fr, lg, _ = batched_stein_peak(n[None], h[None], freqs, FS)
    assert (float(fr[0]), int(lg[0])) == (f_true, lag)


def test_batched_os_matches_single_chip():
    """Windowed long-capture engine (config 4): per-pair answers match
    the single-chip overlap-save engine, including an emitter at the
    FINAL valid lag and one whose window straddles a window boundary."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak

    rng = np.random.default_rng(8)
    p, n, total = 3, 4096, 32768 + 4096
    lags = [300, 8190, 32768]          # 8190 straddles the 8192 boundary
    f_true = [-375.0, 0.0, 375.0]
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((p, total))
                    + 1j * rng.standard_normal((p, total))
                    )).astype(np.complex64)
    t = np.arange(n)
    for b in range(p):
        span = min(n, total - lags[b])
        hays[b, lags[b]:lags[b] + span] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)[:span]
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    fr, lg, _ = batched_stein_os_peak(needles, hays, freqs, FS)
    for b in range(p):
        want = overlap_save_peak(needles[b], hays[b], freqs, FS,
                                 backend="xla")
        assert (float(fr[b]), int(lg[b])) == want[:2] == (
            f_true[b], lags[b])


def test_batched_os_golden_fixture(chirp):
    """Full-capture golden search through the windowed engine."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.utils.io import load_c64

    import pathlib

    data = pathlib.Path(__file__).resolve().parents[1] / "data"
    needle = load_c64(data / "chirp_0_raw.c64")
    full_hay = load_c64(data / "chirp_0_T+202samp_F+69.25Hz.c64")
    freqs = np.arange(-100.0, 100.0, 0.25, dtype=np.float32)
    fr, lg, _ = batched_stein_os_peak(needle[None], full_hay[None],
                                      freqs, FS)
    assert (float(fr[0]), int(lg[0])) == (69.25, 202)


def _coarse_reference(needles, hays, freqs, num_lags, bound=None):
    """Plain complex128 filterbank per program: ``|sum_s h[s+tau]
    conj(n[s]) e^{-j w_k s}|^2`` for tau < num_lags (np.correlate
    conjugates its second operand), masked past ``bound``.  Returns
    (K, P) per-bin (max, argmax) and the (P, K, num_lags) rows."""
    t = np.arange(needles.shape[-1])
    rows = np.empty((len(needles), len(freqs), num_lags))
    for i, (nd, h) in enumerate(zip(needles.astype(np.complex128),
                                    hays.astype(np.complex128))):
        for k, f in enumerate(np.asarray(freqs, np.float64)):
            shifted = nd * np.exp(2j * np.pi * f * t / FS)
            rows[i, k] = np.abs(np.correlate(h, shifted, "valid")
                                [:num_lags]) ** 2
        if bound is not None:
            rows[i, :, bound[i]:] = -1.0
    return rows.max(-1).T, rows.argmax(-1).T, rows


def _run_coarse(needles, hay_slices, freqs, d, num_lags, **kw):
    """coarse_rank on complex needles (one per operator) and complex
    haystack slices (one per h_ext row)."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.models.batched_stein import (
        SUPER,
        _needle_operator,
        coarse_rank,
        fused_span,
        stein_synthesis_weights,
    )
    from caf_cookoff_tpu.ops.splitfft import split_array

    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    b = ns_re.shape[-1] // d
    lmat, sup = _needle_operator(ns_re, ns_im, d)
    span = fused_span(b, sup, num_lags)
    need = span + SUPER - 1
    h = np.zeros((len(hay_slices), need), np.complex64)
    for i, sl in enumerate(hay_slices):
        h[i, :min(len(sl), need)] = sl[:need]
    h_ext = jnp.asarray(np.stack([h.real, h.imag], axis=1))
    ws1, ws2 = stein_synthesis_weights(jnp.asarray(freqs), FS, b, d)
    out = coarse_rank(ws1, ws2, lmat, h_ext, b, sup, num_lags, **kw)
    return [np.asarray(o) for o in out], h


def _plant(n_needle, length, emitters, rng):
    """(needle, capture): needle copies at (lag, freq_hz, amp) over
    low-level noise."""
    t = np.arange(n_needle)
    needle = (rng.standard_normal(n_needle)
              + 1j * rng.standard_normal(n_needle)).astype(np.complex64)
    hay = (1e-3 * (rng.standard_normal(length)
                   + 1j * rng.standard_normal(length))).astype(np.complex64)
    for lag, f_hz, amp in emitters:
        hay[lag:lag + n_needle] += amp * (needle * np.exp(
            2j * np.pi * f_hz * t / FS))[: length - lag]
    return needle, hay


# Bins within +-40 Hz of 0 at D=64: the block-constant phase error
# (w*D/2 <= 0.17 rad) moves a row's value by at most ~1% of the coherent
# peak's power, so coarse maxima sit within 2% OF THE SURFACE PEAK of
# the c128 filterbank's, and every per-bin argmax lands on the planted
# emitter.
_COARSE_RTOL = 2e-2


def _assert_close_to_peak(got, want):
    scale = np.max(want)
    np.testing.assert_allclose(got / scale, want / scale,
                               atol=_COARSE_RTOL)


@pytest.mark.parametrize("mode", ["plain", "num_valid", "want_top2",
                                  "share_h", "windows"])
def test_coarse_rank_matches_c128_filterbank(mode):
    """coarse_rank in each of its modes against the plain complex128
    filterbank of every program's (needle, haystack slice)."""
    rng = np.random.default_rng(21)
    n, d, m = 512, 64, 1024
    freqs = np.linspace(-40, 40, 9).astype(np.float32)
    kw, bound = {}, None
    if mode in ("plain", "want_top2", "num_valid"):
        emit = {"plain": [[(100, 10.0, 1.0)], [(700, -20.0, 1.0)]],
                "want_top2": [[(100, 0.0, 1.0), (400, 0.0, 0.6)],
                              [(650, 10.0, 1.0), (90, 10.0, 0.7)]],
                "num_valid": [[(300, 0.0, 1.0), (900, 0.0, 3.0)],
                              [(200, 20.0, 1.0), (800, 20.0, 3.0)]]
                }[mode]
        pairs = [_plant(n, n + m + 64, e, rng) for e in emit]
        needles = np.stack([p[0] for p in pairs])
        hays = [p[1] for p in pairs]
        prog_needles, prog_hays = needles, hays
        if mode == "want_top2":
            kw = {"want_top2": True, "sep": 50}
        if mode == "num_valid":
            # The stronger decoy past the bound must not shadow the
            # in-range emitter of the same bin.
            bound = np.array([600, 500], np.int32)
            kw = {"num_valid": bound}
    elif mode == "share_h":
        needle, hay = _plant(n, n + m + 64, [(333, 5.0, 1.0)], rng)
        shifts = np.exp(2j * np.pi * np.array([[0.0], [12.0]])
                        * np.arange(n) / FS)
        prog_needles = (needle[None] * shifts).astype(np.complex64)
        needles, hays = prog_needles, [hay]
        prog_hays = [hay, hay]
        kw = {"share_h": 2}
    else:                                   # windows
        needle, hay = _plant(n, 2 * m + n + 64,
                             [(250, 0.0, 1.0), (m + 480, 30.0, 1.0)], rng)
        needles = needle[None]
        hays = [hay[w * m:] for w in range(2)]
        prog_needles = np.stack([needle, needle])
        prog_hays = hays
        kw = {"windows": 2}
    out, h = _run_coarse(needles, hays, freqs, d, m, **kw)
    prog_h = h if mode != "share_h" else np.concatenate([h, h])
    del prog_hays
    ref_v, ref_i, rows = _coarse_reference(prog_needles, prog_h, freqs, m,
                                           bound)
    _assert_close_to_peak(out[0], ref_v)
    np.testing.assert_array_equal(out[1], ref_i)
    if mode == "want_top2":
        lag = np.arange(m)
        masked = np.where(np.abs(lag[None, None] - ref_i.T[..., None])
                          <= 50, -1.0, rows)
        _assert_close_to_peak(out[2], masked.max(-1).T)
        np.testing.assert_array_equal(out[3], masked.argmax(-1).T)


def test_fused_kernel_tie_break_min_lag():
    """Exact cross-tile ties resolve to the MINIMUM lag.

    Two bit-identical copies of the needle placed at lags in different
    512-lag tiles produce bit-for-bit equal per-block correlations, so
    every (bin, lag) value ties between the two lags; the contract
    (shared with find_peak_2d) is that the earlier lag wins."""
    rng = np.random.default_rng(11)
    n, d, k, m = 512, 64, 17, 4096
    lag_a, lag_b = 100, 6 * 512 + 100          # tiles 0 and 6
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(lag_b + n, np.complex64)
    hay[lag_a:lag_a + n] = needle
    hay[lag_b:lag_b + n] = needle
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    (_, ki), _ = _run_coarse(needle[None], [hay], freqs, d, m)
    zero_bin = k // 2                          # linspace midpoint = 0 Hz
    assert ki[zero_bin, 0] == lag_a


def test_fused_kernel_single_tile():
    """num_lags <= FUSED_TILE (one lag tile) against the c128
    filterbank, bin for bin."""
    rng = np.random.default_rng(12)
    n, d, m = 256, 64, 512
    freqs = np.linspace(-40, 40, 9).astype(np.float32)
    pairs = [_plant(n, n + m + 64, [(lag, f, 1.0)], rng)
             for lag, f in ((40, 10.0), (300, -30.0))]
    needles = np.stack([p[0] for p in pairs])
    (kv, ki), h = _run_coarse(needles, [p[1] for p in pairs], freqs, d, m)
    ref_v, ref_i, _ = _coarse_reference(needles, h, freqs, m)
    np.testing.assert_array_equal(ki, ref_i)
    _assert_close_to_peak(kv, ref_v)


def test_fused_kernel_static_tail_mask():
    """num_lags below FUSED_TILE (N=128 -> xcor length 256): lags past
    num_lags are masked out of every bin's (max, argmax), even where a
    stronger correlation sits there."""
    from caf_cookoff_tpu.models.batched_stein import FUSED_TILE

    rng = np.random.default_rng(13)
    n, d, m = 128, 32, 256
    assert m < FUSED_TILE                   # the branch under test
    freqs = np.linspace(-40, 40, 9).astype(np.float32)
    needle, hay = _plant(n, n + FUSED_TILE + 64,
                         [(60, 0.0, 1.0), (400, 0.0, 3.0)], rng)
    (kv, ki), h = _run_coarse(needle[None], [hay], freqs, d, m)
    assert int(np.max(ki)) < m              # no masked lag leaked
    ref_v, ref_i, _ = _coarse_reference(needle[None], h, freqs, m)
    np.testing.assert_array_equal(ki, ref_i)
    _assert_close_to_peak(kv, ref_v)


def test_pow2_block_len():
    freqs100 = np.array([100.0], np.float32)
    assert _pow2_block_len(48e3, freqs100, 64) == 64
    # limit 48000/(4*500) = 24 -> pow2 16
    assert _pow2_block_len(48e3, np.array([500.0], np.float32), 64) == 16
    with pytest.raises(ValueError):
        _pow2_block_len(48e3, np.array([3000.0], np.float32), 64)


def test_batched_shape_validation(grid):
    with pytest.raises(ValueError):
        batched_stein_peak(np.zeros((2, 64), np.complex64),
                           np.zeros((3, 64), np.complex64), grid, FS)


def test_batched_os_small_needle_and_short_capture():
    """Review regressions: the OS refine slices the ORIGINAL needle
    length (not the SUPER-padded one) — a 64-sample needle (padded to
    128) must not wrap real samples through the M-point re-score, and a
    capture barely longer than the needle must not overrun."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak

    rng = np.random.default_rng(17)
    n, total, lag, f_true = 64, 4096 + 50, 3000, 750.0
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += (needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS)).astype(np.complex64)
    freqs = np.arange(-1500.0, 1500.0, 375.0, dtype=np.float32)
    # A 64-sample needle's doppler mainlobe (fs/n = 750 Hz) spans two
    # grid steps, so assert parity with the EXACT engine, not the
    # injection (both can legitimately settle on a neighboring cell).
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak

    want = overlap_save_peak(needle, hay, freqs, FS, backend="xla")
    fr, lg, _ = batched_stein_os_peak(needle[None], hay[None], freqs, FS)
    assert (float(fr[0]), int(lg[0])) == want[:2]
    # capture barely longer than needle (dynamic_slice bound check)
    short = hay[: n + 8]
    fr2, lg2, _ = batched_stein_os_peak(needle[None], short[None],
                                        freqs, FS)
    assert int(lg2[0]) < n + 8


def test_banded_tiny_grid_stays_on_grid():
    """A wide-span grid SMALLER than the refine width: padded bins must
    never reach the exact re-score (returned freq stays on the grid)."""
    from caf_cookoff_tpu.models.stein import stein_caf_peak

    rng = np.random.default_rng(18)
    n = 1024
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    # Emitter just past the last requested bin: the answer must still
    # be one of the 5 requested frequencies.
    hay = (needle * np.exp(
        2j * np.pi * 7400.0 * np.arange(n) / FS)).astype(np.complex64)
    freqs = np.arange(-5000.0, 7000.0, 2400.0, dtype=np.float32)  # 5 bins
    freq, _, _ = stein_caf_peak(needle, hay, freqs, FS)
    assert freq in [float(f) for f in freqs]


def test_batched_os_value_full_energy():
    """Refined VALUES are the true exact |R|^2 at each pair's winning
    (bin, lag) — the guard-extended window must not truncate
    correlation energy (a needle-length slice biased values ~3% low)."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from tests.test_stein import _exact_value_at

    rng = np.random.default_rng(19)
    p, n, total = 2, 2048, 16384
    lags, f_true = [9000, 3333], [250.0, -125.0]
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = (0.01 * (rng.standard_normal((p, total))
                    + 1j * rng.standard_normal((p, total))
                    )).astype(np.complex64)
    t = np.arange(n)
    for b in range(p):
        hays[b, lags[b]:lags[b] + n] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    fr, lg, val = batched_stein_os_peak(needles, hays, freqs, FS)
    for b in range(p):
        assert (float(fr[b]), int(lg[b])) == (f_true[b], lags[b])
        oracle = _exact_value_at(needles[b],
                                 hays[b, lags[b]:lags[b] + n],
                                 f_true[b], FS)
        assert float(val[b]) == pytest.approx(oracle, rel=1e-4)


def test_batched_os_refine_respects_lag_range():
    """A stronger emitter JUST past ``num_lags`` falls inside the
    refine window of the in-range winner; the re-score lag mask must
    keep the reported lag inside the requested range."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak

    rng = np.random.default_rng(21)
    n, total, num_lags = 2048, 16384, 9000
    in_lag, out_lag = 8990, 9040
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[in_lag:in_lag + n] += (0.5 * needle).astype(np.complex64)
    hay[out_lag:out_lag + n] += needle
    freqs = np.arange(-250.0, 250.0, 125.0, dtype=np.float32)
    fr, lg, _ = batched_stein_os_peak(needle[None], hay[None], freqs, FS,
                                      num_lags=num_lags)
    assert int(lg[0]) == in_lag
    assert int(lg[0]) < num_lags


def test_banded_os_wide_span_long_capture():
    """Wide-span LONG captures (previously the engine family's last
    uncovered combination — the single-band envelope needs D < 8) run
    through the banded windowed engine and match the exact overlap-save
    answer, values included."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak
    from tests.test_stein import _exact_value_at

    rng = np.random.default_rng(33)
    n, total, lag_true, f_true = 1024, 10240, 6100, -1650.0
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-3 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag_true:lag_true + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-2000.0, 2000.0, 50.0, dtype=np.float32)
    fr, lg, val = batched_stein_os_peak(needle[None], hay[None], freqs, FS)
    want = overlap_save_peak(needle, hay, freqs, FS, backend="xla")
    assert (float(fr[0]), int(lg[0])) == want[:2] == (f_true, lag_true)
    oracle = _exact_value_at(needle, hay[lag_true:lag_true + n], f_true, FS)
    assert float(val[0]) == pytest.approx(oracle, rel=1e-4)


def test_banded_os_fine_grid_matches_plain():
    """A fine dense grid (the config-3 shape in miniature) routes
    through the banded windowed engine on cost; answers match the
    exact engine and the full-energy value oracle, for two pairs with
    emitters in different bands."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak
    from tests.test_stein import _exact_value_at

    rng = np.random.default_rng(35)
    p, n, total = 2, 1024, 10240
    lags, f_true = [6100, 2333], [-375.5, 411.0]
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = (1e-3 * (rng.standard_normal((p, total))
                    + 1j * rng.standard_normal((p, total))
                    )).astype(np.complex64)
    t = np.arange(n)
    for b in range(p):
        hays[b, lags[b]:lags[b] + n] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)
    freqs = np.arange(-500.0, 500.0, 0.5, dtype=np.float32)
    fr, lg, val = batched_stein_os_peak(needles, hays, freqs, FS)
    for b in range(p):
        want = overlap_save_peak(needles[b], hays[b], freqs, FS,
                                 backend="xla")
        assert (float(fr[b]), int(lg[b])) == want[:2] == (
            f_true[b], lags[b])
        oracle = _exact_value_at(needles[b],
                                 hays[b, lags[b]:lags[b] + n],
                                 f_true[b], FS)
        assert float(val[b]) == pytest.approx(oracle, rel=1e-4)


def test_fused_kernel_composed_windows_bands_matches_twin():
    """windows x share_h COMPOSED (banded long captures): operators per
    (pair, band), haystack slices per (pair, window), programs
    band-major, with a per-program lag bound — against the c128
    filterbank of every program."""
    rng = np.random.default_rng(14)
    p, s, w, n, d, v = 2, 2, 2, 512, 64, 1024
    total_lags = w * v - 300                    # short final window
    freqs = np.linspace(-30, 30, 7).astype(np.float32)
    shifts = np.exp(2j * np.pi * np.array([[0.0], [9.0]])
                    * np.arange(n) / FS)
    needles, slices, prog_n, prog_h = [], [], [], []
    for pair in range(p):
        nd, hay = _plant(n, w * v + n + 64,
                         [(150 + 40 * pair, 0.0, 1.0),
                          (v + 200 + 30 * pair, 9.0, 1.0),
                          # past the final window's bound, stronger
                          (v + total_lags - v + 100, 9.0, 3.0)], rng)
        band_n = (nd[None] * shifts).astype(np.complex64)
        needles.extend(band_n)
        win = [hay[i * v:] for i in range(w)]
        slices.extend(win)
        for j in range(s):
            for i in range(w):
                prog_n.append(band_n[j])
                prog_h.append(i)
    per_w = np.clip(total_lags - np.arange(w) * v, 0, v)
    bound = np.tile(per_w, p * s).astype(np.int32)
    (kv, ki), h = _run_coarse(np.stack(needles), slices, freqs, d, v,
                              windows=w, share_h=s, num_valid=bound)
    prog_hays = np.stack([h[(i // (s * w)) * w + prog_h[i]]
                          for i in range(p * s * w)])
    ref_v, ref_i, _ = _coarse_reference(np.stack(prog_n), prog_hays,
                                        freqs, v, bound)
    np.testing.assert_array_equal(ki, ref_i)
    _assert_close_to_peak(kv, ref_v)


def _windowed_case(windows, share_h=1, pairs=2, seed=15):
    """Operands of windowed_coarse_rank: (ws1, ws2, lmat, hs_re, hs_im,
    num_blocks, sup, v) for ``pairs`` captures of ``windows`` 512-lag
    windows, one needle operator per (pair, band)."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.models.batched_stein import (
        _needle_operator,
        stein_synthesis_weights,
    )

    rng = np.random.default_rng(seed)
    n, d, v = 256, 16, 512
    caps, ops = [], []
    for pair in range(pairs):
        nd, hay = _plant(n, windows * v + n,
                         [(100 + 700 * pair, 20.0, 1.0),
                          (windows * v - 90, -35.0, 0.8)], rng)
        caps.append(hay)
        for band in range(share_h):
            ops.append(nd * np.exp(2j * np.pi * 15.0 * band
                                   * np.arange(n) / FS))
    ops = np.stack(ops).astype(np.complex64)
    lmat, sup = _needle_operator(jnp.asarray(ops.real),
                                 jnp.asarray(ops.imag), d)
    freqs = jnp.linspace(-60.0, 60.0, 25, dtype=jnp.float32)
    ws1, ws2 = stein_synthesis_weights(freqs, FS, n // d, d)
    caps = np.stack(caps)
    return (ws1, ws2, lmat, jnp.asarray(caps.real), jnp.asarray(caps.imag),
            n // d, sup, v)


@pytest.mark.parametrize("mode", ["plain", "want_top2", "share_h",
                                  "first_window"])
def test_windowed_coarse_rank_groups_match_one_group(mode, monkeypatch):
    """Windows run in bounded groups (a lax.map step each, the last
    group padded) give the same per-(bin, program) answers as one group
    holding every window: 1 and 2 windows per step against all 5,
    with a lag bound that ends inside the final window."""
    import caf_cookoff_tpu.models.batched_stein as bs

    windows = 5
    share_h = 2 if mode == "share_h" else 1
    ws1, ws2, lmat, hr, hi, b, sup, v = _windowed_case(windows, share_h)
    kw = {"share_h": share_h}
    total = windows * v - 200
    if mode == "want_top2":
        kw.update(want_top2=True, sep=40)
    if mode == "first_window":
        # A mesh shard's view: windows 2..4 of a 5-window capture.
        kw.update(first_window=2, global_windows=windows)
        windows = 3
    args = (ws1, ws2, lmat, hr, hi, b, sup, v, windows, total)

    def grp(budget):
        monkeypatch.setattr(bs, "WINDOW_GROUP_BYTES", budget)
        return bs.window_group(2, share_h, ws1.shape[0], b, sup, v,
                               windows)

    assert grp(1 << 50) == windows
    want = bs.windowed_coarse_rank(*args, **kw)
    lo, two = 1, 1 << 40                    # least budget for 2 windows
    while lo < two:
        mid = (lo + two) // 2
        lo, two = (lo, mid) if grp(mid) >= 2 else (mid + 1, two)
    assert windows % 2                      # the last group pads
    for budget, size in ((1, 1), (two, 2)):
        assert grp(budget) == size
        got = bs.windowed_coarse_rank(*args, **kw)
        assert len(got) == len(want) == (4 if mode == "want_top2" else 2)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (ws1.shape[0],
                                          2 * share_h * windows)
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6)


def test_windowed_coarse_rank_memory_bounded(monkeypatch):
    """The compiled windowed coarse stage's temporary memory does not
    grow with capture length once windows run in groups: 8x the
    windows costs < 2x the temp bytes at one window per step, while
    one group holding every window grows with them."""
    import functools

    import jax

    import caf_cookoff_tpu.models.batched_stein as bs

    def temp_bytes(windows, budget):
        monkeypatch.setattr(bs, "WINDOW_GROUP_BYTES", budget)
        ws1, ws2, lmat, hr, hi, b, sup, v = _windowed_case(windows,
                                                           pairs=1)
        fn = jax.jit(functools.partial(
            bs.windowed_coarse_rank, num_blocks=b, sup=sup, v=v,
            windows=windows, total_lags=windows * v - 7))
        mem = fn.lower(ws1, ws2, lmat, hr, hi).compile().memory_analysis()
        return mem.temp_size_in_bytes

    assert temp_bytes(32, 1) < 2 * temp_bytes(4, 1)
    assert temp_bytes(32, 1 << 50) > 4 * temp_bytes(4, 1 << 50)


# ---------------------------------------------------------------------------
# Multi-emitter lattices through the fused engines (round 5)
# ---------------------------------------------------------------------------


def _emitters_capture(truths, n=1024, total=16384, seed=5):
    """(needle, haystack) with needle copies at the given
    (freq_hz, lag, amp) truths plus a -80 dB noise floor."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in truths:
        end = min(lag + n, total)
        shifted = (amp * needle
                   * np.exp(2j * np.pi * f * t / FS)).astype(np.complex64)
        hay[lag:end] += shifted[: end - lag]
    return needle, hay


def _rows(fr, lg, vv):
    return [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
            if np.isfinite(float(v))]


def test_os_peaks_matches_xla_lattice_engine(grid):
    """Fused multi-emitter OS engine vs the XLA lattice scan: the
    emitters (distinct lags, windows>1 path) agree row-for-row."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peaks
    from caf_cookoff_tpu.models.overlap_save import (
        batched_overlap_save_peaks_local,
    )

    truths = ((-30.0, 3000, 1.0), (45.0, 9000, 0.8), (10.0, 14000, 0.6))
    needle, hay = _emitters_capture(truths)
    fr, lg, vv = batched_stein_os_peaks(needle[None], hay[None], grid,
                                        FS, 4)
    fr2, lg2, vv2 = batched_overlap_save_peaks_local(
        needle[None], hay[None], grid, FS, 4)
    got = _rows(fr[0], lg[0], vv[0])
    want = _rows(fr2[0], lg2[0], vv2[0])
    # The true emitters must agree; sidelobe-level slots past them may
    # differ (documented lattice contract).
    assert got[: len(truths)] == want[: len(truths)]
    assert got[: len(truths)] == [(f, lag) for f, lag, _ in truths]
    # Values are exact re-scores — match the XLA engine's exact scan.
    np.testing.assert_allclose(np.asarray(vv[0][: len(truths)]),
                               np.asarray(vv2[0][: len(truths)]),
                               rtol=2e-5)


def test_os_peaks_same_lag_distinct_freq_pair(grid):
    """Two emitters at the SAME lag, far apart in frequency: the
    per-entry re-score's freq-cell restriction keeps both (an
    unrestricted argmax would collapse the weaker onto the stronger)."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peaks
    from caf_cookoff_tpu.models.overlap_save import (
        batched_overlap_save_peaks_local,
    )

    truths = ((-20.0, 5000, 1.0), (70.0, 5000, 0.6))
    needle, hay = _emitters_capture(truths, seed=7)
    fr, lg, vv = batched_stein_os_peaks(needle[None], hay[None], grid,
                                        FS, 3)
    fr2, lg2, vv2 = batched_overlap_save_peaks_local(
        needle[None], hay[None], grid, FS, 3)
    assert _rows(fr[0], lg[0], vv[0])[:2] == _rows(fr2[0], lg2[0],
                                                   vv2[0])[:2]
    assert {int(l) for l in lg[0][:2]} == {5000}


def test_os_peaks_detection_threshold(grid):
    """Noise-only capture: every slot masks below the auto threshold;
    with emitters, their slots pass and carry finite SNR."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peaks

    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(1024)
              + 1j * rng.standard_normal(1024)).astype(np.complex64)
    noise = (1e-3 * (rng.standard_normal(16384)
                     + 1j * rng.standard_normal(16384))
             ).astype(np.complex64)
    fr, lg, vv, snr = batched_stein_os_peaks(
        needle[None], noise[None], grid, FS, 3, min_snr_db="auto",
        with_snr=True)
    assert not np.isfinite(vv).any()
    truths = ((-30.0, 3000, 1.0), (45.0, 9000, 0.5))
    needle, hay = _emitters_capture(truths)
    fr, lg, vv, snr = batched_stein_os_peaks(
        needle[None], hay[None], grid, FS, 3, min_snr_db="auto",
        with_snr=True)
    assert _rows(fr[0], lg[0], vv[0])[:2] == [(f, lag)
                                             for f, lag, _ in truths]
    assert np.isfinite(snr[0][:2]).all() and (snr[0][:2] > 20).all()


def test_equal_length_peaks_vs_surface_oracle(grid):
    """Equal-length multi-emitter (circular lags): top entries match
    find_peaks over the exact full surface."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peaks
    from caf_cookoff_tpu.models.filterbank import caf_surface
    from caf_cookoff_tpu.ops.peak import find_peaks, resolve_exclusions

    n = 1024
    rng = np.random.default_rng(7)
    nd = (rng.standard_normal(n)
          + 1j * rng.standard_normal(n)).astype(np.complex64)
    t = np.arange(n)
    hay = (nd * np.exp(2j * np.pi * -20.0 * t / FS)).astype(np.complex64)
    hay = hay + 0.7 * np.roll(
        (nd * np.exp(2j * np.pi * 35.0 * t / FS)).astype(np.complex64),
        300)
    hay = (hay + 1e-4 * (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n))
           ).astype(np.complex64)
    fr, lg, vv = batched_stein_peaks(nd[None], hay[None], grid, FS, 2)
    surf = np.asarray(caf_surface(nd, hay, grid, FS))
    ef, el = resolve_exclusions(nd, grid, FS, None, None)
    pk = find_peaks(surf, 2, ef, el, lag_period=surf.shape[-1])
    want = [(float(grid[int(f)]), int(l))
            for f, l in zip(pk.freq_idx, pk.lag_idx)]
    assert _rows(fr[0], lg[0], vv[0]) == want
    np.testing.assert_allclose(np.asarray(vv[0]), np.asarray(pk.value),
                               rtol=2e-5)


def test_equal_length_peaks_num_peaks1_matches_argmax(chirp, grid):
    """Degenerate 1-slot lattice = the single-peak engine's answer."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peaks

    n0, h0, _ = chirp(0)
    fr1, lg1, _ = batched_stein_peak(n0[None], h0[None], grid, FS)
    fr, lg, vv = batched_stein_peaks(n0[None], h0[None], grid, FS, 1)
    assert (float(fr[0][0]), int(lg[0][0])) == (float(fr1[0]),
                                                int(lg1[0]))


def test_peaks_wide_span_raises_eligibility(chirp):
    """Banding is not supported through the multi-emitter fused engine
    — a clear EligibilityError, not a wrong answer."""
    from caf_cookoff_tpu.errors import EligibilityError
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peaks

    n0, h0, _ = chirp(0)
    wide = np.arange(-6000.0, 6000.0, 10.0, dtype=np.float32)
    with pytest.raises(EligibilityError, match="band"):
        batched_stein_peaks(n0[None], h0[None], wide, FS, 2)


def test_sharded_peaks_matches_single_chip(grid):
    """Mesh lattices = single-chip lattices: (freq, lag) bitwise, values
    to f32 reassociation tolerance (pure data parallelism)."""
    import jax

    from caf_cookoff_tpu.models.batched_stein import batched_stein_peaks
    from caf_cookoff_tpu.parallel import sharded_batched_stein_peaks
    from caf_cookoff_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    n, batch = 1024, 4
    t = np.arange(n)
    nds, hays = [], []
    for p in range(batch):
        nd = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
        hay = (nd * np.exp(2j * np.pi * (-20.0 - 5 * p) * t / FS)
               ).astype(np.complex64)
        hay = hay + 0.6 * np.roll(
            (nd * np.exp(2j * np.pi * (40.0 + 3 * p) * t / FS)
             ).astype(np.complex64), 200 + 10 * p)
        hay = (hay + 1e-4 * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
               ).astype(np.complex64)
        nds.append(nd)
        hays.append(hay)
    nds, hays = np.stack(nds), np.stack(hays)
    single = batched_stein_peaks(nds, hays, grid, FS, 3)
    mesh = make_mesh(pair=2, devices=jax.devices()[:2])
    shard = sharded_batched_stein_peaks(nds, hays, grid, FS, mesh, 3)
    assert np.array_equal(np.asarray(single[0]), np.asarray(shard[0]))
    assert np.array_equal(np.asarray(single[1]), np.asarray(shard[1]))
    fin = np.isfinite(np.asarray(single[2]))
    assert np.array_equal(fin, np.isfinite(np.asarray(shard[2])))
    np.testing.assert_allclose(np.asarray(single[2])[fin],
                               np.asarray(shard[2])[fin], rtol=1e-5)


def test_os_peaks_banded_grid_matches_xla():
    """Wide fine uniform grid routes BANDED (bands x windows fused
    programs); emitters match the XLA lattice engine and the truths."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peaks
    from caf_cookoff_tpu.models.overlap_save import (
        batched_overlap_save_peaks_local,
    )
    from caf_cookoff_tpu.models.stein import _plan_bands

    n, total = 2048, 16384
    rng = np.random.default_rng(5)
    nd = (rng.standard_normal(n)
          + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    freqs = np.linspace(-500, 500, 256,
                        endpoint=False).astype(np.float32)
    assert _plan_bands(FS, freqs) is not None   # the banded regime
    t = np.arange(n)
    truths = []
    for f_idx, lag, amp in ((30, 3000, 1.0), (181, 9000, 0.7),
                            (97, 12000, 0.5)):
        f = float(freqs[f_idx])
        hay[lag:lag + n] += (amp * nd * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
        truths.append((f, lag))
    fr, lg, vv = batched_stein_os_peaks(nd[None], hay[None], freqs,
                                        FS, 4)
    fr2, lg2, vv2 = batched_overlap_save_peaks_local(
        nd[None], hay[None], freqs, FS, 4)
    got = _rows(fr[0], lg[0], vv[0])
    want = _rows(fr2[0], lg2[0], vv2[0])
    assert got[:3] == want[:3] == truths
    np.testing.assert_allclose(np.asarray(vv[0][:3]),
                               np.asarray(vv2[0][:3]), rtol=2e-5)


def test_equal_length_wrap_skirt_cannot_displace_real_emitter(grid):
    """Round-5 review fix: circular-lag NMS. An oversampled needle's
    lag mainlobe wraps — a peak at lag 0 has a skirt at lag m-1 that
    linear NMS would never suppress, letting it claim the slot of a
    genuinely separated weaker emitter."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peaks
    from scipy import signal as sp_signal

    n = 2048
    rng = np.random.default_rng(13)
    # 8x-oversampled (band-limited) needle -> ~8-sample lag mainlobe.
    taps = sp_signal.firwin(127, 1 / 8)
    nd = sp_signal.filtfilt(
        taps, [1.0], rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ).astype(np.complex64)
    t = np.arange(n)
    hay = (nd * np.exp(2j * np.pi * 30.0 * t / FS)).astype(np.complex64)
    hay = hay + 0.6 * np.roll(
        (nd * np.exp(2j * np.pi * -55.0 * t / FS)).astype(np.complex64),
        400)
    hay = (hay + 1e-4 * (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n))
           ).astype(np.complex64)
    fr, lg, vv = batched_stein_peaks(nd[None], hay[None], grid, FS, 2)
    rows = _rows(fr[0], lg[0], vv[0])
    assert len(rows) == 2, rows
    lags = sorted(l for _, l in rows)
    assert lags == [0, 400], rows


def test_rescore_guards_circular_path_not_collapsed():
    """Round-5 review fix: the circular engines pass the period m (not
    n) so the guard keeps its 64-sample default instead of collapsing
    to 1 (which would defeat the bf16 flat-top re-score slack)."""
    from caf_cookoff_tpu.models.batched_stein import _rescore_guards

    assert _rescore_guards(1024, 6, 2048) == (64, 6)
    assert _rescore_guards(1024, 6, 1024) == (1, 1)  # the old collapse
