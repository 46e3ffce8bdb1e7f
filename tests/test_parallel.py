"""Multi-device sharding tests on the 8-virtual-device CPU mesh.

The distributed test coverage the reference has no analog for (nothing in
it is distributed, SURVEY §4): every sharded engine must produce the
single-device answer bit-for-bit in (freq, lag) across mesh shapes — the
mesh version of the reference's cross-strategy consistency tests
(``caf_rust/tests/test.rs:15-145``).
"""

import jax
import numpy as np
import pytest

from caf_cookoff_tpu.config import FreqGrid
from caf_cookoff_tpu.models.filterbank import caf_peak, caf_surface
from caf_cookoff_tpu.models.overlap_save import overlap_save_peak
from caf_cookoff_tpu.parallel import (
    batched_caf_peak,
    factor_devices,
    make_mesh,
    sharded_caf_peak,
    sharded_caf_surface,
    sharded_overlap_save_peak,
)

FS = 48_000.0
GRID = FreqGrid(-100.0, 100.0, 0.25)


def _mesh(pair=1, doppler=1, time=1):
    n = pair * doppler * time
    return make_mesh(pair=pair, doppler=doppler, time=time,
                     devices=jax.devices()[:n])


def test_factor_devices():
    assert factor_devices(8, 3) == (2, 2, 2)
    assert factor_devices(16, 3) == (4, 2, 2)
    assert factor_devices(1, 3) == (1, 1, 1)
    assert factor_devices(6, 2) == (3, 2)
    assert np.prod(factor_devices(12, 3)) == 12


@pytest.mark.parametrize("doppler", [2, 8])
def test_doppler_sharded_surface_matches_single(chirp, doppler):
    needle, haystack, _ = chirp(0)
    freqs = GRID.frequencies(np.float32)
    want = np.asarray(caf_surface(needle, haystack, freqs, FS))
    got = np.asarray(sharded_caf_surface(needle, haystack, freqs, FS,
                                         _mesh(doppler=doppler)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("doppler", [2, 5, 8])
def test_doppler_sharded_peak_golden(chirp, doppler):
    """801 bins over 2/5/8 shards (with grid padding for 5) — identical
    golden answer."""
    needle, haystack, _ = chirp(0)
    freqs = GRID.frequencies(np.float32)
    freq, lag, _ = sharded_caf_peak(needle, haystack, freqs, FS,
                                    _mesh(doppler=doppler))
    assert (freq, lag) == (69.25, 202)


def test_batched_pair_doppler_sharded(chirp):
    """4 pairs x (2 pair-shards x 4 doppler-shards): every pair's peak
    matches its own single-chip answer."""
    freqs = GRID.frequencies(np.float32)
    idxs = [0, 3, 5, 7]
    needles, haystacks, singles = [], [], []
    for i in idxs:
        n, h, _ = chirp(i)
        needles.append(n)
        haystacks.append(h)
        singles.append(caf_peak(n, h, freqs, FS)[:2])
    mesh = _mesh(pair=2, doppler=4)
    fr, lg, _ = batched_caf_peak(np.stack(needles), np.stack(haystacks),
                                 freqs, FS, mesh)
    for b, want in enumerate(singles):
        assert (float(fr[b]), int(lg[b])) == want


@pytest.mark.parametrize("doppler,time", [(1, 8), (4, 2), (2, 2)])
def test_time_sharded_overlap_save(fixture_pairs, doppler, time):
    """Full-haystack search sharded over (doppler, time) with ppermute
    halos equals the single-chip overlap-save answer."""
    from caf_cookoff_tpu.utils.io import load_c64

    needle_path, haystack_path = fixture_pairs[0]
    needle = load_c64(needle_path)
    haystack = load_c64(haystack_path)
    freqs = GRID.frequencies(np.float32)
    want = overlap_save_peak(needle, haystack, freqs, FS)
    got = sharded_overlap_save_peak(needle, haystack, freqs, FS,
                                    _mesh(doppler=doppler, time=time))
    assert got[:2] == want[:2] == (69.25, 202)


def test_time_sharded_synthetic_long():
    """A synthetic 64k haystack with the emitter deep in a late time
    shard: the peak crosses shard boundaries correctly."""
    rng = np.random.default_rng(5)
    n, l, lag, f_true = 512, 65536, 51_200, -1500.0
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    haystack = (1e-4 * (rng.standard_normal(l) + 1j * rng.standard_normal(l))).astype(np.complex64)
    haystack[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    freq, got_lag, _ = sharded_overlap_save_peak(
        needle, haystack, freqs, FS, _mesh(doppler=2, time=4))
    assert (freq, got_lag) == (f_true, lag)


def test_batched_overlap_save_three_axes():
    """Config-5 pattern: pair x doppler x time all sharded at once —
    per-pair answers match the single-chip overlap-save engine."""
    from caf_cookoff_tpu.parallel import batched_overlap_save_peak

    rng = np.random.default_rng(9)
    pairs, n, l = 4, 512, 16384
    lags = [700, 5001, 9800, 15872]            # last = final valid lag
    f_true = [-750.0, 0.0, 250.0, 500.0]
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, l))
                    + 1j * rng.standard_normal((pairs, l))
                    )).astype(np.complex64)
    t = np.arange(n)
    for b in range(pairs):
        span = min(n, l - lags[b])
        hays[b, lags[b]:lags[b] + span] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)[:span]
    freqs = np.arange(-1000.0, 1000.0, 250.0, dtype=np.float32)
    fr, lg, _ = batched_overlap_save_peak(
        needles, hays, freqs, FS, _mesh(pair=2, doppler=2, time=2),
        backend="xla")
    for b in range(pairs):
        want = overlap_save_peak(needles[b], hays[b], freqs, FS,
                                 backend="xla")
        assert (float(fr[b]), int(lg[b])) == want[:2] == (
            f_true[b], lags[b])


def test_deferred_halo_matches_plain_scan():
    """streaming_peak_deferred_halo == streaming_peak over
    concat([local, halo]) — single peak bitwise, lattice + floor on
    well-separated emitters — for chunk sizes hitting every interior/
    boundary split (including chunk < d where everything is boundary).

    This is the latency-hiding restructure (round-4 verdict item 2):
    correctness must not depend on WHERE the scan is split.
    """
    import jax.numpy as jnp

    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.parallel.sharded import (
        streaming_peak_deferred_halo,
    )

    n = 256
    rng = np.random.default_rng(21)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    freqs = np.arange(-100, 100, 10.0, dtype=np.float32)
    total = 8192
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in ((-30.0, 700, 1.0), (40.0, 3000, 0.6)):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    n_sp = tuple(jnp.asarray(p) for p in splitfft.split_array(needle))
    h_sp = splitfft.split_array(hay)
    halo = n - 1
    for chunk in (4096, 3500, 200):      # multi-block, ragged, < d
        m, _, _ = plan_blocks(n, chunk)
        s_conj = needle_spectra_conj(n_sp, jnp.asarray(freqs), FS, m,
                                     "xla")
        local = tuple(jnp.asarray(p[:chunk]) for p in h_sp)
        nbr = tuple(jnp.asarray(p[chunk:chunk + halo]) for p in h_sp)
        ext = tuple(jnp.concatenate([a, b]) for a, b in zip(local, nbr))
        want = streaming_peak(s_conj, ext, n, chunk, backend="xla")
        got = streaming_peak_deferred_halo(
            s_conj, local, nbr, n, chunk, 0, None, "xla")
        assert (int(got.freq_idx), int(got.lag_idx)) == \
            (int(want.freq_idx), int(want.lag_idx)), chunk
        assert float(got.value) == float(want.value), chunk
        # Lattice + floor accumulators over the same split.
        want_l, ws, wc = streaming_peak(
            s_conj, ext, n, chunk, backend="xla", num_peaks=3,
            exclude_freq=2, exclude_lag=64, with_floor=True)
        got_l, gs, gc = streaming_peak_deferred_halo(
            s_conj, local, nbr, n, chunk, 0, None, "xla", num_peaks=3,
            exclude_freq=2, exclude_lag=64, with_floor=True)
        assert float(gc) == float(wc), chunk
        np.testing.assert_allclose(float(gs), float(ws), rtol=1e-6)
        finite = np.isfinite(np.asarray(want_l.value))
        np.testing.assert_array_equal(
            np.asarray(got_l.freq_idx)[finite],
            np.asarray(want_l.freq_idx)[finite], err_msg=str(chunk))
        np.testing.assert_array_equal(
            np.asarray(got_l.lag_idx)[finite],
            np.asarray(want_l.lag_idx)[finite], err_msg=str(chunk))


def test_hbm_estimate_model():
    from caf_cookoff_tpu.parallel import estimate_hbm_per_chip

    est = estimate_hbm_per_chip(256, 4096, 4096, 262144,
                                pair=32, doppler=8, time=1)
    # Dominant term: (256/32 pairs) x (4096/8 bins) x 8192 x 2 x 4 B.
    assert est["needle_spectra_mb"] == 256.0
    assert est["total_gb"] < 1.0


def test_time_sharded_tail_lag():
    """Emitter at the FINAL valid lag: the shard chunking must keep the
    last n-2 haystack samples (sizing chunks from the lag count instead
    of the sample count silently zeroed these lags)."""
    rng = np.random.default_rng(11)
    n, l = 512, 65536
    lag = l - n                                   # final valid lag
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    haystack = (1e-4 * (rng.standard_normal(l)
                        + 1j * rng.standard_normal(l))).astype(np.complex64)
    haystack[lag:] += needle
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    want = overlap_save_peak(needle, haystack, freqs, FS)
    got = sharded_overlap_save_peak(needle, haystack, freqs, FS,
                                    _mesh(time=4))
    assert got[:2] == want[:2] == (0.0, lag)


def test_sharded_determinism(chirp):
    """Same (freq, lag, value) across two runs and across mesh shapes —
    the determinism guarantee SURVEY §5 prescribes in place of race
    detectors."""
    needle, haystack, _ = chirp(2)
    freqs = FreqGrid(30.0, 35.0, 0.05).frequencies(np.float32)
    a = sharded_caf_peak(needle, haystack, freqs, FS, _mesh(doppler=8))
    b = sharded_caf_peak(needle, haystack, freqs, FS, _mesh(doppler=8))
    c = sharded_caf_peak(needle, haystack, freqs, FS, _mesh(doppler=4))
    assert a == b
    assert a[:2] == c[:2]


@pytest.mark.parametrize("doppler", [4, 8])
def test_stein_sharded_peak_golden(chirp, doppler):
    """Doppler-sharded Stein synthesis + exact refinement = golden."""
    from caf_cookoff_tpu.parallel import sharded_stein_peak

    needle, haystack, _ = chirp(0)
    freqs = GRID.frequencies(np.float32)
    freq, lag, _ = sharded_stein_peak(needle, haystack, freqs, FS,
                                      _mesh(doppler=doppler))
    assert (freq, lag) == (69.25, 202)


def test_stein_sharded_distant_near_tie():
    """Two emitters 14 bins apart where the coarse segmented pass picks
    the wrong one (the sinc envelope attenuates the true high-|f| peak
    below a slightly weaker 0 Hz decoy): the on-device top-k re-score
    must recover the exact winner — a +-4-bin window around the coarse
    argmax could not."""
    from caf_cookoff_tpu.parallel import sharded_stein_peak

    n = 4096
    freqs = np.arange(-180.0, 180.1, 12.0, dtype=np.float32)
    t = np.arange(n)
    rng = np.random.default_rng(0)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    needle /= np.abs(needle).max()
    f_true, a_decoy, lag = 168.0, 0.955, 64
    hay = np.zeros(n, np.complex64)
    comp = needle * np.exp(2j * np.pi * f_true * t / FS) + a_decoy * needle
    hay[lag:] = comp[: n - lag].astype(np.complex64)

    mesh = _mesh(doppler=8)
    coarse = sharded_stein_peak(needle, hay, freqs, FS, mesh, refine=False)
    refined = sharded_stein_peak(needle, hay, freqs, FS, mesh)
    assert coarse[0] == 0.0                    # coarse pass is fooled...
    assert refined[:2] == (f_true, lag)        # ...top-k re-score is not
    # and the winner really is outside any +-4-bin refinement window:
    assert abs(f_true - coarse[0]) / 12.0 > 4


def test_stein_sharded_matches_single(chirp):
    from caf_cookoff_tpu.models.stein import stein_caf_peak
    from caf_cookoff_tpu.parallel import sharded_stein_peak

    needle, haystack, _ = chirp(3)
    freqs = GRID.frequencies(np.float32)
    single = stein_caf_peak(needle, haystack, freqs, FS)
    sharded = sharded_stein_peak(needle, haystack, freqs, FS,
                                 _mesh(doppler=8))
    assert sharded[:2] == single[:2] == (-76.25, 151)


def test_sharded_batched_stein_pairs(chirp):
    """The fused batch engine sharded over the pair axis: every pair's
    peak matches its single-pair Stein answer."""
    from caf_cookoff_tpu.models.stein import stein_caf_peak
    from caf_cookoff_tpu.parallel import sharded_batched_stein_peak

    freqs = GRID.frequencies(np.float32)
    idxs = [0, 3, 5, 7]
    needles, haystacks, singles = [], [], []
    for i in idxs:
        n, h, _ = chirp(i)
        needles.append(n)
        haystacks.append(h)
        singles.append(stein_caf_peak(n, h, freqs, FS)[:2])
    fr, lg, _ = sharded_batched_stein_peak(
        np.stack(needles), np.stack(haystacks), freqs, FS, _mesh(pair=4))
    for b, want in enumerate(singles):
        assert (float(fr[b]), int(lg[b])) == want


FUZZ_CASES = [
    # (seed, n, total, lag, f_idx, grid_start, grid_step, grid_bins,
    #  doppler, time) — randomized workloads over randomized mesh
    # factorizations, same philosophy as test_consistency_fuzz but for
    # the shard_map engines (the class of bug the round-1 tail-lag
    # truncation belonged to).
    (20, 1024, 1024, 0, 1, -300.0, 75.0, 8, 8, 1),       # zero lag
    (21, 2048, 2048, 1500, 6, -100.0, 12.5, 16, 2, 1),   # late lag
    (22, 512, 24576, 24064, 4, -500.0, 125.0, 8, 2, 4),  # last full lag
    (23, 1000, 17000, 9871, 2, -750.0, 250.0, 6, 4, 2),  # non-pow2 all
]


@pytest.mark.parametrize("seed,n,total,lag,f_idx,g0,gs,gk,doppler,time",
                         FUZZ_CASES)
def test_sharded_fuzz_matches_single(seed, n, total, lag, f_idx, g0, gs,
                                     gk, doppler, time):
    """Randomized sharded-vs-single consistency: the doppler-sharded
    filterbank and Stein engines (truncated captures) and the
    (doppler, time)-sharded overlap-save engine (long captures) all
    reproduce the single-chip (freq, lag)."""
    from caf_cookoff_tpu.models.stein import stein_caf_peak
    from caf_cookoff_tpu.parallel import sharded_stein_peak

    rng = np.random.default_rng(seed)
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    f_true = float(freqs[f_idx])
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    span = min(n, total - lag)
    hay[lag:lag + span] += (needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS)
    ).astype(np.complex64)[:span]

    want = (f_true, lag)
    if total == n:
        single = caf_peak(needle, hay, freqs, FS)
        got = sharded_caf_peak(needle, hay, freqs, FS,
                               _mesh(doppler=doppler))
        assert got[:2] == single[:2] == want, ("filterbank", got)
        single = stein_caf_peak(needle, hay, freqs, FS)
        got = sharded_stein_peak(needle, hay, freqs, FS,
                                 _mesh(doppler=doppler))
        assert got[:2] == single[:2] == want, ("stein", got)
    else:
        single = overlap_save_peak(needle, hay, freqs, FS)
        got = sharded_overlap_save_peak(needle, hay, freqs, FS,
                                        _mesh(doppler=doppler, time=time))
        assert got[:2] == single[:2] == want, ("overlap-save", got)


# ---- time/doppler-sharded RATE engine (second-order over the mesh) ----


def _swept_capture_rate(emitters, n=2048, length=16384, seed=0,
                        noise=0.01):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    t_sec = np.arange(n) / FS
    hay = (noise * (rng.standard_normal(length)
                    + 1j * rng.standard_normal(length))
           ).astype(np.complex64)
    for f0, rate, lag, amp in emitters:
        cp = amp * needle * np.exp(2j * np.pi * f0 * t_sec
                                   + 1j * np.pi * rate * t_sec ** 2)
        hay[lag:lag + n] += cp.astype(np.complex64)
    return needle, hay


RATE_EMITTERS = [(20.0, 400.0, 4500, 1.0), (-31.0, -200.0, 900, 0.8)]
RATE_FREQS = np.arange(-60, 60, 0.5, dtype=np.float32)
RATE_GRID_R = np.arange(-600.0, 601.0, 200.0)


@pytest.mark.parametrize("doppler,time", [(2, 1), (1, 4), (2, 4)])
def test_sharded_rate_peak_matches_single(doppler, time):
    """The joint (rate, doppler, lag) argmax is identical to the
    single-chip engine on every mesh factorization — one halo exchange
    serves all trial rates."""
    from caf_cookoff_tpu.models.rate import rate_overlap_save_peak
    from caf_cookoff_tpu.parallel import sharded_rate_overlap_save_peak

    needle, hay = _swept_capture_rate(RATE_EMITTERS)
    want = rate_overlap_save_peak(needle, hay, RATE_FREQS, RATE_GRID_R,
                                  FS, backend="xla")
    got = sharded_rate_overlap_save_peak(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS,
        _mesh(doppler=doppler, time=time), backend="xla")
    assert got[:3] == want[:3]
    assert np.isclose(got[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("doppler,time", [(2, 1), (1, 4), (2, 4)])
def test_sharded_rate_lattice_emitters_exact(doppler, time):
    """Both accelerating emitters (distinct lags) occupy the same
    lattice slots with identical (rate, freq, lag, value) as the
    single-chip engine; SNRs agree to float tolerance.  (Tail slots
    below the weakest emitter may differ at same-lag sidelobe level —
    the documented hierarchical-NMS contract.)"""
    from caf_cookoff_tpu.models.rate import rate_overlap_save_peaks
    from caf_cookoff_tpu.parallel import sharded_rate_overlap_save_peaks

    needle, hay = _swept_capture_rate(RATE_EMITTERS)
    want = rate_overlap_save_peaks(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS, num_peaks=3,
        backend="xla", with_snr=True)
    got = sharded_rate_overlap_save_peaks(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS,
        _mesh(doppler=doppler, time=time), num_peaks=3, backend="xla",
        with_snr=True)
    n_emit = len(RATE_EMITTERS)
    for w, g in zip(want[:4], got[:4]):   # rates, freqs, lags, values
        np.testing.assert_allclose(np.asarray(g)[:n_emit],
                                   np.asarray(w)[:n_emit], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[4])[:n_emit],
                               np.asarray(want[4])[:n_emit], atol=1e-3)
    # The recovered slots are the injected emitters, grid-exact.
    got_rows = sorted(zip(np.asarray(got[2])[:n_emit].tolist(),
                          np.asarray(got[0])[:n_emit].tolist()))
    want_rows = sorted((lag, r) for _, r, lag, _ in RATE_EMITTERS)
    assert got_rows == want_rows


def test_sharded_rate_lattice_noise_only_zero_detections():
    """Mesh detection decision: a noise-only capture reports zero
    detections at the auto threshold (global psum floor)."""
    from caf_cookoff_tpu.parallel import sharded_rate_overlap_save_peaks

    needle, hay = _swept_capture_rate([], noise=1.0)
    rr, ff, ll, vv = sharded_rate_overlap_save_peaks(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS, _mesh(doppler=2,
                                                        time=2),
        num_peaks=3, backend="xla", min_snr_db="auto")
    assert np.all(np.isneginf(vv))


def test_sharded_lattices_num_peaks_one():
    """num_peaks=1 is a valid degenerate lattice on every mesh engine
    (regression: the scalar fast path of the streaming scan used to
    reach the lattice concat/gather and die with a trace-time shape
    error), and matches the argmax engines."""
    from caf_cookoff_tpu.parallel import (
        batched_overlap_save_peak,
        batched_overlap_save_peaks,
        sharded_overlap_save_peak,
        sharded_overlap_save_peaks,
        sharded_rate_overlap_save_peak,
        sharded_rate_overlap_save_peaks,
    )

    needle, hay = _swept_capture_rate(RATE_EMITTERS)
    mesh = _mesh(doppler=2, time=2)
    # First-order time/doppler-sharded.
    f1, l1, v1 = sharded_overlap_save_peak(needle, hay, RATE_FREQS, FS,
                                           mesh, backend="xla")
    fr, lg, vv = sharded_overlap_save_peaks(needle, hay, RATE_FREQS, FS,
                                            mesh, 1, backend="xla")
    assert fr.shape == (1,)
    assert (float(fr[0]), int(lg[0]), float(vv[0])) == (f1, l1, v1)
    # Rate-sharded.
    want = sharded_rate_overlap_save_peak(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS, mesh, backend="xla")
    rr, ff, ll, vv = sharded_rate_overlap_save_peaks(
        needle, hay, RATE_FREQS, RATE_GRID_R, FS, mesh, num_peaks=1,
        backend="xla")
    assert (float(rr[0]), float(ff[0]), int(ll[0])) == want[:3]
    # Batched three-axis.
    mesh3 = _mesh(pair=2, doppler=2, time=2)
    needles = np.stack([needle, needle])
    hays = np.stack([hay, hay])
    fb, lb, vb = batched_overlap_save_peak(needles, hays, RATE_FREQS,
                                           FS, mesh3, backend="xla")
    frb, lgb, vvb = batched_overlap_save_peaks(
        needles, hays, RATE_FREQS, FS, mesh3, 1, backend="xla")
    assert frb.shape == (2, 1)
    np.testing.assert_array_equal(frb[:, 0], fb)
    np.testing.assert_array_equal(lgb[:, 0], lb)


def test_sharded_stein_os_matches_single_chip_bitwise():
    """Round 5: the windowed FUSED OS engine with windows over time —
    plain and banded grids, every mesh shape, bit-identical to the
    single-chip engine (the coarse gather preserves window order, so
    even tie-breaks match)."""
    import jax

    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.parallel import sharded_stein_os_peak
    from caf_cookoff_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    n, total = 2048, 32768
    nd = (rng.standard_normal(n)
          + 1j * rng.standard_normal(n)).astype(np.complex64)
    base = (1e-4 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total))
            ).astype(np.complex64)
    t = np.arange(n)
    cases = [
        (np.arange(-100, 100, 0.5, dtype=np.float32), -42.0, 9000),
        (np.linspace(-500, 500, 256, endpoint=False).astype(np.float32),
         None, 21000),                          # banded regime
        # FINAL full-overlap lag: the last shard's window slices must
        # not clamp and shift (round-5 regression — dynamic_slice
        # clamps an out-of-range start silently).
        (np.arange(-100, 100, 0.5, dtype=np.float32), 33.0,
         total - 2048),
    ]
    for freqs, f_inj, lag in cases:
        if f_inj is None:
            f_inj = float(freqs[181])
        hay = base.copy()
        hay[lag:lag + n] += (nd * np.exp(
            2j * np.pi * f_inj * t / FS)).astype(np.complex64)
        s = batched_stein_os_peak(nd[None], hay[None], freqs, FS)
        single = (float(s[0][0]), int(s[1][0]), float(s[2][0]))
        assert single[:2] == (f_inj, lag), single
        for tsh in (2, 4):
            mesh = make_mesh(time=tsh, devices=jax.devices()[:tsh])
            got = sharded_stein_os_peak(nd, hay, freqs, FS, mesh)
            assert got == single, (tsh, got, single)


def test_sharded_rate_pair_axis_shards_rates():
    """Round 5: the sharded rate engines put trial rates on the pair
    axis — a pair>1 mesh (rates padded by repeating the last) returns
    the same answers as pair=1 and as the single-chip engine."""
    import jax

    from caf_cookoff_tpu.models.rate import (
        rate_overlap_save_peak,
        rate_overlap_save_peaks,
    )
    from caf_cookoff_tpu.parallel import (
        sharded_rate_overlap_save_peak,
        sharded_rate_overlap_save_peaks,
    )
    from caf_cookoff_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(12)
    n, total = 1024, 8192
    nd = (rng.standard_normal(n)
          + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    ph = (2 * np.pi * 40.0 * t / FS
          + np.pi * 3000.0 * (t / FS) ** 2)
    hay[5000:5000 + n] += (nd * np.exp(1j * ph)).astype(np.complex64)
    freqs = np.arange(-100.0, 100.0, 25.0, dtype=np.float32)
    rates = np.arange(-6000.0, 6001.0, 3000.0)   # R=5, pads to 6 at pair=2
    want = rate_overlap_save_peak(nd, hay, freqs, rates, FS)
    for shape in ({"pair": 2, "time": 2}, {"pair": 2, "doppler": 2},
                  {"pair": 4}):
        n_dev = int(np.prod(list(shape.values())))
        mesh = make_mesh(devices=jax.devices()[:n_dev], **shape)
        got = sharded_rate_overlap_save_peak(nd, hay, freqs, rates, FS,
                                             mesh, backend="xla")
        # (rate, freq, lag) exact; the value may differ by an f32 ulp
        # under doppler sharding (per-shard DFT tiling reassociation).
        assert got[:3] == want[:3], (shape, got, want)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    # Lattice variant with detection: pad rates must not double-count
    # floor cells (identical SNR across pair factorizations).
    want_l = rate_overlap_save_peaks(nd, hay, freqs, rates, FS, 2,
                                     backend="xla", with_snr=True)
    mesh = make_mesh(pair=2, time=2, devices=jax.devices()[:4])
    got_l = sharded_rate_overlap_save_peaks(nd, hay, freqs, rates, FS,
                                            mesh, 2, backend="xla",
                                            with_snr=True)
    np.testing.assert_array_equal(got_l[0], want_l[0])
    np.testing.assert_array_equal(got_l[2], want_l[2])
    np.testing.assert_allclose(got_l[4], want_l[4], rtol=1e-6)


def test_sharded_fused_lattice_engines_match_single_chip():
    """Round 5: config-5 multi-emitter at fused speed on the mesh —
    pair-sharded batched OS lattices (bitwise freq/lag vs single chip)
    and time-sharded single-pair lattices (emitter rows match), plain
    and banded grids."""
    import jax

    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peaks
    from caf_cookoff_tpu.parallel import (
        sharded_batched_stein_os_peaks,
        sharded_stein_os_peaks,
    )
    from caf_cookoff_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    n, total, batch = 1024, 16384, 4
    t = np.arange(n)
    nds, hays = [], []
    for b in range(batch):
        nd = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
        hay = (1e-4 * (rng.standard_normal(total)
                       + 1j * rng.standard_normal(total))
               ).astype(np.complex64)
        for f, lag, amp in ((-30.0 + b, 3000 + 100 * b, 1.0),
                            (45.0 - b, 9000 + 50 * b, 0.7)):
            hay[lag:lag + n] += (amp * nd * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
        nds.append(nd)
        hays.append(hay)
    nds, hays = np.stack(nds), np.stack(hays)
    for freqs in (np.arange(-100, 100, 0.5, dtype=np.float32),
                  np.linspace(-500, 500, 256,
                              endpoint=False).astype(np.float32)):
        single = batched_stein_os_peaks(nds, hays, freqs, FS, 3)
        mesh = make_mesh(pair=2, devices=jax.devices()[:2])
        shard = sharded_batched_stein_os_peaks(nds, hays, freqs, FS,
                                               mesh, 3)
        assert np.array_equal(np.asarray(single[0]),
                              np.asarray(shard[0]))
        assert np.array_equal(np.asarray(single[1]),
                              np.asarray(shard[1]))
        fin = np.isfinite(np.asarray(single[2]))
        np.testing.assert_allclose(np.asarray(single[2])[fin],
                                   np.asarray(shard[2])[fin],
                                   rtol=1e-5)
        # Time-sharded single-pair lattice: the emitter rows (distinct
        # lags) match the single-chip engine across mesh shapes.
        want = [(float(f), int(l))
                for f, l, v in zip(single[0][0], single[1][0],
                                   single[2][0])
                if np.isfinite(float(v))][:2]
        for tsh in (2, 4):
            mesh_t = make_mesh(time=tsh, devices=jax.devices()[:tsh])
            fr, lg, vv = sharded_stein_os_peaks(nds[0], hays[0], freqs,
                                                FS, mesh_t, 3)
            got = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
                   if np.isfinite(float(v))][:2]
            assert got == want, (tsh, got, want)


def test_sharded_segmented_rate_matches_single_chip():
    """Round 5: the SEGMENTED rate engine with windows over time —
    identical to the single-chip segmented engine across mesh shapes
    (plain + banded grids, incl. a final-window-region emitter that
    exercises the last shard's padding)."""
    import jax

    from caf_cookoff_tpu.models.rate import stein_rate_os_peak
    from caf_cookoff_tpu.parallel import sharded_stein_rate_os_peak
    from caf_cookoff_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(8)
    n, total = 2048, 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    t = np.arange(n)
    rates = np.arange(-240.0, 241.0, 60.0, dtype=np.float32)

    def mk(f0, r_true, lag, seed=1):
        r2 = np.random.default_rng(seed)
        hay = (1e-4 * (r2.standard_normal(total)
                       + 1j * r2.standard_normal(total))
               ).astype(np.complex64)
        ph = 2 * np.pi * f0 * t / FS + np.pi * r_true * (t / FS) ** 2
        hay[lag:lag + n] += (needle * np.exp(1j * ph)
                             ).astype(np.complex64)
        return hay

    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    hay = mk(25.0, 120.0, total - n)      # final-window-region lag
    single = stein_rate_os_peak(needle, hay, freqs, rates, FS)
    for tsh in (2, 4):
        mesh = make_mesh(time=tsh, devices=jax.devices()[:tsh])
        got = sharded_stein_rate_os_peak(needle, hay, freqs, rates, FS,
                                         mesh)
        assert got == single, (tsh, got, single)
    freqs_w = np.linspace(-500, 500, 400,
                          endpoint=False).astype(np.float32)
    hay2 = mk(float(freqs_w[317]), -180.0, 7000, seed=2)
    sb = stein_rate_os_peak(needle, hay2, freqs_w, rates, FS)
    mesh = make_mesh(time=4, devices=jax.devices()[:4])
    gb = sharded_stein_rate_os_peak(needle, hay2, freqs_w, rates, FS,
                                    mesh)
    assert gb == sb, (gb, sb)
