"""Multi-emitter extraction through the long-capture engines.

BASELINE config 4 is "streaming multi-emitter"; the reference only ever
reports the global argmax (``caf_rust/src/caf/mod.rs:31-42``).  These
tests pin that a capture containing several emitters at distinct
(lag, freq) is FULLY recovered by

* the overlap-save scan engine (lattice carried through the block scan),
* the streaming engine across chunk boundaries (lattice in the carry),
* the time-sharded engine on the virtual mesh (lattice reduced over
  ``(doppler, time)`` collectives),

including an emitter pair whose NMS exclusion cells abut, plus the NMS
primitives themselves (:func:`merge_peaks`, :func:`resolution_cell`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from caf_cookoff_tpu.ops.peak import (
    CafPeak,
    find_peaks,
    merge_peaks,
    resolution_cell,
)

FS = 48_000.0


def _multi_emitter_capture(n=1024, total=65536, seed=5,
                           truths=((-30.0, 9000, 1.0),
                                   (45.0, 40000, 0.8),
                                   (10.0, 60000, 0.6))):
    """(needle, haystack, [(freq, lag)]) with emitters strongest-first."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in truths:
        end = min(lag + n, total)
        shifted = (amp * needle
                   * np.exp(2j * np.pi * f * t / FS)).astype(np.complex64)
        hay[lag:end] += shifted[: end - lag]
    return needle, hay, [(f, lag) for f, lag, _ in truths]


def _finite_rows(fr, lg, vv):
    return [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
            if np.isfinite(float(v))]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def test_merge_peaks_dedups_and_ranks():
    cands = CafPeak(jnp.array([9.5, 10.0, 8.0, -jnp.inf]),
                    jnp.array([5, 5, 20, 0], jnp.int32),
                    jnp.array([110, 100, 300, 0], jnp.int32))
    out = merge_peaks(cands, 3, exclude_freq=2, exclude_lag=32)
    assert out.value.tolist()[:2] == [10.0, 8.0]
    assert not np.isfinite(out.value[2])      # only 2 distinct survive
    assert out.freq_idx.tolist()[:2] == [5, 20]
    assert out.lag_idx.tolist()[:2] == [100, 300]


def test_merge_peaks_abutting_cells_both_survive():
    """Separation one sample past the exclusion window keeps both."""
    cands = CafPeak(jnp.array([10.0, 9.5]),
                    jnp.array([5, 5], jnp.int32),
                    jnp.array([100, 133], jnp.int32))
    out = merge_peaks(cands, 2, exclude_freq=2, exclude_lag=32)
    assert out.lag_idx.tolist() == [100, 133]
    # ...and exactly at the window edge the weaker one is suppressed.
    cands = CafPeak(jnp.array([10.0, 9.5]),
                    jnp.array([5, 5], jnp.int32),
                    jnp.array([100, 132], jnp.int32))
    out = merge_peaks(cands, 2, exclude_freq=2, exclude_lag=32)
    assert out.lag_idx[0] == 100 and not np.isfinite(out.value[1])


def test_merge_peaks_sentinels_cannot_suppress():
    """-inf slots at index (0, 0) must not veto a real (0, 0) peak."""
    cands = CafPeak(jnp.array([-jnp.inf, 7.0]),
                    jnp.array([0, 0], jnp.int32),
                    jnp.array([0, 3], jnp.int32))
    out = merge_peaks(cands, 2, exclude_freq=2, exclude_lag=32)
    assert float(out.value[0]) == 7.0


def test_merge_peaks_deterministic_tiebreak():
    """Equal values: row-major (freq, lag) order wins, either input order."""
    a = CafPeak(jnp.array([5.0, 5.0]), jnp.array([9, 2], jnp.int32),
                jnp.array([10, 500], jnp.int32))
    b = CafPeak(jnp.array([5.0, 5.0]), jnp.array([2, 9], jnp.int32),
                jnp.array([500, 10], jnp.int32))
    out_a = merge_peaks(a, 1, 1, 1)
    out_b = merge_peaks(b, 1, 1, 1)
    assert (int(out_a.freq_idx[0]), int(out_a.lag_idx[0])) == (2, 500)
    assert (int(out_b.freq_idx[0]), int(out_b.lag_idx[0])) == (2, 500)


def test_resolution_cell_tracks_grid_and_bandwidth():
    needle, _, _ = _multi_emitter_capture()
    coarse = resolution_cell(needle, np.arange(-100, 100, 2.5), FS)
    fine = resolution_cell(needle, np.arange(-100, 100, 0.25), FS)
    # Doppler window in BINS scales inversely with the grid step: both
    # cover the same physical fs/N mainlobe to within one coarse bin.
    assert abs(fine[0] * 0.25 - coarse[0] * 2.5) <= 2.5
    # Full-band noise needle -> lag mainlobe of a few samples.
    assert 1 <= coarse[1] <= 8
    # A narrowband needle has a proportionally wider lag mainlobe.
    t = np.arange(4096)
    narrow = np.exp(2j * np.pi * 0.01 * t) * np.hanning(4096)
    wide_lag = resolution_cell(narrow, np.arange(-100, 100, 2.5), FS)[1]
    assert wide_lag > 8 * coarse[1]


def test_find_peaks_resolution_cell_fine_grid():
    """On a fine grid, auto windows keep a skirt from re-detecting."""
    from caf_cookoff_tpu.models.overlap_save import overlap_save_surface

    # Both emitters' copies lie fully inside the capture with disjoint
    # correlation windows, so both peaks are full-coherence and
    # interference-free.
    needle, hay, truths = _multi_emitter_capture(
        n=1024, total=4096,
        truths=((-30.0, 200, 1.0), (42.0, 2000, 0.7)))
    freqs = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    surface = overlap_save_surface(needle, hay, freqs, FS)
    excl_f, excl_l = resolution_cell(needle, freqs, FS)
    pks = find_peaks(np.asarray(surface), 2, excl_f, excl_l)
    got = sorted((float(freqs[int(k)]), int(t))
                 for k, t in zip(pks.freq_idx, pks.lag_idx))
    assert got == sorted(truths)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def test_overlap_save_peaks_three_emitters():
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peaks

    needle, hay, truths = _multi_emitter_capture()
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    fr, lg, vv = overlap_save_peaks(needle, hay, freqs, FS, 4)
    assert _finite_rows(fr, lg, vv)[:3] == truths
    # Values rank strongest-first.
    finite = [v for v in vv if np.isfinite(v)]
    assert finite == sorted(finite, reverse=True)


def test_overlap_save_peaks_abutting_emitters():
    """Two emitters one lag past the exclusion window both survive the
    scan lattice (their NMS cells abut at a block-boundary-free spot)."""
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peaks

    needle, hay, _ = _multi_emitter_capture(
        truths=((-30.0, 9000, 1.0),))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    excl_f, excl_l = resolution_cell(needle, freqs, FS)
    n = len(needle)
    t = np.arange(n)
    # Same frequency, lag separated by exactly excl_l + 1.
    lag2 = 9000 + excl_l + 1
    hay[lag2:lag2 + n] += (0.7 * needle * np.exp(
        2j * np.pi * -30.0 * t / FS)).astype(np.complex64)
    fr, lg, vv = overlap_save_peaks(needle, hay, freqs, FS, 3,
                                    exclude_freq=excl_f,
                                    exclude_lag=excl_l)
    got = _finite_rows(fr, lg, vv)
    assert got[0] == (-30.0, 9000)
    assert (-30.0, lag2) in got


def test_overlap_save_peaks_emitter_on_block_boundary():
    """An emitter whose lag sits ON an overlap-save block edge is
    reported once (cross-block skirt dedup), alongside the others."""
    from caf_cookoff_tpu.models.overlap_save import (
        overlap_save_peaks,
        plan_blocks,
    )

    n = 1024
    _, v, _ = plan_blocks(n, 60000)
    needle, hay, _ = _multi_emitter_capture(
        truths=((-30.0, 9000, 1.0), (45.0, v - 1, 0.8)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    fr, lg, vv = overlap_save_peaks(needle, hay, freqs, FS, 4)
    got = _finite_rows(fr, lg, vv)
    assert got[0] == (-30.0, 9000) and got[1] == (45.0, v - 1)
    # No duplicate of the boundary emitter within one exclusion cell.
    near = [(f, l) for f, l in got[2:] if f == 45.0 and abs(l - (v - 1)) < 64]
    assert not near


def test_streaming_multi_emitter_across_chunks():
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    # 40800 straddles the 8192-sample chunk boundary at 40960.
    needle, hay, truths = _multi_emitter_capture(
        truths=((-30.0, 9000, 1.0), (45.0, 40800, 0.8),
                (10.0, 60000, 0.6)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=4)
    for off in range(0, len(hay), 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    assert _finite_rows(fr, lg, vv)[:3] == truths
    # best() is the lattice's strongest entry.
    assert s.best()[:2] == truths[0]


def test_streaming_stein_lattice():
    """Multi-emitter through the FUSED stein stream: per-entry carried
    windows re-score exactly, post-re-score NMS dedups coarse cells
    that collapse onto one emitter."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    needle, hay, truths = _multi_emitter_capture(
        truths=((-30.0, 9000, 1.0), (45.0, 40800, 0.8),
                (10.0, 60000, 0.6)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=4, backend="stein")
    for off in range(0, len(hay), 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    assert _finite_rows(fr, lg, vv)[:3] == truths
    assert s.best()[:2] == truths[0]


def test_streaming_stein_same_bin_emitters():
    """Two emitters in the SAME doppler bin at distinct lags inside ONE
    chunk window both reach the lattice through the fused stein stream.

    Round-3 caveat (retired): the kernel's per-bin (max, argmax)
    epilogue presented one candidate per doppler bin per window, so the
    weaker same-bin emitter was invisible whenever both fell in one
    chunk.  The ``want_top2`` epilogue carries a second
    ``>=exclude_lag``-separated lag candidate per bin, making this the
    BASELINE config-4 case the XLA path already handled."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    # Lags 9000 and 12000 both land in chunk window [8192, 16384):
    # same frequency => same doppler bin, 3000-sample separation.
    needle, hay, truths = _multi_emitter_capture(
        truths=((-30.0, 9000, 1.0), (-30.0, 12000, 0.7)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=2, backend="stein")
    for off in range(0, len(hay), 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    assert _finite_rows(fr, lg, vv) == truths
    assert s.best()[:2] == truths[0]


def test_streaming_stein_same_bin_weaker_first():
    """Same-bin pair with the WEAKER emitter at the earlier lag — pins
    that slot 2 is the separated second max, not just 'the later lag'."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    needle, hay, truths = _multi_emitter_capture(
        truths=((10.0, 13500, 1.0), (10.0, 9100, 0.65)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=3, backend="stein")
    for off in range(0, len(hay), 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    got = _finite_rows(fr, lg, vv)
    assert got[:2] == truths
    # Nothing spurious within one exclusion cell of either emitter.
    for f, lag in truths:
        near = [(g, l) for g, l in got[2:] if g == f and abs(l - lag) < 64]
        assert not near


def _narrowband_noise_needle(n=1024, frac=32, seed=13):
    """Band-limited noise: wide lag mainlobe (~fs·frac/fs = frac
    samples), thumbtack ambiguity — unlike an LFM chirp there is no
    range-doppler ridge to outrank a genuine second emitter."""
    rng = np.random.default_rng(seed)
    spec = np.zeros(n, np.complex64)
    nb = n // frac
    spec[:nb // 2] = (rng.standard_normal(nb // 2)
                      + 1j * rng.standard_normal(nb // 2))
    spec[-nb // 2:] = (rng.standard_normal(nb // 2)
                       + 1j * rng.standard_normal(nb // 2))
    needle = np.fft.ifft(spec).astype(np.complex64)
    return needle / np.abs(needle).max(), rng


def test_streaming_stein_same_bin_tile_boundary_skirt():
    """The ``want_top2`` exactness bound (|Δlag| > 2·cell) holds when
    the stronger emitter's mainlobe straddles a FUSED_TILE boundary —
    the adversarial geometry where the previous tile's per-bin max is
    the stronger's SKIRT, not a real peak, and a naive per-tile second
    pick would mask the true weaker emitter.

    Also exercises the constrained re-score: each lattice entry's
    exact argmax is limited to one cell around its own carried
    candidate, so the nearby stronger emitter inside the same carried
    window cannot collapse the weaker entry onto itself."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF
    from caf_cookoff_tpu.models.batched_stein import FUSED_TILE

    n, total = 1024, 32768
    t = np.arange(n)
    needle, rng = _narrowband_noise_needle(n)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    excl_f, excl_l = resolution_cell(needle, freqs, FS)
    hay = (1e-5 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    base = 8192                                   # chunk-2 window start
    lag1 = base + 4 * FUSED_TILE + 5              # 5 past a tile edge
    lag2 = lag1 - (2 * excl_l + 8)                # previous tile, >2*cell
    truths = [(-30.0, lag1), (-30.0, lag2)]
    for amp, (f, lag) in zip((1.0, 0.6), truths):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    s = StreamingCAF(needle, freqs, FS, num_peaks=2, backend="stein",
                     chunk_len=8192)
    for off in range(0, total, 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    got = _finite_rows(fr, lg, vv)
    assert len(got) == 2
    # Cell-level agreement: the wide-mainlobe waveform legitimately
    # ranks an adjacent doppler bin / neighboring lag sample first.
    for (f_want, l_want), (f_got, l_got) in zip(truths, got):
        assert abs(f_got - f_want) <= 2.5 and abs(l_got - l_want) <= 2, \
            (got, truths)
    # The documented residual regime — a same-bin pair under one cell
    # of guard apart, (cell, 2*cell] — routes to the XLA stream, which
    # must recover it (pins that the escape hatch exists and works).
    hay2 = (1e-5 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total))
            ).astype(np.complex64)
    truths2 = [(-30.0, lag1), (-30.0, lag1 - (excl_l + 5))]
    for amp, (f, lag) in zip((1.0, 0.6), truths2):
        hay2[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    s2 = StreamingCAF(needle, freqs, FS, num_peaks=2, backend="xla",
                      chunk_len=8192)
    for off in range(0, total, 8192):
        s2.process(hay2[off:off + 8192])
    got2 = _finite_rows(*s2.peaks())
    assert len(got2) == 2
    # Within one guard cell the two mainlobes overlap and interfere —
    # the grid argmax shifts a few samples; assert distinct detections
    # near each truth, not sample-exactness.
    for (f_want, l_want), (f_got, l_got) in zip(truths2, got2):
        assert abs(f_got - f_want) <= 2.5 and abs(l_got - l_want) <= 8, \
            (got2, truths2)


@pytest.mark.parametrize("shape", [dict(time=4), dict(time=2, doppler=2),
                                   dict(time=8), dict(time=4, doppler=2)])
def test_sharded_multi_emitter(shape):
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import sharded_overlap_save_peaks

    needle, hay, truths = _multi_emitter_capture()
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    n_dev = int(np.prod(list(shape.values())))
    mesh = make_mesh(devices=jax.devices()[:n_dev], **shape)
    fr, lg, vv = sharded_overlap_save_peaks(needle, hay, freqs, FS, mesh, 4)
    assert _finite_rows(fr, lg, vv)[:3] == truths


def test_sharded_emitter_straddles_shard_boundary():
    """An emitter whose correlation window spans two time shards is
    recovered once — the ppermute halo supplies the tail samples and
    the cross-shard NMS merge dedups the skirt."""
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import sharded_overlap_save_peaks

    n, total, t_shards = 1024, 65536, 4
    total_lags = total - n + 1
    chunk = -(-total_lags // t_shards)     # matches the engine's sizing
    lag = chunk - n // 2                   # window [lag, lag+n) spans shards
    needle, hay, truths = _multi_emitter_capture(
        n=n, total=total, truths=((-30.0, lag, 1.0), (10.0, 60000, 0.6)))
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    mesh = make_mesh(time=t_shards, devices=jax.devices()[:t_shards])
    fr, lg, vv = sharded_overlap_save_peaks(needle, hay, freqs, FS, mesh, 4)
    got = _finite_rows(fr, lg, vv)
    assert got[0] == (-30.0, lag) and got[1] == (10.0, 60000)
    # No same-frequency duplicate of the straddling emitter (slots past
    # the real emitters may hold doppler sidelobes at OTHER frequencies
    # beyond the exclusion window — expected top-P behavior).
    near = [(f, l) for f, l in got[2:] if f == -30.0 and abs(l - lag) < 64]
    assert not near


def test_sharded_lattice_padded_doppler_no_duplicate():
    """Doppler-grid padding must not double-report an emitter at the
    last grid frequency (ADVICE r3: pad_axis_to duplicates the last
    bin; a duplicate row farther than exclude_freq from the original
    survived the NMS merge and displaced a real weaker emitter)."""
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import sharded_overlap_save_peaks

    # 21 bins pad to 24 on a doppler=4 mesh: pad rows sit 1..3 bins past
    # the last real row — row +3 is outside exclude_freq=2.  The 25 Hz
    # step keeps the 1024-sample needle's fs/N ~ 47 Hz mainlobe inside
    # the 2-bin exclusion so only genuine rows compete for slots.
    freqs = np.arange(-250.0, 251.0, 25.0, dtype=np.float32)
    assert len(freqs) == 21
    needle, hay, truths = _multi_emitter_capture(
        total=40960, truths=((250.0, 1200, 1.0), (-100.0, 30000, 0.6)))
    mesh = make_mesh(doppler=4, devices=jax.devices()[:4])
    fr, lg, vv = sharded_overlap_save_peaks(
        needle, hay, freqs, FS, mesh, 4, exclude_freq=2, exclude_lag=32)
    got = _finite_rows(fr, lg, vv)
    assert got[:2] == truths, got
    assert len(set(got)) == len(got), f"duplicate lattice rows: {got}"


def test_batched_lattice_padded_doppler_no_duplicate():
    """Same pad-row guard through the three-axis batched lattice."""
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import batched_overlap_save_peaks

    freqs = np.arange(-250.0, 251.0, 25.0, dtype=np.float32)
    rng = np.random.default_rng(7)
    n, total = 1024, 40960
    t = np.arange(n)
    needles, hays, truths = [], [], []
    for b in range(2):
        nd = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
        hy = (1e-4 * (rng.standard_normal(total)
                      + 1j * rng.standard_normal(total))
              ).astype(np.complex64)
        es = [(250.0, 1200 + 500 * b), (-100.0 - 25.0 * b,
                                        30000 + 700 * b)]
        for amp, (f, lag) in zip((1.0, 0.6), es):
            hy[lag:lag + n] += (amp * nd * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
        needles.append(nd)
        hays.append(hy)
        truths.append(es)
    mesh = make_mesh(pair=2, doppler=4, devices=jax.devices()[:8])
    fr, lg, vv = batched_overlap_save_peaks(
        np.stack(needles), np.stack(hays), freqs, FS, mesh, 4,
        exclude_freq=2, exclude_lag=32)
    for b in range(2):
        got = _finite_rows(fr[b], lg[b], vv[b])
        assert got[:2] == truths[b], (b, got)
        assert len(set(got)) == len(got), f"duplicate rows: {got}"


def test_batched_three_axis_lattices():
    """Per-pair top-P lattices through the config-5 pattern: pairs x
    doppler x time all sharded at once, every pair's emitters recovered
    (the lattice folds over (doppler, time) but stays per-pair)."""
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import batched_overlap_save_peaks

    rng = np.random.default_rng(5)
    pairs, n, total = 4, 1024, 32768
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, total))
                    + 1j * rng.standard_normal((pairs, total)))
            ).astype(np.complex64)
    t = np.arange(n)
    truths = {}
    for b in range(pairs):
        es = [(-30.0 + 5 * b, 3000 + 700 * b), (40.0 - 5 * b,
                                                20000 + 900 * b)]
        truths[b] = es
        for amp, (f, lag) in zip((1.0, 0.7), es):
            hays[b, lag:lag + n] += (amp * needles[b] * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    mesh = make_mesh(pair=2, doppler=2, time=2)
    fr, lg, vv = batched_overlap_save_peaks(needles, hays, freqs, FS,
                                            mesh, 3)
    assert fr.shape == (pairs, 3)
    for b in range(pairs):
        assert _finite_rows(fr[b], lg[b], vv[b])[:2] == truths[b]


@pytest.mark.parametrize("seed", range(5))
def test_lattice_fuzz_and_mesh_determinism(seed):
    """Randomized emitters: the lattice recovers every injected emitter
    whose separation exceeds the resolution cell, and the time/doppler-
    sharded lattice matches the single-device one EXACTLY (same values,
    same order) across a mesh — determinism across shardings."""
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peaks
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import sharded_overlap_save_peaks

    rng = np.random.default_rng(100 + seed)
    n, total = 1024, 49152
    step = float(rng.choice([1.0, 2.5]))
    freqs = np.arange(-100, 100, step, dtype=np.float32)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    from caf_cookoff_tpu.ops.peak import resolution_cell

    excl_f, excl_l = resolution_cell(needle, freqs, FS)
    num = int(rng.integers(2, 5))
    # Emitters separated by > the exclusion cell in BOTH axes.
    t = np.arange(n)
    truths = []
    while len(truths) < num:
        f = float(freqs[int(rng.integers(5, len(freqs) - 5))])
        lag = int(rng.integers(0, total - n))
        if all(abs(f - f2) > (excl_f + 2) * step
               or abs(lag - l2) > excl_l + 2 for f2, l2 in truths):
            truths.append((f, lag))
    amps = np.linspace(1.0, 0.5, num)
    for amp, (f, lag) in zip(amps, truths):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    p = num + 1
    fr, lg, vv = overlap_save_peaks(needle, hay, freqs, FS, p)
    got = set(_finite_rows(fr, lg, vv)[:num])
    assert got == set(truths), (seed, got, truths)
    mesh = make_mesh(time=2, doppler=2,
                     devices=jax.devices()[:4])
    fr2, lg2, vv2 = sharded_overlap_save_peaks(needle, hay, freqs, FS,
                                               mesh, p)
    assert fr2.tolist() == fr.tolist()
    assert lg2.tolist() == lg.tolist()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_batched_local_lattices():
    from caf_cookoff_tpu.models.overlap_save import (
        batched_overlap_save_peaks_local,
    )

    rng = np.random.default_rng(5)
    pairs, n, total = 3, 1024, 32768
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, total))
                    + 1j * rng.standard_normal((pairs, total)))
            ).astype(np.complex64)
    t = np.arange(n)
    truths = {}
    for b in range(pairs):
        es = [(-30.0 + 5 * b, 3000 + 500 * b), (40.0, 20000 + 700 * b)]
        truths[b] = es
        for amp, (f, lag) in zip((1.0, 0.7), es):
            hays[b, lag:lag + n] += (amp * needles[b] * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    fr, lg, vv = batched_overlap_save_peaks_local(needles, hays, freqs,
                                                  FS, 3)
    assert fr.shape == (pairs, 3)
    for b in range(pairs):
        assert _finite_rows(fr[b], lg[b], vv[b])[:2] == truths[b]


def test_cli_batch_num_peaks(tmp_path, capsys):
    import json

    from caf_cookoff_tpu.cli import main
    from caf_cookoff_tpu.utils.io import write_c64

    rng = np.random.default_rng(5)
    n, total = 1024, 32768
    t = np.arange(n)
    specs, truths = [], []
    for b in range(2):
        needle = (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
        hay = (1e-4 * (rng.standard_normal(total) + 1j
                       * rng.standard_normal(total))).astype(np.complex64)
        es = [(-30.0 + 5 * b, 3000 + 100 * b), (40.0, 20000 + 200 * b)]
        truths.append(es)
        for amp, (f, lag) in zip((1.0, 0.7), es):
            hay[lag:lag + n] += (amp * needle * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
        write_c64(str(tmp_path / f"n{b}.c64"), needle)
        write_c64(str(tmp_path / f"c{b}.c64"), hay)
        specs.append(f"{tmp_path}/n{b}.c64:{tmp_path}/c{b}.c64")
    rc = main(["batch", *specs, "--full-haystack", "--num-peaks", "3",
               "--freq-step", "2.5", "--json"])
    assert rc == 0
    records = json.loads(capsys.readouterr().out)
    for rec, es in zip(records, truths):
        got = [(p["freq_hz"], p["lag_samples"]) for p in rec["peaks"]][:2]
        assert got == es


def test_cli_full_haystack_num_peaks(tmp_path, capsys):
    from caf_cookoff_tpu.cli import main
    from caf_cookoff_tpu.utils.io import write_c64

    needle, hay, truths = _multi_emitter_capture()
    n_path = tmp_path / "needle.c64"
    h_path = tmp_path / "capture.c64"
    write_c64(str(n_path), needle)
    write_c64(str(h_path), hay)
    rc = main(["run", str(n_path), str(h_path), "--full-haystack",
               "--num-peaks", "3", "--freq-step", "2.5"])
    assert rc == 0
    out = capsys.readouterr().out
    for i, (f, lag) in enumerate(truths):
        assert f"peak {i + 1}: {f:+9.3f} Hz @ lag {lag:>6d}" in out
