"""Compiled on-device golden tests: all 10 fixtures x every backend on
the GPU, plus every engine family compiled at its real widths.

Every test here is marked ``gpu`` and skips where JAX finds no GPU (the
decision is made by a fixture, at run time).  ``python chip_smoke.py``
runs this module on the card in its own process; the CPU suite covers
the same engines at small shapes.  Reference analog: ``cargo test``
exercising every strategy on the real FFT backends
(``caf_rust/tests/test.rs``).
"""

import numpy as np
import pytest

from caf_cookoff_tpu.config import FreqGrid
from caf_cookoff_tpu.models.filterbank import caf_peak, caf_surface

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _require_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


FS = 48_000.0

# Same table as tests/test_golden.py (the literal test.rs asserts).
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

BACKENDS = ["xla", "matmul", "stein"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_golden_on_chip(chirp, backend, idx, grid, want_freq, want_lag):
    needle, haystack, _ = chirp(idx)
    freqs = grid.frequencies(np.float32)
    freq, lag, _ = caf_peak(needle, haystack, freqs, FS, backend=backend)
    assert freq == pytest.approx(want_freq, abs=1e-4)
    assert lag == want_lag


def test_surface_tiers_match_on_chip(chirp):
    """The matmul-DFT surface vs the cuFFT (xla) surface on the card:
    peaks identical, values within 1e-5 of the surface peak.  On the
    0.5 Hz grid chirp_0's truth (69.25 Hz) sits midway between two bins
    whose values differ by ~7e-6 of the peak, so only two f32-grade
    tiers agree on the argmax: this holds the exact 'matmul' tier to
    HIGHEST precision (TF32 picks the neighbouring bin)."""
    needle, haystack, _ = chirp(0)
    freqs = FreqGrid(-100.0, 100.0, 0.5).frequencies(np.float32)
    want = np.asarray(caf_surface(needle, haystack, freqs, FS,
                                  backend="xla"))
    got = np.asarray(caf_surface(needle, haystack, freqs, FS,
                                 backend="matmul"))
    assert got.shape == want.shape
    assert np.unravel_index(got.argmax(), got.shape) == \
        np.unravel_index(want.argmax(), want.shape)
    scale = want.max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_batched_os_on_chip(chirp):
    """The windowed long-capture engine compiled on the card: golden
    full-capture search (no truncation)."""
    import pathlib

    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.utils.io import load_c64

    data = pathlib.Path(__file__).resolve().parents[1] / "data"
    needle = load_c64(data / "chirp_0_raw.c64")
    full_hay = load_c64(data / "chirp_0_T+202samp_F+69.25Hz.c64")
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    fr, lg, _ = batched_stein_os_peak(needle[None], full_hay[None],
                                      freqs, FS)
    assert (float(fr[0]), int(lg[0])) == (69.25, 202)


def test_batched_stein_on_chip(chirp):
    """The config-2 engine compiled on the card: golden parity for a
    4-pair batch."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peak

    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    idxs = [0, 3, 5, 7]
    wants = {0: (69.25, 202), 3: (-76.25, 151), 5: (-92.75, 177),
             7: (68.25, 84)}
    needles, hays = [], []
    for i in idxs:
        n, h, _ = chirp(i)
        needles.append(n)
        hays.append(h)
    fr, lg, _ = batched_stein_peak(np.stack(needles), np.stack(hays),
                                   freqs, FS)
    for b, i in enumerate(idxs):
        assert (float(fr[b]), int(lg[b])) == wants[i]


def test_streaming_stein_on_chip(chirp):
    """Stein-mode streaming compiled on the card: chunked full-capture
    golden search."""
    import pathlib

    from caf_cookoff_tpu.models.streaming import StreamingCAF
    from caf_cookoff_tpu.utils.io import load_c64

    data = pathlib.Path(__file__).resolve().parents[1] / "data"
    needle = load_c64(data / "chirp_0_raw.c64")
    capture = load_c64(data / "chirp_0_T+202samp_F+69.25Hz.c64")
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    s = StreamingCAF(needle, freqs, FS, backend="stein", chunk_len=2048)
    for i in range(0, len(capture), 2048):
        s.process(capture[i:i + 2048])
    freq, lag, _ = s.best()
    assert (freq, lag) == (69.25, 202)


def test_streaming_stein_same_bin_on_chip():
    """The coarse stage's ``want_top2`` epilogue on the card: two
    emitters in one doppler bin at distinct lags inside one chunk
    window, both recovered by the stein stream's lattice."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    rng = np.random.default_rng(7)
    n, total = 1024, 32768
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    truths = [(-30.0, 9000), (-30.0, 12000)]
    for amp, (f, lag) in zip((1.0, 0.7), truths):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=2, backend="stein",
                     chunk_len=8192)
    for off in range(0, total, 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    got = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
           if np.isfinite(float(v))]
    assert got == truths


def test_banded_wide_span_on_chip():
    """Banded Stein (bands as the coarse stage's batch axis) compiled
    on the card: exact wide-span answer vs the matmul filterbank."""
    rng = np.random.default_rng(12)
    n = 4096
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    f_true, lag = 4300.0, 512
    hay = np.zeros(n, np.complex64)
    hay[lag:] = (needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS)
    ).astype(np.complex64)[: n - lag]
    freqs = np.arange(-6000.0, 6000.0, 100.0, dtype=np.float32)
    from caf_cookoff_tpu.models.stein import stein_caf_peak

    banded = stein_caf_peak(needle, hay, freqs, FS)
    exact = caf_peak(needle, hay, freqs, FS, backend="matmul")
    assert banded[:2] == exact[:2] == (f_true, lag)


def test_banded_windowed_os_on_chip():
    """The banded x windowed composition (config 3's shape, scaled)
    compiled on the card: multiple bands AND multiple lag windows per
    pair, with an uneven tail window exercising the per-program lag
    bound (p_eff = bands x windows programs)."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_os_peak
    from caf_cookoff_tpu.models.stein import _plan_bands

    rng = np.random.default_rng(21)
    n, lags, k = 2048, 12_000, 500
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (0.1 * (rng.standard_normal(lags + n)
                  + 1j * rng.standard_normal(lags + n))).astype(np.complex64)
    freqs = np.linspace(-500.0, 500.0, k, endpoint=False).astype(np.float32)
    plan = _plan_bands(FS, freqs)
    assert plan["bands"] > 1                    # really banded
    assert -(-lags // (2 * n)) > 1              # really multi-window
    # Emitter in the FINAL, partial lag window (lags not a multiple of
    # the 2n window): the per-program bound must cut past-num_lags
    # columns without dropping the bin.
    f_true, lag_true = float(freqs[457]), 11_990
    t = np.arange(n)
    add = (needle * np.exp(2j * np.pi * f_true * t / FS)).astype(np.complex64)
    hay[lag_true:lag_true + n] += add[: lags + n - lag_true]
    fr, lg, _ = batched_stein_os_peak(needle[None], hay[None], freqs, FS,
                                      num_lags=lags)
    assert (float(fr[0]), int(lg[0])) == (f_true, lag_true)


def test_stein_os_routes_fused_on_chip():
    """``stein_overlap_save_peak`` (the ``run --full-haystack`` engine)
    routes its coarse pass through the windowed engine: exact answer
    on a capture whose emitter sits past the first lag window."""
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak

    rng = np.random.default_rng(33)
    n, lags = 4096, 20_000
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (0.1 * (rng.standard_normal(lags + n)
                  + 1j * rng.standard_normal(lags + n))).astype(np.complex64)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    f_true, lag_true = 42.5, 13_777
    t = np.arange(n)
    hay[lag_true:lag_true + n] += (needle * np.exp(
        2j * np.pi * f_true * t / FS)).astype(np.complex64)
    freq, lag, value = stein_overlap_save_peak(needle, hay, freqs, FS)
    assert (freq, lag) == (f_true, lag_true)
    assert value > 0


def test_sharded_batched_stein_on_chip(chirp):
    """The batch engine under ``shard_map`` on the card (1-device
    ``pair`` mesh)."""
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import sharded_batched_stein_peak

    import jax

    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    idxs = [0, 3]
    wants = {0: (69.25, 202), 3: (-76.25, 151)}
    needles, hays = [], []
    for i in idxs:
        n, h, _ = chirp(i)
        needles.append(n)
        hays.append(h)
    mesh = make_mesh(pair=1, devices=jax.devices()[:1])
    fr, lg, _ = sharded_batched_stein_peak(np.stack(needles),
                                           np.stack(hays), freqs, FS,
                                           mesh)
    for b, i in enumerate(idxs):
        assert (float(fr[b]), int(lg[b])) == wants[i]


def test_remaining_sharded_engines_on_chip(chirp, fixture_pairs):
    """Every other shard_map engine compiled on the card (1-device
    meshes) — 'works on the CPU mesh' does not imply 'compiles for the
    GPU', so the whole sharded family gets a compiled smoke here:
    doppler-sharded filterbank + Stein (top-k refine collectives),
    pair-sharded filterbank batch, time-sharded overlap-save, and the
    three-axis batched OS engine (config 5's pattern)."""
    import jax

    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import (
        batched_caf_peak,
        batched_overlap_save_peak,
        sharded_caf_peak,
        sharded_overlap_save_peak,
        sharded_stein_peak,
    )

    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    needle, hay, _ = chirp(0)
    dev = jax.devices()[:1]
    want = (69.25, 202)

    mesh_d = make_mesh(doppler=1, devices=dev)
    freq, lag, _ = sharded_caf_peak(needle, hay, freqs, FS, mesh_d)
    assert (freq, lag) == want
    freq, lag, _ = sharded_stein_peak(needle, hay, freqs, FS, mesh_d)
    assert (freq, lag) == want

    mesh_p = make_mesh(pair=1, devices=dev)
    n3, h3, _ = chirp(3)
    fr, lg, _ = batched_caf_peak(np.stack([needle, n3]),
                                 np.stack([hay, h3]), freqs, FS, mesh_p)
    assert (float(fr[0]), int(lg[0])) == want
    assert (float(fr[1]), int(lg[1])) == (-76.25, 151)

    # The OS engines search the FULL captures (truncated haystacks
    # collapse the lag range to a single lag).
    from caf_cookoff_tpu.utils.io import load_c64

    full0 = load_c64(fixture_pairs[0][1])
    full3 = load_c64(fixture_pairs[3][1])
    mesh_t = make_mesh(time=1, devices=dev)
    freq, lag, _ = sharded_overlap_save_peak(needle, full0, freqs, FS,
                                             mesh_t)
    assert (freq, lag) == want

    width = max(len(full0), len(full3))
    fulls = np.stack([np.pad(full0, (0, width - len(full0))),
                      np.pad(full3, (0, width - len(full3)))])
    fr, lg, _ = batched_overlap_save_peak(np.stack([needle, n3]), fulls,
                                          freqs, FS, mesh_p)
    assert (float(fr[0]), int(lg[0])) == want
    assert (float(fr[1]), int(lg[1])) == (-76.25, 151)


def test_refine_on_chip(chirp, fixture_pairs):
    """Sub-bin zoom refinement compiled on the card: every fixture
    within <=0.01 Hz / <=0.1 sample of the INJECTED truth (the grids
    above can only ever report the snap, e.g. test.rs:162's 36.0 for
    chirp_1's true +35.99)."""
    from caf_cookoff_tpu.ops.refine import refine_peak
    from caf_cookoff_tpu.utils.io import load_c64

    freqs = FreqGrid(-100.0, 100.0, 0.5).frequencies(np.float32)
    for idx in range(10):
        needle, hay_t, gt = chirp(idx)
        f0, lag0, _ = caf_peak(needle, hay_t, freqs, FS, backend="matmul")
        hay = load_c64(fixture_pairs[idx][1])
        f_hat, tau_hat, _ = refine_peak(needle, hay, f0, lag0, FS,
                                        coarse_step_hz=0.5,
                                        backend="matmul")
        assert abs(f_hat - gt.freq_hz) <= 0.01, (idx, f_hat, gt)
        assert abs(tau_hat - gt.lag_samples) <= 0.1, (idx, tau_hat, gt)


def test_multi_emitter_scan_on_chip():
    """Top-P lattice scan (overlap_save_peaks) compiled on the card:
    three injected emitters fully recovered, strongest first."""
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peaks

    rng = np.random.default_rng(5)
    n, total = 1024, 65536
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    truths = [(-30.0, 9000, 1.0), (45.0, 40000, 0.8), (10.0, 60000, 0.6)]
    t = np.arange(n)
    for f, lag, amp in truths:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    fr, lg, vv = overlap_save_peaks(needle, hay, freqs, FS, 4,
                                    backend="matmul")
    got = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
           if np.isfinite(float(v))][:3]
    assert got == [(f, lag) for f, lag, _ in truths]


def test_stein_streaming_lattice_on_chip():
    """Multi-emitter lattice through the stein stream compiled on the
    card (per-bin coarse rank + carried windows + exact re-score)."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    rng = np.random.default_rng(5)
    n, total = 1024, 65536
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    truths = [(-30.0, 9000, 1.0), (45.0, 40800, 0.8), (10.0, 60000, 0.6)]
    t = np.arange(n)
    for f, lag, amp in truths:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s = StreamingCAF(needle, freqs, FS, num_peaks=4, backend="stein")
    for off in range(0, total, 8192):
        s.process(hay[off:off + 8192])
    fr, lg, vv = s.peaks()
    got = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
           if np.isfinite(float(v))][:3]
    assert got == [(f, lag) for f, lag, _ in truths]


def test_rate_overlap_save_on_chip():
    """Round-4: joint (rate, doppler, lag) search over a long capture
    compiled on the card — a 400 Hz/s sweep at lag 50k in a
    65536-lag capture, coarse dechirp-bank x overlap-save then refined
    to <=0.1 Hz/s."""
    from scipy.signal import filtfilt, firwin

    from caf_cookoff_tpu.models.rate import rate_overlap_save_peak
    from caf_cookoff_tpu.ops.refine import refine_peak_rate

    rng = np.random.default_rng(42)
    n, total = 4096, 65536 + 4096
    lag_true, rate_true, f0 = 50_000, 400.0, -400.0
    taps = firwin(127, 0.25)
    needle = filtfilt(taps, 1.0, rng.standard_normal(n)
                      + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (0.002 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t_abs = (lag_true + np.arange(n)) / FS
    ph = 2 * np.pi * f0 * t_abs + np.pi * rate_true * t_abs * t_abs
    hay[lag_true:lag_true + n] += (needle
                                   * np.exp(1j * ph)).astype(np.complex64)
    f_ws = f0 + rate_true * lag_true / FS
    freqs = np.arange(-100.0, 100.1, 2.5, dtype=np.float32)
    rates = np.arange(-600.0, 601.0, 150.0)
    r_c, f_c, lag_c, _ = rate_overlap_save_peak(
        needle, hay, freqs, rates, FS, backend="matmul")
    assert abs(lag_c - lag_true) <= 2
    assert abs(r_c - rate_true) <= 150.0
    f2, r2, t2, _ = refine_peak_rate(
        needle, hay, f_c, lag_c, FS, rate0_hz_per_s=r_c,
        max_rate_hz_per_s=150.0, coarse_step_hz=2.5, backend="matmul")
    assert abs(r2 - rate_true) <= 0.1
    assert abs(t2 - lag_true) <= 0.1
    assert abs(f2 - f_ws) <= 0.05


def test_rate_lattice_on_chip():
    """Round-4+: multi-emitter through the joint (rate, doppler, lag)
    search compiled on the card — two accelerating emitters at distinct
    (rate, lag) both reach the lattice, with per-slot SNR."""
    from caf_cookoff_tpu.models.rate import rate_overlap_save_peaks

    rng = np.random.default_rng(7)
    n, total = 2048, 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (0.01 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t_sec = np.arange(n) / FS
    emitters = [(20.0, 400.0, 4500, 1.0), (-31.0, -200.0, 900, 0.8)]
    for f0, rate, lag, amp in emitters:
        cp = amp * needle * np.exp(2j * np.pi * f0 * t_sec
                                   + 1j * np.pi * rate * t_sec ** 2)
        hay[lag:lag + n] += cp.astype(np.complex64)
    freqs = np.arange(-60.0, 60.0, 0.5, dtype=np.float32)
    rates = np.arange(-600.0, 601.0, 200.0)
    rr, ff, ll, vv, snr = rate_overlap_save_peaks(
        needle, hay, freqs, rates, FS, num_peaks=2, backend="matmul",
        with_snr=True)
    got = sorted(zip(ll.tolist(), rr.tolist(), ff.tolist()))
    want = sorted((lag, r, f0) for f0, r, lag, _ in emitters)
    for (lg_g, r_g, f_g), (lg_w, r_w, f_w) in zip(got, want):
        assert lg_g == lg_w and r_g == r_w
        assert abs(f_g - f_w) <= 1.0
    assert np.all(snr > 10.0)


def test_detection_threshold_on_chip():
    """Round-4 detection decisions compiled on the card: noise-only
    capture -> zero detections; two emitters in eight slots -> two."""
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peaks

    rng = np.random.default_rng(7)
    n, total = 512, 4096
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    freqs = np.arange(-100.0, 100.1, 2.5, dtype=np.float32)
    rng2 = np.random.default_rng(1000)
    noise = (rng2.standard_normal(total)
             + 1j * rng2.standard_normal(total)).astype(np.complex64)
    _, _, vv = overlap_save_peaks(needle, noise, freqs, FS, 4,
                                  min_snr_db="auto", backend="matmul")
    assert int(np.sum(np.isfinite(vv))) == 0

    hay = noise.copy()
    t = np.arange(n)
    for f, lag, amp in [(30.0, 800, 1.0), (-60.0, 2500, 0.7)]:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    fr, lg, vv, snr = overlap_save_peaks(
        needle, hay, freqs, FS, 8, min_snr_db="auto", with_snr=True,
        backend="matmul")
    det = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
           if np.isfinite(v)]
    assert len(det) == 2
    assert [lag for _, lag in det] == [800, 2500]


def test_fused_multi_emitter_lattices_on_chip():
    """Round-5 multi-emitter segmented engines compiled on the card: the
    OS lattice (want_top2 epilogue at windows>1) and the
    equal-length lattice recover injected emitter sets exactly."""
    from caf_cookoff_tpu.models.batched_stein import (
        batched_stein_os_peaks,
        batched_stein_peaks,
    )

    rng = np.random.default_rng(5)
    n, total = 1024, 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    truths = [(-30.0, 3000, 1.0), (45.0, 9000, 0.8), (10.0, 14000, 0.6)]
    for f, lag, amp in truths:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    fr, lg, vv = batched_stein_os_peaks(needle[None], hay[None], freqs,
                                        FS, 4)
    got = [(float(f), int(l)) for f, l, v in zip(fr[0], lg[0], vv[0])
           if np.isfinite(float(v))][:3]
    assert got == [(f, lag) for f, lag, _ in truths], got

    hay2 = (needle * np.exp(2j * np.pi * -20.0 * t / FS)
            ).astype(np.complex64)
    hay2 = hay2 + 0.7 * np.roll((needle * np.exp(
        2j * np.pi * 35.0 * t / FS)).astype(np.complex64), 300)
    hay2 = (hay2 + 1e-4 * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    fr2, lg2, vv2 = batched_stein_peaks(needle[None], hay2[None],
                                        freqs, FS, 2)
    got2 = [(float(f), int(l))
            for f, l, v in zip(fr2[0], lg2[0], vv2[0])
            if np.isfinite(float(v))]
    # Overlapping same-window emitters interfere: the surface peak can
    # sit an adjacent bin off the injected frequency (a true near-tie,
    # tier-dependent) — compare against the SAME-backend full-surface
    # oracle, with the injected lags exact.
    from caf_cookoff_tpu.models.filterbank import caf_surface
    from caf_cookoff_tpu.ops.peak import find_peaks, resolve_exclusions

    surf = np.asarray(caf_surface(needle, hay2, freqs, FS,
                                  backend="matmul"))
    ef, el = resolve_exclusions(needle, freqs, FS, None, None)
    pk = find_peaks(surf, 2, ef, el, lag_period=surf.shape[-1])
    want2 = [(float(freqs[int(f)]), int(l))
             for f, l in zip(pk.freq_idx, pk.lag_idx)]
    assert got2 == want2, (got2, want2)
    assert [l for _, l in got2] == [0, 300], got2


def test_segmented_rate_engines_on_chip():
    """Round-5 segmented rate search on the card: argmax and lattice
    match the exact serial engine's answers (rank-then-score)."""
    from caf_cookoff_tpu.models.rate import (
        rate_overlap_save_peak,
        stein_rate_os_peak,
        stein_rate_os_peaks,
    )

    rng = np.random.default_rng(8)
    n, total = 2048, 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))
           ).astype(np.complex64)
    t = np.arange(n)
    emitters = [(25.0, 120.0, 3000, 1.0), (-60.0, -120.0, 11000, 0.6)]
    for f0, r, lag, amp in emitters:
        ph = 2 * np.pi * f0 * t / FS + np.pi * r * (t / FS) ** 2
        hay[lag:lag + n] += amp * (needle * np.exp(1j * ph)
                                   ).astype(np.complex64)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    rates = np.arange(-240.0, 241.0, 60.0, dtype=np.float32)
    want = rate_overlap_save_peak(needle, hay, freqs, rates, FS)
    got = stein_rate_os_peak(needle, hay, freqs, rates, FS)
    assert got[:3] == want[:3] == (120.0, 25.0, 3000), (got, want)
    rr, ff, ll, vv = stein_rate_os_peaks(needle, hay, freqs, rates, FS,
                                         3)
    rows = [(float(r), float(f), int(l))
            for r, f, l, v in zip(rr, ff, ll, vv)
            if np.isfinite(float(v))][:2]
    assert rows == [(120.0, 25.0, 3000), (-120.0, -60.0, 11000)], rows
