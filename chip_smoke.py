#!/usr/bin/env python3
"""Bring-up smoke test of the CAF engines on one NVIDIA GPU.

Drives every engine family once through the package's public API and
``caf_cookoff_tpu.cli.main`` (in this process — no child opens the
card), at the reference workload's real widths, and gates every
reported peak bin-exactly against the injected truth AND the argmax of
a plain complex128 filterbank computed on the host over a needle-length
lag window around that truth.  Synthetic captures come from ``--seed``.

    python chip_smoke.py                 # one GPU: every phase below
    python chip_smoke.py --four-gpus     # only the 4-GPU mesh phase

Phases: device, numerics, golden (``selftest`` x 3 backends), headline
(400x8192), batch (64 pairs), long capture (``run --full-haystack``,
2000 x 65536; 2000 x 4194304 in bounded memory; the wide-span banded
route), multi-emitter + stream
(16 x 1024 x 32768, 3 peaks), rate (config-3 shape, R = 9), and the
``gpu``-marked pytest lane.  Each phase prints the compiled programs'
``memory_analysis()``, the device's peak bytes in use, and the host time
of one warm call (ending in ``block_until_ready``) beside the card's
name and power limit.  The last stdout line is one JSON object with
``ok`` and the device; any failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import sys
import time

import numpy as np

from caf_cookoff_tpu.utils.bench import card_line, require_gpu

FS = 48_000.0
ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"
PHASES = ("numerics", "golden", "headline", "batch", "long", "multi",
          "rate", "gpu-tests")


class GateError(AssertionError):
    """A phase's answer disagrees with the truth or the c128 oracle."""


# ---------------------------------------------------------------------------
# Host reference and gates (numpy only; unit-tested on CPU)
# ---------------------------------------------------------------------------


def oracle_peak(needle, capture, freqs, lag_lo: int, lag_hi: int,
                rate=0.0, bins_per_chunk: int = 128):
    """(bin, lag) argmax of the plain complex128 filterbank

        |sum_s capture[lag + s] * conj(needle[s] e^{j(2 pi f s / fs
                                                  + pi r (s / fs)^2)})|^2

    over lags [lag_lo, lag_hi) (capture zero-extended past its end) and
    every bin of ``freqs``; ``rate`` pre-chirps the needle (Hz/s)."""
    n = len(needle)
    lag_lo = max(int(lag_lo), 0)
    width = int(lag_hi) - lag_lo
    seg = np.zeros(width + n - 1, np.complex128)
    part = np.asarray(capture[lag_lo:lag_lo + width + n - 1], np.complex128)
    seg[:len(part)] = part
    nfft = 1 << (len(seg) + n - 1).bit_length()
    seg_f = np.fft.fft(seg, nfft)
    t = np.arange(n) / FS
    base = np.asarray(needle, np.complex128) * np.exp(1j * np.pi * rate
                                                      * t * t)
    best = (-1.0, 0, 0)
    freqs = np.asarray(freqs, np.float64)
    for k0 in range(0, len(freqs), bins_per_chunk):
        f = freqs[k0:k0 + bins_per_chunk, None]
        taps = base[None] * np.exp(2j * np.pi * f * t[None])
        corr = np.fft.ifft(seg_f[None] * np.conj(np.fft.fft(taps, nfft)))
        mag = np.abs(corr[:, :width]) ** 2
        k, tau = np.unravel_index(int(np.argmax(mag)), mag.shape)
        if mag[k, tau] > best[0]:
            best = (float(mag[k, tau]), k0 + int(k), lag_lo + int(tau))
    return best[1], best[2]


def gate(name: str, got, truth, oracle) -> None:
    """Require ``got == truth == oracle`` ((bin, lag) tuples)."""
    got, truth, oracle = (tuple(int(v) for v in x)
                          for x in (got, truth, oracle))
    if not got == truth == oracle:
        raise GateError(f"{name}: engine {got}, truth {truth}, "
                        f"c128 oracle {oracle}")


def bin_of(freqs, f_hz: float) -> int:
    """Grid index of a reported frequency (must sit on the grid)."""
    idx = int(np.argmin(np.abs(np.asarray(freqs, np.float64) - f_hz)))
    if abs(float(freqs[idx]) - f_hz) > 1e-3:
        raise GateError(f"reported {f_hz} Hz is not a grid bin")
    return idx


def plant(rng, n: int, length: int, emitters, noise: float = 0.05):
    """(needle, capture): complex-Gaussian needle, copies at
    ``(lag, f_hz, amp[, rate])`` in complex-Gaussian noise."""
    needle = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              / np.sqrt(2)).astype(np.complex64)
    cap = (noise * (rng.standard_normal(length)
                    + 1j * rng.standard_normal(length))
           / np.sqrt(2)).astype(np.complex64)
    t = np.arange(n) / FS
    for lag, f_hz, amp, *rate in emitters:
        r = rate[0] if rate else 0.0
        sig = amp * needle * np.exp(2j * np.pi * f_hz * t
                                    + 1j * np.pi * r * t * t)
        end = min(lag + n, length)
        cap[lag:end] += sig[:end - lag].astype(np.complex64)
    return needle, cap


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


class Phase:
    """One phase: captures the compiled programs it runs (for their
    ``memory_analysis()``) and reports memory and a warm host time."""

    def __init__(self, name: str, card: str):
        self.name, self.card = name, card
        self.programs = []

    @contextlib.contextmanager
    def capture(self, module, *names):
        """Wrap ``module.<name>`` jitted entry points so their compiled
        executables' memory analyses are recorded."""
        origs = {n: getattr(module, n) for n in names}

        def wrap(name, fn):
            def wrapper(*a, **k):
                compiled = fn.lower(*a, **k).compile()
                self.programs.append((name, compiled.memory_analysis()))
                return fn(*a, **k)
            wrapper.__wrapped__ = getattr(fn, "__wrapped__", fn)
            return wrapper

        for n, fn in origs.items():
            setattr(module, n, wrap(n, fn))
        try:
            yield
        finally:
            for n, fn in origs.items():
                setattr(module, n, fn)

    def timed(self, label: str, fn, reps: int = 10):
        """Host time of one warm call, and the median of ``reps`` more
        (each call's results are pulled to the host or blocked on
        before its clock stops)."""
        import jax

        fn()
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"  [{self.name}] {label}: {times[0]:.3f} ms host time, one "
              f"warm call; median of {reps} more {np.median(times[1:]):.3f}"
              f" ms ({self.card})")

    def report(self):
        import jax

        for name, mem in self.programs:
            fields = {k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
                if hasattr(mem, k)}
            print(f"  [{self.name}] memory_analysis {name}: {fields}")
        peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
        print(f"  [{self.name}] peak_bytes_in_use: {peak}")
        print(f"phase {self.name}: ok")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_numerics(card):
    """Relative error of every DFT tier and matmul precision on the card
    against complex128 / float64 (information for the exact tiers)."""
    import jax
    import jax.numpy as jnp

    from caf_cookoff_tpu.ops import splitfft

    ph = Phase("numerics", card)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
    want = np.fft.fft(x)
    for tier in ("xla", "matmul-highest", "matmul", "matmul-bf16"):
        fft_fn, _ = splitfft.get_split_fft(tier)
        re, im = jax.jit(fft_fn)((jnp.asarray(x.real, jnp.float32),
                                  jnp.asarray(x.imag, jnp.float32)))
        got = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        print(f"  [numerics] DFT tier {tier}: rel err {err:.3e}")
    a = rng.standard_normal((512, 512))
    b = rng.standard_normal((512, 512))
    ref = a @ b
    for prec in ("DEFAULT", "HIGH", "HIGHEST"):
        got = np.asarray(jnp.dot(jnp.asarray(a, jnp.float32),
                                 jnp.asarray(b, jnp.float32),
                                 precision=getattr(jax.lax.Precision,
                                                   prec)), np.float64)
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        print(f"  [numerics] f32 matmul precision {prec}: rel err "
              f"{err:.3e}")
    ph.report()


def phase_golden(card):
    """``selftest`` through the CLI on the default, stein and xla
    backends, then every fixture's default-backend peak against the
    c128 oracle."""
    from caf_cookoff_tpu import cli
    from caf_cookoff_tpu.config import FreqGrid
    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64, parse_ground_truth

    ph = Phase("golden", card)
    data = ROOT / "data"
    for backend in ("auto", "stein", "xla"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["selftest", "--data", str(data),
                           "--backend", backend])
        out = buf.getvalue()
        if rc != 0 or "10/10 golden fixtures exact" not in out:
            raise GateError(f"selftest --backend {backend}: rc {rc}\n{out}")
        print(f"  [golden] selftest --backend {backend}: "
              f"{out.strip().splitlines()[-1]}")
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    for n_path, h_path in ensure_fixtures(data):
        truth = parse_ground_truth(h_path)
        needle = load_c64(n_path)
        hay = load_c64(h_path, count=len(needle))
        f, lag, _ = caf_peak(needle, hay, freqs, FS)
        n = len(needle)
        want = oracle_peak(needle, hay, freqs, truth.lag_samples - n // 2,
                           truth.lag_samples + n // 2)
        # The fixtures' injected frequency is off-grid: truth is its
        # nearest bin, which the oracle decides.
        gate(f"golden chirp_{truth.index}", (bin_of(freqs, f), lag),
             (want[0], truth.lag_samples), want)
    ph.report()


def phase_headline(card, rng):
    """400 x 8192: ``caf_peak`` on stein and the default backend, and the
    timings that pick the default split-FFT tier (xla vs matmul)."""
    import caf_cookoff_tpu.models.filterbank as fb
    import caf_cookoff_tpu.models.stein as st
    from caf_cookoff_tpu.config import BENCH_GRID
    from caf_cookoff_tpu.models.filterbank import caf_peak

    ph = Phase("headline", card)
    n = 4096
    freqs = BENCH_GRID.frequencies(np.float32)
    k_true, lag_true = int(rng.integers(20, 380)), int(rng.integers(1, 1500))
    needle, hay = plant(rng, n, n, [(lag_true, float(freqs[k_true]), 1.0)])
    want = oracle_peak(needle, hay, freqs, lag_true - n // 2,
                       lag_true + n // 2)
    runs = {
        "caf_peak stein": lambda: caf_peak(needle, hay, freqs, FS,
                                           backend="stein"),
        "caf_peak default": lambda: caf_peak(needle, hay, freqs, FS),
        "caf_peak xla": lambda: caf_peak(needle, hay, freqs, FS,
                                         backend="xla"),
        "caf_peak matmul": lambda: caf_peak(needle, hay, freqs, FS,
                                            backend="matmul"),
    }
    with ph.capture(st, "_stein_peak_jit"), \
            ph.capture(fb, "_peak_split_jit"):
        for label, fn in runs.items():
            f, lag, _ = fn()
            gate(f"headline {label}", (bin_of(freqs, f), lag),
                 (k_true, lag_true), want)
    for label, fn in runs.items():
        ph.timed(label, fn)
    ph.report()


def phase_batch(card, rng):
    """64 pairs of 400 x 8192 through ``batched_stein_peak``."""
    import caf_cookoff_tpu.models.batched_stein as bs
    from caf_cookoff_tpu.config import BENCH_GRID

    ph = Phase("batch", card)
    p, n = 64, 4096
    freqs = BENCH_GRID.frequencies(np.float32)
    truths = [(int(rng.integers(20, 380)), int(rng.integers(1, 1500)))
              for _ in range(p)]
    pairs = [plant(rng, n, n, [(lag, float(freqs[k]), 1.0)])
             for k, lag in truths]
    needles = np.stack([a for a, _ in pairs])
    hays = np.stack([b for _, b in pairs])
    with ph.capture(bs, "_batched_stein_peak_jit"):
        fr, lg, _ = bs.batched_stein_peak(needles, hays, freqs, FS)
    for i, (k, lag) in enumerate(truths):
        want = oracle_peak(needles[i], hays[i], freqs, lag - n // 2,
                           lag + n // 2)
        gate(f"batch pair {i}", (bin_of(freqs, fr[i]), lg[i]), (k, lag),
             want)
    ph.timed("batched_stein_peak, 64 pairs",
             lambda: bs.batched_stein_peak(needles, hays, freqs, FS))
    ph.report()


def _cli_run(argv):
    from caf_cookoff_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise GateError(f"caf-tpu {' '.join(argv)}: rc {rc}\n{out}")
    f = float(re.search(r"Frequency offset: ([-+\d.]+) Hz", out).group(1))
    lag = int(re.search(r"Time offset: (-?\d+) samples", out).group(1))
    return f, lag, out


def phase_long(card, rng):
    """2000 x 65536 through ``run --full-haystack`` (the windowed
    segmented engine); 2000 x 4194304, whose 512 lag windows would not
    fit on the card at once, through the same engine (its windows run
    in bounded groups: the compiled program's temp bytes must stay
    within twice the 65536-lag program's); and the wide-span banded
    single-pair route."""
    import caf_cookoff_tpu.models.batched_stein as bs
    from caf_cookoff_tpu.config import FreqGrid
    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.models.stein import stein_overlap_save_peak
    from caf_cookoff_tpu.utils.io import write_c64

    ph = Phase("long", card)
    n, lags = 4096, 65536
    grid = FreqGrid(-500.0, 500.0, 0.5)
    freqs = grid.frequencies(np.float32)
    k_true, lag_true = int(rng.integers(50, 1950)), int(rng.integers(
        40_000, 60_000))
    needle, cap = plant(rng, n, lags + n - 1,
                        [(lag_true, float(freqs[k_true]), 1.0)], noise=0.5)
    WORK.mkdir(parents=True, exist_ok=True)
    n_path, c_path = WORK / "needle.c64", WORK / "capture.c64"
    write_c64(n_path, needle)
    write_c64(c_path, cap)
    argv = ["run", str(n_path), str(c_path), "--full-haystack",
            "--freq-start", "-500", "--freq-stop", "500",
            "--freq-step", "0.5"]
    with ph.capture(bs, "_banded_stein_os_jit", "_batched_stein_os_jit"):
        f, lag, out = _cli_run(argv)
    if "Engine: stein-os (segmented long-capture)" not in out:
        raise GateError(f"run --full-haystack took another route:\n{out}")
    want = oracle_peak(needle, cap, freqs, lag_true - n // 2,
                       lag_true + n // 2)
    gate("long run --full-haystack", (bin_of(freqs, f), lag),
         (k_true, lag_true), want)
    ph.timed("stein_overlap_save_peak 2000x65536",
             lambda: stein_overlap_save_peak(needle, cap, freqs, FS))

    long_lags = 1 << 22
    k_l = int(rng.integers(50, 1950))
    lag_l = int(rng.integers(long_lags - 200_000, long_lags - n))
    needle_l, cap_l = plant(rng, n, long_lags + n - 1,
                            [(lag_l, float(freqs[k_l]), 1.0)], noise=0.5)
    first = len(ph.programs)
    with ph.capture(bs, "_banded_stein_os_jit", "_batched_stein_os_jit"):
        f, lag, _ = stein_overlap_save_peak(needle_l, cap_l, freqs, FS)
    want = oracle_peak(needle_l, cap_l, freqs, lag_l - n // 2,
                       lag_l + n // 2)
    gate(f"long 2000x{long_lags}", (bin_of(freqs, f), lag), (k_l, lag_l),
         want)
    temp_short = ph.programs[0][1].temp_size_in_bytes
    temp_long = ph.programs[first][1].temp_size_in_bytes
    print(f"  [long] compiled temp bytes: {lags} lags {temp_short}, "
          f"{long_lags} lags {temp_long}")
    if temp_long > 2 * temp_short:
        raise GateError(f"windowed engine memory grows with capture "
                        f"length: {temp_short} -> {temp_long} bytes")
    ph.timed(f"stein_overlap_save_peak 2000x{long_lags}",
             lambda: stein_overlap_save_peak(needle_l, cap_l, freqs, FS),
             reps=3)

    # Wide span (|f| > fs/32): the banded single-pair Stein route.
    wide = np.arange(-4000.0, 4000.0, 10.0, dtype=np.float32)
    k_w, lag_w = int(rng.integers(0, len(wide))), int(rng.integers(1, 1500))
    needle_w, hay_w = plant(rng, n, n, [(lag_w, float(wide[k_w]), 1.0)])
    with ph.capture(bs, "_banded_batched_jit"):
        f, lag, _ = caf_peak(needle_w, hay_w, wide, FS, backend="stein")
    want = oracle_peak(needle_w, hay_w, wide, lag_w - n // 2,
                       lag_w + n // 2)
    gate("long wide-span banded", (bin_of(wide, f), lag), (k_w, lag_w),
         want)
    ph.timed("caf_peak stein, 800 bins over +-4 kHz",
             lambda: caf_peak(needle_w, hay_w, wide, FS, backend="stein"))
    ph.report()


def phase_multi(card, rng):
    """16 pairs x 1024 bins x 32768 lags, 3 emitters each, through
    ``batched_stein_os_peaks``; pair 0 again through the stein
    ``StreamingCAF``."""
    import caf_cookoff_tpu.models.batched_stein as bs
    import caf_cookoff_tpu.models.streaming as sm

    ph = Phase("multi", card)
    p, n, lags, k = 16, 4096, 32768, 1024
    freqs = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    truths, needles, caps = [], [], []
    for _ in range(p):
        bins = rng.choice(np.arange(40, k - 40), 3, replace=False)
        starts = np.sort(rng.choice(np.arange(3), 3, replace=False))
        lagv = [int(s * 10_000 + rng.integers(500, 5_000)) for s in starts]
        em = [(lagv[i], float(freqs[bins[i]]), amp)
              for i, amp in enumerate((1.0, 0.8, 0.6))]
        needle, cap = plant(rng, n, lags + n - 1, em)
        truths.append([(int(bins[i]), lagv[i]) for i in range(3)])
        needles.append(needle)
        caps.append(cap)
    needles, caps = np.stack(needles), np.stack(caps)
    with ph.capture(bs, "_banded_stein_os_peaks_jit",
                    "_batched_stein_os_peaks_jit"):
        fr, lg, vv = bs.batched_stein_os_peaks(needles, caps, freqs, FS, 3,
                                               num_lags=lags)
    for i in range(p):
        got = [(bin_of(freqs, fr[i, j]), int(lg[i, j])) for j in range(3)]
        for j, (kk, lag) in enumerate(truths[i]):
            want = oracle_peak(needles[i], caps[i], freqs, lag - n // 2,
                               lag + n // 2)
            gate(f"multi pair {i} emitter {j}", got[j], (kk, lag), want)
    ph.timed("batched_stein_os_peaks 16x1024x32768",
             lambda: bs.batched_stein_os_peaks(needles, caps, freqs, FS, 3,
                                               num_lags=lags))

    chunk = 8192

    def stream():
        s = sm.StreamingCAF(needles[0], freqs, FS, backend="stein",
                            num_peaks=3, chunk_len=chunk)
        for off in range(0, caps.shape[1], chunk):
            s.process(caps[0, off:off + chunk])
        return s.peaks(min_snr_db=None)

    with ph.capture(sm, "_stein_stream_lattice_step_jit"):
        fr, lg, _ = stream()
    for j, (kk, lag) in enumerate(truths[0]):
        want = oracle_peak(needles[0], caps[0], freqs, lag - n // 2,
                           lag + n // 2)
        gate(f"stream emitter {j}", (bin_of(freqs, fr[j]), lg[j]),
             (kk, lag), want)
    ph.timed("StreamingCAF stein, 5 chunks of 8192", stream)
    ph.report()


def phase_rate(card, rng):
    """``stein_rate_os_peak`` at the config-3 shape with 9 trial rates."""
    import caf_cookoff_tpu.models.rate as rt

    ph = Phase("rate", card)
    n, lags = 4096, 65536
    freqs = np.linspace(-500, 500, 2000, endpoint=False).astype(np.float32)
    rates = np.arange(-400.0, 401.0, 100.0)
    k_true, r_idx = int(rng.integers(100, 1900)), int(rng.integers(0, 9))
    lag_true = int(rng.integers(5_000, 60_000))
    needle, cap = plant(rng, n, lags + n - 1,
                        [(lag_true, float(freqs[k_true]), 1.0,
                          float(rates[r_idx]))], noise=0.5)
    with ph.capture(rt, "_stein_rate_os_peak_jit"):
        r, f, lag, _ = rt.stein_rate_os_peak(needle, cap, freqs, rates, FS,
                                             num_lags=lags)
    # The oracle over every trial rate: the winning rate's (bin, lag).
    best = None
    for ri, rate in enumerate(rates):
        kk, tau = oracle_peak(needle, cap, freqs, lag_true - n // 2,
                              lag_true + n // 2, rate=rate)
        val = _oracle_value(needle, cap, freqs[kk], tau, rate)
        if best is None or val > best[0]:
            best = (val, ri, kk, tau)
    got_r = int(np.argmin(np.abs(rates - r)))
    gate("rate (rate, bin, lag)", (got_r, bin_of(freqs, f), lag),
         (r_idx, k_true, lag_true), best[1:])
    ph.timed("stein_rate_os_peak 9x2000x65536",
             lambda: rt.stein_rate_os_peak(needle, cap, freqs, rates, FS,
                                           num_lags=lags))
    ph.report()


def _oracle_value(needle, cap, f_hz, lag, rate):
    t = np.arange(len(needle)) / FS
    taps = np.asarray(needle, np.complex128) * np.exp(
        2j * np.pi * float(f_hz) * t + 1j * np.pi * rate * t * t)
    seg = np.asarray(cap[lag:lag + len(needle)], np.complex128)
    return float(np.abs(np.vdot(taps[:len(seg)], seg)) ** 2)


def phase_gpu_tests(card):
    """The ``gpu``-marked pytest lane, in this process."""
    import pytest

    ph = Phase("gpu-tests", card)
    os.environ["CAF_TESTS_ON_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_on_chip.py")])
    print(f"  [gpu-tests] pytest rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise GateError(f"gpu-marked tests failed (rc {rc})")
    ph.report()


def phase_four_gpus(devices, card, rng):
    """The mesh engines on a 4-GPU mesh, each compared bin-exactly with
    the same engine on device 0 and with the injected truth."""
    from caf_cookoff_tpu.config import BENCH_GRID
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peak
    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import (
        sharded_batched_stein_peak,
        sharded_overlap_save_peak,
        sharded_stein_os_peak,
    )

    if len(devices) < 4:
        raise GateError(f"--four-gpus needs 4 GPUs, JAX found "
                        f"{len(devices)}")
    devices = devices[:4]
    one = devices[:1]
    ph = Phase("four-gpus", card)

    p, n = 64, 4096
    freqs = BENCH_GRID.frequencies(np.float32)
    truths = [(int(rng.integers(20, 380)), int(rng.integers(1, 1500)))
              for _ in range(p)]
    pairs = [plant(rng, n, n, [(lag, float(freqs[k]), 1.0)])
             for k, lag in truths]
    needles = np.stack([a for a, _ in pairs])
    hays = np.stack([b for _, b in pairs])
    mesh4 = make_mesh(pair=4, devices=devices)
    fr4, lg4, _ = sharded_batched_stein_peak(needles, hays, freqs, FS,
                                             mesh4)
    fr1, lg1, _ = batched_stein_peak(needles, hays, freqs, FS)
    for i, (k, lag) in enumerate(truths):
        gate(f"pair-sharded stein pair {i}",
             (bin_of(freqs, fr4[i]), lg4[i]), (k, lag),
             (bin_of(freqs, fr1[i]), lg1[i]))
    ph.timed("sharded_batched_stein_peak pair=4, 64 pairs",
             lambda: sharded_batched_stein_peak(needles, hays, freqs, FS,
                                                mesh4))

    lags = 65536
    grid = np.linspace(-500, 500, 2000, endpoint=False).astype(np.float32)
    k_true, lag_true = int(rng.integers(50, 1950)), int(rng.integers(
        40_000, 60_000))
    needle, cap = plant(rng, n, lags + n - 1,
                        [(lag_true, float(grid[k_true]), 1.0)], noise=0.5)
    truth = (k_true, lag_true)
    for label, fn, mesh_4, mesh_1 in (
            ("sharded_overlap_save_peak doppler=2 x time=2",
             lambda m: sharded_overlap_save_peak(needle, cap, grid, FS, m,
                                                 num_lags=lags,
                                                 backend="xla"),
             make_mesh(doppler=2, time=2, devices=devices),
             make_mesh(devices=one)),
            ("sharded_stein_os_peak time=4",
             lambda m: sharded_stein_os_peak(needle, cap, grid, FS, m,
                                             num_lags=lags),
             make_mesh(time=4, devices=devices),
             make_mesh(devices=one))):
        f4, l4, _ = fn(mesh_4)
        f1, l1, _ = fn(mesh_1)
        gate(label, (bin_of(grid, f4), l4), truth,
             (bin_of(grid, f1), l1))
        ph.timed(label, lambda: fn(mesh_4))
    used = [d.memory_stats()["peak_bytes_in_use"] for d in devices]
    print(f"  [four-gpus] peak_bytes_in_use per card: {used}")
    if min(used) <= 0:
        raise GateError(f"a card held no buffers: {used}")
    ph.report()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU mesh phase")
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="run only these one-GPU phases (repeatable; "
                    "default: all)")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu()
    from caf_cookoff_tpu.config import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s); compile cache {cache}")
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    if args.four_gpus:
        phase_four_gpus(devices, card, rng)
        devices = devices[:4]
    else:
        from caf_cookoff_tpu.utils.bench import device_peaks

        print(f"published peaks: {device_peaks(devices[0].device_kind)}")
        runners = {"numerics": phase_numerics, "golden": phase_golden,
                   "headline": phase_headline, "batch": phase_batch,
                   "long": phase_long, "multi": phase_multi,
                   "rate": phase_rate, "gpu-tests": phase_gpu_tests}
        for name in args.phase or PHASES:
            fn = runners[name]
            if "rng" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
                fn(card, rng)
            else:
                fn(card)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
