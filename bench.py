#!/usr/bin/env python3
"""Headline benchmark: the reference's 400x8192 filterbank CAF workload.

Workload identical to every reference main (``caf_rust/src/main.rs:17-22``,
``caf_go/main.go:22``, ``caf_python/caf.py:133-134``): 4096-sample complex
needle, 400 doppler bins (-100..+100 Hz step 0.5), fs = 48 kHz, 8192-point
zero-padded cross-correlation -> magnitude-squared surface -> 2-D argmax
peak (surface + ``find_peak``, the full reference pipeline).

Configuration measured: ``caf_peak(..., backend="stein")`` — the Stein
time-segmented engine with exact top-k refinement (models/stein.py),
gated on the golden chirp_0 answer before it is timed.

Baseline to beat: 28 ms/surface — the reference's best published parallel
number (RustFFT + threadpool on a Ryzen9-3900X, ``README.md:36,38``).
``vs_baseline`` is the speedup factor (baseline_ms / our_ms).

Timing: host clock around each call; every call ends with its peak on
the host, so the device work is included.  The value is the median of
REPS warm calls.  Needs an NVIDIA GPU (exits 1 elsewhere).  Prints
exactly ONE JSON line on stdout; diagnostics go to stderr.
"""

import json
import pathlib
import sys
import time

import numpy as np

BASELINE_MS = 28.0
FS = 48_000.0
REPS = 50


def main() -> None:
    from caf_cookoff_tpu.config import BENCH_GRID, enable_compile_cache
    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.utils.bench import card_line, require_gpu
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64

    devices = require_gpu()
    enable_compile_cache()
    card = card_line()
    print(f"device: {devices[0].device_kind} ({card})", file=sys.stderr)

    data_dir = pathlib.Path(__file__).resolve().parent / "data"
    needle_path, haystack_path = ensure_fixtures(data_dir)[0]
    needle = load_c64(needle_path)
    haystack = load_c64(haystack_path, count=len(needle))
    freqs = BENCH_GRID.frequencies(np.float32)

    def run():
        return caf_peak(needle, haystack, freqs, FS, backend="stein")

    # Gate: the golden chirp_0 answer (nearest 0.5 Hz bin to +69.25).
    freq, lag, _ = run()
    if not (abs(freq - 69.25) <= 0.5 and lag == 202):
        raise SystemExit(f"bench: golden check failed: ({freq}, {lag})")
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    print(f"per-surface median {ms:.4f} ms over {REPS} warm calls "
          f"(p10 {np.percentile(times, 10):.4f}, p90 "
          f"{np.percentile(times, 90):.4f}) [stein-refine, golden-exact]",
          file=sys.stderr)
    print(json.dumps({
        "metric": "caf_peak_stein_400x8192_host_ms",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "p10_ms": float(np.percentile(times, 10)),
        "p90_ms": float(np.percentile(times, 90)),
        "reps": REPS,
        "card": card,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))


if __name__ == "__main__":
    main()
