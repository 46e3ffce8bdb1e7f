#!/usr/bin/env python3
"""Scaling-configuration benchmarks (every BASELINE.json config, 1-5).

One JSON line per config, each carrying best/median/spread over REPS
measurement cycles plus the 1-iteration chain time (``load_ms`` — the
per-call dispatch floor):

  1. reference 400x8192 single surface (the bench.py headline workload)
  2. batch of 64 pairs, 400x8192, one chip (fused batched Stein)
  3. wideband 2000x65536 overlap-save surface peak (one GPU;
     time-shardable over a mesh)
  4. streaming multi-emitter slice: 16 pairs x 1024 bins x 32768 lags
  5. three-axis shape (pair x doppler x time mesh), scaled down on a
     VIRTUAL 8-device CPU mesh in a child process (sharding/collective
     validation with a correctness gate, not a performance number).

Chain timing: a dependency-serialized ``lax.scan`` inside one jitted
program, with the 1-iteration time subtracted;
batch/stream configs report per-*unit* numbers (per pair-surface) for
comparability.  Every config is correctness-gated before it is timed.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

FS = 48_000.0
REPS = 4


def _chain(step_fn, make_carry0, iters, reps=None):
    """Chained step time stats over ``reps`` measurement cycles.

    Each cycle pairs one chain(1) with one chain(1+iters) measurement
    (pairing cancels correlated load drift between the two) and yields
    ``(T(1+iters) - T(1)) / iters``.  Returns a dict with ``value``
    (best cycle), ``median_ms``, ``spread_ms`` (max - min across
    cycles: two runs of this script should agree within each other's
    spread), and ``load_ms`` (best chain(1) time, the dispatch floor).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    # Read the module REPS at CALL time (an early-bound default would
    # freeze the import-time value and silently ignore --reps).
    reps = REPS if reps is None else reps

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(n):
        def body(carry, _):
            return step_fn(carry), None

        carry, _ = lax.scan(body, make_carry0(), None, length=n)
        return carry

    def once(n):
        t0 = time.perf_counter()
        float(jnp.sum(chain(n)))
        return (time.perf_counter() - t0) * 1e3

    for n in (1, 1 + iters):           # compile + warm both programs
        jax.block_until_ready(chain(n))
        float(jnp.sum(chain(n)))
    samples, loads = [], []
    for _ in range(reps):
        t1 = once(1)
        tn = once(1 + iters)
        samples.append((tn - t1) / iters)
        loads.append(t1)
    best = min(samples)
    med = float(np.median(samples))
    if best <= 0.0:
        # The subtraction can go non-positive under dispatch jitter
        # when iters is small; the median is the robust fallback
        # (never report a negative time).
        print(f"warning: non-positive best chain delta ({best:.3f} ms "
              f"over {reps} reps); falling back to the median",
              file=sys.stderr)
        best = med if med > 0.0 else None
    return {
        "value": best,
        "median_ms": med,
        "spread_ms": max(samples) - min(samples),
        "load_ms": min(loads),
        "reps": reps,
    }


def _rand_pair(n, lag, f_hz, seed):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = np.zeros(n, dtype=np.complex64)
    hay[lag:] = needle[: n - lag]
    hay *= np.exp(2j * np.pi * f_hz * np.arange(n) / FS).astype(np.complex64)
    return needle, hay


def config1_single():
    """Config 1: the reference 400x8192 chirp_0 workload, the same
    engine bench.py times (stein + exact refinement) — here with
    rep statistics so all five configs come from one command."""
    import pathlib

    import jax.numpy as jnp

    from caf_cookoff_tpu.config import (BENCH_GRID, default_backend,
                                        xcor_length)
    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.models.stein import _stein_peak_jit
    from caf_cookoff_tpu.ops.splitfft import split_array
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64

    data_dir = pathlib.Path(__file__).resolve().parent / "data"
    needle_path, haystack_path = ensure_fixtures(data_dir)[0]
    needle = load_c64(needle_path)
    hay = load_c64(haystack_path, count=len(needle))
    freqs_np = BENCH_GRID.frequencies(np.float32)
    # Correctness gate: the golden chirp_0 answer on this device.
    freq, lag, _ = caf_peak(needle, hay, freqs_np, FS, backend="stein")
    assert abs(freq - 69.25) <= 0.5 and lag == 202, (freq, lag)
    n_re, n_im = map(jnp.asarray, split_array(needle))
    h_re, h_im = map(jnp.asarray, split_array(hay))
    freqs = jnp.asarray(freqs_np)
    fft_len = xcor_length(len(needle))
    backend = default_backend()

    def step(carry):
        pk = _stein_peak_jit.__wrapped__(
            n_re + carry, n_im, h_re, h_im, freqs, FS, fft_len, 64,
            backend, True)
        return pk.value * 1e-30

    stats = _chain(step, lambda: jnp.float32(0), iters=400)
    return {"metric": "config1_single_400x8192_ms",
            "value": _round(stats["value"], 4), "unit": "ms",
            **_stat_fields(stats)}


def _round(x, ndigits):
    return None if x is None else round(x, ndigits)


def _stat_fields(stats, scale=1.0):
    return {"median_ms": round(stats["median_ms"] * scale, 4),
            "spread_ms": round(stats["spread_ms"] * scale, 4),
            "load_ms": round(stats["load_ms"], 2),
            "reps": stats["reps"]}


def config2_batch64():
    """64 pairs x 400x8192 on one GPU: the batched Stein engine
    (direct-dot stage A + synthesis/rank + vmapped top-k re-score)."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.config import BENCH_GRID, default_backend
    from caf_cookoff_tpu.models.batched_stein import (
        _batched_stein_peak_jit,
        batched_stein_peak,
    )
    from caf_cookoff_tpu.models.stein import stein_caf_peak
    from caf_cookoff_tpu.ops.splitfft import split_array

    b, n = 64, 4096
    needles = np.stack([_rand_pair(n, 50 + i, 10.0 * i - 300, i)[0]
                        for i in range(b)])
    hays = np.stack([_rand_pair(n, 50 + i, 10.0 * i - 300, i)[1]
                     for i in range(b)])
    freqs_np = BENCH_GRID.frequencies(np.float32)
    # Correctness gate before timing: every pair's batched peak must
    # match its single-pair Stein answer (and the injected truth).
    fr, lg, _ = batched_stein_peak(needles, hays, freqs_np, FS)
    for i in range(0, b, 13):
        want = stein_caf_peak(needles[i], hays[i], freqs_np, FS)[:2]
        assert (float(fr[i]), int(lg[i])) == want, (i, fr[i], lg[i], want)
    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    hs_re, hs_im = map(jnp.asarray, split_array(hays))
    freqs = jnp.asarray(freqs_np)
    backend = default_backend()

    def step(carry):
        pk = _batched_stein_peak_jit.__wrapped__(
            ns_re + carry, ns_im, hs_re, hs_im, freqs, FS, 2 * n, 64,
            backend, True)
        return jnp.sum(pk.value) * 1e-30

    stats = _chain(step, lambda: jnp.float32(0), iters=32)
    return {"metric": "config2_batch64_400x8192_ms_per_surface",
            "value": _round(None if stats["value"] is None else stats["value"] / b, 4), "unit": "ms",
            "batch_total_ms": _round(stats["value"], 3),
            **_stat_fields(stats, scale=1.0 / b)}


def config3_wideband():
    """2000 bins x 65536 lags: banded windowed-OS segmented engine.

    Doppler span +-500 Hz at a 0.5 Hz pitch: the plain Stein envelope
    caps blocks at fs/(4*f_max)=24 samples, but banding the grid (6
    bands x 375 bins, needle shifted to each band center) lifts the
    block length to 128, cutting the dominant synthesis MACs ~4x.
    Each (band, lag-window) is one program of the coarse stage."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.config import default_backend

    from caf_cookoff_tpu.models.batched_stein import (
        _banded_stein_os_jit,
        batched_stein_os_peak,
    )
    from caf_cookoff_tpu.models.stein import _plan_bands
    from caf_cookoff_tpu.ops.splitfft import split_array
    from caf_cookoff_tpu.ops.xcor import xcor_length

    n, lags, k = 4096, 65536, 2000
    needle, _ = _rand_pair(n, 7, 0.0, 0)
    rng = np.random.default_rng(1)
    hay = (rng.standard_normal(lags + n)
           + 1j * rng.standard_normal(lags + n)).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    true_f, true_lag = float(freqs_np[1234]), 30_000
    t = np.arange(n)
    hay[true_lag:true_lag + n] += 3 * (needle * np.exp(
        2j * np.pi * true_f * t / FS)).astype(np.complex64)
    # Correctness gate: the public API (which routes this grid through
    # the banded engine) must recover the injected emitter.
    fr, lg, _ = batched_stein_os_peak(needle[None], hay[None], freqs_np,
                                      FS, num_lags=lags)
    assert (float(fr[0]), int(lg[0])) == (true_f, true_lag), (fr, lg)
    n_re, n_im = split_array(needle[None])
    h_re, h_im = map(jnp.asarray, split_array(hay[None]))
    n_re, n_im = jnp.asarray(n_re), jnp.asarray(n_im)
    plan = _plan_bands(FS, freqs_np)
    freqs_pad = jnp.asarray(plan["freqs_pad"])
    centers = jnp.asarray(plan["centers"])
    rel = jnp.asarray(plan["rel"])
    m = xcor_length(n)
    windows = -(-lags // m)
    backend = default_backend()

    def step(carry):
        pk = _banded_stein_os_jit.__wrapped__(
            n_re + carry, n_im, h_re, h_im, freqs_pad, centers, rel, FS,
            m, plan["block_len"], backend, windows, lags, n, k)
        return jnp.sum(pk.value) * 1e-30

    stats = _chain(step, lambda: jnp.float32(0), iters=64)
    return {"metric": "config3_wideband_2000x65536_ms",
            "value": _round(stats["value"], 2), "unit": "ms",
            **_stat_fields(stats)}


def config4_stream16():
    """16 pairs x 1024 bins x 32768 lags: the windowed segmented engine
    (batched_stein_os_peak) — every (pair, band, lag-window) is one
    program of the coarse stage."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.config import default_backend

    from caf_cookoff_tpu.models.batched_stein import (
        _banded_stein_os_jit,
        batched_stein_os_peak,
    )
    from caf_cookoff_tpu.models.stein import _plan_bands
    from caf_cookoff_tpu.ops.splitfft import split_array

    pairs, n, lags, k = 16, 4096, 32768, 1024
    rng = np.random.default_rng(2)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n))
                    )).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    emitters = []
    for b in range(pairs):
        lag = 777 + b * 2011
        f_hz = float(freqs_np[61 * (b + 1)])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)[: lags + n - lag]
        emitters.append((f_hz, lag))
    # Correctness gate: every pair recovers its injected emitter —
    # num_lags pinned so the gated and timed programs use the SAME
    # window count (the default L-n+1 would be lags+1 -> one extra).
    fr, lg, _ = batched_stein_os_peak(needles, hays, freqs_np, FS,
                                      num_lags=lags)
    for b in range(pairs):
        assert (float(fr[b]), int(lg[b])) == emitters[b], (
            b, fr[b], lg[b], emitters[b])
    ns = tuple(map(jnp.asarray, split_array(needles)))
    hs = tuple(map(jnp.asarray, split_array(hays)))
    m = 2 * n
    windows = -(-lags // m)
    backend = default_backend()
    # This grid (1024 bins over +-500 Hz) routes banded: 6 bands x 192
    # bins at block 128 vs the plain envelope's block 16 — time the
    # same program the gate above exercised.
    plan = _plan_bands(FS, freqs_np)
    freqs_pad = jnp.asarray(plan["freqs_pad"])
    centers = jnp.asarray(plan["centers"])
    rel = jnp.asarray(plan["rel"])

    def step(carry):
        pk = _banded_stein_os_jit.__wrapped__(
            ns[0] + carry, ns[1], hs[0], hs[1], freqs_pad, centers, rel,
            FS, m, plan["block_len"], backend, windows, lags, n, k)
        return jnp.sum(pk.value) * 1e-30

    stats = _chain(step, lambda: jnp.float32(0), iters=16)
    return {"metric": "config4_stream16_1024x32768_ms_per_pair",
            "value": _round(None if stats["value"] is None else stats["value"] / pairs, 3), "unit": "ms",
            "slice_total_ms": _round(stats["value"], 2),
            **_stat_fields(stats, scale=1.0 / pairs)}


def config5_virtual():
    """Config 5 (three-axis shape) on a VIRTUAL 8-device CPU mesh:
    8 pairs x 64 bins x 16384 lags sharded pair=2 x doppler=2 x time=2,
    every injected emitter recovered through the ppermute halos and the
    (doppler, time) peak reduction.  A sharding/collective validation
    artifact (virtual devices share one host's cores), not a
    performance number; per-device memory for the full 256-device shape
    is printed by ``__graft_entry__.dryrun_multichip``.
    """
    import jax
    import jax.numpy as jnp

    from caf_cookoff_tpu.parallel.mesh import make_mesh
    from caf_cookoff_tpu.parallel.sharded import (
        _batched_os_peak_jit,
        batched_overlap_save_peak,
        pad_axis_to,
    )
    from caf_cookoff_tpu.ops.splitfft import split_array

    if len(jax.devices()) < 8 or jax.default_backend() != "cpu":
        raise RuntimeError(
            "config 5 needs the virtual 8-device CPU child process")
    pairs, n, lags, k = 8, 1024, 16_384, 64
    rng = np.random.default_rng(4)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n))
                    )).astype(np.complex64)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    emitters = []
    for b in range(pairs):
        lag = 500 + b * 1777
        f_hz = float(freqs_np[5 + 7 * b])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)
        emitters.append((f_hz, lag))
    mesh = make_mesh(pair=2, doppler=2, time=2)
    # Correctness gate at the exact mesh being timed.
    fr, lg, _ = batched_overlap_save_peak(needles, hays, freqs_np, FS,
                                          mesh, num_lags=lags,
                                          backend="xla")
    for b in range(pairs):
        assert (float(fr[b]), int(lg[b])) == emitters[b], (
            b, fr[b], lg[b], emitters[b])
    # Host-side prep replicating the wrapper's layout for the chain.
    t_shards = mesh.shape["time"]
    needed = lags + n - 1
    chunk = max(-(-needed // t_shards), n - 1)
    hay_p = np.pad(hays, ((0, 0), (0, t_shards * chunk - hays.shape[-1])))\
        if t_shards * chunk > hays.shape[-1] else hays[:, :t_shards * chunk]
    ns = tuple(map(jnp.asarray, split_array(needles)))
    hs = tuple(map(jnp.asarray, split_array(hay_p)))
    freqs_p = jnp.asarray(pad_axis_to(freqs_np, mesh.shape["doppler"]))

    def step(carry):
        pk = _batched_os_peak_jit.__wrapped__(
            ns[0] + carry, ns[1], hs[0], hs[1], freqs_p, FS, mesh, n,
            chunk, lags, "xla")
        return jnp.sum(pk.value) * 1e-30

    stats = _chain(step, lambda: jnp.float32(0), iters=2)
    return {"metric": "config5_virtual8_8x64x16384_ms_per_pair",
            "value": _round(None if stats["value"] is None else stats["value"] / pairs, 3), "unit": "ms",
            "mesh": "pair=2 x doppler=2 x time=2 (virtual CPU)",
            "note": "sharding validation, not perf",
            **_stat_fields(stats, scale=1.0 / pairs)}


def main() -> None:
    global REPS
    ap = argparse.ArgumentParser(
        description="BASELINE config benchmarks (1-5); one JSON line "
                    "per config with best/median/spread over REPS "
                    "cycles and the chain(1) load proxy.")
    ap.add_argument("configs", nargs="*", default=["2", "3", "4"],
                    choices=["1", "2", "3", "4", "5"],
                    help="which configs to run (default: 2 3 4)")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="measurement cycles per config")
    ap.add_argument("--_virtual-child", action="store_true",
                    help=argparse.SUPPRESS)   # internal: config-5 child
    args = ap.parse_args()
    REPS = args.reps

    if args._virtual_child:
        import jax

        jax.config.update("jax_platforms", "cpu")
        result = config5_virtual()
        result["device"] = "cpu-virtual8"
        print(json.dumps(result))
        return

    on_chip = [c for c in args.configs if c != "5"]
    if on_chip:
        from caf_cookoff_tpu.config import enable_compile_cache
        from caf_cookoff_tpu.utils.bench import card_line, require_gpu

        device = require_gpu()[0]
        enable_compile_cache()
        print(f"device: {device.device_kind} ({card_line()})",
              file=sys.stderr)
        runners = {"1": config1_single, "2": config2_batch64,
                   "3": config3_wideband, "4": config4_stream16}
        for w in on_chip:
            result = runners[w]()
            result["device"] = str(device.device_kind)
            print(json.dumps(result))
    if "5" in args.configs:
        # Virtual devices must be configured before the child's JAX
        # backend initializes — hence a separate process.
        env = dict(os.environ,
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_force_host_platform_device_count=8"
                              ).strip(),
                   JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, __file__, "5", "--_virtual-child",
             "--reps", str(REPS)],
            env=env, text=True, capture_output=True)
        sys.stderr.write(r.stderr)
        if r.returncode:
            raise SystemExit(f"config 5 child failed ({r.returncode})")
        sys.stdout.write(r.stdout)


if __name__ == "__main__":
    main()
