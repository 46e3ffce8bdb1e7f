#!/usr/bin/env python3
"""Contention-free multi-process scaling measurement (pinned cores).

The virtual-device harness (``bench_scaling.py --virtual``) validates
shardings but its efficiencies confound collective cost with host-core
CONTENTION: N virtual devices share one XLA CPU thread pool, so the
N=1 baseline already uses every core.  This harness removes that
confound the way BASELINE's "N>=2 hosts" axis demands:

* N separate JAX processes (``jax.distributed.initialize`` + Gloo CPU
  collectives — REAL cross-process traffic, the same code path as
  cross-host collectives), each owning exactly ONE XLA CPU device;
* each process pinned to a DISJOINT core (``sched_setaffinity``), so
  per-device compute resources are constant across N — any efficiency
  loss is sharding overhead + collective time, not timesharing;
* per mesh point, TWO timings of the same per-shard work:
  ``full_ms`` (the production sharded program, collectives included)
  and ``compute_ms`` (identical local math, collectives elided), so
  ``collective_ms = full - compute`` is measured, not asserted, and is
  reported next to the analytic bytes-on-the-wire model.  These are CPU
  processes: no device metric comes from this harness.

Engines (strong scaling, fixed total problem):

* ``doppler`` — the reference 400x8192 workload, bins sharded over N
  processes; collectives = the pmax/pmin peak lattice (a few dozen
  bytes/step: efficiency is compute-bound by construction).
* ``time``   — one long capture, lag axis chunked over N processes
  with cross-process ``ppermute`` halos (2 planes x 4 B x (n-1) bytes
  per neighbor per step — the one engine with real per-step traffic).

Every mesh point is correctness-gated (golden / injected truth) before
it is timed.  One JSON line per (engine, N); ``--out`` writes the full
document.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

FS = 48_000.0
DOPPLER_GATE = (69.25, 202)      # chirp_0 truth on the 0.25-binnable grid
# Production-like lag count: uniform time chunks waste ceil-rounded
# overlap-save blocks (N*ceil(chunk/V) vs ceil(needed/V) at N=1); at
# 64k lags that quantization is ~5% at N=4 (at 16k it would be ~18%
# and dominate the efficiency read).
TIME_SHAPE = dict(n=1024, total_lags=65_536, num_bins=64)
TIME_GATE_SEED = 3
# Combined-axes (BASELINE config 5) shape: 4 pairs x 64 bins x 32768
# lags through the per-pair lattice engine (_batched_os_peaks_jit's
# composition), mesh factored 2x2 at N=4.
CONFIG5_SHAPE = dict(n=1024, total_lags=32_768, num_bins=64, pairs=4,
                     num_peaks=2)
CONFIG5_GATE_SEED = 11
# Second-order engine: the dechirp bank multiplies per-shard compute
# by num_rates while the ONE halo ppermute is shared by every trial
# rate — scaling should meet or beat the first-order time engine.
# Lag count sized so the rate-bank synthesis (R x K x M spectra +
# pre-chirp phasors — replicated per shard, chunk-INDEPENDENT) stays a
# small fraction of a shard's block scan: at 32k lags that fixed term
# alone capped measured strong efficiency at ~0.72 on 4 pinned cores
# (compute twin 0.67 — not a collective effect); at 128k lags it
# amortizes the way production capture lengths (256k+, BASELINE
# config 3) do.
RATE_SHAPE = dict(n=1024, total_lags=131_072, num_bins=64, num_rates=5)
RATE_GATE_SEED = 17


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Worker (one per process; runs under --_worker)
# ---------------------------------------------------------------------------


def _worker(args) -> None:
    pid, nprocs = args.pid, args.nprocs
    # Disjoint one-core pin BEFORE jax spins up its thread pools.
    os.sched_setaffinity(0, {pid % os.cpu_count()})
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1"
                               ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from caf_cookoff_tpu.parallel import multihost

    multihost.initialize_cluster(f"localhost:{args.port}",
                                 num_processes=nprocs, process_id=pid)
    assert len(jax.devices()) == nprocs

    import time as _time

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from caf_cookoff_tpu.parallel.mesh import (
        AXIS_DOPPLER,
        AXIS_TIME,
        make_mesh,
    )

    put = multihost.put_global

    def chain_stats(chain_fn, fetch, iters, reps):
        """(value best/median/spread, load) of (T(1+iters)-T(1))/iters.

        ``chain_fn(k)`` runs the k-step program; ``fetch`` forces its
        result to the host (blocks until done).  Every process executes
        the same calls in lockstep (the collectives synchronize);
        process 0's wall clock is the measurement.
        """
        for k in (1, 1 + iters):
            fetch(chain_fn(k))
        samples, loads = [], []
        for _ in range(reps):
            t0 = _time.perf_counter()
            fetch(chain_fn(1))
            t1 = (_time.perf_counter() - t0) * 1e3
            t0 = _time.perf_counter()
            fetch(chain_fn(1 + iters))
            tn = (_time.perf_counter() - t0) * 1e3
            samples.append((tn - t1) / iters)
            loads.append(t1)
        return {"value": min(samples),
                "median_ms": float(np.median(samples)),
                "spread_ms": max(samples) - min(samples),
                "load_ms": min(loads)}

    if args.engine == "doppler":
        result = _worker_doppler(jax, jnp, np, P, make_mesh, put,
                                 AXIS_DOPPLER, nprocs, chain_stats,
                                 args.iters, args.reps)
    elif args.engine == "time":
        result = _worker_time(jax, jnp, np, P, make_mesh, put, AXIS_TIME,
                              nprocs, chain_stats, args.iters, args.reps)
    elif args.engine == "pair":
        result = _worker_pair(jax, jnp, np, P, make_mesh, put, nprocs,
                              chain_stats, args.iters, args.reps)
    elif args.engine in ("config5_dt", "config5_pt"):
        result = _worker_config5(jax, jnp, np, P, make_mesh, put, nprocs,
                                 chain_stats, args.iters, args.reps,
                                 args.engine[-2:])
    elif args.engine == "rate":
        result = _worker_rate(jax, jnp, np, P, make_mesh, put, AXIS_TIME,
                              nprocs, chain_stats, args.iters, args.reps)
    else:
        raise SystemExit(f"unknown engine {args.engine}")
    if pid == 0:
        print("WORKER_JSON " + json.dumps(result), flush=True)


def _worker_doppler(jax, jnp, np, P, make_mesh, put, AXIS_DOPPLER, nprocs,
                    chain_stats, iters, reps):
    import functools
    import pathlib

    from caf_cookoff_tpu.config import BENCH_GRID, xcor_length
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import CafPeak, find_peak_2d
    from caf_cookoff_tpu.parallel import multihost
    from caf_cookoff_tpu.parallel.collectives import global_peak
    from caf_cookoff_tpu.parallel.sharded import pad_axis_to
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64

    data_dir = pathlib.Path(__file__).resolve().parent / "data"
    needle_path, haystack_path = ensure_fixtures(data_dir)[0]
    needle = load_c64(needle_path)
    hay = load_c64(haystack_path, count=len(needle))
    freqs_np = BENCH_GRID.frequencies(np.float32)
    mesh = multihost.global_mesh(doppler=nprocs)
    # Gate: the golden chirp_0 answer through THIS mesh's collectives.
    freq, lag, _ = multihost.multihost_caf_peak(needle, hay, freqs_np,
                                                FS, mesh, backend="xla")
    assert abs(freq - DOPPLER_GATE[0]) <= 0.5 and lag == DOPPLER_GATE[1], \
        (freq, lag)

    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(hay)
    xl = xcor_length(len(needle))
    freqs_p = pad_axis_to(freqs_np, nprocs)
    k_loc = freqs_p.shape[0] // nprocs
    rep = lambda a: put(a, mesh, P())
    g_nre, g_nim, g_hre, g_him = map(rep, (n_re, n_im, h_re, h_im))
    g_freqs = put(freqs_p, mesh, P(AXIS_DOPPLER))

    def local_peak(n_re, n_im, h_re, h_im, freqs_loc):
        rows = _surface_rows_split((n_re, n_im), (h_re, h_im), freqs_loc,
                                   FS, xl, "xla")
        return find_peak_2d(splitfft.mag2(rows))

    def body_full(n_re, n_im, h_re, h_im, freqs_loc, carry):
        local = local_peak(n_re + carry[0], n_im, h_re, h_im, freqs_loc)
        local = CafPeak(
            local.value,
            local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
            local.lag_idx)
        g = global_peak(local, AXIS_DOPPLER)
        return jnp.reshape(g.value, (1,)) * 1e-30

    def body_compute(n_re, n_im, h_re, h_im, freqs_loc, carry):
        local = local_peak(n_re + carry[0], n_im, h_re, h_im, freqs_loc)
        return jnp.reshape(local.value, (1,)) * 1e-30

    def make_chain(body, carry_spec):
        sm = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(AXIS_DOPPLER), carry_spec),
            out_specs=carry_spec)

        @functools.partial(jax.jit, static_argnames=("k",))
        def chain(nr, ni, hr, hi, fr, k):
            init = jnp.zeros(
                (1 if carry_spec == P() else nprocs,), nr.dtype)

            def step(c, _):
                return sm(nr, ni, hr, hi, fr, c), None

            out, _ = jax.lax.scan(step, init, None, length=k)
            return out

        return chain

    chain_full = make_chain(body_full, P())
    chain_comp = make_chain(body_compute, P(AXIS_DOPPLER))
    fetch_full = lambda out: float(out[0])
    fetch_comp = lambda out: np.asarray(out.addressable_shards[0].data)
    full = chain_stats(lambda k: chain_full(
        g_nre, g_nim, g_hre, g_him, g_freqs, k), fetch_full, iters, reps)
    comp = chain_stats(lambda k: chain_comp(
        g_nre, g_nim, g_hre, g_him, g_freqs, k), fetch_comp, iters, reps)
    return {
        "engine": "doppler_strong_400x8192", "n": nprocs, "mode": "strong",
        "full": full, "compute": comp,
        "collective_ms": round(full["value"] - comp["value"], 3),
        # pmax + 2 pmin on (value, freq, lag) triples: 3 reductions of
        # one 4-byte scalar per device per step.
        "wire_bytes_per_step": 3 * 4 * nprocs,
    }


def _worker_pair(jax, jnp, np, P, make_mesh, put, nprocs, chain_stats,
                 iters, reps):
    """WEAK scaling: 2 pairs per process (batch grows with N), pure
    data parallelism over the ``pair`` axis — zero collectives, so
    efficiency(N) = T(1)/T(N) reads the harness's own noise floor."""
    import functools

    from caf_cookoff_tpu.config import xcor_length
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import find_peak_2d
    from caf_cookoff_tpu.parallel.mesh import AXIS_PAIR
    from caf_cookoff_tpu.parallel.sharded import _batched_peak_jit

    per_proc, n, k = 2, 4096, 64
    batch = per_proc * nprocs
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    rng = np.random.default_rng(9)
    truths = [(float(freqs_np[5 + 2 * b]), 50 + 3 * b)
              for b in range(batch)]
    needles = (rng.standard_normal((batch, n))
               + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    hays = np.zeros((batch, n), np.complex64)
    t = np.arange(n)
    for b, (f, lag) in enumerate(truths):
        hays[b, lag:] = (needles[b] * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)[: n - lag]
    mesh = make_mesh(pair=nprocs)
    ns = splitfft.split_array(needles)
    hs = splitfft.split_array(hays)
    xl = xcor_length(n)
    g_ns = tuple(put(p, mesh, P(AXIS_PAIR)) for p in ns)
    g_hs = tuple(put(p, mesh, P(AXIS_PAIR)) for p in hs)
    g_freqs = put(freqs_np, mesh, P())
    # Gate: each process checks its ADDRESSABLE pair shard (a global
    # fetch would need an allgather in multi-controller mode).
    pk = _batched_peak_jit(*g_ns, *g_hs, put(freqs_np, mesh, P()), FS,
                           mesh, xl, "xla")
    for shard in pk.lag_idx.addressable_shards:
        b0 = shard.index[0].start or 0
        for i, got_lag in enumerate(np.asarray(shard.data)):
            b = b0 + i
            assert int(got_lag) == truths[b][1], (b, got_lag, truths[b])
    for shard in pk.freq_idx.addressable_shards:
        b0 = shard.index[0].start or 0
        for i, fidx in enumerate(np.asarray(shard.data)):
            b = b0 + i
            assert float(freqs_np[int(fidx)]) == truths[b][0], (
                b, freqs_np[int(fidx)], truths[b])

    def body(ns_re, ns_im, hs_re, hs_im, freqs, carry):
        pk = jax.vmap(
            lambda nr, ni, hr, hi: find_peak_2d(splitfft.mag2(
                _surface_rows_split((nr + carry[0], ni), (hr, hi), freqs,
                                    FS, xl, "xla")))
        )(ns_re, ns_im, hs_re, hs_im)
        return pk.value * 1e-30                      # (B_loc,) sharded

    sm = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR),
                  P(), P(AXIS_PAIR)),
        out_specs=P(AXIS_PAIR))

    @functools.partial(jax.jit, static_argnames=("kk",))
    def chain(nsr, nsi, hsr, hsi, fr_, kk):
        def step(c, _):
            return sm(nsr, nsi, hsr, hsi, fr_, c), None

        out, _ = jax.lax.scan(step, jnp.zeros(batch, ns[0].dtype), None,
                              length=kk)
        return out

    fetch = lambda out: np.asarray(out.addressable_shards[0].data)
    stats = chain_stats(
        lambda kk: chain(*g_ns, *g_hs, g_freqs, kk), fetch, iters, reps)
    return {
        "engine": f"pair_weak_{per_proc}perproc_{k}x{2 * n}", "n": nprocs,
        "mode": "weak",
        "full": stats, "compute": stats,
        "collective_ms": 0.0,
        "wire_bytes_per_step": 0,
    }


def _worker_time(jax, jnp, np, P, make_mesh, put, AXIS_TIME, nprocs,
                 chain_stats, iters, reps):
    import functools

    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import CafPeak
    from caf_cookoff_tpu.parallel.collectives import global_peak
    from caf_cookoff_tpu.parallel.sharded import (
        _right_halo,
        streaming_peak_deferred_halo,
    )

    n, total_lags, k = (TIME_SHAPE["n"], TIME_SHAPE["total_lags"],
                        TIME_SHAPE["num_bins"])
    rng = np.random.default_rng(TIME_GATE_SEED)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total_lags + n - 1) + 1j
                   * rng.standard_normal(total_lags + n - 1))
           ).astype(np.complex64)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    true_f, true_lag = float(freqs_np[k // 3]), total_lags - 1
    t = np.arange(n)
    hay[true_lag:true_lag + n] += (needle * np.exp(
        2j * np.pi * true_f * t / FS)).astype(np.complex64)[: len(hay)
                                                            - true_lag]
    mesh = make_mesh(time=nprocs)
    needed = total_lags + n - 1
    chunk = max(-(-needed // nprocs), n - 1)
    hay_p = np.pad(hay, (0, nprocs * chunk - len(hay))) \
        if nprocs * chunk > len(hay) else hay[: nprocs * chunk]
    n_sp = splitfft.split_array(needle)
    h_sp = splitfft.split_array(hay_p)
    m, _, _ = plan_blocks(n, chunk)
    halo = n - 1
    g_nre, g_nim = (put(p, mesh, P()) for p in n_sp)
    g_hre, g_him = (put(p, mesh, P(AXIS_TIME)) for p in h_sp)
    g_freqs = put(freqs_np, mesh, P())

    def body_full(n_re, n_im, h_re, h_im, freqs, carry):
        # Deferred halo (matches the production engine): the ppermute
        # feeds only the boundary blocks, overlapping interior compute.
        h_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                       for p in (h_re, h_im))
        s_conj = needle_spectra_conj((n_re + carry[0], n_im), freqs, FS,
                                     m, "xla")
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        local = streaming_peak_deferred_halo(
            s_conj, (h_re, h_im), h_halo, n, chunk, offset, total_lags,
            "xla")
        g = global_peak(local, AXIS_TIME)
        return jnp.reshape(g.value, (1,)) * 1e-30

    def body_compute(n_re, n_im, h_re, h_im, freqs, carry):
        s_conj = needle_spectra_conj((n_re + carry[0], n_im), freqs, FS,
                                     m, "xla")
        # Same per-shard math, zero halo (no neighbor traffic): each
        # chunk zero-extends instead of fetching its right neighbor.
        hay_ext = tuple(
            jnp.pad(p, ((0, halo),)) for p in (h_re, h_im))
        local = streaming_peak(s_conj, hay_ext, n, chunk,
                               backend="xla")
        return jnp.reshape(local.value, (1,)) * 1e-30

    def make_chain(body, carry_spec):
        sm = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(),
                      carry_spec),
            out_specs=carry_spec)

        @functools.partial(jax.jit, static_argnames=("kk",))
        def chain(nr, ni, hr, hi, fr, kk):
            init = jnp.zeros(
                (1 if carry_spec == P() else nprocs,), nr.dtype)

            def step(c, _):
                return sm(nr, ni, hr, hi, fr, c), None

            out, _ = jax.lax.scan(step, init, None, length=kk)
            return out

        return chain

    # Gate: tail-lag emitter (lives entirely in the last chunk's halo)
    # through THIS mesh — the full program must answer exactly.
    chain_full = make_chain(body_full, P())
    gate = chain_full(g_nre, g_nim, g_hre, g_him, g_freqs, 1)
    # Recompute the actual peak (not the 1e-30-scaled carry) once:
    sm_peak = jax.shard_map(
        lambda nr, ni, hr, hi, fr: global_peak(
            _time_local(jax, jnp, nr, ni, hr, hi, fr, m, n, chunk,
                        total_lags, halo, AXIS_TIME), AXIS_TIME),
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P()),
        out_specs=CafPeak(P(), P(), P()))
    pk = jax.jit(sm_peak)(g_nre, g_nim, g_hre, g_him, g_freqs)
    assert (float(freqs_np[int(pk.freq_idx)]), int(pk.lag_idx)) == \
        (true_f, true_lag), (nprocs, pk)
    del gate

    chain_comp = make_chain(body_compute, P(AXIS_TIME))
    fetch_full = lambda out: float(out[0])
    fetch_comp = lambda out: np.asarray(out.addressable_shards[0].data)
    full = chain_stats(lambda kk: chain_full(
        g_nre, g_nim, g_hre, g_him, g_freqs, kk), fetch_full, iters, reps)
    comp = chain_stats(lambda kk: chain_comp(
        g_nre, g_nim, g_hre, g_him, g_freqs, kk), fetch_comp, iters, reps)
    return {
        "engine": f"time_strong_{k}x{total_lags}", "n": nprocs,
        "mode": "strong",
        "full": full, "compute": comp,
        "collective_ms": round(full["value"] - comp["value"], 3),
        # ppermute halo: 2 f32 planes x (n-1) samples per neighbor link
        # per step, plus the 3-scalar peak lattice.
        "wire_bytes_per_step": (2 * 4 * (n - 1) * max(nprocs - 1, 0)
                                + 3 * 4 * nprocs),
    }


def _time_local(jax, jnp, n_re, n_im, h_re, h_im, freqs, m, n, chunk,
                total_lags, halo, axis):
    from caf_cookoff_tpu.models.overlap_save import needle_spectra_conj
    from caf_cookoff_tpu.parallel.sharded import (
        _right_halo,
        streaming_peak_deferred_halo,
    )

    h_halo = tuple(_right_halo(p, halo, axis) for p in (h_re, h_im))
    s_conj = needle_spectra_conj((n_re, n_im), freqs, FS, m, "xla")
    offset = jax.lax.axis_index(axis) * chunk
    return streaming_peak_deferred_halo(
        s_conj, (h_re, h_im), h_halo, n, chunk, offset, total_lags, "xla")


def _worker_rate(jax, jnp, np, P, make_mesh, put, AXIS_TIME, nprocs,
                 chain_stats, iters, reps):
    """Second-order (dechirp bank x time-sharded) scaling point.

    Same layout as ``_worker_time`` but the per-shard scan runs
    ``num_rates`` pre-chirped passes over its lag chunk — the ONE halo
    ppermute (issued before the rate scan, consumed by every rate's
    boundary blocks) amortizes over R x the compute, so the collective
    share of a step is ~1/R of the first-order engine's.
    """
    import functools

    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.parallel.collectives import global_rate_peak
    from caf_cookoff_tpu.parallel.sharded import (
        _right_halo,
        streaming_peak_deferred_halo,
    )

    n, total_lags, k, nrates = (RATE_SHAPE["n"], RATE_SHAPE["total_lags"],
                                RATE_SHAPE["num_bins"],
                                RATE_SHAPE["num_rates"])
    rng = np.random.default_rng(RATE_GATE_SEED)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total_lags + n - 1) + 1j
                   * rng.standard_normal(total_lags + n - 1))
           ).astype(np.complex64)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    # Rate grid sized to the window's resolution cell 1/T^2 ~ 2.2 kHz/s.
    rates_np = np.arange(-4000.0, 4001.0, 2000.0).astype(np.float32)
    assert len(rates_np) == nrates
    true_r = float(rates_np[3])                      # +2000 Hz/s
    true_f, true_lag = float(freqs_np[k // 3]), total_lags - 1
    t_sec = np.arange(n) / FS
    sw = (needle * np.exp(2j * np.pi * true_f * t_sec
                          + 1j * np.pi * true_r * t_sec ** 2)
          ).astype(np.complex64)
    hay[true_lag:true_lag + n] += sw[: len(hay) - true_lag]
    mesh = make_mesh(time=nprocs)
    needed = total_lags + n - 1
    chunk = max(-(-needed // nprocs), n - 1)
    hay_p = np.pad(hay, (0, nprocs * chunk - len(hay))) \
        if nprocs * chunk > len(hay) else hay[: nprocs * chunk]
    n_sp = splitfft.split_array(needle)
    h_sp = splitfft.split_array(hay_p)
    m, _, _ = plan_blocks(n, chunk)
    halo = n - 1
    g_nre, g_nim = (put(p, mesh, P()) for p in n_sp)
    g_hre, g_him = (put(p, mesh, P(AXIS_TIME)) for p in h_sp)
    g_freqs = put(freqs_np, mesh, P())
    g_rates = put(rates_np, mesh, P())

    def rate_scan(n_re, n_im, h_re, h_im, freqs, rates, peak_fn):
        """(r_idx, value, freq, lag) best over the rate bank;
        ``peak_fn(s_conj)`` runs the per-rate block scan."""
        t = jnp.arange(n, dtype=n_re.dtype) / FS

        def rstep(best, xr):
            r_idx, r = xr
            ph = jnp.pi * r * (t * t)
            c, s = jnp.cos(ph), jnp.sin(ph)
            nb = (n_re * c - n_im * s, n_re * s + n_im * c)
            s_conj = needle_spectra_conj(nb, freqs, FS, m, "xla")
            pk = peak_fn(s_conj)
            b_r, b_v, b_f, b_l = best
            take = pk.value > b_v
            return ((jnp.where(take, r_idx, b_r),
                     jnp.where(take, pk.value, b_v),
                     jnp.where(take, pk.freq_idx, b_f),
                     jnp.where(take, pk.lag_idx, b_l)), None)

        zero = (jnp.sum(n_re[..., :1]) * 0 + jnp.sum(h_re[..., :1]) * 0
                + jnp.sum(freqs[..., :1]) * 0)
        init = (zero.astype(jnp.int32), zero - jnp.inf,
                zero.astype(jnp.int32), zero.astype(jnp.int32))
        best, _ = jax.lax.scan(
            rstep, init,
            (jnp.arange(rates.shape[0], dtype=jnp.int32), rates))
        return best

    def body_full(n_re, n_im, h_re, h_im, freqs, rates, carry):
        # ONE halo exchange serves every trial rate.
        h_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                       for p in (h_re, h_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        best = rate_scan(
            n_re + carry[0], n_im, h_re, h_im, freqs, rates,
            lambda s_conj: streaming_peak_deferred_halo(
                s_conj, (h_re, h_im), h_halo, n, chunk, offset,
                total_lags, "xla"))
        g = global_rate_peak(best[1], best[0], best[2], best[3],
                             AXIS_TIME)
        return jnp.reshape(g[0], (1,)) * 1e-30

    def body_compute(n_re, n_im, h_re, h_im, freqs, rates, carry):
        hay_ext = tuple(jnp.pad(p, ((0, halo),)) for p in (h_re, h_im))
        best = rate_scan(
            n_re + carry[0], n_im, h_re, h_im, freqs, rates,
            lambda s_conj: streaming_peak(s_conj, hay_ext, n, chunk,
                                          backend="xla"))
        return jnp.reshape(best[1], (1,)) * 1e-30

    def make_chain(body, carry_spec):
        sm = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(), P(),
                      carry_spec),
            out_specs=carry_spec)

        @functools.partial(jax.jit, static_argnames=("kk",))
        def chain(nr, ni, hr, hi, fr, rt, kk):
            init = jnp.zeros(
                (1 if carry_spec == P() else nprocs,), nr.dtype)

            def step(c, _):
                return sm(nr, ni, hr, hi, fr, rt, c), None

            out, _ = jax.lax.scan(step, init, None, length=kk)
            return out

        return chain

    # Gate: the swept tail-lag emitter (lag in the last chunk, sweep
    # spanning ~2 rate cells) must come back grid-exact in
    # (rate, freq, lag) through THIS mesh.
    sm_quad = jax.shard_map(
        lambda nr, ni, hr, hi, fr, rt: global_rate_peak(
            *_rate_best_reorder(rate_scan(
                nr, ni, hr, hi, fr, rt,
                lambda s_conj: _rate_halo_peak(
                    jax, jnp, s_conj, hr, hi, n, chunk, total_lags,
                    halo, AXIS_TIME))), AXIS_TIME),
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(), P()),
        out_specs=(P(), P(), P(), P()))
    val, r_i, f_i, l_i = jax.jit(sm_quad)(g_nre, g_nim, g_hre, g_him,
                                          g_freqs, g_rates)
    got = (float(rates_np[int(r_i)]), float(freqs_np[int(f_i)]),
           int(l_i))
    assert got == (true_r, true_f, true_lag), (nprocs, got)

    chain_full = make_chain(body_full, P())
    chain_comp = make_chain(body_compute, P(AXIS_TIME))
    fetch_full = lambda out: float(out[0])
    fetch_comp = lambda out: np.asarray(out.addressable_shards[0].data)
    full = chain_stats(lambda kk: chain_full(
        g_nre, g_nim, g_hre, g_him, g_freqs, g_rates, kk), fetch_full,
        iters, reps)
    comp = chain_stats(lambda kk: chain_comp(
        g_nre, g_nim, g_hre, g_him, g_freqs, g_rates, kk), fetch_comp,
        iters, reps)
    return {
        "engine": f"rate_strong_{nrates}x{k}x{total_lags}", "n": nprocs,
        "mode": "strong",
        "full": full, "compute": comp,
        "collective_ms": round(full["value"] - comp["value"], 3),
        # One halo ppermute for ALL rates + the 4-scalar quad reduce.
        "wire_bytes_per_step": (2 * 4 * (n - 1) * max(nprocs - 1, 0)
                                + 4 * 4 * nprocs),
    }


def _rate_best_reorder(best):
    """rate_scan's (r_idx, value, f, lag) -> global_rate_peak's
    (value, rate_idx, freq_idx, lag_idx) argument order."""
    r_idx, value, f_idx, l_idx = best
    return value, r_idx, f_idx, l_idx


def _rate_halo_peak(jax, jnp, s_conj, h_re, h_im, n, chunk, total_lags,
                    halo, axis):
    from caf_cookoff_tpu.parallel.sharded import (
        _right_halo,
        streaming_peak_deferred_halo,
    )

    h_halo = tuple(_right_halo(p, halo, axis) for p in (h_re, h_im))
    offset = jax.lax.axis_index(axis) * chunk
    return streaming_peak_deferred_halo(
        s_conj, (h_re, h_im), h_halo, n, chunk, offset, total_lags,
        "xla")


def _worker_config5(jax, jnp, np, P, make_mesh, put, nprocs, chain_stats,
                    iters, reps, axes):
    """Combined-axes STRONG scaling (BASELINE config 5's composition):
    4 pairs x 64 bins x 32768 lags through the per-pair multi-emitter
    lattice engine — the ``_batched_os_peaks_jit`` shape, where a wrong
    axis ordering or a reduce-over-(doppler,time)-leaving-pair bug
    would first show under real multi-process collectives.

    ``axes='dt'``: pairs local (vmapped), mesh = doppler x time —
    2x2 at N=4; collectives = ppermute halos over ``time`` PLUS the
    per-pair lattice all_gather over ``(doppler, time)``.
    ``axes='pt'``: bins local, mesh = pair x time — 2x2 at N=4; the
    lattice all_gather folds over ``time`` only (``pair`` stays a
    data axis, per-pair results sharded).

    The compute twin runs the identical per-shard math with zero halo
    and no cross-shard merge, so ``collective_ms`` attributes the
    combined-axes collective stack.  Both factorizations gate on every
    pair's TWO injected emitters recovered exactly through the mesh.
    """
    import functools

    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import CafPeak
    from caf_cookoff_tpu.parallel.collectives import global_peaks_batched
    from caf_cookoff_tpu.parallel.mesh import (
        AXIS_DOPPLER,
        AXIS_PAIR,
        AXIS_TIME,
    )
    from caf_cookoff_tpu.parallel.sharded import (
        _right_halo,
        pad_axis_to,
        streaming_peak_deferred_halo,
    )

    n, total_lags, k, batch, num_peaks = (
        CONFIG5_SHAPE["n"], CONFIG5_SHAPE["total_lags"],
        CONFIG5_SHAPE["num_bins"], CONFIG5_SHAPE["pairs"],
        CONFIG5_SHAPE["num_peaks"])
    tm = min(nprocs, 2)          # time axis: 1, 2, 2 at N = 1, 2, 4
    om = nprocs // tm            # other axis (doppler or pair)
    rng = np.random.default_rng(CONFIG5_GATE_SEED)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    needles = (rng.standard_normal((batch, n)) + 1j
               * rng.standard_normal((batch, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((batch, total_lags + n - 1)) + 1j
                    * rng.standard_normal((batch, total_lags + n - 1)))
            ).astype(np.complex64)
    t = np.arange(n)
    truths = []                  # per pair: [(freq, lag) strongest-first]
    for b in range(batch):
        pair_truths = [(float(freqs_np[7 + 5 * b]), 900 + 1000 * b),
                       (float(freqs_np[40 - 4 * b]), total_lags - 1 - 700 * b)]
        for amp, (f, lag) in zip((1.0, 0.7), pair_truths):
            end = min(lag + n, hays.shape[1])
            hays[b, lag:end] += (amp * needles[b] * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)[: end - lag]
        truths.append(pair_truths)

    # Resolution-derived NMS cell (1024 samples at 48 kHz: the doppler
    # mainlobe spans ~15 of these 3.125 Hz bins — a hardcoded cell
    # would let sidelobes of emitter 1 occupy lattice slots).
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    excl_f, excl_l = resolve_exclusions(needles[0], freqs_np, FS,
                                        None, None)
    needed = total_lags + n - 1
    chunk = max(-(-needed // tm), n - 1)
    if tm * chunk > hays.shape[1]:
        hays = np.pad(hays, ((0, 0), (0, tm * chunk - hays.shape[1])))
    else:
        hays = hays[:, : tm * chunk]
    ns = splitfft.split_array(needles)
    hs = splitfft.split_array(hays)
    m, _, _ = plan_blocks(n, chunk)
    halo = n - 1

    if axes == "dt":
        mesh = make_mesh(doppler=om, time=tm)
        freqs_p = pad_axis_to(freqs_np, om)
        k_loc = freqs_p.shape[0] // om
        ns_spec, hs_spec, fr_spec = P(), P(None, AXIS_TIME), P(AXIS_DOPPLER)
        reduce_axes = (AXIS_DOPPLER, AXIS_TIME)
        lat_spec = CafPeak(P(), P(), P())
        full_carry, full_len = P(), 1
    else:
        mesh = make_mesh(pair=om, time=tm)
        freqs_p, k_loc = freqs_np, k
        ns_spec, hs_spec, fr_spec = (P(AXIS_PAIR),
                                     P(AXIS_PAIR, AXIS_TIME), P())
        reduce_axes = (AXIS_TIME,)
        lat_spec = CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR))
        full_carry, full_len = P(AXIS_PAIR), om
    g_ns = tuple(put(p, mesh, ns_spec) for p in ns)
    g_hs = tuple(put(p, mesh, hs_spec) for p in hs)
    g_freqs = put(freqs_p, mesh, fr_spec)

    def lattices(ns_re, ns_im, hs_re, hs_im, freqs_loc, seed):
        """Per-pair (B_loc, num_peaks) lattices reduced over the mesh."""
        hs_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                        for p in (hs_re, hs_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        if axes == "dt":
            row0 = jax.lax.axis_index(AXIS_DOPPLER) * k_loc
        else:
            row0 = jnp.int32(0)
        rows_global = row0 + jnp.arange(k_loc, dtype=jnp.int32)

        def one(nr, ni, hr, hi, qr, qi):
            s_conj = needle_spectra_conj((nr + seed, ni), freqs_loc, FS,
                                         m, "xla")
            lat = streaming_peak_deferred_halo(
                s_conj, (hr, hi), (qr, qi), n, chunk, offset, total_lags,
                "xla", num_peaks=num_peaks, exclude_freq=excl_f,
                exclude_lag=excl_l, valid_rows=rows_global < k)
            return CafPeak(lat.value, lat.freq_idx + row0, lat.lag_idx)

        local = jax.vmap(one)(ns_re, ns_im, hs_re, hs_im, *hs_halo)
        return global_peaks_batched(local, reduce_axes, num_peaks,
                                    excl_f, excl_l)

    def body_full(ns_re, ns_im, hs_re, hs_im, freqs_loc, carry):
        g = lattices(ns_re, ns_im, hs_re, hs_im, freqs_loc, carry[0])
        val = jnp.sum(jnp.where(jnp.isfinite(g.value), g.value, 0.0))
        return jnp.reshape(val, (1,)) * 1e-30

    def body_compute(ns_re, ns_im, hs_re, hs_im, freqs_loc, carry):
        # Identical per-shard math: zero halo (no neighbor traffic),
        # local lattices only (no all_gather merge).
        if axes == "dt":
            row0 = jax.lax.axis_index(AXIS_DOPPLER) * k_loc
        else:
            row0 = jnp.int32(0)
        rows_global = row0 + jnp.arange(k_loc, dtype=jnp.int32)

        def one(nr, ni, hr, hi):
            s_conj = needle_spectra_conj((nr + carry[0], ni), freqs_loc,
                                         FS, m, "xla")
            hay_ext = tuple(jnp.pad(p, ((0, halo),)) for p in (hr, hi))
            lat = streaming_peak(s_conj, hay_ext, n, chunk,
                                 backend="xla", num_peaks=num_peaks,
                                 exclude_freq=excl_f, exclude_lag=excl_l,
                                 valid_rows=rows_global < k)
            return lat

        lat = jax.vmap(one)(ns_re, ns_im, hs_re, hs_im)
        val = jnp.sum(jnp.where(jnp.isfinite(lat.value), lat.value, 0.0))
        return jnp.reshape(val, (1,)) * 1e-30

    def make_chain(body, carry_spec, carry_len):
        sm = jax.shard_map(
            body, mesh=mesh,
            in_specs=(ns_spec, ns_spec, hs_spec, hs_spec, fr_spec,
                      carry_spec),
            out_specs=carry_spec, check_vma=False)

        @functools.partial(jax.jit, static_argnames=("kk",))
        def chain(nsr, nsi, hsr, hsi, fr_, kk):
            def step(c, _):
                return sm(nsr, nsi, hsr, hsi, fr_, c), None

            out, _ = jax.lax.scan(
                step, jnp.zeros((carry_len,), nsr.dtype), None, length=kk)
            return out

        return chain

    # Gate: every pair's two injected emitters, exactly, through THIS
    # mesh's combined collectives (lattice replicated for dt; sharded
    # over pair for pt — each process checks its addressable shard).
    sm_lat = jax.jit(jax.shard_map(
        lambda nr, ni, hr, hi, fr_: lattices(nr, ni, hr, hi, fr_,
                                             jnp.float32(0)),
        mesh=mesh,
        in_specs=(ns_spec, ns_spec, hs_spec, hs_spec, fr_spec),
        out_specs=lat_spec, check_vma=False))
    lat = sm_lat(*g_ns, *g_hs, g_freqs)
    for fshard, lshard in zip(lat.freq_idx.addressable_shards,
                              lat.lag_idx.addressable_shards):
        b0 = (fshard.index[0].start or 0) if axes == "pt" else 0
        fidx = np.asarray(fshard.data)
        lagi = np.asarray(lshard.data)
        for i in range(fidx.shape[0]):
            got = [(float(freqs_p[fi]), int(lg))
                   for fi, lg in zip(fidx[i], lagi[i])]
            assert got == truths[b0 + i], (axes, b0 + i, got,
                                           truths[b0 + i])

    chain_full = make_chain(body_full, full_carry, full_len)
    chain_comp = make_chain(body_compute, P(AXIS_TIME), tm)
    fetch = lambda out: np.asarray(out.addressable_shards[0].data)
    full = chain_stats(lambda kk: chain_full(
        *g_ns, *g_hs, g_freqs, kk), fetch, iters, reps)
    comp = chain_stats(lambda kk: chain_comp(
        *g_ns, *g_hs, g_freqs, kk), fetch, iters, reps)
    # Wire model per step: halo ppermute on every time link of every
    # mesh row (2 f32 planes x (n-1) samples x local pair count), plus
    # the per-pair lattice all_gather (3 fields x 4 B x pairs x P) over
    # each reduction axis hop.
    b_loc = batch if axes == "dt" else batch // om
    halo_bytes = 2 * 4 * (n - 1) * b_loc * max(tm - 1, 0) * om
    gather_hops = (nprocs - 1) if axes == "dt" else (tm - 1) * om
    gather_bytes = 3 * 4 * b_loc * num_peaks * max(gather_hops, 0)
    return {
        "engine": (f"config5_{axes}_{batch}pair_{k}x{total_lags}"
                   f"_mesh{om}x{tm}"),
        "n": nprocs, "mode": "strong",
        "mesh": ({"doppler": om, "time": tm} if axes == "dt"
                 else {"pair": om, "time": tm}),
        "full": full, "compute": comp,
        "collective_ms": round(full["value"] - comp["value"], 3),
        "wire_bytes_per_step": halo_bytes + gather_bytes,
    }


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------


def _run_point(engine: str, nprocs: int, iters: int, reps: int) -> dict:
    port = _free_port()
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--_worker", "--engine", engine,
         "--pid", str(i), "--nprocs", str(nprocs), "--port", str(port),
         "--iters", str(iters), "--reps", str(reps)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(nprocs)]
    outs = [p.communicate(timeout=1800)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(
                f"{engine} N={nprocs} worker {i} failed:\n{out[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("WORKER_JSON "):
            return json.loads(line[len("WORKER_JSON "):])
    raise SystemExit(f"{engine} N={nprocs}: no result line:\n"
                     f"{outs[0][-3000:]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", default="1,2,4",
                    help="comma list of process counts (disjoint "
                    "one-core pins; max = core count)")
    ap.add_argument("--engines",
                    default="doppler,time,pair,config5_dt,config5_pt,"
                            "rate")
    ap.add_argument("--iters", type=int, default=2,
                    help="chain length per measurement")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    # Internal worker-mode flags:
    ap.add_argument("--_worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--engine", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--nprocs", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args._worker:
        _worker(args)
        return

    counts = [int(c) for c in args.procs.split(",")]
    ncores = os.cpu_count()
    if max(counts) > ncores:
        raise SystemExit(f"--procs max {max(counts)} exceeds {ncores} "
                         "cores (pins must be disjoint)")
    doc = {"method": "pinned-core multi-process (Gloo), one XLA CPU "
                     "device and one disjoint core per process",
           "cores": ncores, "engines": {}}
    for engine in args.engines.split(","):
        engine = engine.strip()
        rows = [_run_point(engine, n, args.iters, args.reps)
                for n in counts]
        t1 = rows[0]["full"]["value"]
        c1 = rows[0]["compute"]["value"]
        for r in rows:
            # strong: fixed total problem -> T1/(N*TN); weak: fixed
            # per-process problem -> T1/TN.
            nd = r["n"] if r.get("mode") != "weak" else 1
            r["efficiency"] = (round(t1 / (nd * r["full"]["value"]), 3)
                               if r["full"]["value"] > 0 and t1 > 0
                               else None)
            r["compute_efficiency"] = (
                round(c1 / (nd * r["compute"]["value"]), 3)
                if r["compute"]["value"] > 0 and c1 > 0 else None)
            print(json.dumps(r))
        doc["engines"][engine] = rows
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
