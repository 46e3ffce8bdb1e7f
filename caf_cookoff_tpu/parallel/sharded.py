"""Multi-device CAF engines: ``shard_map`` over a named device mesh.

The mesh replacement for the reference's seven CPU fan-out strategies
(SURVEY §2.3): instead of rayon work-stealing (``caf_rust/src/caf/
mod.rs:185``), 400 goroutines (``caf_go/caf.go:143-160``) or a pickling
process pool (``caf_python/caf.py:63-70``), the doppler/pair/time axes of
the problem are laid out over mesh axes and XLA inserts collectives:

* ``doppler``  — frequency bins sharded; peak reduced via pmax/pmin
  (:mod:`caf_cookoff_tpu.parallel.collectives`);
* ``pair``     — independent signal pairs, purely data parallel;
* ``time``     — long-haystack lag blocks with ``ppermute`` halo
  exchange of the ``N-1`` boundary samples (overlap-save, the
  ring-attention-style neighbor pattern).

All device math is split-complex (re, im real planes); complex dtypes
appear only at the host boundary,
where inputs are split before entering the jitted programs.  Inputs stay
host-side (numpy) until jit places them onto the mesh devices — eager
placement would pin them to the default device, which may not be in the
mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from caf_cookoff_tpu.config import as_grid, default_backend, xcor_length
from caf_cookoff_tpu.models.filterbank import _surface_rows_split
from caf_cookoff_tpu.models.overlap_save import (
    needle_spectra_conj,
    plan_blocks,
    streaming_peak,
)
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import CafPeak, as_lattice, find_peak_2d
from caf_cookoff_tpu.parallel.collectives import (
    global_peak,
    global_peaks,
    global_peaks_batched,
)
from caf_cookoff_tpu.parallel.mesh import AXIS_DOPPLER, AXIS_PAIR, AXIS_TIME

shard_map = jax.shard_map


def pad_axis_to(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``x`` along ``axis`` to a multiple by repeating the last slice.

    Used on the doppler grid: duplicated frequencies produce duplicate
    surface rows, and the lowest-index tie-break in the peak reduction
    guarantees the original row wins, so padding never changes results.
    """
    x = np.asarray(x)
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    last = np.take(x, [size - 1] * (target - size), axis=axis)
    return np.concatenate([x, last], axis=axis)


def _right_halo(chunk: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """First ``halo`` samples of the right neighbor's chunk (zeros at edge).

    The overlap-save neighbor exchange: device ``i`` receives from
    ``i+1`` via ``ppermute``; the last device, having no right
    neighbor, receives zeros (``ppermute``'s defined fill), which matches
    the zero-padded haystack tail.
    """
    n_dev = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n_dev - 1)]
    return jax.lax.ppermute(chunk[..., :halo], axis_name, perm)


def _split_host(x) -> Tuple[np.ndarray, np.ndarray]:
    return splitfft.split_array(np.asarray(x))


def streaming_peak_deferred_halo(s_conj, h_local, h_halo, needle_len: int,
                                 chunk: int, lag_offset, total_lags,
                                 backend: str, num_peaks: int = 1,
                                 exclude_freq: Optional[int] = None,
                                 exclude_lag: Optional[int] = None,
                                 valid_rows=None, with_floor: bool = False):
    """Shard-local overlap-save scan with the neighbor halo consumed
    ONLY by the boundary blocks — the ``ppermute`` overlaps interior
    compute instead of serializing exchange-then-scan.

    A block covering local lags ``[b*V, b*V + V)`` reads samples
    ``[b*V, b*V + V + N - 1)``: every block whose read window stays
    inside the shard's own ``chunk`` samples never touches the
    exchanged halo.  The scan therefore splits into an interior scan
    (pure local data, no dependency on the collective) and a short
    boundary scan over the final ``<= ceil((N-1)/V) + 1`` blocks; with
    the ``ppermute`` result feeding only the second scan, the scheduler
    is free to run the collective concurrently with the interior
    compute (latency hiding — the round-3 time-axis pinned efficiency
    was collective-latency-bound at N=4).

    Semantics vs :func:`streaming_peak` over ``concat([local, halo])``:
    same lag/row/validity masks, same earliest-lag tie-break (the
    interior scan owns the earlier lags and the boundary result only
    wins on a STRICT greater), and the floor accumulators sum over the
    two disjoint lag ranges.  The single-peak argmax is bit-identical.
    For ``num_peaks > 1`` the top peaks at distinct lags match, but
    sidelobe-level slots may differ from the sequential fold: the
    boundary blocks fold into their own lattice before merging with the
    interior survivors, so a boundary candidate suppressed by a
    neighbor that a stronger interior peak would itself have suppressed
    can be lost — the same 'exact at distinct lags, sidelobe-level
    slots may differ' contract as the cross-shard hierarchical merge
    (:func:`caf_cookoff_tpu.parallel.collectives.global_peaks`).
    """
    from caf_cookoff_tpu.ops.peak import concat_peaks, merge_peaks

    _, v, nblocks = plan_blocks(needle_len, chunk)
    d = v + needle_len - 1
    b_int = min((chunk - d) // v + 1, nblocks) if chunk >= d else 0
    kw = dict(total_lags=total_lags, backend=backend, num_peaks=num_peaks,
              exclude_freq=exclude_freq, exclude_lag=exclude_lag,
              valid_rows=valid_rows, with_floor=with_floor)
    if b_int <= 0:
        hay_ext = tuple(jnp.concatenate([p, q], axis=-1)
                        for p, q in zip(h_local, h_halo))
        return streaming_peak(s_conj, hay_ext, needle_len, chunk,
                              lag_offset=lag_offset, **kw)
    lags_int = b_int * v           # b_int*v + N-1 <= chunk: local-only
    out_i = streaming_peak(s_conj, h_local, needle_len, lags_int,
                           lag_offset=lag_offset, **kw)
    tail = tuple(jnp.concatenate([p[..., lags_int:], q], axis=-1)
                 for p, q in zip(h_local, h_halo))
    out_b = streaming_peak(s_conj, tail, needle_len, chunk - lags_int,
                           lag_offset=lag_offset + lags_int, **kw)
    pk_i, pk_b = (out_i[0], out_b[0]) if with_floor else (out_i, out_b)
    if num_peaks > 1:
        pk = merge_peaks(concat_peaks(pk_i, pk_b), num_peaks,
                         exclude_freq, exclude_lag)
    else:
        take = pk_b.value > pk_i.value   # strict: earlier lags win ties
        pk = CafPeak(jnp.where(take, pk_b.value, pk_i.value),
                     jnp.where(take, pk_b.freq_idx, pk_i.freq_idx),
                     jnp.where(take, pk_b.lag_idx, pk_i.lag_idx))
    if with_floor:
        return pk, out_i[1] + out_b[1], out_i[2] + out_b[2]
    return pk


# ---------------------------------------------------------------------------
# Doppler-sharded filterbank surface / peak (truncated-haystack workload)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("mesh", "xcor_len", "num_bins", "backend"))
def _sharded_surface_jit(n_re, n_im, h_re, h_im, freqs_padded, sample_rate,
                         mesh, xcor_len, num_bins, backend):
    def body(n_re, n_im, h_re, h_im, freqs_loc):
        rows = _surface_rows_split((n_re, n_im), (h_re, h_im), freqs_loc,
                                   sample_rate, xcor_len, backend)
        return splitfft.mag2(rows)

    mag2 = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS_DOPPLER)),
        out_specs=P(AXIS_DOPPLER, None),
    )(n_re, n_im, h_re, h_im, freqs_padded)
    return mag2[:num_bins]


def sharded_caf_surface(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                        *, backend: Optional[str] = None) -> jax.Array:
    """(K, M) mag^2 surface with doppler bins sharded over the mesh.

    Same contract as :func:`caf_cookoff_tpu.caf_surface`; the output is a
    global array laid out shard-by-shard over the ``doppler`` mesh axis.
    """
    backend = backend or default_backend()
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs = pad_axis_to(as_grid(freqs_hz, dtype=n_re.dtype),
                        mesh.shape[AXIS_DOPPLER])
    return _sharded_surface_jit(
        n_re, n_im, h_re, h_im, freqs, float(sample_rate), mesh,
        xcor_length(n_re.shape[-1]), int(np.shape(freqs_hz)[0]), backend)


@functools.partial(
    jax.jit, static_argnames=("mesh", "xcor_len", "backend"))
def _sharded_peak_jit(n_re, n_im, h_re, h_im, freqs_padded, sample_rate,
                      mesh, xcor_len, backend):
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]

    def body(n_re, n_im, h_re, h_im, freqs_loc):
        rows = _surface_rows_split((n_re, n_im), (h_re, h_im), freqs_loc,
                                   sample_rate, xcor_len, backend)
        local = find_peak_2d(splitfft.mag2(rows))
        local = CafPeak(
            local.value,
            local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
            local.lag_idx)
        return global_peak(local, AXIS_DOPPLER)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS_DOPPLER)),
        out_specs=CafPeak(P(), P(), P()),
    )(n_re, n_im, h_re, h_im, freqs_padded)


def sharded_caf_peak(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                     *, backend: Optional[str] = None) -> Tuple[float, int, float]:
    """(freq_hz, lag_idx, value): doppler-sharded fused surface+peak.

    The surface never materializes anywhere — each chip reduces its bin
    block and the triples meet in a pmax/pmin lattice.
    """
    backend = backend or default_backend()
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=n_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    peak = _sharded_peak_jit(n_re, n_im, h_re, h_im, freqs_p,
                             float(sample_rate), mesh,
                             xcor_length(n_re.shape[-1]), backend)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "num_bins", "refine"))
def _sharded_stein_peak_jit(n_re, n_im, h_re, h_im, freqs_padded,
                            sample_rate, mesh, xcor_len, block_len,
                            backend, num_bins, refine):
    """Doppler-sharded Stein synthesis: segment correlations replicate
    (they are K-independent and cheap); each chip synthesizes and
    reduces its own doppler slice.

    With ``refine`` the coarse pass only RANKS bins (bf16 synthesis, the
    same tiering as the single-chip ``_stein_peak_jit``): per-bin row
    maxima are ``all_gather``-ed over the doppler axis (K floats — far
    cheaper than any surface traffic) and the global top-k candidate
    bins are re-scored with exact filterbank rows on-device, so a
    distant near-tie sidelobe is recovered exactly as on one chip — no
    host round-trip, one compiled program.
    """
    from caf_cookoff_tpu.models.stein import (
        _doppler_synthesis,
        _refine_candidates,
        _segment_correlations,
    )

    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    if refine:
        coarse_backend = ("matmul-bf16" if backend.startswith("matmul")
                          else backend)
        synth_prec = jax.lax.Precision.DEFAULT
    else:
        coarse_backend = backend
        synth_prec = None

    def body(n_re, n_im, h_re, h_im, freqs_loc, freqs_full):
        g = _segment_correlations((n_re, n_im), (h_re, h_im), xcor_len,
                                  block_len, coarse_backend)
        rows = _doppler_synthesis(g, freqs_loc, sample_rate, block_len,
                                  synth_prec)
        mag2 = splitfft.mag2(rows)
        if not refine:
            local = find_peak_2d(mag2)
            local = CafPeak(
                local.value,
                local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
                local.lag_idx)
            return global_peak(local, AXIS_DOPPLER)
        rowmax_loc = jnp.max(mag2, axis=-1)                  # (K_loc,)
        rowmax = jax.lax.all_gather(rowmax_loc, AXIS_DOPPLER,
                                    tiled=True)              # (K_pad,)
        # Grid-padding duplicates the last frequency; mask the padded
        # rows out of the candidate ranking.
        idx = jnp.arange(rowmax.shape[0])
        rowmax = jnp.where(idx < num_bins, rowmax, -jnp.inf)
        # Hybrid plain/mainlobe-separated candidate set — same closer
        # as the single-chip engine (models/stein._refine_candidates).
        cand = _refine_candidates(rowmax, freqs_full, n_re.shape[-1],
                                  sample_rate, num_bins)
        exact = splitfft.mag2(_surface_rows_split(
            (n_re, n_im), (h_re, h_im), freqs_full[cand], sample_rate,
            xcor_len, backend))                              # (P, M)
        rowmax_e = jnp.max(exact, axis=-1)
        best = jnp.lexsort((cand.astype(jnp.int32), -rowmax_e))[0]
        peak = CafPeak(value=rowmax_e[best],
                       freq_idx=cand[best].astype(jnp.int32),
                       lag_idx=jnp.argmax(exact[best]).astype(jnp.int32))
        # Every shard computed the same peak from the gathered ranking;
        # the reduction is an identity that establishes replication.
        return global_peak(peak, AXIS_DOPPLER)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS_DOPPLER), P()),
        out_specs=CafPeak(P(), P(), P()),
    )(n_re, n_im, h_re, h_im, freqs_padded, freqs_padded)


def sharded_stein_peak(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                       *, block_len: int = 64, refine: bool = True,
                       backend: Optional[str] = None
                       ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value): Stein synthesis sharded over ``doppler``.

    Coarse segmented rank across the mesh, then (``refine=True``) an
    exact on-device top-k re-score — the same rank-then-score design as
    the single-chip engine (``models/stein.py``), so bin-exact answers
    at segmented-scan cost even when the winner is a distant near-tie.
    """
    from caf_cookoff_tpu.models.stein import _auto_block_len

    backend = backend or default_backend()
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs_np = as_grid(freqs_hz, dtype=n_re.dtype)
    block_len = _auto_block_len(sample_rate, freqs_np, block_len)
    freqs_p = pad_axis_to(freqs_np, mesh.shape[AXIS_DOPPLER])
    peak = _sharded_stein_peak_jit(
        n_re, n_im, h_re, h_im, freqs_p, float(sample_rate), mesh,
        xcor_length(n_re.shape[-1]), block_len, backend,
        len(freqs_np), refine)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


# ---------------------------------------------------------------------------
# Pair + doppler sharded batch engine (many signal pairs at once)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("mesh", "xcor_len", "backend"))
def _batched_peak_jit(ns_re, ns_im, hs_re, hs_im, freqs_padded, sample_rate,
                      mesh, xcor_len, backend):
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]

    def body(ns_re, ns_im, hs_re, hs_im, freqs_loc):
        mag2 = jax.vmap(
            lambda nr, ni, hr, hi: splitfft.mag2(_surface_rows_split(
                (nr, ni), (hr, hi), freqs_loc, sample_rate, xcor_len,
                backend))
        )(ns_re, ns_im, hs_re, hs_im)                  # (B_loc, K_loc, M)
        local = find_peak_2d(mag2)                     # each field (B_loc,)
        local = CafPeak(
            local.value,
            local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
            local.lag_idx)
        return global_peak(local, AXIS_DOPPLER)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR),
                  P(AXIS_DOPPLER)),
        out_specs=CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR)),
    )(ns_re, ns_im, hs_re, hs_im, freqs_padded)


def batched_caf_peak(needles, haystacks, freqs_hz, sample_rate, mesh: Mesh,
                     *, backend: Optional[str] = None):
    """Peaks for a batch of pairs: (freqs (B,), lags (B,), values (B,)).

    Batch is data-parallel over the ``pair`` mesh axis, bins over
    ``doppler`` — the two-axis generalization the reference's
    one-pair-at-a-time mains never reach (``caf_python/caf.py:89-108``
    defines the single-pair unit of work).
    """
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.shape != needles.shape:
        raise ValueError(
            f"need matching (B, N) batches, got {needles.shape} vs "
            f"{haystacks.shape}")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    backend = backend or default_backend()
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(haystacks)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=ns_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    peak = _batched_peak_jit(ns_re, ns_im, hs_re, hs_im, freqs_p,
                             float(sample_rate), mesh,
                             xcor_length(needles.shape[-1]), backend)
    return (freqs_p[np.asarray(peak.freq_idx)], np.asarray(peak.lag_idx),
            np.asarray(peak.value))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend"))
def _sharded_batched_stein_jit(ns_re, ns_im, hs_re, hs_im, freqs,
                               sample_rate, mesh, xcor_len, block_len,
                               backend):
    from caf_cookoff_tpu.models.batched_stein import _batched_stein_core

    def body(ns_re, ns_im, hs_re, hs_im, freqs):
        return _batched_stein_core(ns_re, ns_im, hs_re, hs_im, freqs,
                                   sample_rate, xcor_len, block_len,
                                   backend, True)

    # check_vma=False: the body is pure data parallelism (no
    # collectives), so there is no varying-axis state to check.
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR),
                  P()),
        out_specs=CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR)),
        check_vma=False,
    )(ns_re, ns_im, hs_re, hs_im, freqs)


def sharded_batched_stein_peak(needles, haystacks, freqs_hz, sample_rate,
                               mesh: Mesh, *, block_len: int = 64,
                               backend: Optional[str] = None):
    """Per-pair peaks with the segmented batch engine sharded over ``pair``.

    The single-device batch engine (:func:`caf_cookoff_tpu.models.
    batched_stein.batched_stein_peak`) scaled out: each device runs
    the segmented engine on its local pair block — pure data
    parallelism, zero collectives, so scaling efficiency is bounded
    only by batch divisibility.  Doppler bins replicate (the synthesis
    weights are O(K*B), trivial).
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _pow2_block_len,
        SUPER,
    )

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.shape != needles.shape:
        raise ValueError(
            f"need matching (B, N) batches, got {needles.shape} vs "
            f"{haystacks.shape}")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    d = _pow2_block_len(sample_rate, freqs, block_len)
    n = ns_re.shape[-1]
    pad = (-n) % SUPER
    if pad:
        ns_re = np.pad(ns_re, ((0, 0), (0, pad)))
        ns_im = np.pad(ns_im, ((0, 0), (0, pad)))
    peak = _sharded_batched_stein_jit(
        ns_re, ns_im, hs_re, hs_im, freqs, float(sample_rate), mesh,
        xcor_length(n), d, backend)
    return (freqs[np.asarray(peak.freq_idx)], np.asarray(peak.lag_idx),
            np.asarray(peak.value))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "num_peaks", "exclude_freq", "exclude_lag", "guard",
                     "rescore_win"))
def _sharded_batched_stein_peaks_jit(ns_re, ns_im, hs_re, hs_im, freqs,
                                     sample_rate, mesh, xcor_len,
                                     block_len, backend, num_peaks,
                                     exclude_freq, exclude_lag, guard,
                                     rescore_win):
    from caf_cookoff_tpu.models.batched_stein import (
        _batched_stein_peaks_core,
    )

    def body(ns_re, ns_im, hs_re, hs_im, freqs):
        return _batched_stein_peaks_core(
            ns_re, ns_im, hs_re, hs_im, freqs, sample_rate, xcor_len,
            block_len, backend, num_peaks, exclude_freq, exclude_lag,
            guard, rescore_win)

    # check_vma=False for the same reason as _sharded_batched_stein_jit
    # (pure data parallelism).
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR),
                  P()),
        out_specs=CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR)),
        check_vma=False,
    )(ns_re, ns_im, hs_re, hs_im, freqs)


def sharded_batched_stein_peaks(needles, haystacks, freqs_hz, sample_rate,
                                mesh: Mesh, num_peaks: int, *,
                                block_len: int = 64,
                                exclude_freq: Optional[int] = None,
                                exclude_lag: Optional[int] = None,
                                backend: Optional[str] = None,
                                min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR with the segmented batch engine
    sharded over ``pair`` — the multi-emitter variant of
    :func:`sharded_batched_stein_peak` (config 4/5's lattice semantics
    through the segmented engine on the mesh).

    Pure data parallelism (each device runs the coarse stage + per-entry
    exact re-score on its pair block; zero collectives).  Returns
    ``(freqs (B, P), lags (B, P), values (B, P)[, snr_db])``, lags
    CIRCULAR like the single-peak engine.  ``min_snr_db`` thresholds
    against the per-pair model floor (:func:`caf_cookoff_tpu.models.
    batched_stein._stein_model_floor`).  See the batched_stein
    module-level same-bin exactness contract.
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _pow2_block_len,
        _rescore_guards,
        _stein_model_floor,
    )
    from caf_cookoff_tpu.models.overlap_save import detection_rows
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.shape != needles.shape:
        raise ValueError(
            f"need matching (B, N) batches, got {needles.shape} vs "
            f"{haystacks.shape}")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    d = _pow2_block_len(sample_rate, freqs, block_len)
    n = ns_re.shape[-1]
    auto = resolve_exclusions(needles[0], freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    # Circular path: pass the period m, not n (see batched_stein_peaks).
    guard, rescore_win = _rescore_guards(n, auto[1], xcor_length(n))
    pk = _sharded_batched_stein_peaks_jit(
        ns_re, ns_im, hs_re, hs_im, freqs, float(sample_rate), mesh,
        xcor_length(n), d, backend, int(num_peaks), exclude_freq,
        exclude_lag, guard, rescore_win)
    if min_snr_db is None and not with_snr:
        return (freqs[np.asarray(pk.freq_idx)], np.asarray(pk.lag_idx),
                np.asarray(pk.value))
    return detection_rows(freqs, pk, _stein_model_floor(needles, haystacks),
                          len(freqs) * xcor_length(n), min_snr_db,
                          with_snr)


# ---------------------------------------------------------------------------
# Time-sharded overlap-save engine (long haystacks over the mesh)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags", "backend"))
def _os_sharded_peak_jit(n_re, n_im, h_re, h_im, freqs_padded, sample_rate,
                         mesh, needle_len, chunk, total_lags, backend):
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1

    def body(n_re, n_im, h_re, h_im, freqs_loc):
        # Halo first, consumed only by the boundary blocks inside the
        # deferred-halo scan — the ppermute overlaps interior compute.
        h_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                       for p in (h_re, h_im))
        s_conj = needle_spectra_conj((n_re, n_im), freqs_loc, sample_rate,
                                     m, backend)
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        local = streaming_peak_deferred_halo(
            s_conj, (h_re, h_im), h_halo, needle_len, chunk, offset,
            total_lags, backend)
        local = CafPeak(
            local.value,
            local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
            local.lag_idx)
        return global_peak(local, (AXIS_DOPPLER, AXIS_TIME))

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(AXIS_DOPPLER)),
        out_specs=CafPeak(P(), P(), P()),
    )(n_re, n_im, h_re, h_im, freqs_padded)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags", "backend",
                     "num_peaks", "exclude_freq", "exclude_lag", "num_bins",
                     "with_floor"))
def _os_sharded_peaks_jit(n_re, n_im, h_re, h_im, freqs_padded, sample_rate,
                          mesh, needle_len, chunk, total_lags, backend,
                          num_peaks, exclude_freq, exclude_lag, num_bins,
                          with_floor=False):
    """Time/doppler-sharded multi-emitter lattice (top-``num_peaks``).

    Same halo-exchange layout as :func:`_os_sharded_peak_jit`; each
    shard's scan carries a local NMS lattice and the lattices meet in
    an ``all_gather`` + deterministic merge
    (:func:`caf_cookoff_tpu.parallel.collectives.global_peaks`), so an
    emitter straddling a time-shard boundary — seen by both neighbors
    via the halo — collapses to one entry.  Grid-padded doppler rows
    (``global row >= num_bins``) are masked before the local NMS — a
    pad duplicate farther than ``exclude_freq`` bins from the last real
    row would otherwise survive the merge and double-report.

    ``with_floor``: each shard's scan also accumulates its (sum, count)
    of valid mag^2 cells (pad rows and out-of-range lags excluded by
    the same masks), and the two scalars ``psum`` over
    ``(doppler, time)`` — the global noise-floor statistic costs two
    scalar collectives.  Returns ``(lattice, floor_sum, floor_count)``.
    """
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1

    def body(n_re, n_im, h_re, h_im, freqs_loc):
        h_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                       for p in (h_re, h_im))
        s_conj = needle_spectra_conj((n_re, n_im), freqs_loc, sample_rate,
                                     m, backend)
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        rows_global = (jax.lax.axis_index(AXIS_DOPPLER) * k_loc
                       + jnp.arange(k_loc, dtype=jnp.int32))
        out = streaming_peak_deferred_halo(
            s_conj, (h_re, h_im), h_halo, needle_len, chunk, offset,
            total_lags, backend, num_peaks=num_peaks,
            exclude_freq=exclude_freq, exclude_lag=exclude_lag,
            valid_rows=rows_global < num_bins, with_floor=with_floor)
        local = out[0] if with_floor else out
        if num_peaks == 1:
            local = as_lattice(local)
        local = CafPeak(
            local.value,
            local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
            local.lag_idx)
        lat = global_peaks(local, (AXIS_DOPPLER, AXIS_TIME), num_peaks,
                           exclude_freq, exclude_lag)
        if with_floor:
            fsum = jax.lax.psum(out[1], (AXIS_DOPPLER, AXIS_TIME))
            fcnt = jax.lax.psum(out[2], (AXIS_DOPPLER, AXIS_TIME))
            return lat, fsum, fcnt
        return lat

    # check_vma=False: the lattice reduction ends in all_gather + a
    # deterministic merge every shard computes identically, so the
    # output IS replicated — but vma cannot infer that (all_gather
    # outputs stay 'varying' and no varying->invariant pcast exists).
    out_specs = (CafPeak(P(), P(), P()), P(), P()) if with_floor \
        else CafPeak(P(), P(), P())
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(AXIS_DOPPLER)),
        out_specs=out_specs,
        check_vma=False,
    )(n_re, n_im, h_re, h_im, freqs_padded)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags", "backend"))
def _batched_os_peak_jit(ns_re, ns_im, hs_re, hs_im, freqs_padded,
                         sample_rate, mesh, needle_len, chunk, total_lags,
                         backend):
    """Pair x doppler x time sharded long-capture search (config 5).

    All three parallel axes at once: pairs are data-parallel over
    ``pair``, each pair's lag axis is chunked over ``time`` with
    ppermute halos, doppler bins shard over ``doppler``, and the peak
    triples reduce over (doppler, time) leaving per-pair results."""
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1

    def body(ns_re, ns_im, hs_re, hs_im, freqs_loc):
        # ns: (B_loc, N); hs: (B_loc, chunk) — halo from the right time
        # neighbor is exchanged for the whole local pair block at once,
        # and consumed only by each pair's boundary blocks (deferred
        # halo: the ppermute overlaps the interior scans).
        hs_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                        for p in (hs_re, hs_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk

        def one(nr, ni, hr, hi, qr, qi):
            s_conj = needle_spectra_conj((nr, ni), freqs_loc, sample_rate,
                                         m, backend)
            local = streaming_peak_deferred_halo(
                s_conj, (hr, hi), (qr, qi), needle_len, chunk, offset,
                total_lags, backend)
            return CafPeak(
                local.value,
                local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
                local.lag_idx)

        local = jax.vmap(one)(ns_re, ns_im, hs_re, hs_im, *hs_halo)
        return global_peak(local, (AXIS_DOPPLER, AXIS_TIME))

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR),
                  P(AXIS_PAIR, AXIS_TIME), P(AXIS_PAIR, AXIS_TIME),
                  P(AXIS_DOPPLER)),
        out_specs=CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR)),
    )(ns_re, ns_im, hs_re, hs_im, freqs_padded)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags", "backend",
                     "num_peaks", "exclude_freq", "exclude_lag", "num_bins",
                     "with_floor"))
def _batched_os_peaks_jit(ns_re, ns_im, hs_re, hs_im, freqs_padded,
                          sample_rate, mesh, needle_len, chunk, total_lags,
                          backend, num_peaks, exclude_freq, exclude_lag,
                          num_bins, with_floor=False):
    """Per-pair top-``num_peaks`` lattices through the THREE-axis
    engine (config 5's pattern): pairs data-parallel, lags chunked with
    ppermute halos, doppler sharded; per-pair lattices fold over
    ``(doppler, time)`` via :func:`global_peaks_batched`.  Grid-padded
    doppler rows mask out before the local NMS (see
    :func:`_os_sharded_peaks_jit`).

    ``with_floor``: per-pair (sum, count) floor accumulators ``psum``
    over ``(doppler, time)`` — each pair keeps its OWN measured noise
    floor (pairs are independent captures), sharded over ``pair`` like
    the lattices.  Returns ``(lattice, floor_sum (B,), count (B,))``.
    """
    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1

    def body(ns_re, ns_im, hs_re, hs_im, freqs_loc):
        hs_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                        for p in (hs_re, hs_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        rows_global = (jax.lax.axis_index(AXIS_DOPPLER) * k_loc
                       + jnp.arange(k_loc, dtype=jnp.int32))

        def one(nr, ni, hr, hi, qr, qi):
            s_conj = needle_spectra_conj((nr, ni), freqs_loc, sample_rate,
                                         m, backend)
            out = streaming_peak_deferred_halo(
                s_conj, (hr, hi), (qr, qi), needle_len, chunk, offset,
                total_lags, backend, num_peaks=num_peaks,
                exclude_freq=exclude_freq, exclude_lag=exclude_lag,
                valid_rows=rows_global < num_bins, with_floor=with_floor)
            local = out[0] if with_floor else out
            if num_peaks == 1:
                local = as_lattice(local)
            local = CafPeak(
                local.value,
                local.freq_idx + jax.lax.axis_index(AXIS_DOPPLER) * k_loc,
                local.lag_idx)
            return (local, out[1], out[2]) if with_floor else local

        out = jax.vmap(one)(ns_re, ns_im, hs_re, hs_im, *hs_halo)
        # fields (B_loc, P)
        local = out[0] if with_floor else out
        lat = global_peaks_batched(local, (AXIS_DOPPLER, AXIS_TIME),
                                   num_peaks, exclude_freq, exclude_lag)
        if with_floor:
            fsum = jax.lax.psum(out[1], (AXIS_DOPPLER, AXIS_TIME))
            fcnt = jax.lax.psum(out[2], (AXIS_DOPPLER, AXIS_TIME))
            return lat, fsum, fcnt
        return lat

    # check_vma=False: all_gather + identical deterministic merges =
    # replicated by construction (see _os_sharded_peaks_jit).
    lat_spec = CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR))
    out_specs = (lat_spec, P(AXIS_PAIR), P(AXIS_PAIR)) if with_floor \
        else lat_spec
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR),
                  P(AXIS_PAIR, AXIS_TIME), P(AXIS_PAIR, AXIS_TIME),
                  P(AXIS_DOPPLER)),
        out_specs=out_specs,
        check_vma=False,
    )(ns_re, ns_im, hs_re, hs_im, freqs_padded)


def batched_overlap_save_peaks(needles, haystacks, freqs_hz, sample_rate,
                               mesh: Mesh, num_peaks: int,
                               num_lags: Optional[int] = None, *,
                               exclude_freq: Optional[int] = None,
                               exclude_lag: Optional[int] = None,
                               backend: Optional[str] = None,
                               min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR on the three-axis mesh.

    The multi-emitter variant of :func:`batched_overlap_save_peak`
    (BASELINE config 5 is "streaming multi-emitter" at pod scale):
    returns ``(freqs (B, P), lags (B, P), values (B, P)[, snr (B, P)])``,
    strongest first per pair, empty slots ``-inf``.  Exclusion windows
    default to the first needle's resolution cell (pass explicit values
    for heterogeneous batches).  ``min_snr_db`` / ``with_snr`` apply
    the detection threshold against each pair's own measured floor,
    ``psum``-reduced over ``(doppler, time)``
    (see :func:`caf_cookoff_tpu.models.overlap_save.overlap_save_peaks`).
    """
    from caf_cookoff_tpu.models.overlap_save import (
        detection_rows,
        mean_floor,
    )
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.ndim != 2 \
            or needles.shape[0] != haystacks.shape[0]:
        raise ValueError(
            f"need (B, N) needles and (B, L) haystacks, got "
            f"{needles.shape} vs {haystacks.shape}")
    n = needles.shape[-1]
    if haystacks.shape[-1] < n:
        raise ValueError("haystacks shorter than needles")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    total_lags = num_lags or haystacks.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(haystacks.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    width = t_shards * chunk
    hay_p = np.pad(haystacks,
                   ((0, 0), (0, width - haystacks.shape[-1]))) \
        if width > haystacks.shape[-1] else haystacks[:, :width]
    freqs_np = as_grid(freqs_hz, dtype=np.float32)
    exclude_freq, exclude_lag = resolve_exclusions(
        needles[0], freqs_np, sample_rate, exclude_freq, exclude_lag)
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(hay_p)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=ns_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    want_floor = with_snr or min_snr_db is not None
    out = _batched_os_peaks_jit(ns_re, ns_im, hs_re, hs_im, freqs_p,
                                float(sample_rate), mesh, n, chunk,
                                total_lags, backend, int(num_peaks),
                                int(exclude_freq), int(exclude_lag),
                                len(freqs_np), with_floor=want_floor)
    if not want_floor:
        pk = out
        return (freqs_p[np.asarray(pk.freq_idx)], np.asarray(pk.lag_idx),
                np.asarray(pk.value))
    pk, fsum, fcnt = out
    return detection_rows(freqs_p, pk, mean_floor(fsum, fcnt),
                          total_lags * len(freqs_np), min_snr_db,
                          with_snr)


def batched_overlap_save_peak(needles, haystacks, freqs_hz, sample_rate,
                              mesh: Mesh,
                              num_lags: Optional[int] = None, *,
                              backend: Optional[str] = None):
    """Per-pair (freqs (B,), lags (B,), values (B,)) for long captures
    sharded over ALL THREE mesh axes — BASELINE config 5's pattern
    (256 pairs x 4096 bins x 262144 lags over N hosts).

    See :func:`estimate_hbm_per_chip` for the per-chip memory model.
    """
    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.ndim != 2 \
            or needles.shape[0] != haystacks.shape[0]:
        raise ValueError(
            f"need (B, N) needles and (B, L) haystacks, got "
            f"{needles.shape} vs {haystacks.shape}")
    n = needles.shape[-1]
    if haystacks.shape[-1] < n:
        raise ValueError("haystacks shorter than needles")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    total_lags = num_lags or haystacks.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(haystacks.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    width = t_shards * chunk
    hay_p = np.pad(haystacks,
                   ((0, 0), (0, width - haystacks.shape[-1]))) \
        if width > haystacks.shape[-1] else haystacks[:, :width]
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(hay_p)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=ns_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    peak = _batched_os_peak_jit(ns_re, ns_im, hs_re, hs_im, freqs_p,
                                float(sample_rate), mesh, n, chunk,
                                total_lags, backend)
    return (freqs_p[np.asarray(peak.freq_idx)], np.asarray(peak.lag_idx),
            np.asarray(peak.value))


def estimate_hbm_per_chip(num_pairs: int, num_bins: int, needle_len: int,
                          total_lags: int, *, pair: int = 1,
                          doppler: int = 1, time: int = 1,
                          bytes_per_real: int = 4) -> dict:
    """Per-chip HBM bytes for the batched overlap-save engine.

    Model (split-complex => 2 real planes everywhere):

    * haystack shard:   (B/pair) x chunk            x 2 planes
    * needle replicas:  (B/pair) x N                x 2
    * shifted needle spectra (the dominant term):
                        (B/pair) x (K/doppler) x M  x 2
    * per-block scratch: (K/doppler) x M x 2 (streamed, x2 for ping-pong)

    where M = xcor_length(N) and chunk ~= (total_lags + N)/time.  Used
    to check a config fits before launching (BASELINE config 5:
    256 pairs x 4096 bins x 262144 lags).

    ``docs/hbm_validate.py`` compares the model with XLA's buffer
    assignment for the compiled engine on the GPU (not measured yet).
    The model is meant as an UPPER bound: treat ``total_gb`` as
    "guaranteed to fit if this fits", not as a prediction of live
    bytes.
    """
    from caf_cookoff_tpu.config import xcor_length

    m = xcor_length(needle_len)
    b_loc = -(-num_pairs // pair)
    k_loc = -(-num_bins // doppler)
    chunk = max(-(-(total_lags + needle_len - 1) // time), needle_len - 1)
    hay = b_loc * chunk * 2 * bytes_per_real
    needles = b_loc * needle_len * 2 * bytes_per_real
    spectra = b_loc * k_loc * m * 2 * bytes_per_real
    scratch = 2 * k_loc * m * 2 * bytes_per_real
    total = hay + needles + spectra + scratch
    return {
        "haystack_shard_mb": round(hay / 2**20, 1),
        "needle_mb": round(needles / 2**20, 1),
        "needle_spectra_mb": round(spectra / 2**20, 1),
        "block_scratch_mb": round(scratch / 2**20, 1),
        "total_gb": round(total / 2**30, 3),
    }


def sharded_overlap_save_peak(needle, haystack, freqs_hz, sample_rate,
                              mesh: Mesh,
                              num_lags: Optional[int] = None, *,
                              backend: Optional[str] = None
                              ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value) for a long haystack sharded over ``time``.

    Each chip owns a contiguous lag chunk, fetches its ``N-1``-sample
    halo from the right neighbor via ``ppermute`` (zeros past the edge),
    streams its overlap-save blocks locally, and the peak triples reduce
    over ``(doppler, time)`` — BASELINE configs 3–5's compute pattern.
    """
    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] < n:
        raise ValueError("haystack shorter than needle")
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    # Size chunks from the SAMPLE count the lags need, not the lag count:
    # lag ``l`` reads samples ``[l, l+n-1]``, so lag ``total_lags-1`` needs
    # samples through ``total_lags+n-2``.  Sizing from ``total_lags`` alone
    # would truncate up to ``n-2`` tail samples and zero out tail lags.
    # Each chunk must also be at least the halo length so the ppermute
    # neighbor exchange (chunk[:N-1]) is well-defined.
    needed = min(haystack.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    hay_p = np.pad(haystack, (0, t_shards * chunk - haystack.shape[-1])) \
        if t_shards * chunk > haystack.shape[-1] \
        else haystack[: t_shards * chunk]
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(hay_p)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=n_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    peak = _os_sharded_peak_jit(n_re, n_im, h_re, h_im, freqs_p,
                                float(sample_rate), mesh, n, chunk,
                                total_lags, backend)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


def sharded_overlap_save_peaks(needle, haystack, freqs_hz, sample_rate,
                               mesh: Mesh, num_peaks: int,
                               num_lags: Optional[int] = None, *,
                               exclude_freq: Optional[int] = None,
                               exclude_lag: Optional[int] = None,
                               backend: Optional[str] = None,
                               min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters of a time-sharded long capture.

    The multi-emitter variant of :func:`sharded_overlap_save_peak`:
    each chip's overlap-save scan carries an NMS lattice over its lag
    chunk, lattices reduce over ``(doppler, time)`` via all_gather +
    deterministic merge, and emitters straddling shard boundaries
    (reachable through the ppermute halo) deduplicate.  Exclusion
    windows default to the waveform's resolution cell.
    ``min_snr_db`` / ``with_snr`` apply the detection threshold against
    the global measured floor (two scalar ``psum``s over the mesh — see
    :func:`caf_cookoff_tpu.models.overlap_save.overlap_save_peaks`).
    Returns ``(freqs (P,), lags (P,), values (P,)[, snr_db (P,)])``;
    empty slots ``-inf``.
    """
    from caf_cookoff_tpu.models.overlap_save import (
        detection_rows,
        mean_floor,
    )
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] < n:
        raise ValueError("haystack shorter than needle")
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(haystack.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    hay_p = np.pad(haystack, (0, t_shards * chunk - haystack.shape[-1])) \
        if t_shards * chunk > haystack.shape[-1] \
        else haystack[: t_shards * chunk]
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(hay_p)
    freqs_np = as_grid(freqs_hz, dtype=n_re.dtype)
    exclude_freq, exclude_lag = resolve_exclusions(
        needle, freqs_np, sample_rate, exclude_freq, exclude_lag)
    freqs_p = pad_axis_to(freqs_np, mesh.shape[AXIS_DOPPLER])
    want_floor = with_snr or min_snr_db is not None
    out = _os_sharded_peaks_jit(n_re, n_im, h_re, h_im, freqs_p,
                                float(sample_rate), mesh, n, chunk,
                                total_lags, backend, int(num_peaks),
                                exclude_freq, exclude_lag, len(freqs_np),
                                with_floor=want_floor)
    if not want_floor:
        pk = out
        return (freqs_p[np.asarray(pk.freq_idx)], np.asarray(pk.lag_idx),
                np.asarray(pk.value))
    pk, fsum, fcnt = out
    return detection_rows(freqs_p, pk, mean_floor(fsum, fcnt),
                          total_lags * len(freqs_np), min_snr_db,
                          with_snr)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "windows", "total_lags", "needle_len", "num_bins",
                     "num_peaks", "exclude_freq", "exclude_lag",
                     "guard", "rescore_win", "banded"))
def _sharded_batched_stein_os_peaks_jit(ns_re, ns_im, hs_re, hs_im,
                                        freqs_pad, centers, rel,
                                        sample_rate, mesh, xcor_len,
                                        block_len, backend,
                                        windows: int, total_lags: int,
                                        needle_len: int, num_bins: int,
                                        num_peaks: int,
                                        exclude_freq: int,
                                        exclude_lag: int, guard: int,
                                        rescore_win: int, banded: bool):
    """Config 5's multi-emitter composition through the segmented
    engine: per-pair top-``num_peaks`` lattices through the windowed
    engine
    (plain or banded), pairs sharded over the ``pair`` mesh axis —
    pure data parallelism, zero collectives."""
    from caf_cookoff_tpu.models.batched_stein import (
        _banded_stein_os_peaks_jit,
        _batched_stein_os_peaks_jit,
    )

    def body(ns_re, ns_im, hs_re, hs_im):
        if banded:
            return _banded_stein_os_peaks_jit.__wrapped__(
                ns_re, ns_im, hs_re, hs_im, freqs_pad, centers, rel,
                sample_rate, xcor_len, block_len, backend, windows,
                total_lags, needle_len, num_bins, num_peaks,
                exclude_freq, exclude_lag, guard, rescore_win)
        # (num_bins unused here — plain grids have no pad rows.)
        return _batched_stein_os_peaks_jit.__wrapped__(
            ns_re, ns_im, hs_re, hs_im, freqs_pad, sample_rate,
            xcor_len, block_len, backend, windows, total_lags,
            needle_len, num_peaks, exclude_freq, exclude_lag, guard,
            rescore_win)

    # check_vma=False for the same reason as _sharded_batched_stein_jit.
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR),
                  P(AXIS_PAIR)),
        out_specs=CafPeak(P(AXIS_PAIR), P(AXIS_PAIR), P(AXIS_PAIR)),
        check_vma=False,
    )(ns_re, ns_im, hs_re, hs_im)


def sharded_batched_stein_os_peaks(needles, haystacks, freqs_hz,
                                   sample_rate, mesh: Mesh,
                                   num_peaks: int,
                                   num_lags: Optional[int] = None, *,
                                   block_len: int = 64,
                                   exclude_freq: Optional[int] = None,
                                   exclude_lag: Optional[int] = None,
                                   backend: Optional[str] = None,
                                   min_snr_db=None,
                                   with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR of long captures, segmented
    engine, pairs sharded over the mesh — BASELINE config 5's
    "streaming multi-emitter at pod scale" workload without the XLA
    lattice fallback (the round-4 gap this round closes).

    Same results/contract as :func:`caf_cookoff_tpu.models.
    batched_stein.batched_stein_os_peaks` (plain AND banded routing,
    same-bin exactness contract, per-pair model-floor detection);
    returns ``(freqs (B, P), lags (B, P), values (B, P)[, snr_db])``.
    Zero collectives: scaling is bounded only by batch divisibility.
    """
    from caf_cookoff_tpu.errors import EligibilityError, SpanError
    from caf_cookoff_tpu.models.batched_stein import (
        _pow2_block_len,
        _rescore_guards,
        _stein_model_floor,
    )
    from caf_cookoff_tpu.models.overlap_save import detection_rows
    from caf_cookoff_tpu.models.stein import _band_routing
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.ndim != 2 \
            or needles.shape[0] != haystacks.shape[0]:
        raise ValueError(
            f"need (B, N) needles and (B, L) haystacks, got "
            f"{needles.shape} vs {haystacks.shape}")
    n = needles.shape[-1]
    if haystacks.shape[-1] <= n:
        raise ValueError(
            "use sharded_batched_stein_peaks for equal-length pairs")
    pair_shards = mesh.shape[AXIS_PAIR]
    if needles.shape[0] % pair_shards:
        raise ValueError(
            f"batch {needles.shape[0]} not divisible by pair axis "
            f"{pair_shards}")
    ns_re, ns_im = _split_host(needles)
    hs_re, hs_im = _split_host(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        d = None
    use_banded, d, freqs_pad, centers, rel = _band_routing(
        sample_rate, freqs, d)
    if d is None:
        raise EligibilityError(
            "grid neither fits the single-band envelope nor bands "
            "cleanly; use batched_overlap_save_peaks (XLA lattice)")
    m = xcor_length(n)
    total_lags = num_lags or haystacks.shape[-1] - n + 1
    windows = -(-total_lags // m)
    auto = resolve_exclusions(needles[0], freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto[1], haystacks.shape[-1])
    pk = _sharded_batched_stein_os_peaks_jit(
        ns_re, ns_im, hs_re, hs_im, freqs_pad, np.asarray(centers),
        np.asarray(rel), float(sample_rate), mesh, m, d, backend,
        windows, total_lags, n, len(freqs), int(num_peaks),
        exclude_freq, exclude_lag, guard, rescore_win, use_banded)
    if min_snr_db is None and not with_snr:
        return (freqs_pad[np.asarray(pk.freq_idx)],
                np.asarray(pk.lag_idx), np.asarray(pk.value))
    return detection_rows(freqs_pad, pk,
                          _stein_model_floor(needles, haystacks),
                          len(freqs) * total_lags, min_snr_db, with_snr)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "windows_local", "total_lags", "needle_len",
                     "num_bins"))
def _sharded_stein_os_jit(n_re, n_im, h_re, h_im, freqs_pad, centers,
                          rel, sample_rate, mesh, xcor_len, block_len,
                          backend, windows_local: int, total_lags: int,
                          needle_len: int, num_bins: int):
    """Windowed fused OS engine with the WINDOW axis over ``time``.

    Each shard runs its ``windows_local`` consecutive overlap-save
    windows as coarse-stage programs against the replicated capture
    (windows are independent given their guard-extended slices, so the
    only collective is one (T, K) all_gather of per-bin coarse
    (rowmax, rowlag) — gather order equals global window order, so the
    per-bin earliest-window tie-break, and with it every answer, is
    BIT-IDENTICAL to the single-chip engine).  The exact top-k
    re-score then runs replicated on every shard.  Banded-general:
    plain grids pass ``centers=[0]``, ``rel=freqs``.
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _needle_operator,
        _os_topk_refine,
        _shift_to_centers,
        stein_synthesis_weights,
        windowed_coarse_rank,
    )

    n = needle_len
    v = xcor_len
    s = centers.shape[0]
    kb = rel.shape[0]
    k_pad = freqs_pad.shape[0]
    t_windows = mesh.shape[AXIS_TIME] * windows_local

    def body(n_re, n_im, h_re, h_im):
        t_idx = jax.lax.axis_index(AXIS_TIME)
        w0 = t_idx * windows_local
        sr, si = _shift_to_centers(n_re[None], n_im[None], centers,
                                   sample_rate)
        b = sr.shape[-1] // block_len
        lmat, group = _needle_operator(sr, si, block_len)
        ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b,
                                           block_len)
        # Every shard's capture is padded for the LAST global window, so
        # no window slice starts out of range (dynamic_slice would clamp
        # it and silently shift that shard's lags).
        vals, idxs = windowed_coarse_rank(
            ws1, ws2, lmat, h_re[None], h_im[None], b, group, v,
            windows_local, total_lags, first_window=w0,
            global_windows=t_windows, share_h=s)
        vals = vals.reshape(kb, s, windows_local)
        glob = (idxs.reshape(kb, s, windows_local)
                + ((w0 + jnp.arange(windows_local)) * v)[None, None, :])
        vals = jnp.where((glob < total_lags) & (vals >= 0), vals, -1.0)
        wbest = jnp.argmax(vals, axis=-1)
        take_w = lambda a: jnp.take_along_axis(
            a, wbest[..., None], axis=-1)[..., 0]
        rowmax_loc = take_w(vals).T.reshape(k_pad)   # band-major bins
        rowlag_loc = take_w(glob).T.reshape(k_pad)
        rowmax_all = jax.lax.all_gather(rowmax_loc, AXIS_TIME)  # (T, K)
        rowlag_all = jax.lax.all_gather(rowlag_loc, AXIS_TIME)
        # Per-bin best shard, earliest (= earliest window) on ties —
        # the flat single-chip argmax reproduced exactly.
        tbest = jnp.argmax(rowmax_all, axis=0)
        rowmax = jnp.take_along_axis(rowmax_all, tbest[None], axis=0)[0]
        rowlag = jnp.take_along_axis(rowlag_all, tbest[None], axis=0)[0]
        rowmax = jnp.where(rowmax < 0, -jnp.inf, rowmax)
        rowmax = jnp.where(jnp.arange(k_pad) < num_bins, rowmax,
                           -jnp.inf)
        pk = _os_topk_refine(
            n_re[None], n_im[None], h_re[None], h_im[None], freqs_pad,
            rowmax[None], rowlag[None], sample_rate, v, backend,
            total_lags, n, num_valid_bins=num_bins)
        return CafPeak(pk.value[0], pk.freq_idx[0], pk.lag_idx[0])

    # check_vma=False: the
    # all_gather + identical replicated reduction/refine is replicated
    # by construction (see _os_sharded_peaks_jit).
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=CafPeak(P(), P(), P()),
        check_vma=False,
    )(n_re, n_im, h_re, h_im)


def sharded_stein_os_peak(needle, haystack, freqs_hz, sample_rate,
                          mesh: Mesh, num_lags: Optional[int] = None, *,
                          block_len: int = 64,
                          backend: Optional[str] = None
                          ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value): the segmented windowed long-capture engine
    (``models/batched_stein.batched_stein_os_peak``) with its window
    axis sharded over ``time`` — the fastest config-3 engine on the
    mesh.

    Windows are embarrassingly parallel given the replicated capture
    (each reads its own guard-extended slice), so the only collective
    is a (T, K)-float gather of coarse per-bin maxima; answers are
    bit-identical to the single-chip engine across mesh shapes (pinned
    in tests).  Uniform wide grids route banded exactly like the
    single-chip engine.
    """
    from caf_cookoff_tpu.models.batched_stein import _pow2_block_len
    from caf_cookoff_tpu.models.stein import _band_routing
    from caf_cookoff_tpu.errors import EligibilityError

    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] <= n:
        raise ValueError("haystack must be longer than the needle")
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    from caf_cookoff_tpu.errors import SpanError

    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        d = None
    _, d, freqs_pad, centers, rel = _band_routing(sample_rate, freqs, d)
    if d is None:
        raise EligibilityError(
            "grid neither fits the single-band envelope nor bands "
            "cleanly; use sharded_overlap_save_peak for it")
    m = xcor_length(n)
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    windows = -(-total_lags // m)
    windows_local = -(-windows // t_shards)
    peak = _sharded_stein_os_jit(
        n_re, n_im, h_re, h_im, freqs_pad, np.asarray(centers),
        np.asarray(rel), float(sample_rate), mesh, m, d, backend,
        windows_local, total_lags, n, len(freqs))
    return (float(freqs_pad[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "windows_local", "total_lags", "needle_len",
                     "num_bins", "num_peaks", "exclude_freq",
                     "exclude_lag", "guard", "rescore_win"))
def _sharded_stein_os_peaks_jit(n_re, n_im, h_re, h_im, freqs_pad,
                                centers, rel, sample_rate, mesh,
                                xcor_len, block_len, backend,
                                windows_local: int, total_lags: int,
                                needle_len: int, num_bins: int,
                                num_peaks: int, exclude_freq: int,
                                exclude_lag: int, guard: int,
                                rescore_win: int):
    """Fused multi-emitter lattice with the WINDOW axis over ``time``.

    Each shard runs its windows through the kernel's top-2 epilogue and
    folds a local lattice; shard lattices meet in
    :func:`caf_cookoff_tpu.parallel.collectives.global_peaks`, and the
    per-bin candidate SLOTS are all_gather'ed window-major (K x W*2
    floats+ints — tiny) so every shard re-scores the global lattice
    identically against the replicated capture.  Results replicate,
    and match the single-chip :func:`caf_cookoff_tpu.models.
    batched_stein.batched_stein_os_peaks` on (freq, lag) with values
    to f32 reassociation tolerance.
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _lattice_from_bin_candidates,
        _needle_operator,
        _rescore_entries_windowed,
        _shift_to_centers,
        stein_synthesis_weights,
        windowed_coarse_rank,
    )
    from caf_cookoff_tpu.ops.peak import merge_peaks

    n = needle_len
    v = xcor_len
    s = centers.shape[0]
    kb = rel.shape[0]
    k_pad = freqs_pad.shape[0]
    t_windows = mesh.shape[AXIS_TIME] * windows_local

    def body(n_re, n_im, h_re, h_im):
        t_idx = jax.lax.axis_index(AXIS_TIME)
        w0 = t_idx * windows_local
        sr, si = _shift_to_centers(n_re[None], n_im[None], centers,
                                   sample_rate)
        b = sr.shape[-1] // block_len
        lmat, group = _needle_operator(sr, si, block_len)
        ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b,
                                           block_len)
        # Padded for the LAST global window (see _sharded_stein_os_jit).
        v1, i1, v2, i2 = windowed_coarse_rank(
            ws1, ws2, lmat, h_re[None], h_im[None], b, group, v,
            windows_local, total_lags, first_window=w0,
            global_windows=t_windows, share_h=s, want_top2=True,
            sep=exclude_lag)
        woff_g = (w0 + jnp.arange(windows_local, dtype=jnp.int32)) * v
        vals_j = jnp.stack([v1, v2], axis=-1).reshape(
            kb, s, windows_local, 2)
        lags_j = (jnp.stack([i1, i2], axis=-1).reshape(
            kb, s, windows_local, 2)
            + woff_g[None, None, :, None])
        vals_j = jnp.where(lags_j < total_lags, vals_j, -1.0)
        # Local lattice over this shard's (band, window) programs.
        vr = vals_j.transpose(1, 2, 0, 3)        # (S, W_loc, Kb, 2)
        lr = lags_j.transpose(1, 2, 0, 3)
        wl = jax.vmap(lambda vs, ls, off: jax.vmap(
            lambda vj, lj: _lattice_from_bin_candidates(
                vj, lj, num_peaks, exclude_freq, exclude_lag,
                bin_offset=off, num_bins=num_bins))(vs, ls),
        )(vr, lr, jnp.arange(s, dtype=jnp.int32) * kb)
        flat = CafPeak(*(f.reshape(-1) for f in wl))
        local = merge_peaks(flat, num_peaks, exclude_freq, exclude_lag)
        lat = global_peaks(local, AXIS_TIME, num_peaks, exclude_freq,
                           exclude_lag)
        # Candidate slots, gathered window-major so every shard holds
        # the full (K, W*2) set for the replicated re-score.
        vflat_loc = vals_j.transpose(1, 0, 2, 3).reshape(s * kb, -1)
        lflat_loc = lags_j.transpose(1, 0, 2, 3).reshape(s * kb, -1)
        vflat = jnp.moveaxis(
            jax.lax.all_gather(vflat_loc, AXIS_TIME), 0, 1
        ).reshape(k_pad, -1)
        lflat = jnp.moveaxis(
            jax.lax.all_gather(lflat_loc, AXIS_TIME), 0, 1
        ).reshape(k_pad, -1)
        rows = jnp.arange(k_pad)
        vflat = jnp.where(rows[:, None] < num_bins, vflat, -1.0)
        vals_e, bins_e, lags_e = _rescore_entries_windowed(
            (n_re, n_im), (h_re, h_im), freqs_pad, vflat, lflat, lat,
            sample_rate, v, n, total_lags, guard, rescore_win,
            exclude_lag, exclude_freq, backend)
        return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                           exclude_freq, exclude_lag)

    # check_vma=False: gather-then-identical-merge
    # replication (see _os_sharded_peaks_jit).
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=CafPeak(P(), P(), P()),
        check_vma=False,
    )(n_re, n_im, h_re, h_im)


def sharded_stein_os_peaks(needle, haystack, freqs_hz, sample_rate,
                           mesh: Mesh, num_peaks: int,
                           num_lags: Optional[int] = None, *,
                           block_len: int = 64,
                           exclude_freq: Optional[int] = None,
                           exclude_lag: Optional[int] = None,
                           backend: Optional[str] = None,
                           min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters of one long capture, segmented windowed
    engine, windows sharded over ``time`` — the multi-emitter variant
    of :func:`sharded_stein_os_peak` (one (T, ...) coarse gather, the
    re-score replicated).  Returns ``(freqs (P,), lags (P,),
    values (P,)[, snr_db])``; detection against the model floor like
    every fused lattice path.
    """
    from caf_cookoff_tpu.errors import EligibilityError, SpanError
    from caf_cookoff_tpu.models.batched_stein import (
        _pow2_block_len,
        _rescore_guards,
        _stein_model_floor,
    )
    from caf_cookoff_tpu.models.overlap_save import detection_rows
    from caf_cookoff_tpu.models.stein import _band_routing
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] <= n:
        raise ValueError("haystack must be longer than the needle")
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        d = None
    _, d, freqs_pad, centers, rel = _band_routing(sample_rate, freqs, d)
    if d is None:
        raise EligibilityError(
            "grid neither fits the single-band envelope nor bands "
            "cleanly; use sharded_overlap_save_peaks for it")
    m = xcor_length(n)
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    windows = -(-total_lags // m)
    windows_local = -(-windows // t_shards)
    auto = resolve_exclusions(needle, freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto[1], haystack.shape[-1])
    pk = _sharded_stein_os_peaks_jit(
        n_re, n_im, h_re, h_im, freqs_pad, np.asarray(centers),
        np.asarray(rel), float(sample_rate), mesh, m, d, backend,
        windows_local, total_lags, n, len(freqs), int(num_peaks),
        exclude_freq, exclude_lag, guard, rescore_win)
    if min_snr_db is None and not with_snr:
        return (freqs_pad[np.asarray(pk.freq_idx)],
                np.asarray(pk.lag_idx), np.asarray(pk.value))
    return detection_rows(
        freqs_pad, pk,
        float(_stein_model_floor(needle[None], haystack[None])[0]),
        len(freqs) * total_lags, min_snr_db, with_snr)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "xcor_len", "block_len", "backend",
                     "windows_local", "total_lags", "needle_len",
                     "num_bins", "rate_chunk", "guard"))
def _sharded_stein_rate_os_jit(n_re, n_im, h_re, h_im, freqs_pad,
                               centers, rel, rates, sample_rate, mesh,
                               xcor_len, block_len, backend,
                               windows_local: int, total_lags: int,
                               needle_len: int, num_bins: int,
                               rate_chunk: int, guard: int):
    """SEGMENTED rate search with the window axis over ``time``.

    Each shard runs its overlap-save windows through the coarse stage
    with (rate × relative-bin) synthesis rows (stage A shared by every
    trial rate — the round-5 de-serialization) against the replicated
    capture; per-(rate, bin) coarse maxima gather over ``time`` in
    window order (exact flat argmax reproduction) and the pre-chirped
    exact re-score runs replicated.  The fastest rate engine, on the
    mesh.
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _needle_operator,
        _shift_to_centers,
        stein_rate_synthesis_weights,
        windowed_coarse_rank,
    )
    from caf_cookoff_tpu.models.rate import _rate_coarse_closer

    n = needle_len
    v = xcor_len
    s = centers.shape[0]
    kb = rel.shape[0]
    k_pad = freqs_pad.shape[0]
    num_rates = rates.shape[0]
    t_windows = mesh.shape[AXIS_TIME] * windows_local

    def body(n_re, n_im, h_re, h_im):
        t_idx = jax.lax.axis_index(AXIS_TIME)
        w0 = t_idx * windows_local
        sr, si = _shift_to_centers(n_re[None], n_im[None], centers,
                                   sample_rate)
        b = sr.shape[-1] // block_len
        lmat, group = _needle_operator(sr, si, block_len)
        woff_g = (w0 + jnp.arange(windows_local, dtype=jnp.int32)) * v
        rowmax_parts, rowlag_parts = [], []
        for c0 in range(0, num_rates, rate_chunk):
            rc = min(rate_chunk, num_rates - c0)
            ws1, ws2 = stein_rate_synthesis_weights(
                rel, rates[c0:c0 + rc], sample_rate, b, block_len)
            # Padded for the LAST global window (see
            # _sharded_stein_os_jit).
            vals, idxs = windowed_coarse_rank(
                ws1, ws2, lmat, h_re[None], h_im[None], b, group, v,
                windows_local, total_lags, first_window=w0,
                global_windows=t_windows, share_h=s)
            vals = vals.reshape(rc, kb, s, windows_local)
            glob = (idxs.reshape(rc, kb, s, windows_local)
                    + woff_g[None, None, None, :])
            vals = jnp.where((glob < total_lags) & (vals >= 0), vals,
                             -jnp.inf)
            wbest = jnp.argmax(vals, axis=-1)
            take_w = lambda a: jnp.take_along_axis(
                a, wbest[..., None], axis=-1)[..., 0]
            rowmax_parts.append(
                take_w(vals).transpose(0, 2, 1).reshape(rc, k_pad))
            rowlag_parts.append(
                take_w(glob).transpose(0, 2, 1).reshape(rc, k_pad))
        rowmax_loc = jnp.concatenate(rowmax_parts)   # (R, K_pad)
        rowlag_loc = jnp.concatenate(rowlag_parts)
        rowmax_all = jax.lax.all_gather(rowmax_loc, AXIS_TIME)
        rowlag_all = jax.lax.all_gather(rowlag_loc, AXIS_TIME)
        tbest = jnp.argmax(rowmax_all, axis=0)       # earliest window
        rowmax = jnp.take_along_axis(rowmax_all, tbest[None],
                                     axis=0)[0]
        rowlag = jnp.take_along_axis(rowlag_all, tbest[None],
                                     axis=0)[0]
        return _rate_coarse_closer(
            (n_re, n_im), (h_re, h_im), freqs_pad, rates, rowmax,
            rowlag, sample_rate, v, n, total_lags, guard, num_bins,
            backend)

    # check_vma=False: gather-then-identical-closer
    # replication (see _os_sharded_peaks_jit).
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(n_re, n_im, h_re, h_im)


def sharded_stein_rate_os_peak(needle, haystack, freqs_hz,
                               rates_hz_per_s, sample_rate, mesh: Mesh,
                               num_lags: Optional[int] = None, *,
                               block_len: int = 64,
                               backend: Optional[str] = None
                               ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag, value): the SEGMENTED rate search
    (:func:`caf_cookoff_tpu.models.rate.stein_rate_os_peak` — trial
    rates as synthesis rows, 56× the serial scan at the config-3
    shape) with its window axis sharded over ``time``.

    One (T, R, K)-float gather in window order keeps answers identical
    to the single-chip segmented engine across mesh shapes; the serial
    dechirp-bank mesh engine (:func:`sharded_rate_overlap_save_peak`)
    remains for grids/rates outside the segmented envelope.
    """
    from caf_cookoff_tpu.models.rate import _rate_routing

    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] < n:
        raise ValueError("haystack shorter than needle")
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    d, freqs_pad, centers, rel, rate_chunk, guard = _rate_routing(
        sample_rate, freqs, rates, n, block_len, haystack.shape[-1])
    total_lags = num_lags or haystack.shape[-1] - n + 1
    m = xcor_length(n)
    t_shards = mesh.shape[AXIS_TIME]
    windows = -(-total_lags // m)
    windows_local = -(-windows // t_shards)
    r_idx, value, f_idx, lag = _sharded_stein_rate_os_jit(
        n_re, n_im, h_re, h_im, np.asarray(freqs_pad),
        np.asarray(centers), np.asarray(rel), jnp.asarray(rates),
        float(sample_rate), mesh, m, d, backend, windows_local,
        total_lags, n, len(freqs), rate_chunk, guard)
    return (float(rates[int(r_idx)]), float(freqs_pad[int(f_idx)]),
            int(lag), float(value))


# ---------------------------------------------------------------------------
# Time/doppler-sharded RATE engine (second-order search over the mesh)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags",
                     "backend"))
def _rate_os_sharded_peak_jit(n_re, n_im, h_re, h_im, freqs_padded, rates,
                              sample_rate, mesh, needle_len, chunk,
                              total_lags, backend):
    """Dechirp bank x time/doppler-sharded overlap-save argmax.

    Per shard: ``lax.scan`` over its LOCAL trial rates — the rate axis
    shards over ``pair`` (round 5: rates are embarrassingly parallel
    and the single-pair engine left that axis idle; the host pads the
    grid by repeating the last rate, whose duplicate loses every
    min-rate-idx tie-break) — each pre-chirping the (replicated)
    needle, building the local doppler shard's spectra bank, and
    running the deferred-halo block scan; the per-shard
    (rate, value, freq, lag) best reduces over
    ``(pair, doppler, time)`` via :func:`caf_cookoff_tpu.parallel.
    collectives.global_rate_peak`.  One halo ``ppermute`` serves ALL
    trial rates (the haystack does not depend on the rate), so the
    collective cost matches the first-order engine's.
    """
    from caf_cookoff_tpu.parallel.collectives import global_rate_peak

    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    r_loc = rates.shape[0] // mesh.shape[AXIS_PAIR]
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1
    dtype = n_re.dtype

    def body(n_re, n_im, h_re, h_im, freqs_loc, rates_loc):
        h_halo = tuple(_right_halo(p, halo, AXIS_TIME)
                       for p in (h_re, h_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        r_base = jax.lax.axis_index(AXIS_PAIR) * r_loc
        fs = jnp.asarray(sample_rate, dtype)
        t = jnp.arange(needle_len, dtype=dtype) / fs

        def step(best, xr):
            r_idx, r = xr
            r_idx = r_base + r_idx
            ph = jnp.pi * r * (t * t)
            c, s = jnp.cos(ph), jnp.sin(ph)
            nb = (n_re * c - n_im * s, n_re * s + n_im * c)
            s_conj = needle_spectra_conj(nb, freqs_loc, sample_rate, m,
                                         backend)
            pk = streaming_peak_deferred_halo(
                s_conj, (h_re, h_im), h_halo, needle_len, chunk, offset,
                total_lags, backend)
            b_ridx, b_val, b_f, b_lag = best
            take = pk.value > b_val   # strict: earlier rate wins ties
            return ((jnp.where(take, r_idx, b_ridx),
                     jnp.where(take, pk.value, b_val),
                     jnp.where(take, pk.freq_idx, b_f),
                     jnp.where(take, pk.lag_idx, b_lag)), None)

        # Init derived from the traced operands so the scan carry
        # inherits their varying-manual-axes under shard_map.
        zero = (jnp.sum(n_re[..., :1]) * 0 + jnp.sum(h_re[..., :1]) * 0
                + jnp.sum(freqs_loc[..., :1]) * 0
                + jnp.sum(rates_loc[..., :1]) * 0)
        init = (zero.astype(jnp.int32), zero - jnp.inf,
                zero.astype(jnp.int32), zero.astype(jnp.int32))
        (r_b, v_b, f_b, l_b), _ = jax.lax.scan(
            step, init,
            (jnp.arange(rates_loc.shape[0], dtype=jnp.int32), rates_loc))
        f_g = f_b + jax.lax.axis_index(AXIS_DOPPLER) * k_loc
        return global_rate_peak(v_b, r_b, f_g, l_b,
                                (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME))

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(AXIS_DOPPLER),
                  P(AXIS_PAIR)),
        out_specs=(P(), P(), P(), P()),
    )(n_re, n_im, h_re, h_im, freqs_padded, rates)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "needle_len", "chunk", "total_lags",
                     "backend", "num_peaks", "exclude_freq", "exclude_lag",
                     "num_bins", "half_t_bins", "num_real_rates",
                     "with_floor"))
def _rate_os_sharded_peaks_jit(n_re, n_im, h_re, h_im, freqs_padded,
                               rates, sample_rate, mesh, needle_len,
                               chunk, total_lags, backend, num_peaks,
                               exclude_freq, exclude_lag, num_bins,
                               half_t_bins, num_real_rates,
                               with_floor=False):
    """Sharded multi-emitter RATE lattice (top-``num_peaks``).

    Each shard's rate scan carries the cross-rate-merged lattice of
    :func:`caf_cookoff_tpu.models.rate._rate_os_peaks_jit` (candidates
    keyed by window-CENTER frequency, rate-aware NMS window) over its
    (doppler shard x lag chunk); shard lattices meet in
    :func:`caf_cookoff_tpu.parallel.collectives.global_rate_peaks`
    (value gather + one packed 4-field int block + the same
    deterministic merge, replicated by construction).  ``half_t_bins``
    is the host-derived center-key factor ``T / (2*df)`` — static so
    every shard agrees on it regardless of which grid rows (including
    pad duplicates) it owns.  Grid-padded doppler rows mask before the
    local NMS exactly like the first-order lattice bodies.  The rate
    axis shards over ``pair`` (see :func:`_rate_os_sharded_peak_jit`);
    pad-duplicated rates produce identical candidates the rate-aware
    NMS dedups, and their floor cells are masked so the global floor
    counts each real cell exactly once (``num_rates`` is the REAL
    count).
    """
    from caf_cookoff_tpu.models.rate import _merge_rate_lattice
    from caf_cookoff_tpu.parallel.collectives import global_rate_peaks

    k_loc = freqs_padded.shape[0] // mesh.shape[AXIS_DOPPLER]
    r_loc = rates.shape[0] // mesh.shape[AXIS_PAIR]
    num_rates = int(num_real_rates)
    m, _, _ = plan_blocks(needle_len, chunk)
    halo = needle_len - 1
    dtype = n_re.dtype
    p = num_peaks
    htb = jnp.asarray(half_t_bins, dtype)

    def body(n_re, n_im, h_re, h_im, freqs_loc, rates_loc, rates_full):
        h_halo = tuple(_right_halo(q, halo, AXIS_TIME)
                       for q in (h_re, h_im))
        offset = jax.lax.axis_index(AXIS_TIME) * chunk
        r_base = jax.lax.axis_index(AXIS_PAIR) * r_loc
        rows_global = (jax.lax.axis_index(AXIS_DOPPLER) * k_loc
                       + jnp.arange(k_loc, dtype=jnp.int32))
        fs = jnp.asarray(sample_rate, dtype)
        t = jnp.arange(needle_len, dtype=dtype) / fs

        def step(carry, xr):
            lat, fsum, fcnt = carry
            vals, keys, lags_c, ridx_c, fws_c, rvl_c = lat
            r_idx, r = xr
            r_idx = r_base + r_idx
            real = r_idx < num_rates
            ph = jnp.pi * r * (t * t)
            c, s = jnp.cos(ph), jnp.sin(ph)
            nb = (n_re * c - n_im * s, n_re * s + n_im * c)
            s_conj = needle_spectra_conj(nb, freqs_loc, sample_rate, m,
                                         backend)
            out = streaming_peak_deferred_halo(
                s_conj, (h_re, h_im), h_halo, needle_len, chunk, offset,
                total_lags, backend, num_peaks=p,
                exclude_freq=exclude_freq, exclude_lag=exclude_lag,
                valid_rows=rows_global < num_bins,
                with_floor=with_floor)
            if with_floor:
                pk, fsum_b, fcnt_b = out
                # Pad-duplicated rates must not double-count cells.
                fsum = fsum + jnp.where(real, fsum_b, 0.0)
                fcnt = fcnt + jnp.where(real, fcnt_b, 0.0)
            else:
                pk = out
            if p == 1:
                pk = as_lattice(pk)
            f_g = (pk.freq_idx
                   + jax.lax.axis_index(AXIS_DOPPLER) * k_loc)
            off = jnp.round(r * htb).astype(jnp.int32)
            merged = _merge_rate_lattice(
                jnp.concatenate([vals, pk.value]),
                jnp.concatenate([keys, f_g + off]),
                jnp.concatenate([lags_c, pk.lag_idx]),
                jnp.concatenate([ridx_c,
                                 jnp.full((p,), r_idx, jnp.int32)]),
                jnp.concatenate([fws_c, f_g]),
                jnp.concatenate([rvl_c, jnp.full((p,), r, dtype)]),
                p, exclude_freq, exclude_lag, htb)
            return (merged, fsum, fcnt), None

        zero = (jnp.sum(n_re[..., :1]) * 0 + jnp.sum(h_re[..., :1]) * 0
                + jnp.sum(freqs_loc[..., :1]) * 0
                + jnp.sum(rates_loc[..., :1]) * 0)
        zeros_p = jnp.zeros((p,), dtype) + zero
        init_lat = (zeros_p - jnp.inf, zeros_p.astype(jnp.int32),
                    zeros_p.astype(jnp.int32), zeros_p.astype(jnp.int32),
                    zeros_p.astype(jnp.int32), zeros_p)
        (lat, fsum, fcnt), _ = jax.lax.scan(
            step, (init_lat, zero, zero),
            (jnp.arange(rates_loc.shape[0], dtype=jnp.int32), rates_loc))
        vals, keys, lags_c, ridx_c, fws_c, _ = lat
        out = global_rate_peaks(vals, keys, lags_c, ridx_c, fws_c,
                                rates_full,
                                (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME), p,
                                exclude_freq, exclude_lag, htb)
        g_vals, g_keys, g_lags, g_ridx, g_fws, _ = out
        if with_floor:
            fsum = jax.lax.psum(fsum,
                                (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME))
            fcnt = jax.lax.psum(fcnt,
                                (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME))
            return (g_vals, g_lags, g_ridx, g_fws), fsum, fcnt
        return (g_vals, g_lags, g_ridx, g_fws)

    # check_vma=False: all_gather + identical deterministic merges =
    # replicated by construction (see _os_sharded_peaks_jit).
    lat_spec = (P(), P(), P(), P())
    out_specs = (lat_spec, P(), P()) if with_floor else lat_spec
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(AXIS_TIME), P(AXIS_TIME), P(AXIS_DOPPLER),
                  P(AXIS_PAIR), P()),
        out_specs=out_specs,
        check_vma=False,
    )(n_re, n_im, h_re, h_im, freqs_padded, rates, rates)


def sharded_rate_overlap_save_peak(needle, haystack, freqs_hz,
                                   rates_hz_per_s, sample_rate,
                                   mesh: Mesh,
                                   num_lags: Optional[int] = None, *,
                                   backend: Optional[str] = None
                                   ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag, value): the joint (rate, doppler,
    lag) search of :func:`caf_cookoff_tpu.models.rate.
    rate_overlap_save_peak` sharded over ``(doppler, time)``.

    Doppler bins shard like the first-order engine; every trial rate
    reuses the one halo exchange.  The reference has no rate model, no
    long-capture search, and no multi-chip execution at all — this is
    all three composed.
    """
    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] < n:
        raise ValueError("haystack shorter than needle")
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(haystack.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    hay_p = np.pad(haystack, (0, t_shards * chunk - haystack.shape[-1])) \
        if t_shards * chunk > haystack.shape[-1] \
        else haystack[: t_shards * chunk]
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(hay_p)
    freqs_p = pad_axis_to(as_grid(freqs_hz, dtype=n_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    # Rates shard over the (otherwise idle) pair axis; pad duplicates
    # of the LAST rate lose every min-rate-idx tie-break, so results
    # are invariant to the padding.
    rates_p = pad_axis_to(rates, mesh.shape[AXIS_PAIR])
    val, r_idx, f_idx, lag = _rate_os_sharded_peak_jit(
        n_re, n_im, h_re, h_im, freqs_p, jnp.asarray(rates_p),
        float(sample_rate), mesh, n, chunk, total_lags, backend)
    return (float(rates_p[int(r_idx)]), float(freqs_p[int(f_idx)]),
            int(lag), float(val))


def sharded_rate_overlap_save_peaks(needle, haystack, freqs_hz,
                                    rates_hz_per_s, sample_rate,
                                    mesh: Mesh, num_peaks: int,
                                    num_lags: Optional[int] = None, *,
                                    exclude_freq: Optional[int] = None,
                                    exclude_lag: Optional[int] = None,
                                    backend: Optional[str] = None,
                                    min_snr_db=None,
                                    with_snr: bool = False):
    """Top-``num_peaks`` accelerating emitters of a time/doppler-sharded
    long capture — the mesh variant of :func:`caf_cookoff_tpu.models.
    rate.rate_overlap_save_peaks` with the same semantics (window-
    center-keyed cross-rate merge, rate-aware NMS window, detection
    threshold over ``R*K*num_lags`` cells against the ``psum``-reduced
    global floor).  Returns ``(rates (P,), freqs (P,), lags (P,),
    values (P,)[, snr_db (P,)])``.

    Exactness contract: the argmax and emitters at DISTINCT lags match
    the single-chip engine bit-for-bit across mesh shapes (pinned in
    ``tests/test_parallel.py``).  Slots below that can differ from the
    single-chip lattice at same-lag sidelobe level: hierarchical NMS
    lets a shard-local candidate (e.g. a strong emitter's rate ghost
    whose center key falls in a different doppler shard than the
    emitter) suppress a same-lag neighbor before the global merge kills
    the ghost itself.  Ghosts share their parent's lag, so only
    candidates at the strong emitter's OWN lag cell — its sidelobes,
    or a weaker emitter overlapping it in both lag and center
    frequency — are exposed; emitters separated in lag by more than
    ``exclude_lag`` are never affected.
    """
    from caf_cookoff_tpu.models.overlap_save import mean_floor
    from caf_cookoff_tpu.models.rate import _rate_grid_half_t_bins
    from caf_cookoff_tpu.ops.peak import (
        apply_detection_threshold,
        resolve_exclusions,
    )

    backend = backend or default_backend()
    needle = np.asarray(needle)
    haystack = np.asarray(haystack)
    n = needle.shape[-1]
    if haystack.shape[-1] < n:
        raise ValueError("haystack shorter than needle")
    total_lags = num_lags or haystack.shape[-1] - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(haystack.shape[-1], total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    hay_p = np.pad(haystack, (0, t_shards * chunk - haystack.shape[-1])) \
        if t_shards * chunk > haystack.shape[-1] \
        else haystack[: t_shards * chunk]
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(hay_p)
    freqs_np = as_grid(freqs_hz, dtype=n_re.dtype)
    exclude_freq, exclude_lag = resolve_exclusions(
        needle, freqs_np, sample_rate, exclude_freq, exclude_lag)
    freqs_p = pad_axis_to(freqs_np, mesh.shape[AXIS_DOPPLER])
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    rates_p = pad_axis_to(rates, mesh.shape[AXIS_PAIR])
    htb = _rate_grid_half_t_bins(freqs_np, n, sample_rate)
    want_floor = with_snr or min_snr_db is not None
    out = _rate_os_sharded_peaks_jit(
        n_re, n_im, h_re, h_im, freqs_p, jnp.asarray(rates_p),
        float(sample_rate), mesh, n, chunk, total_lags, backend,
        int(num_peaks), exclude_freq, exclude_lag, len(freqs_np), htb,
        len(rates), with_floor=want_floor)
    lat = out[0] if want_floor else out
    vals, lags, ridx, fws = (np.asarray(x) for x in lat)
    out_rates = rates_p.astype(np.float64)[ridx]
    out_freqs = np.asarray(freqs_p, np.float64)[fws]
    if not want_floor:
        return out_rates, out_freqs, lags, vals
    floor = mean_floor(out[1], out[2])
    num_cells = rates.shape[0] * len(freqs_np) * total_lags
    vals, snr, _ = apply_detection_threshold(vals, floor, num_cells,
                                             min_snr_db)
    res = (out_rates, out_freqs, lags, vals)
    return res + ((snr,) if with_snr else ())
