"""Overlap-save segmented correlation — long-haystack CAF.

The reference cannot search a capture longer than the needle: every impl
truncates the haystack to needle length (``caf_go/main.go:20``,
``caf_rust/tests/test.rs:327``, ``caf_python/caf.py:130``).  This engine
is the sequence-parallel analog the reference lacks (SURVEY §5
"long-context"): the haystack is cut into blocks of ``V`` lags with
``N-1``-sample forward halos, each block is a circular FFT correlation
against the doppler-shifted needle bank, and blocks are stitched into a
``(K, L-N+1)`` linear-correlation surface.

Block math: with FFT size ``M = next_pow2(2N)`` and ``V = M - N`` lags
per block, block ``b`` reads haystack samples ``[bV, bV + V + N - 1)``
(zero-padded at the tail), so circular lag ``i < V`` of the block equals
linear lag ``bV + i`` of the full correlation — no wrap contamination.

All device math is split-complex (re, im real pairs,
:mod:`caf_cookoff_tpu.ops.splitfft`); complex dtypes appear only at the
public API boundary.  The doppler-shifted needle
spectra are computed once and reused across all blocks (the hoisting the
reference misses even for its single haystack FFT, SURVEY §3.1).  The
peak path streams blocks through a ``lax.scan`` so the surface never
touches HBM; the time-sharded multi-chip variant lives in
``parallel/sharded.py`` and reuses :func:`streaming_peak` per shard
after a ``ppermute`` halo exchange.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import as_grid, default_backend, xcor_length
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import (
    CafPeak,
    apply_detection_threshold,
    as_lattice,
    concat_peaks,
    find_peak_2d,
    find_peaks,
    merge_peaks,
    resolve_exclusions,
)
from caf_cookoff_tpu.ops.splitfft import SplitComplex


def plan_blocks(needle_len: int, num_lags: int) -> Tuple[int, int, int]:
    """(fft_len M, lags_per_block V, num_blocks B) for a lag count."""
    m = xcor_length(needle_len)
    v = m - needle_len
    b = -(-num_lags // v)
    return m, v, b


def needle_spectra_conj(needle: SplitComplex, freqs_hz: jax.Array,
                        sample_rate, fft_len: int,
                        backend: str = "matmul") -> SplitComplex:
    """conj(FFT(padded shifted needle bank)) — split (K, M), computed once."""
    fft_fn, _ = splitfft.get_split_fft(backend)
    n_re, n_im = needle
    real_dtype = n_re.dtype
    rate = (2.0 * jnp.pi) * (freqs_hz.astype(real_dtype)
                             / jnp.asarray(sample_rate, real_dtype))
    phase = rate[:, None] * jnp.arange(n_re.shape[-1], dtype=real_dtype)
    cos, sin = jnp.cos(phase), jnp.sin(phase)
    shifted = splitfft.pad_split(
        (n_re[None, :] * cos - n_im[None, :] * sin,
         n_re[None, :] * sin + n_im[None, :] * cos), fft_len)
    s_re, s_im = fft_fn(shifted)
    return s_re, -s_im


def _block_rows(hay: SplitComplex, s_conj: SplitComplex, b: jax.Array,
                v: int, d: int, m: int, backend: str) -> jax.Array:
    """(K, V) mag^2 rows of block ``b``: local lags [b*V, b*V + V)."""
    fft_fn, ifft_fn = splitfft.get_split_fft(backend)
    blk = tuple(jax.lax.dynamic_slice(p, (b * v,), (d,)) for p in hay)
    spec = fft_fn(splitfft.pad_split(blk, m))
    sp_re = spec[0][None, :]
    sp_im = spec[1][None, :]
    # spec * s_conj (conjugation pre-folded into s_conj)
    rows = ifft_fn(splitfft.cmul((sp_re, sp_im), s_conj))
    return splitfft.mag2((rows[0][..., :v], rows[1][..., :v]))


def streaming_peak(s_conj: SplitComplex, haystack: SplitComplex,
                   needle_len: int, num_lags: int, lag_offset=0,
                   total_lags: Optional[int] = None,
                   backend: str = "matmul", num_peaks: int = 1,
                   exclude_freq: Optional[int] = None,
                   exclude_lag: Optional[int] = None,
                   valid_rows: Optional[jax.Array] = None,
                   with_floor: bool = False):
    """Scan-over-blocks peak of ``num_lags`` local lags (traceable core).

    ``lag_offset`` (may be traced, e.g. ``axis_index * chunk``) shifts
    local lags to global lag indices; lags at or beyond ``total_lags``
    (global) are masked out so zero-padded tails cannot win.  Returns a
    :class:`CafPeak` with the *global* lag index.

    ``valid_rows`` (optional ``(K,)`` bool, may be traced) masks whole
    doppler rows — a doppler-sharded caller whose grid was padded to
    the mesh axis passes ``global_row < num_bins`` so duplicated pad
    rows can neither win nor occupy lattice slots (a pad duplicate
    farther than ``exclude_freq`` from its original would otherwise
    double-report the same emitter).

    ``with_floor=True`` additionally accumulates the surface's noise
    floor through the scan — ``(sum, count)`` of every VALID mag^2
    cell, one fused reduction per block (the surface still never
    touches HBM) — and returns ``(peak, floor_sum, floor_count)``.
    Sharded callers ``psum`` the two scalars over their reduction axes
    before dividing; the mean is the exponential noise cells' scale
    parameter, which :func:`caf_cookoff_tpu.ops.peak.
    apply_detection_threshold` turns into detection decisions.

    ``num_peaks > 1`` carries a top-``num_peaks`` lattice through the
    scan instead of a single triple: each block contributes its NMS'd
    local peaks and :func:`merge_peaks` deduplicates against the
    running lattice — an emitter whose mainlobe straddles a block
    boundary (detected once per adjacent block) collapses to one entry,
    while distinct emitters anywhere in the capture all survive.  The
    result's fields are ``(num_peaks,)``, strongest first, empty slots
    ``-inf``.  Exclusion windows size the dedup cell — derive them with
    :func:`caf_cookoff_tpu.ops.peak.resolution_cell`.
    """
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    if num_peaks > 1 and (exclude_freq is None or exclude_lag is None):
        raise ValueError(
            "num_peaks > 1 needs explicit NMS exclusion windows — derive "
            "them from the waveform via ops.peak.resolve_exclusions "
            "(hardcoded defaults would be unrelated to your resolution "
            "cell)")
    d = v + needle_len - 1
    target = nblocks * v + needle_len - 1
    if haystack[0].shape[-1] >= target:
        # Samples beyond the last block's reach cannot affect the
        # requested lags — drop them instead of refusing.
        hay = tuple(p[..., :target] for p in haystack)
    else:
        hay = splitfft.pad_split(haystack, target)
    real_dtype = s_conj[0].dtype
    lattice = num_peaks > 1

    def step(carry, b):
        best, fsum, fcnt = carry
        mag2 = _block_rows(hay, s_conj, b, v, d, m, backend)
        local_ok = jax.lax.broadcasted_iota(jnp.int32, (1, v), 1) + b * v
        keep = local_ok < num_lags
        if total_lags is not None:
            # Global mask: only meaningful when the caller owns a shard
            # of a known-length lag axis (time-sharded overlap-save).
            tau_global = local_ok + lag_offset
            keep = keep & (tau_global < total_lags)
        if valid_rows is not None:
            keep = keep & valid_rows[:, None]
        if with_floor:
            # Floor accumulation from the raw (pre-sentinel) block rows:
            # (sum, count) over every VALID cell, fused into the block's
            # one pass over the rows.  f32 count: only ever a mean's
            # denominator, so the >16.7M rounding (~1e-7 relative) is
            # irrelevant against dB-scale thresholds.  f32 sum: one
            # rounding per block against the growing partial sum —
            # relative error O(num_blocks * eps) ~ 1e-4 even at a
            # million blocks, i.e. ~0.0004 dB on the floor, far under
            # any detection margin (f64 accumulation is unavailable
            # on-device with x64 disabled and not worth a host pass).
            keep_b = jnp.broadcast_to(keep, mag2.shape)
            fsum = fsum + jnp.sum(jnp.where(keep_b, mag2, 0.0))
            fcnt = fcnt + jnp.sum(keep_b.astype(real_dtype))
        if lattice:
            # Masked lags become -inf sentinels so they can neither win
            # a lattice slot nor suppress a real candidate.
            mag2 = jnp.where(keep, mag2, -jnp.inf)
            cand = find_peaks(mag2, num_peaks, exclude_freq, exclude_lag)
            cand = CafPeak(cand.value, cand.freq_idx, cand.lag_idx + b * v)
            merged = merge_peaks(concat_peaks(best, cand), num_peaks,
                                 exclude_freq, exclude_lag)
            return (merged, fsum, fcnt), None
        mag2 = jnp.where(keep, mag2, -1.0)
        cand = find_peak_2d(mag2)
        cand = CafPeak(cand.value, cand.freq_idx, cand.lag_idx + b * v)
        take = cand.value > best.value  # strict: earlier block wins ties
        merged = CafPeak(
            value=jnp.where(take, cand.value, best.value),
            freq_idx=jnp.where(take, cand.freq_idx, best.freq_idx),
            lag_idx=jnp.where(take, cand.lag_idx, best.lag_idx),
        )
        return (merged, fsum, fcnt), None

    # The scan carry must match the body output's varying-manual-axes
    # when traced inside shard_map; deriving the init from the traced
    # operands (value * 0) inherits the right VMA both in and out of
    # shard_map without naming mesh axes here.
    zero = (jnp.sum(s_conj[0][..., :1, :1]) * 0
            + jnp.sum(hay[0][..., :1]) * 0
            + jnp.asarray(lag_offset, real_dtype) * 0)
    if lattice:
        zeros_p = jnp.zeros(num_peaks, real_dtype) + zero
        init = CafPeak(value=zeros_p - jnp.inf,
                       freq_idx=zeros_p.astype(jnp.int32),
                       lag_idx=zeros_p.astype(jnp.int32))
    else:
        init = CafPeak(value=zero - jnp.inf,
                       freq_idx=zero.astype(jnp.int32),
                       lag_idx=zero.astype(jnp.int32))
    # int32 block ids: under x64 a default arange is int64 and
    # `cand.lag_idx + b * v` would widen the carry mid-scan (c128
    # parity mode runs this path under jax.enable_x64).
    (best, fsum, fcnt), _ = jax.lax.scan(
        step, (init, zero, zero), jnp.arange(nblocks, dtype=jnp.int32))
    peak = CafPeak(best.value, best.freq_idx,
                   best.lag_idx + jnp.asarray(lag_offset, jnp.int32))
    if with_floor:
        return peak, fsum, fcnt
    return peak


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend"))
def _os_surface_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate, num_lags,
                    needle_len, backend="matmul"):
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    d = v + needle_len - 1
    s_conj = needle_spectra_conj((n_re, n_im), freqs_hz, sample_rate, m,
                                 backend)
    hay = splitfft.pad_split((h_re, h_im), nblocks * v + needle_len - 1)

    def step(_, b):
        return None, _block_rows(hay, s_conj, b, v, d, m, backend)

    _, blocks = jax.lax.scan(step, None, jnp.arange(nblocks))  # (B, K, V)
    surf = jnp.moveaxis(blocks, 0, 1).reshape(freqs_hz.shape[0],
                                              nblocks * v)
    return surf[:, :num_lags]


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend",
                              "with_floor"))
def _os_peak_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate, num_lags,
                 needle_len, backend="matmul", with_floor=False):
    m, _, _ = plan_blocks(needle_len, num_lags)
    s_conj = needle_spectra_conj((n_re, n_im), freqs_hz, sample_rate, m,
                                 backend)
    return streaming_peak(s_conj, (h_re, h_im), needle_len, num_lags,
                          backend=backend, with_floor=with_floor)


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend",
                              "num_peaks", "exclude_freq", "exclude_lag",
                              "with_floor"))
def _os_peaks_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate, num_lags,
                  needle_len, backend, num_peaks, exclude_freq,
                  exclude_lag, with_floor=False):
    m, _, _ = plan_blocks(needle_len, num_lags)
    s_conj = needle_spectra_conj((n_re, n_im), freqs_hz, sample_rate, m,
                                 backend)
    out = streaming_peak(s_conj, (h_re, h_im), needle_len, num_lags,
                         backend=backend, num_peaks=num_peaks,
                         exclude_freq=exclude_freq,
                         exclude_lag=exclude_lag, with_floor=with_floor)
    if num_peaks > 1:
        return out
    # num_peaks=1 rides the scalar fast path (no NMS carry); lattice
    # callers are promised (num_peaks,)-shaped fields.
    if with_floor:
        pk, fsum, fcnt = out
        return as_lattice(pk), fsum, fcnt
    return as_lattice(out)


def _prep(needle, haystack, freqs_hz):
    needle = splitfft.split_array(needle)
    haystack = splitfft.split_array(haystack)
    if haystack[0].shape[-1] < needle[0].shape[-1]:
        raise ValueError(
            f"haystack ({haystack[0].shape[-1]}) shorter than needle "
            f"({needle[0].shape[-1]})")
    return needle, haystack, as_grid(freqs_hz, dtype=needle[0].dtype)


def overlap_save_surface(needle, haystack, freqs_hz, sample_rate,
                         num_lags: Optional[int] = None, *,
                         backend: Optional[str] = None) -> jax.Array:
    """(K, num_lags) linear-correlation CAF surface for a long haystack.

    ``num_lags`` defaults to the full-overlap range ``L - N + 1``.
    """
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep(needle, haystack, freqs_hz)
    n = n_re.shape[-1]
    lags = num_lags or h_re.shape[-1] - n + 1
    return _os_surface_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                           float(sample_rate), lags, n, backend)


def mean_floor(floor_sum, floor_count):
    """Mean mag^2 over all searched cells from the scan's accumulators
    (scalars, or per-pair arrays from the batched engines)."""
    return (np.asarray(floor_sum, np.float64)
            / np.maximum(np.asarray(floor_count, np.float64), 1.0))


def detection_rows(freqs_np, pk: CafPeak, floor, num_cells: int,
                   min_snr_db, with_snr: bool):
    """Shared lattice→detections epilogue of every multi-peak endpoint.

    Applies :func:`caf_cookoff_tpu.ops.peak.apply_detection_threshold`
    (slots below the SNR threshold mask to ``-inf``) and shapes the
    ``(freqs, lags, values[, snr_db])`` host output.  ``pk`` fields may
    be ``(P,)`` or batched ``(..., P)``.
    """
    vals, snr, _ = apply_detection_threshold(
        np.asarray(pk.value), floor, num_cells, min_snr_db)
    out = (np.asarray(freqs_np)[np.asarray(pk.freq_idx)],
           np.asarray(pk.lag_idx), vals)
    return out + ((snr,) if with_snr else ())


def overlap_save_peak(needle, haystack, freqs_hz, sample_rate,
                      num_lags: Optional[int] = None, *,
                      backend: Optional[str] = None,
                      with_snr: bool = False):
    """(freq_hz, lag, value) peak of the long-haystack CAF.

    Streams blocks through a ``lax.scan`` — the full surface never
    touches HBM, so arbitrarily long captures run in O(K*M) memory.
    ``with_snr=True`` appends the peak-to-floor ratio in dB (the floor
    is the mean mag^2 over every searched cell, accumulated inside the
    same scan): ``(freq_hz, lag, value, snr_db)``.
    """
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep(needle, haystack, freqs_hz)
    n = n_re.shape[-1]
    lags = num_lags or h_re.shape[-1] - n + 1
    out = _os_peak_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                       float(sample_rate), lags, n, backend,
                       with_floor=with_snr)
    if with_snr:
        peak, fsum, fcnt = out
        floor = mean_floor(fsum, fcnt)
        snr_db = (10.0 * float(np.log10(float(peak.value)
                                        / max(floor, 1e-300)))
                  if float(peak.value) > 0 else float("-inf"))
        return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
                float(peak.value), snr_db)
    peak = out
    return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend",
                              "num_peaks", "exclude_freq", "exclude_lag",
                              "with_floor"))
def _os_peaks_batch_jit(ns_re, ns_im, hs_re, hs_im, freqs_hz, sample_rate,
                        num_lags, needle_len, backend, num_peaks,
                        exclude_freq, exclude_lag, with_floor=False):
    """vmapped per-pair lattice scan: fields (B, num_peaks)."""
    return jax.vmap(
        lambda nr, ni, hr, hi: _os_peaks_jit.__wrapped__(
            nr, ni, hr, hi, freqs_hz, sample_rate, num_lags, needle_len,
            backend, num_peaks, exclude_freq, exclude_lag, with_floor)
    )(ns_re, ns_im, hs_re, hs_im)


def batched_overlap_save_peaks_local(needles, haystacks, freqs_hz,
                                     sample_rate, num_peaks: int,
                                     num_lags: Optional[int] = None, *,
                                     exclude_freq: Optional[int] = None,
                                     exclude_lag: Optional[int] = None,
                                     backend: Optional[str] = None,
                                     min_snr_db=None,
                                     with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR, single device (one vmapped
    lattice-scan program).

    ``(B, N)`` needles × ``(B, L)`` captures → ``(freqs (B, P),
    lags (B, P), values (B, P)[, snr_db (B, P)])``, strongest first per
    pair, empty slots ``-inf``.  ``min_snr_db`` / ``with_snr`` apply
    the per-pair detection threshold (each pair gets its own measured
    floor — see :func:`overlap_save_peaks`).  The mesh-sharded variant
    is :func:`caf_cookoff_tpu.parallel.sharded.
    batched_overlap_save_peaks`.
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
    lags = num_lags or haystacks.shape[-1] - n + 1
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    exclude_freq, exclude_lag = resolve_exclusions(
        needles[0], freqs, sample_rate, exclude_freq, exclude_lag)
    want_floor = with_snr or min_snr_db is not None
    out = _os_peaks_batch_jit(
        jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
        jnp.asarray(hs_im), jnp.asarray(freqs),
        float(sample_rate), lags, n, backend, int(num_peaks),
        exclude_freq, exclude_lag, with_floor=want_floor)
    if not want_floor:
        pk = out
        return (np.asarray(freqs)[np.asarray(pk.freq_idx)],
                np.asarray(pk.lag_idx), np.asarray(pk.value))
    pk, fsum, fcnt = out
    return detection_rows(freqs, pk, mean_floor(fsum, fcnt),
                          lags * freqs.shape[0], min_snr_db, with_snr)


def overlap_save_peaks(needle, haystack, freqs_hz, sample_rate,
                       num_peaks: int,
                       num_lags: Optional[int] = None, *,
                       exclude_freq: Optional[int] = None,
                       exclude_lag: Optional[int] = None,
                       backend: Optional[str] = None,
                       min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters of a long capture, strongest first.

    Multi-emitter extraction through the streaming scan (BASELINE
    config 4's "streaming multi-emitter"; the reference reports only a
    global argmax, ``caf_rust/src/caf/mod.rs:31-42``): the overlap-save
    block scan carries a top-``num_peaks`` NMS lattice, so the full
    surface never materializes and emitters whose mainlobes straddle
    block boundaries deduplicate.  Exclusion windows default to the
    waveform's resolution cell (:func:`ops.peak.resolution_cell`).

    Detection decisions: with ``min_snr_db`` (a float, or ``"auto"``
    for :func:`ops.peak.detection_threshold_db` at the searched cell
    count) slots whose peak-to-floor dB falls below the threshold mask
    to ``-inf`` — a lattice slot filled by a noise maximum stops
    masquerading as an emitter.  The floor is the mean mag^2 over every
    searched cell, accumulated inside the same scan (the surface still
    never materializes).  ``with_snr=True`` appends per-slot
    peak-to-floor dB.

    Returns ``(freqs_hz (P,), lags (P,), values (P,)[, snr_db (P,)])``
    numpy arrays; slots past the number of distinct detections carry
    ``value=-inf``.
    """
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep(needle, haystack, freqs_hz)
    n = n_re.shape[-1]
    lags = num_lags or h_re.shape[-1] - n + 1
    exclude_freq, exclude_lag = resolve_exclusions(
        needle, freqs, sample_rate, exclude_freq, exclude_lag)
    want_floor = with_snr or min_snr_db is not None
    out = _os_peaks_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                        float(sample_rate), lags, n, backend,
                        int(num_peaks), exclude_freq, exclude_lag,
                        with_floor=want_floor)
    if not want_floor:
        pk = out
        return (np.asarray(freqs)[np.asarray(pk.freq_idx)],
                np.asarray(pk.lag_idx), np.asarray(pk.value))
    pk, fsum, fcnt = out
    return detection_rows(freqs, pk, mean_floor(fsum, fcnt),
                          lags * freqs.shape[0], min_snr_db, with_snr)
