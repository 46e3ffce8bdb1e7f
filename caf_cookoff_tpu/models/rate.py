"""Second-order CAF: joint (rate, doppler, lag) search via a dechirp bank.

The reference's CAF model is strictly first-order — a constant
frequency offset (``caf_rust/src/caf/mod.rs:44-65``) — yet its own
generator synthesizes time-varying offsets by phase integration
(``utils/generate.py:10-20``).  An emitter with real doppler RATE
(accelerating platform) smears across the first-order surface: a sweep
of ``r`` Hz/s spreads the peak over ``r*T`` Hz of doppler bins and
suppresses it by ~``sinc``-like loss once ``r*T`` passes a bin.  The
refine-stage estimator (:func:`caf_cookoff_tpu.ops.refine.
refine_peak_rate`) recovers rates up to about one bin of drift; THIS
engine is the coarse search for everything beyond it.

Shape: the rate axis is a **dechirp bank** — pre-chirp the needle by
each candidate rate (one (R, N) phasor multiply, exact by shift
composition: a swept copy ``n[t]e^{j2pi f t + j pi r t^2}`` correlates
coherently with the ``r``-pre-chirped needle at offset ``f``) and run
the standard filterbank over the whole bank as one extra vmap axis.
One jitted program computes all R x K x M cells and reduces to the
(rate, freq, lag) argmax triple without materializing the volume —
the doppler fan-out trick, applied twice.

Rate grid sizing: the rate resolution cell is ``~2/T^2`` (quadratic
phase of pi*r*t^2 reaching ~pi at the window edge); pick steps <= 1/T^2
for a contiguous search, like doppler steps <= fs/N.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import as_grid, default_backend, xcor_length
from caf_cookoff_tpu.models.filterbank import _peak_split_jit
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import as_lattice, resolve_exclusions


@functools.partial(
    jax.jit, static_argnames=("xcor_len", "backend"))
def _rate_bank_peak_jit(n_re, n_im, h_re, h_im, freqs_hz, rates, sample_rate,
                        xcor_len, backend):
    dtype = n_re.dtype
    fs = jnp.asarray(sample_rate, dtype)
    t = jnp.arange(n_re.shape[-1], dtype=dtype) / fs
    # Pre-chirp bank: n_r[t] = n[t] * e^{+j pi r t^2}  (R, N)
    ph = jnp.pi * rates[:, None] * (t * t)[None, :]
    c, s = jnp.cos(ph), jnp.sin(ph)
    nb_re = n_re[None, :] * c - n_im[None, :] * s
    nb_im = n_re[None, :] * s + n_im[None, :] * c

    peaks = jax.vmap(
        lambda nr, ni: _peak_split_jit.__wrapped__(
            nr, ni, h_re, h_im, freqs_hz, sample_rate, xcor_len, backend)
    )(nb_re, nb_im)                               # fields (R,)
    r_best = jnp.argmax(peaks.value)
    return (r_best.astype(jnp.int32), peaks.value[r_best],
            peaks.freq_idx[r_best], peaks.lag_idx[r_best])


def rate_caf_peak(needle, haystack, freqs_hz, rates_hz_per_s, sample_rate,
                  *, backend: Optional[str] = None
                  ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_idx, value): dechirp-bank CAF peak.

    ``rates_hz_per_s`` is the candidate rate grid (include 0.0 to keep
    unswept emitters detectable); frequency is reported at the WINDOW
    START (t = 0) convention, like :func:`refine_peak_rate`.  Chain
    with ``refine_peak_rate`` (bracket = one rate step) for continuous
    estimates.  The haystack is a needle-length window (the raw lag is
    a CIRCULAR xcor index — unwrap with :func:`caf_cookoff_tpu.ops.
    peak.unwrap_lag` before treating it as a capture offset); for
    captures longer than the needle use :func:`rate_overlap_save_peak`.
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    r_idx, value, f_idx, lag_idx = _rate_bank_peak_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(h_re),
        jnp.asarray(h_im), jnp.asarray(freqs), jnp.asarray(rates),
        float(sample_rate), xcor_length(n_re.shape[-1]), backend)
    return (float(rates[int(r_idx)]), float(freqs[int(f_idx)]),
            int(lag_idx), float(value))


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend"))
def _rate_os_peak_jit(n_re, n_im, h_re, h_im, freqs_hz, rates, sample_rate,
                      num_lags, needle_len, backend):
    """Dechirp bank x overlap-save: scan over rates, each rate running
    the full block scan; memory stays O(K*M) — one pre-chirped needle
    spectrum bank live at a time, never (R, K, M)."""
    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )

    dtype = n_re.dtype
    m, _, _ = plan_blocks(needle_len, num_lags)
    fs = jnp.asarray(sample_rate, dtype)
    t = jnp.arange(needle_len, dtype=dtype) / fs

    def step(best, xr):
        r_idx, r = xr
        ph = jnp.pi * r * (t * t)
        c, s = jnp.cos(ph), jnp.sin(ph)
        nb = (n_re * c - n_im * s, n_re * s + n_im * c)
        s_conj = needle_spectra_conj(nb, freqs_hz, sample_rate, m,
                                     backend)
        pk = streaming_peak(s_conj, (h_re, h_im), needle_len, num_lags,
                            backend=backend)
        b_ridx, b_val, b_f, b_lag = best
        take = pk.value > b_val  # strict: earlier (lower) rate wins ties
        return ((jnp.where(take, r_idx, b_ridx),
                 jnp.where(take, pk.value, b_val),
                 jnp.where(take, pk.freq_idx, b_f),
                 jnp.where(take, pk.lag_idx, b_lag)), None)

    num_rates = rates.shape[0]
    init = (jnp.asarray(0, jnp.int32), jnp.asarray(-jnp.inf, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    best, _ = jax.lax.scan(
        step, init, (jnp.arange(num_rates, dtype=jnp.int32), rates))
    return best


def rate_overlap_save_peak(needle, haystack, freqs_hz, rates_hz_per_s,
                           sample_rate, num_lags: Optional[int] = None,
                           *, backend: Optional[str] = None
                           ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_samples, value): joint
    (rate, doppler, lag) search over a LONG capture.

    Composes the dechirp bank with the overlap-save block scan: each
    candidate rate pre-chirps the needle (one (N,) phasor multiply),
    its shifted-spectrum bank streams over every lag of the capture,
    and the (rate, freq, lag) argmax reduces through the scans without
    materializing anything — the search the reference's generator
    implies but no engine anywhere provides (it synthesizes
    time-varying offsets, ``utils/generate.py:10-20``, and then
    truncates every capture to needle length).

    Physics note: an emitter swept at ``r`` Hz/s over CAPTURE time that
    starts at absolute lag ``tau`` presents a window-start frequency of
    ``f0 + r*tau/fs`` — size the doppler grid to cover that range, not
    just ``f0`` (the returned frequency uses the same window-start
    convention as :func:`caf_cookoff_tpu.ops.refine.refine_peak_rate`,
    so chaining refinement needs no conversion).  The returned lag is
    an absolute capture offset (no circular wrap — overlap-save lags
    are linear).
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = n_re.shape[-1]
    if h_re.shape[-1] < n:
        raise ValueError(
            f"haystack ({h_re.shape[-1]}) shorter than needle ({n})")
    lags = num_lags or h_re.shape[-1] - n + 1
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    r_idx, value, f_idx, lag_idx = _rate_os_peak_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(h_re),
        jnp.asarray(h_im), jnp.asarray(freqs), jnp.asarray(rates),
        float(sample_rate), lags, n, backend)
    return (float(rates[int(r_idx)]), float(freqs[int(f_idx)]),
            int(lag_idx), float(value))


def _merge_rate_lattice(v, key, lag, ridx, fws, rvals, num_peaks,
                        exclude_freq, exclude_lag, half_t_bins):
    """Greedy NMS over (center-freq key, lag) with a RATE-AWARE window.

    Cross-rate physics: an emitter swept at true rate ``r`` appears at
    every trial dechirp rate ``r'`` with the SAME window-center
    frequency ``f0 + r*T/2`` (dechirping tilts the instantaneous-
    frequency slope but preserves the window mean), smeared over a
    residual-chirp ridge of half-extent ``|r - r'| * T / 2`` Hz around
    that center.  So candidates from different trial rates are merged
    in center-frequency space (``key``), and the suppression window
    between two candidates widens by their rate distance's ridge
    extent: a ridge SUB-peak of a mismatched rate may sit anywhere
    within its half-extent of the common center, and the matched-rate
    top entry's widened window covers exactly that span — a strong
    emitter's rate sidelobes cannot claim lattice slots and displace a
    weaker real emitter.  Same deterministic order and
    suppressed-cannot-suppress semantics as :func:`caf_cookoff_tpu.
    ops.peak.merge_peaks`; ``ridx``/``fws``/``rvals`` are per-candidate
    payloads (trial-rate index, window-start freq bin, physical rate)
    permuted alongside.
    """
    c = v.shape[0]
    order = jnp.lexsort((lag, key, -v)).astype(jnp.int32)
    v, key, lag = v[order], key[order], lag[order]
    ridx, fws, rvals = ridx[order], fws[order], rvals[order]
    valid = v > -jnp.inf
    ridge = jnp.ceil(jnp.abs(rvals[:, None] - rvals[None, :])
                     * half_t_bins).astype(jnp.int32)
    # Cross-rate pairs get one EXTRA exclusion cell beyond the ridge
    # half-extent: the ridge edge is convolved with the window's sinc,
    # so its skirt/first sidelobe peaks up to ~1.5 resolution cells
    # past the nominal extent (measured: a +1-step trial-rate ghost at
    # 0.5 bins past ridge+1 cell).  Same-rate pairs (ridge == 0) keep
    # the exact resolution cell so two same-rate emitters one cell
    # apart still resolve, matching the first-order lattice contract.
    margin = jnp.where(ridge > 0, exclude_freq, 0)
    close = ((jnp.abs(key[:, None] - key[None, :])
              <= exclude_freq + ridge + margin)
             & (jnp.abs(lag[:, None] - lag[None, :]) <= exclude_lag))
    pos = jnp.arange(c)

    def step(kept, i):
        suppressed = jnp.any(kept & close[:, i] & (pos < i))
        return kept.at[i].set(valid[i] & ~suppressed), None

    kept, _ = jax.lax.scan(step, v > jnp.inf, pos)
    sel = jnp.argsort(jnp.where(kept, pos, c))[:num_peaks]
    filled = jnp.arange(num_peaks) < jnp.sum(kept)
    return (jnp.where(filled, v[sel], -jnp.inf),
            jnp.where(filled, key[sel], 0).astype(jnp.int32),
            jnp.where(filled, lag[sel], 0).astype(jnp.int32),
            jnp.where(filled, ridx[sel], 0).astype(jnp.int32),
            jnp.where(filled, fws[sel], 0).astype(jnp.int32),
            jnp.where(filled, rvals[sel], 0.0))


def _rate_grid_half_t_bins(freqs_np, needle_len: int,
                           sample_rate) -> float:
    """Host-side center-key factor ``T / (2*df)`` (grid bins per unit
    rate): ``key = f_ws_bin + round(r * half_t_bins)``.  Host-derived
    and STATIC so the single-chip and mesh engines (where shards may
    own pad-duplicated grid rows with a degenerate local step) agree
    bit-for-bit on every key and ridge window."""
    freqs_np = np.asarray(freqs_np, np.float64).reshape(-1)
    t_win = needle_len / float(sample_rate)
    if freqs_np.shape[0] > 1:
        df = float(np.min(np.abs(np.diff(freqs_np))))
    else:
        df = float(sample_rate) / needle_len
    return t_win / (2.0 * max(df, 1e-30))


@functools.partial(
    jax.jit, static_argnames=("num_lags", "needle_len", "backend",
                              "num_peaks", "exclude_freq", "exclude_lag",
                              "half_t_bins", "with_floor"))
def _rate_os_peaks_jit(n_re, n_im, h_re, h_im, freqs_hz, rates,
                       sample_rate, num_lags, needle_len, backend,
                       num_peaks, exclude_freq, exclude_lag,
                       half_t_bins, with_floor=False):
    """Dechirp bank x overlap-save LATTICE: scan over rates, each rate
    carrying a top-``num_peaks`` NMS lattice through the block scan,
    cross-rate-merged in center-frequency space (memory stays O(K*M) +
    the (P,) lattice — never (R, K, M))."""
    from caf_cookoff_tpu.models.overlap_save import (
        needle_spectra_conj,
        plan_blocks,
        streaming_peak,
    )

    dtype = n_re.dtype
    m, _, _ = plan_blocks(needle_len, num_lags)
    fs = jnp.asarray(sample_rate, dtype)
    t = jnp.arange(needle_len, dtype=dtype) / fs
    half_t_bins = jnp.asarray(half_t_bins, dtype)
    p = num_peaks

    def step(carry, xr):
        lat, fsum, fcnt = carry
        vals, keys, lags_c, ridx_c, fws_c, rvl_c = lat
        r_idx, r = xr
        ph = jnp.pi * r * (t * t)
        c, s = jnp.cos(ph), jnp.sin(ph)
        nb = (n_re * c - n_im * s, n_re * s + n_im * c)
        s_conj = needle_spectra_conj(nb, freqs_hz, sample_rate, m,
                                     backend)
        out = streaming_peak(s_conj, (h_re, h_im), needle_len, num_lags,
                             backend=backend, num_peaks=p,
                             exclude_freq=exclude_freq,
                             exclude_lag=exclude_lag,
                             with_floor=with_floor)
        if with_floor:
            pk, fsum_b, fcnt_b = out
            fsum = fsum + fsum_b
            fcnt = fcnt + fcnt_b
        else:
            pk = out
        if p == 1:
            pk = as_lattice(pk)
        off = jnp.round(r * half_t_bins).astype(jnp.int32)
        merged = _merge_rate_lattice(
            jnp.concatenate([vals, pk.value]),
            jnp.concatenate([keys, pk.freq_idx + off]),
            jnp.concatenate([lags_c, pk.lag_idx]),
            jnp.concatenate([ridx_c, jnp.full((p,), r_idx, jnp.int32)]),
            jnp.concatenate([fws_c, pk.freq_idx]),
            jnp.concatenate([rvl_c, jnp.full((p,), r, dtype)]),
            p, exclude_freq, exclude_lag, half_t_bins)
        return (merged, fsum, fcnt), None

    zero = jnp.zeros((), dtype)
    init_lat = (jnp.full((p,), -jnp.inf, dtype),
                jnp.zeros((p,), jnp.int32), jnp.zeros((p,), jnp.int32),
                jnp.zeros((p,), jnp.int32), jnp.zeros((p,), jnp.int32),
                jnp.zeros((p,), dtype))
    num_rates = rates.shape[0]
    (lat, fsum, fcnt), _ = jax.lax.scan(
        step, (init_lat, zero, zero),
        (jnp.arange(num_rates, dtype=jnp.int32), rates))
    return lat, fsum, fcnt


def rate_overlap_save_peaks(needle, haystack, freqs_hz, rates_hz_per_s,
                            sample_rate, num_peaks: int,
                            num_lags: Optional[int] = None, *,
                            exclude_freq: Optional[int] = None,
                            exclude_lag: Optional[int] = None,
                            backend: Optional[str] = None,
                            min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` ACCELERATING emitters of a long capture —
    multi-emitter + detection through the joint (rate, doppler, lag)
    search.

    Each trial rate runs the lattice-carrying overlap-save scan
    (:func:`caf_cookoff_tpu.models.overlap_save.streaming_peak` with
    ``num_peaks``); lattices merge across rates in window-CENTER
    frequency space with a rate-aware suppression window (see
    :func:`_merge_rate_lattice` — a strong emitter's residual-chirp
    ridge at mismatched trial rates deduplicates against its
    matched-rate peak instead of displacing weaker real emitters).
    The reference cannot do any of this: no rate model, no
    multi-emitter notion, no detection decision (argmax only,
    ``caf_rust/src/caf/mod.rs:31-42``), and every impl truncates the
    capture to needle length (``caf_go/main.go:20``).

    ``min_snr_db`` / ``with_snr`` apply the detection threshold over
    the full searched cell count ``R*K*num_lags`` (the floor is the
    mean mag^2 over every cell of every trial-rate surface,
    accumulated inside the scans).  Returns ``(rates (P,), freqs (P,),
    lags (P,), values (P,)[, snr_db (P,)])`` numpy arrays, strongest
    first; empty/sub-threshold slots carry ``value=-inf``.  Reported
    frequencies use the window-start convention, lags are absolute
    capture offsets — chain each row through :func:`caf_cookoff_tpu.
    ops.refine.refine_peak_rate` for continuous estimates.
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = n_re.shape[-1]
    if h_re.shape[-1] < n:
        raise ValueError(
            f"haystack ({h_re.shape[-1]}) shorter than needle ({n})")
    lags = num_lags or h_re.shape[-1] - n + 1
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    exclude_freq, exclude_lag = resolve_exclusions(
        needle, freqs, sample_rate, exclude_freq, exclude_lag)
    want_floor = with_snr or min_snr_db is not None
    lat, fsum, fcnt = _rate_os_peaks_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(h_re),
        jnp.asarray(h_im), jnp.asarray(freqs), jnp.asarray(rates),
        float(sample_rate), lags, n, backend, int(num_peaks),
        exclude_freq, exclude_lag,
        _rate_grid_half_t_bins(freqs, n, sample_rate),
        with_floor=want_floor)
    vals, _keys, lag_idx, ridx, fws, _rv = (np.asarray(x) for x in lat)
    out_rates = rates.astype(np.float64)[ridx]
    out_freqs = np.asarray(freqs, np.float64)[fws]
    if not want_floor:
        return out_rates, out_freqs, lag_idx, vals
    from caf_cookoff_tpu.models.overlap_save import mean_floor
    from caf_cookoff_tpu.ops.peak import apply_detection_threshold

    floor = mean_floor(fsum, fcnt)
    num_cells = rates.shape[0] * freqs.shape[0] * lags
    vals, snr, _ = apply_detection_threshold(vals, floor, num_cells,
                                             min_snr_db)
    out = (out_rates, out_freqs, lag_idx, vals)
    return out + ((snr,) if with_snr else ())


# ---------------------------------------------------------------------------
# Stein-segmented rate search (round 5): the rate axis as synthesis rows
# ---------------------------------------------------------------------------
#
# The round-4 rate engines scan trial rates SERIALLY, each paying a
# fresh K-row spectra bank plus a full block scan (R x latency,
# ``_rate_os_peak_jit`` above).  The segmented formulation removes the
# R factor from the transform count entirely: the dechirp quadratic
# phase ``pi*r*(t/fs)^2`` is block-center-constant to the same
# tolerance as the doppler phase, so every (rate, doppler) pair is ONE
# synthesis row over the SHARED segment correlations
# (:func:`caf_cookoff_tpu.models.batched_stein.
# stein_rate_synthesis_weights`) — stage A runs once per chunk and the
# whole (R, K, lag) volume is synthesis matmuls.  Rows are chunked to
# bound the per-call synthesized volume in device memory.  Exactness
# is rank-then-score: top (rate, bin) candidates re-score with EXACTLY
# pre-chirped needles on a guard-extended capture slice, so answers
# match the exact serial engine bit-for-bit on the golden tests.


# Synthesis-row budget per coarse call: the call materializes
# (rows, programs, lags) float32 planes, ~1.6 GB per plane at 1024 rows
# x 48 programs x 8192 lags (the config-3 shape), so chunks stay near
# 1024 rows.
_RATE_ROWS_BUDGET = 1024


def _rate_block_len(sample_rate, freqs_np, rates_np, needle_len: int,
                    requested: int) -> int:
    """Block length under the RATE-AUGMENTED envelope.

    A trial rate ``r`` adds a within-block frequency of ``r * t_b / fs``
    (up to ``|r|_max * T`` at the last block) on top of the doppler
    span, plus a quadratic residual ``pi*|r|*(D/fs)^2`` — both must
    stay inside the block-constant-phase tolerance.
    """
    from caf_cookoff_tpu.config import floor_pow2
    from caf_cookoff_tpu.models.stein import _auto_block_len
    from caf_cookoff_tpu.models.batched_stein import SUPER

    fs = float(sample_rate)
    t_win = needle_len / fs
    r_max = float(np.max(np.abs(rates_np))) if len(rates_np) else 0.0
    f_aug = float(np.max(np.abs(freqs_np))) + r_max * t_win
    d = _auto_block_len(fs, np.asarray([f_aug]), requested)
    if r_max > 0:
        # pi * r * (D/fs)^2 <= pi/2  ->  D <= fs / sqrt(2 r)
        d = min(d, int(fs / np.sqrt(2.0 * r_max)))
    d = floor_pow2(min(d, SUPER))
    if d < 8:
        from caf_cookoff_tpu.errors import SpanError

        raise SpanError(
            f"rate-augmented span +-{f_aug:.0f} Hz needs segment length "
            "< 8 — the segmented rate engine does not pay off; use "
            "rate_overlap_save_peak (exact serial scan)")
    return d


@functools.partial(
    jax.jit,
    static_argnames=("total_lags", "needle_len", "block_len", "backend",
                     "windows", "num_bins", "rate_chunk", "guard"))
def _stein_rate_os_peak_jit(n_re, n_im, h_re, h_im, freqs_pad, centers,
                            rel, rates, sample_rate, total_lags: int,
                            needle_len: int, block_len: int, backend,
                            windows: int, num_bins: int, rate_chunk: int,
                            guard: int):
    """Banded-general segmented rate search (plain grids are the
    one-band case: ``centers=[0]``, ``rel=freqs``).  Programs run
    (band, window)-major with ``share_h`` banding; synthesis rows are
    (rate, relative-bin) pairs, chunked over rates to bound memory."""
    from caf_cookoff_tpu.models.batched_stein import (
        _needle_operator,
        _shift_to_centers,
        stein_rate_synthesis_weights,
        windowed_coarse_rank,
    )

    n = needle_len
    s = centers.shape[0]
    sr, si = _shift_to_centers(n_re[None], n_im[None], centers,
                               sample_rate)          # (S, n_pad)
    b = sr.shape[-1] // block_len
    v = xcor_length(n)
    lmat, group = _needle_operator(sr, si, block_len)
    kb = rel.shape[0]
    k = freqs_pad.shape[0]                           # S * Kb
    num_rates = rates.shape[0]
    woff = jnp.arange(windows, dtype=jnp.int32) * v
    rowmax_parts, rowlag_parts = [], []
    for c0 in range(0, num_rates, rate_chunk):
        rc = min(rate_chunk, num_rates - c0)
        ws1, ws2 = stein_rate_synthesis_weights(
            rel, rates[c0:c0 + rc], sample_rate, b, block_len)
        vals, idxs = windowed_coarse_rank(
            ws1, ws2, lmat, h_re[None], h_im[None], b, group, v, windows,
            total_lags, share_h=s)
        vals = vals.reshape(rc, kb, s, windows)
        glob = (idxs.reshape(rc, kb, s, windows)
                + woff[None, None, None, :])
        vals = jnp.where((glob < total_lags) & (vals >= 0), vals,
                         -jnp.inf)
        wbest = jnp.argmax(vals, axis=-1)
        take_w = lambda a: jnp.take_along_axis(
            a, wbest[..., None], axis=-1)[..., 0]     # (rc, kb, s)
        # Global bin = band*Kb + j on the freqs_pad lattice.
        rowmax_parts.append(
            take_w(vals).transpose(0, 2, 1).reshape(rc, k))
        rowlag_parts.append(
            take_w(glob).transpose(0, 2, 1).reshape(rc, k))
    rowmax = jnp.concatenate(rowmax_parts)          # (R, K_pad)
    rowlag = jnp.concatenate(rowlag_parts)
    return _rate_coarse_closer((n_re, n_im), (h_re, h_im), freqs_pad,
                               rates, rowmax, rowlag, sample_rate, v, n,
                               total_lags, guard, num_bins, backend)


def _rate_coarse_closer(n_planes, h_planes, freqs_pad, rates, rowmax,
                        rowlag, sample_rate, v: int, n: int,
                        total_lags: int, guard: int, num_bins: int,
                        backend):
    """Traceable rank-then-score closer shared by the single-chip and
    mesh segmented rate engines: pad-bin masking, the hybrid candidate
    set (global top-8 over (rate, bin), mainlobe-separated top-4 within
    the winning rate's row, every rate's own best), per-candidate exact
    re-score with its OWN pre-chirped needle on a guard window, and the
    serial engine's tie-break."""
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops.peak import doppler_cell_bins, topk_separated

    n_re, n_im = n_planes
    h_re, h_im = h_planes
    dtype = n_re.dtype
    k = freqs_pad.shape[0]
    num_rates = rates.shape[0]
    rowmax = jnp.where(jnp.arange(k)[None, :] < num_bins, rowmax,
                       -jnp.inf)                    # pad bins out
    freqs = freqs_pad
    flat = rowmax.reshape(-1)
    _, cand8 = jax.lax.top_k(flat, min(8, flat.shape[0]))
    r0 = cand8[0] // k
    row0 = jnp.take(rowmax, r0, axis=0)
    sep = doppler_cell_bins(freqs, n, sample_rate)
    cand_sep = topk_separated(row0, min(4, k), sep) + r0 * k
    per_rate = (jnp.argmax(rowmax, axis=1).astype(jnp.int32)
                + jnp.arange(num_rates, dtype=jnp.int32) * k)
    cand = jnp.concatenate([cand8.astype(jnp.int32),
                            cand_sep.astype(jnp.int32), per_rate])
    # Mask candidates whose coarse entry is -inf (pad bins on banded
    # grids with k % kb != 0, or fully-masked rows): their exact rows
    # would otherwise be scored at frequencies OUTSIDE the requested
    # grid and could win.
    cand_ok = jnp.isfinite(rowmax.reshape(-1)[cand])
    lag_c = rowlag.reshape(-1)[cand]
    r_c = cand // k
    k_c = cand % k
    fs = jnp.asarray(sample_rate, dtype)
    t = jnp.arange(n, dtype=dtype) / fs
    wlen = n + 2 * guard
    hay_len = h_re.shape[-1]
    local = jnp.arange(v, dtype=jnp.int32)

    def rescore(ri, ki, lag_e):
        r = rates[ri]
        ph = jnp.pi * r * (t * t)
        c, s = jnp.cos(ph), jnp.sin(ph)
        nb = (n_re * c - n_im * s, n_re * s + n_im * c)
        start = jnp.clip(lag_e - guard, 0, max(hay_len - wlen, 0))
        wr = jax.lax.dynamic_slice(h_re, (start,), (wlen,))
        wi = jax.lax.dynamic_slice(h_im, (start,), (wlen,))
        exact = splitfft.mag2(_surface_rows_split(
            nb, (wr, wi), freqs[jnp.reshape(ki, (1,))], sample_rate, v,
            backend))[0]
        ok = (local <= 2 * guard) & (start + local < total_lags)
        exact = jnp.where(ok, exact, -jnp.inf)
        return jnp.max(exact), start + jnp.argmax(exact).astype(jnp.int32)

    vals_e, lags_e = jax.vmap(rescore)(r_c, k_c, lag_c)
    vals_e = jnp.where(cand_ok, vals_e, -jnp.inf)
    # Exact-value winner; ties break like the serial engine: earlier
    # rate strictly, then lowest (bin, lag).
    best = jnp.lexsort((lags_e, k_c, r_c, -vals_e))[0]
    return (r_c[best], vals_e[best], k_c[best], lags_e[best])


def _rate_routing(sample_rate, freqs, rates, needle_len: int,
                  block_len: int, hay_len: int):
    """Shared rate-envelope preamble of the segmented rate engines
    (single-chip argmax/lattice and the mesh wrapper): the rate-drift
    margin + quadratic cap, plain-vs-banded routing, the re-raise on
    full ineligibility, and the row-chunk/guard sizing.  One copy so
    the mesh wrapper's bitwise single-chip-parity contract cannot
    drift.  Returns ``(d, freqs_pad, centers, rel, rate_chunk,
    guard)``."""
    from caf_cookoff_tpu.errors import SpanError
    from caf_cookoff_tpu.models.stein import _band_routing

    fs = float(sample_rate)
    n = needle_len
    r_max = float(np.max(np.abs(rates))) if len(rates) else 0.0
    margin = r_max * (n / fs)
    d_quad = int(fs / np.sqrt(2.0 * r_max)) if r_max > 0 else None
    try:
        d = _rate_block_len(sample_rate, freqs, rates, n, block_len)
    except SpanError:
        d = None
    _, d, freqs_pad, centers, rel = _band_routing(
        fs, freqs, d, margin_hz=margin, d_cap=d_quad)
    if d is None:
        _rate_block_len(sample_rate, freqs, rates, n, block_len)  # raise
    rate_chunk = max(1, _RATE_ROWS_BUDGET // max(len(rel), 1))
    guard = min(64, n // 4, max((hay_len - n) // 2, 1))
    return d, freqs_pad, centers, rel, rate_chunk, guard


def stein_rate_os_peak(needle, haystack, freqs_hz, rates_hz_per_s,
                       sample_rate, num_lags: Optional[int] = None, *,
                       block_len: int = 64,
                       backend: Optional[str] = None
                       ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_samples, value): the joint
    (rate, doppler, lag) long-capture search with the rate axis
    DE-SERIALIZED through the segmented engine.

    Same contract as :func:`rate_overlap_save_peak` (window-start
    frequency convention, absolute lags, earlier-rate tie-break) at a
    fraction of the cost: trial rates are synthesis rows over shared
    segment correlations instead of R full block scans (see the
    section comment above).  Wide uniform grids band exactly like
    the first-order engines (with the rate drift folded into the band
    envelope); grids/rates outside every segmented envelope raise
    ``SpanError`` — fall back to the exact serial engine there.
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = n_re.shape[-1]
    if h_re.shape[-1] < n:
        raise ValueError(
            f"haystack ({h_re.shape[-1]}) shorter than needle ({n})")
    total_lags = num_lags or h_re.shape[-1] - n + 1
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    d, freqs_pad, centers, rel, rate_chunk, guard = _rate_routing(
        sample_rate, freqs, rates, n, block_len, h_re.shape[-1])
    m = xcor_length(n)
    windows = -(-total_lags // m)
    r_idx, value, f_idx, lag = _stein_rate_os_peak_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(h_re),
        jnp.asarray(h_im), jnp.asarray(freqs_pad), jnp.asarray(centers),
        jnp.asarray(rel), jnp.asarray(rates), float(sample_rate),
        total_lags, n, d, backend, windows, len(freqs), rate_chunk,
        guard)
    return (float(rates[int(r_idx)]), float(freqs_pad[int(f_idx)]),
            int(lag), float(value))


@functools.partial(
    jax.jit,
    static_argnames=("total_lags", "needle_len", "block_len", "backend",
                     "windows", "num_bins", "rate_chunk", "guard",
                     "rescore_win", "num_peaks", "exclude_freq",
                     "exclude_lag", "half_t_bins"))
def _stein_rate_os_peaks_jit(n_re, n_im, h_re, h_im, freqs_pad, centers,
                             rel, rates, sample_rate, total_lags: int,
                             needle_len: int, block_len: int, backend,
                             windows: int, num_bins: int,
                             rate_chunk: int, guard: int,
                             rescore_win: int, num_peaks: int,
                             exclude_freq: int, exclude_lag: int,
                             half_t_bins):
    """Multi-emitter segmented rate search: per-rate NMS lattices from
    the coarse stage's top-2 per-bin candidates, cross-rate-merged in
    window-center frequency space (the rate-aware NMS of
    :func:`_merge_rate_lattice`), each survivor re-scored EXACTLY with
    its own pre-chirped needle on a guard-extended capture slice
    (doubly cell-constrained like the first-order segmented lattices)."""
    from caf_cookoff_tpu.models.batched_stein import (
        _entry_candidate_bins,
        _lattice_from_bin_candidates,
        _needle_operator,
        _shift_to_centers,
        stein_rate_synthesis_weights,
        windowed_coarse_rank,
    )
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops.peak import CafPeak, find_peak_2d, merge_peaks

    n = needle_len
    dtype = n_re.dtype
    s = centers.shape[0]
    sr, si = _shift_to_centers(n_re[None], n_im[None], centers,
                               sample_rate)
    b = sr.shape[-1] // block_len
    v = xcor_length(n)
    lmat, group = _needle_operator(sr, si, block_len)
    kb = rel.shape[0]
    k = freqs_pad.shape[0]
    num_rates = rates.shape[0]
    p = num_peaks
    htb = jnp.asarray(half_t_bins, dtype)
    woff = jnp.arange(windows, dtype=jnp.int32) * v
    offs = jnp.arange(s, dtype=jnp.int32) * kb
    lat_parts, vslots_parts, lslots_parts = [], [], []
    for c0 in range(0, num_rates, rate_chunk):
        rc = min(rate_chunk, num_rates - c0)
        ws1, ws2 = stein_rate_synthesis_weights(
            rel, rates[c0:c0 + rc], sample_rate, b, block_len)
        v1, i1, v2, i2 = windowed_coarse_rank(
            ws1, ws2, lmat, h_re[None], h_im[None], b, group, v, windows,
            total_lags, share_h=s, want_top2=True, sep=exclude_lag)
        vals_j = jnp.stack([v1, v2], axis=-1).reshape(
            rc, kb, s, windows, 2)
        lags_j = (jnp.stack([i1, i2], axis=-1).reshape(
            rc, kb, s, windows, 2) + woff[None, None, None, :, None])
        vals_j = jnp.where(lags_j < total_lags, vals_j, -1.0)
        # per-rate lattices: (band, window) NMS -> fold.
        vr = vals_j.transpose(0, 2, 3, 1, 4)     # (rc, S, W, Kb, 2)
        lr = lags_j.transpose(0, 2, 3, 1, 4)

        def rate_lattice(vb, lb):                # (S, W, Kb, 2)
            wl = jax.vmap(lambda vs, ls, off: jax.vmap(
                lambda vj, lj: _lattice_from_bin_candidates(
                    vj, lj, p, exclude_freq, exclude_lag,
                    bin_offset=off, num_bins=num_bins))(vs, ls),
            )(vb, lb, offs)                      # (S, W, p) fields
            flat = CafPeak(*(f.reshape(-1) for f in wl))
            return merge_peaks(flat, p, exclude_freq, exclude_lag)

        lat_parts.append(jax.vmap(rate_lattice)(vr, lr))
        # Candidate slots per rate on the global lattice: (rc, K, W*2).
        vslots_parts.append(
            vals_j.transpose(0, 2, 1, 3, 4).reshape(rc, s * kb, -1))
        lslots_parts.append(
            lags_j.transpose(0, 2, 1, 3, 4).reshape(rc, s * kb, -1))
    rlat = CafPeak(*(jnp.concatenate([getattr(x, f) for x in lat_parts])
                     for f in ("value", "freq_idx", "lag_idx")))
    vslots = jnp.concatenate(vslots_parts)       # (R, K, J)
    lslots = jnp.concatenate(lslots_parts)
    rows = jnp.arange(k)
    vslots = jnp.where(rows[None, :, None] < num_bins, vslots, -1.0)
    # Cross-rate merge on window-center keys (coarse values rank only).
    r_of = jnp.repeat(jnp.arange(num_rates, dtype=jnp.int32), p)
    rv_of = jnp.repeat(rates.astype(dtype), p)
    cv = rlat.value.reshape(-1)
    cb = rlat.freq_idx.reshape(-1)
    cl = rlat.lag_idx.reshape(-1)
    keys = cb + jnp.round(rv_of * htb).astype(jnp.int32)
    mv, mk, ml, mr, mf, mrv = _merge_rate_lattice(
        cv, keys, cl, r_of, cb, rv_of, p, exclude_freq, exclude_lag,
        htb)
    # Exact per-entry re-score with the entry's own pre-chirped needle.
    fs = jnp.asarray(sample_rate, dtype)
    t = jnp.arange(n, dtype=dtype) / fs
    wlen = n + 2 * guard
    hay_len = h_re.shape[-1]

    def rescore(ri, bin_e, lag_e, coarse_ok):
        r = rates[ri]
        ph = jnp.pi * r * (t * t)
        c, sn = jnp.cos(ph), jnp.sin(ph)
        nb = (n_re * c - n_im * sn, n_re * sn + n_im * c)
        bins, bok = _entry_candidate_bins(
            vslots[ri], lslots[ri], lag_e, bin_e, exclude_lag,
            exclude_freq, k)
        start = jnp.clip(lag_e - guard, 0, max(hay_len - wlen, 0))
        wr = jax.lax.dynamic_slice(h_re, (start,), (wlen,))
        wi = jax.lax.dynamic_slice(h_im, (start,), (wlen,))
        exact = splitfft.mag2(_surface_rows_split(
            nb, (wr, wi), freqs_pad[bins], sample_rate, v, backend))
        d = jax.lax.broadcasted_iota(jnp.int32, exact.shape, 1)
        keep = (bok[:, None] & (d <= 2 * guard)
                & (start + d < total_lags)
                & (jnp.abs(start + d - lag_e) <= rescore_win))
        pk = find_peak_2d(jnp.where(keep, exact, -jnp.inf))
        return (jnp.where(coarse_ok, pk.value, -jnp.inf),
                bins[pk.freq_idx].astype(jnp.int32),
                (start + pk.lag_idx).astype(jnp.int32))

    ev, eb, el_ = jax.vmap(rescore)(mr, mf, ml,
                                    jnp.isfinite(mv))
    # Re-merge on exact values (rate-aware keys from the exact bins).
    ekeys = eb + jnp.round(mrv * htb).astype(jnp.int32)
    return _merge_rate_lattice(ev, ekeys, el_, mr, eb, mrv, p,
                               exclude_freq, exclude_lag, htb)


def stein_rate_os_peaks(needle, haystack, freqs_hz, rates_hz_per_s,
                        sample_rate, num_peaks: int,
                        num_lags: Optional[int] = None, *,
                        block_len: int = 64,
                        exclude_freq: Optional[int] = None,
                        exclude_lag: Optional[int] = None,
                        backend: Optional[str] = None,
                        min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` ACCELERATING emitters of a long capture at
    segmented speed — the multi-emitter sibling of
    :func:`stein_rate_os_peak`, with :func:`rate_overlap_save_peaks`'s
    semantics (window-center-keyed cross-rate merge, rate-aware NMS,
    window-start frequencies, absolute lags).

    Returns ``(rates (P,), freqs (P,), lags (P,), values (P,)
    [, snr_db])``, strongest first, empty/sub-threshold slots ``-inf``.
    ``min_snr_db`` thresholds against the model floor
    (``sum|n|^2 * mean|h|^2`` — the dechirp has unit magnitude, so one
    floor serves every trial rate) over ``R*K*num_lags`` cells.
    Same-bin exactness contract as the first-order segmented lattices
    (exact past ``exclude_lag`` same-bin separation).
    """
    from caf_cookoff_tpu.models.batched_stein import (
        _rescore_guards,
        _stein_model_floor,
    )
    from caf_cookoff_tpu.ops.peak import apply_detection_threshold

    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = n_re.shape[-1]
    if h_re.shape[-1] < n:
        raise ValueError(
            f"haystack ({h_re.shape[-1]}) shorter than needle ({n})")
    total_lags = num_lags or h_re.shape[-1] - n + 1
    freqs = as_grid(freqs_hz, dtype=n_re.dtype)
    rates = np.asarray(rates_hz_per_s, dtype=n_re.dtype).reshape(-1)
    d, freqs_pad, centers, rel, rate_chunk, _guard = _rate_routing(
        sample_rate, freqs, rates, n, block_len, h_re.shape[-1])
    auto = resolve_exclusions(needle, freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto[1], h_re.shape[-1])
    m = xcor_length(n)
    windows = -(-total_lags // m)
    htb = _rate_grid_half_t_bins(freqs, n, sample_rate)
    vals, _k, lags, ridx, fws, _rv = _stein_rate_os_peaks_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(h_re),
        jnp.asarray(h_im), jnp.asarray(freqs_pad), jnp.asarray(centers),
        jnp.asarray(rel), jnp.asarray(rates), float(sample_rate),
        total_lags, n, d, backend, windows, len(freqs), rate_chunk,
        guard, rescore_win, int(num_peaks), exclude_freq, exclude_lag,
        htb)
    vals = np.asarray(vals)
    out_rates = rates.astype(np.float64)[np.asarray(ridx)]
    out_freqs = np.asarray(freqs_pad, np.float64)[np.asarray(fws)]
    lags = np.asarray(lags)
    if min_snr_db is None and not with_snr:
        return out_rates, out_freqs, lags, vals
    floor = float(_stein_model_floor(np.asarray(needle)[None],
                                     np.asarray(haystack)[None])[0])
    num_cells = len(rates) * len(freqs) * total_lags
    vals, snr, _ = apply_detection_threshold(vals, floor, num_cells,
                                             min_snr_db)
    out = (out_rates, out_freqs, lags, vals)
    return out + ((snr,) if with_snr else ())
