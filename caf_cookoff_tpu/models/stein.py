"""Stein time-segmented CAF — fast fine-grid doppler search.

The reference cites Stein's classic paper (``README.md:159-161``,
"Algorithms for Ambiguity Function Processing", 1981) but implements
only the brute-force filterbank: one shift + FFT-correlation per doppler
bin, 2K+1 length-M transforms per surface.  This engine implements the
paper's segmentation idea, restructured around one matmul:

    r_k[tau] = sum_s h[s+tau] conj(n[s]) e^{-j w_k s}
             ~ sum_b e^{-j w_k (bD + c)} * G[b, tau]
      where  G[b, tau] = sum_{d<D} h[bD+d+tau] conj(n[bD+d])

* Stage A — segment correlations ``G``: the needle is cut into B = N/D
  blocks; each block's correlation against the haystack shares ONE
  haystack FFT, and a block's in-place spectrum is its at-origin
  spectrum times a linear phase twist (shift theorem) — 2B+1 length-M
  transforms total, independent of K.
* Stage B — doppler synthesis: ``R = W @ G`` with
  ``W[k,b] = e^{-j w_k (bD + c)}``, ``c = (D-1)/2`` — one stacked
  split-complex (2K, 2B) x (2B, M) matmul.

Cost: (2B+1) transforms + K*B*M complex MACs, vs the filterbank's 2K
transforms + K*M elementwise work.  At the reference shape (K=400,
B=64) that is ~3x fewer FLOPs; at wideband grids (K=2000+, BASELINE
configs 3/5) ~5x and growing linearly in K's favor.

Accuracy: the block-constant phase approximation attenuates doppler
responses by ``sinc(w_k D / 2)`` — a smooth per-bin envelope (3% at
|f| = 100 Hz, D = 64, fs = 48 kHz) that does not move the argmax for
peaked surfaces; all ten golden fixtures recover bin-exactly (tests).
Halve ``block_len`` to tighten the envelope for wider doppler spans:
valid whenever ``w_max * D << pi``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import as_grid, default_backend, xcor_length
from caf_cookoff_tpu.errors import EngineError, SpanError
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import CafPeak, find_peak_2d

_PRECISION = jax.lax.Precision.HIGHEST


def _segment_correlations(needle, haystack, xcor_len: int, block_len: int,
                          backend: str):
    """G (B, M) split: per-needle-block correlations vs the haystack."""
    fft_fn, ifft_fn = splitfft.get_split_fft(backend)
    n_re, n_im = needle
    n = n_re.shape[-1]
    d = block_len
    b = -(-n // d)
    m = xcor_len
    pad = b * d - n
    if pad:
        n_re = jnp.pad(n_re, (0, pad))
        n_im = jnp.pad(n_im, (0, pad))
    blocks = (n_re.reshape(b, d), n_im.reshape(b, d))
    s0 = fft_fn(splitfft.pad_split(blocks, m))          # at-origin spectra
    # Shift theorem: block b actually lives at offset b*d, so its true
    # spectrum is s0[b] * e^{-j 2 pi q b d / m} (q = freq index).
    q = np.arange(m)
    bd = np.arange(b)[:, None] * d
    ang = (-2.0 * np.pi / m) * (bd * q[None, :])
    twist = (jnp.asarray(np.cos(ang), n_re.dtype),
             jnp.asarray(np.sin(ang), n_re.dtype))
    s_b = splitfft.cmul(s0, twist)
    h_spec = fft_fn(splitfft.pad_split(haystack, m))
    prod = splitfft.cmul_conj((h_spec[0][None, :], h_spec[1][None, :]), s_b)
    return ifft_fn(prod)                                 # G (B, M) split


def _doppler_synthesis(g, freqs_hz, sample_rate, block_len: int,
                       precision=None):
    """R = W @ G: stacked split-complex matmul over the segment axis."""
    gr, gi = g
    b = gr.shape[0]
    rdtype = gr.dtype
    centers = jnp.asarray(
        np.arange(b) * block_len + (block_len - 1) / 2.0, rdtype)
    w = ((-2.0 * jnp.pi) / jnp.asarray(sample_rate, rdtype)) * jnp.outer(
        freqs_hz.astype(rdtype), centers)               # (K, B) phase
    wr = jnp.cos(w)
    wi = jnp.sin(w)
    ws = jnp.concatenate(
        [jnp.concatenate([wr, -wi], axis=1),
         jnp.concatenate([wi, wr], axis=1)], axis=0)     # (2K, 2B)
    gs = jnp.concatenate([gr, gi], axis=0)               # (2B, M)
    rs = jnp.dot(ws, gs, precision=precision or _PRECISION)  # (2K, M)
    k = wr.shape[0]
    return rs[:k], rs[k:]


def _stein_rows(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                block_len: int, backend: str, synth_precision=None):
    g = _segment_correlations(needle, haystack, xcor_len, block_len,
                              backend)
    return _doppler_synthesis(g, freqs_hz, sample_rate, block_len,
                              synth_precision)


@functools.partial(
    jax.jit, static_argnames=("xcor_len", "block_len", "backend"))
def _stein_surface_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate,
                       xcor_len, block_len, backend):
    rows = _stein_rows((n_re, n_im), (h_re, h_im), freqs_hz, sample_rate,
                       xcor_len, block_len, backend)
    return splitfft.mag2(rows)


# Candidate counts for the exact re-score (see _refine_candidates):
# _REFINE_BINS plain top-k picks (adjacent near-tie flips) plus
# _REFINE_SEP_BINS mainlobe-separated picks (distinct lobes on grids
# finer than the fs/N doppler mainlobe, where the plain picks would all
# cluster on one emitter's skirt).
_REFINE_BINS = 8
_REFINE_SEP_BINS = 4


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "refine"))
def _stein_peak_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate,
                    xcor_len, block_len, backend, refine: bool = True):
    if refine:
        # The coarse pass only RANKS candidate bins — the exact re-score
        # below restores bin-exact answers — so it runs at the cheapest
        # tier ('matmul-bf16' DFT, default matmul precision) regardless
        # of the exact backend tier.
        coarse_backend = ("matmul-bf16" if backend.startswith("matmul")
                          else backend)
        synth_prec = jax.lax.Precision.DEFAULT
    else:
        coarse_backend = backend
        synth_prec = None

    rows = _stein_rows((n_re, n_im), (h_re, h_im), freqs_hz, sample_rate,
                       xcor_len, block_len, coarse_backend, synth_prec)
    mag2 = splitfft.mag2(rows)
    if not refine:
        return find_peak_2d(mag2)
    rowmax_coarse = jnp.max(mag2, axis=-1)
    # The block-constant phase approximation perturbs near-tie adjacent
    # bins (as does a reduced-precision coarse pass); re-scoring the top
    # candidates with the exact filterbank rows restores bin-exact
    # answers.
    return _refine_topk((n_re, n_im), (h_re, h_im), freqs_hz,
                        rowmax_coarse, sample_rate, xcor_len, backend)


def _refine_candidates(rowmax_coarse, freqs_all, needle_len: int,
                       sample_rate, num_valid: Optional[int] = None):
    """Candidate bins for the exact re-score: plain top-k UNION a
    mainlobe-separated top-k.

    Plain top-k covers adjacent near-tie flips (the common coarse
    error: the true winner ranks just below its perturbed neighbor).
    On grids much finer than the doppler mainlobe (fs/N) all k plain
    candidates can sit on ONE emitter's skirt, missing a distant
    competitor within ~6% of the winner — the separated picks
    (:func:`ops.peak.topk_separated`, separation = the mainlobe width
    in bins of THIS grid, traced) guarantee coverage of
    ``_REFINE_SEP_BINS`` distinct lobes.  Duplicates across the two
    sets are harmless (identical re-score rows; the lowest-bin
    tie-break is unaffected).
    """
    from caf_cookoff_tpu.ops.peak import doppler_cell_bins, topk_separated

    k = min(_REFINE_BINS, int(rowmax_coarse.shape[-1]),
            num_valid or _REFINE_BINS)
    _, cand = jax.lax.top_k(rowmax_coarse, k)
    ksep = min(_REFINE_SEP_BINS, k)
    sep = doppler_cell_bins(freqs_all, needle_len, sample_rate)
    if rowmax_coarse.ndim == 1:
        cand_sep = topk_separated(rowmax_coarse, ksep, sep)
    else:
        cand_sep = jax.vmap(lambda v: topk_separated(v, ksep, sep))(
            rowmax_coarse)
    return jnp.concatenate([cand, cand_sep], axis=-1)


def _refine_topk(needle, haystack, freqs_all, rowmax_coarse, sample_rate,
                 xcor_len: int, backend: str,
                 num_valid: Optional[int] = None) -> CafPeak:
    """Exact re-score of the coarse per-bin ranking (the
    rank-then-score closer shared by the plain and banded paths).

    ``num_valid`` caps the candidate count when the ranking vector
    carries -inf padded bins (banded grids): without it, a grid smaller
    than the refine width would let padded bins into the exact re-score
    and the returned frequency could lie outside the requested grid.
    """
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split

    cand = _refine_candidates(rowmax_coarse, freqs_all,
                              needle[0].shape[-1], sample_rate, num_valid)
    exact = splitfft.mag2(_surface_rows_split(
        needle, haystack, freqs_all[cand], sample_rate, xcor_len,
        backend))                                       # (k, M)
    rowmax = jnp.max(exact, axis=-1)
    # Highest exact value wins; exact ties break toward the lowest bin.
    best = jnp.lexsort((cand.astype(jnp.int32), -rowmax))[0]
    return CafPeak(value=rowmax[best],
                   freq_idx=cand[best].astype(jnp.int32),
                   lag_idx=jnp.argmax(exact[best]).astype(jnp.int32))


def _plan_bands(sample_rate: float, freqs_hz: np.ndarray,
                margin_hz: float = 0.0, d_cap: Optional[int] = None):
    """Band partition for wide-span grids, or ``None`` if infeasible.

    Only uniform grids band cleanly (every band then shares ONE
    relative grid, so the whole sweep is a single batched coarse call
    with the band axis as the pair axis).  Bands are sized so the
    relative |f| stays within the pow2-32-segment envelope.

    ``margin_hz`` shrinks every band by a frequency allowance consumed
    by something other than the grid — the rate engines pass their
    ``|r|_max * T`` dechirp drift so (band offset + rate drift) stays
    inside the block-constant-phase tolerance.  ``d_cap`` excludes
    block lengths above it (the rate engines' quadratic-residual cap).
    """
    k = len(freqs_hz)
    if k < 2:
        return None
    diffs = np.diff(np.asarray(freqs_hz, np.float64))
    g = float(diffs[0])
    if g <= 0 or not np.allclose(diffs, g, rtol=1e-5, atol=1e-9):
        return None
    # Per lag column, stage A costs ~4N MACs per band (independent of
    # D: (2B rows)x(2D taps) with B = N/D) and synthesis ~4*K_pad*N/D,
    # so with s bands of kb bins each, cost(D) ~ s*(1 + kb/D) in units
    # of 4N.  The continuous optimum is D* = sqrt(fs/(2g)), but the
    # pow2 quantization matters (floor_pow2(D*) can lose to the next
    # pow2 up — and small D doubles the block-count rows of stage A
    # and of G), so evaluate the model at every
    # eligible pow2 and take the cheapest.
    best = None
    for cand in (8, 16, 32, 64, 128):
        if d_cap is not None and cand > d_cap:
            continue
        # Widest band the phase-error envelope allows at this D:
        # rel_max + margin <= fs/(4D)  =>  kb <= 2*(fs/(4D) - margin)/g.
        width = sample_rate / (4.0 * cand) - float(margin_hz)
        if width <= 0:
            continue
        kb_c = max(1, int(2.0 * width / g))
        s_c = -(-k // kb_c)
        cost = s_c * (1.0 + kb_c / cand)
        if best is None or cost < best[0]:
            best = (cost, cand, kb_c)
    if best is None:
        return None
    _, d, kb = best
    s = -(-k // kb)
    f0 = float(freqs_hz[0])
    freqs_pad = (f0 + g * np.arange(s * kb)).astype(np.float32)
    centers = (f0 + g * (np.arange(s) * kb + (kb - 1) / 2.0)).astype(
        np.float32)
    rel = (g * (np.arange(kb) - (kb - 1) / 2.0)).astype(np.float32)
    return {"block_len": d, "kb": kb, "bands": s, "freqs_pad": freqs_pad,
            "centers": centers, "rel": rel}


def _band_routing(sample_rate, freqs_np, d: Optional[int], *,
                  margin_hz: float = 0.0, d_cap: Optional[int] = None):
    """Shared banded-vs-plain routing of every windowed/banded engine.

    ``d`` is the plain-envelope block length (``None`` when the plain
    path is ineligible).  Returns ``(use_banded, d_eff, freqs_pad,
    centers, rel)`` — the one-band degenerate values (``centers=[0]``,
    ``rel=freqs_pad=freqs``) for the plain route, the band plan's
    arrays otherwise.  ``d_eff`` is ``None`` when NEITHER route is
    eligible (callers raise their own engine-specific error).  The
    banded route wins when the cost model (``s*(1 + kb/D)`` vs
    ``1 + K/D`` MACs per lag column, in units of 4N — see
    :func:`_plan_bands`) says it is at least ~10% cheaper.
    """
    plan = _plan_bands(float(sample_rate), freqs_np, margin_hz=margin_hz,
                       d_cap=d_cap)
    use_banded = False
    if plan is not None:
        if d is None:
            use_banded = True
        else:
            cost_plain = 1.0 + len(freqs_np) / d
            cost_band = (plan["bands"]
                         + plan["bands"] * plan["kb"] / plan["block_len"])
            use_banded = cost_band < 0.9 * cost_plain
    if use_banded:
        return (True, plan["block_len"], np.asarray(plan["freqs_pad"]),
                np.asarray(plan["centers"]), np.asarray(plan["rel"]))
    return (False, d, np.asarray(freqs_np), np.zeros(1, np.float32),
            np.asarray(freqs_np))


def _banded_stein_peak_jit(n_re, n_im, h_re, h_im, freqs_pad, centers,
                           rel, sample_rate, xcor_len, block_len,
                           backend, num_bins):
    """Wide-span Stein for ONE pair: the P=1 case of the banded batch
    engine (``models/batched_stein._banded_batched_jit`` — band centers
    become the coarse stage's batch axis via ``share_h``)."""
    from caf_cookoff_tpu.models.batched_stein import _banded_batched_jit

    peak = _banded_batched_jit(
        n_re[None], n_im[None], h_re[None], h_im[None], freqs_pad,
        centers, rel, sample_rate, xcor_len, block_len, backend,
        num_bins)
    return CafPeak(value=peak.value[0], freq_idx=peak.freq_idx[0],
                   lag_idx=peak.lag_idx[0])


def _auto_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Clamp the segment length to the approximation's validity range.

    The block-constant phase error is ``w_max * D / 2``; keeping it
    under ~pi/8 requires ``D <= fs / (4 * f_max)``.  Wide doppler spans
    make the segmented engine pointless (D too small to amortize) — use
    the filterbank backends there.
    """
    f_max = float(np.max(np.abs(freqs_hz))) if len(freqs_hz) else 0.0
    if f_max <= 0:
        return requested
    limit = int(sample_rate / (4.0 * f_max))
    d = min(requested, max(limit, 1))
    if d < 8:
        raise SpanError(
            f"doppler span +-{f_max:.0f} Hz needs segment length <= {limit} "
            f"(< 8) at fs={sample_rate:.0f}; the segmented (stein) engine "
            "does not pay off — use the 'xla' or 'matmul' backend")
    return d


def _prep(needle, haystack, freqs_hz):
    n = splitfft.split_array(needle)
    h = splitfft.split_array(haystack)
    n_len, h_len = n[0].shape[-1], h[0].shape[-1]
    # The haystack may run up to the M-point correlation length: the
    # engines zero-pad it to M anyway, so a slightly-longer window
    # (e.g. the overlap-save refine's guard-extended slice) just
    # shrinks the implicit zero tail.  Shorter-than-needle or
    # longer-than-M inputs are real errors.
    if h_len < n_len or h_len > xcor_length(n_len):
        raise ValueError(
            f"haystack length {h_len} outside [{n_len}, "
            f"{xcor_length(n_len)}] for needle length {n_len}; use "
            "stein_overlap_save_peak for long captures")
    return n, h, as_grid(freqs_hz, dtype=n[0].dtype)


def stein_caf_surface(needle, haystack, freqs_hz, sample_rate, *,
                      block_len: int = 64,
                      backend: Optional[str] = None) -> jax.Array:
    """(K, M) mag^2 surface via time segmentation (Stein's method)."""
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep(needle, haystack, freqs_hz)
    block_len = _auto_block_len(sample_rate, freqs, block_len)
    return _stein_surface_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                              float(sample_rate),
                              xcor_length(n_re.shape[-1]), block_len,
                              backend)


def _segment_spectra_conj(needle, fft_len: int, block_len: int,
                          backend: str):
    """conj spectra of the needle's D-blocks at their true offsets —
    (B, M) split, doppler-independent (computed once per needle)."""
    fft_fn, _ = splitfft.get_split_fft(backend)
    n_re, n_im = needle
    n = n_re.shape[-1]
    d = block_len
    b = -(-n // d)
    m = fft_len
    pad = b * d - n
    if pad:
        n_re = jnp.pad(n_re, (0, pad))
        n_im = jnp.pad(n_im, (0, pad))
    s0 = fft_fn(splitfft.pad_split(
        (n_re.reshape(b, d), n_im.reshape(b, d)), m))
    q = np.arange(m)
    ang = (-2.0 * np.pi / m) * (np.arange(b)[:, None] * d * q[None, :])
    twist = (jnp.asarray(np.cos(ang), n_re.dtype),
             jnp.asarray(np.sin(ang), n_re.dtype))
    s_re, s_im = splitfft.cmul(s0, twist)
    return s_re, -s_im


@functools.partial(
    jax.jit,
    static_argnames=("needle_len", "num_lags", "block_len", "backend",
                     "coarse"))
def _stein_os_scan_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate,
                       needle_len, num_lags, block_len, backend,
                       coarse: bool = False):
    """Streaming overlap-save peak with Stein doppler synthesis.

    Per haystack block: ONE forward FFT + B_seg = N/D inverse FFTs (the
    segment correlations) + one (2K, 2B_seg) x (2B_seg, V) synthesis
    matmul — vs K inverse FFTs per block for the filterbank streaming
    path.  For wideband grids (K >> B_seg) this decouples doppler
    resolution from transform count on long captures too.
    """
    from caf_cookoff_tpu.models.overlap_save import plan_blocks

    if coarse and backend.startswith("matmul"):
        # Ranking-only scan (exact refinement follows): bf16 throughout.
        backend = "matmul-bf16"
        synth_prec = jax.lax.Precision.DEFAULT
    else:
        synth_prec = None
    fft_fn, ifft_fn = splitfft.get_split_fft(backend)
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    d_read = v + needle_len - 1
    sc = _segment_spectra_conj((n_re, n_im), m, block_len, backend)
    target = nblocks * v + needle_len - 1
    if h_re.shape[-1] >= target:
        hay = (h_re[:target], h_im[:target])
    else:
        hay = splitfft.pad_split((h_re, h_im), target)

    def step(best: CafPeak, blk):
        seg = tuple(jax.lax.dynamic_slice(p, (blk * v,), (d_read,))
                    for p in hay)
        spec = fft_fn(splitfft.pad_split(seg, m))
        prod = splitfft.cmul((spec[0][None], spec[1][None]), sc)
        g = ifft_fn(prod)                                # (B_seg, M)
        g = (g[0][:, :v], g[1][:, :v])
        rows = _doppler_synthesis(g, freqs_hz, sample_rate, block_len,
                                  synth_prec)
        mag2 = splitfft.mag2(rows)                       # (K, V)
        local_ok = jax.lax.broadcasted_iota(jnp.int32, (1, v), 1) + blk * v
        mag2 = jnp.where(local_ok < num_lags, mag2, -1.0)
        cand = find_peak_2d(mag2)
        cand = CafPeak(cand.value, cand.freq_idx, cand.lag_idx + blk * v)
        take = cand.value > best.value
        return CafPeak(
            jnp.where(take, cand.value, best.value),
            jnp.where(take, cand.freq_idx, best.freq_idx),
            jnp.where(take, cand.lag_idx, best.lag_idx)), None

    init = CafPeak(value=jnp.asarray(-jnp.inf, n_re.dtype),
                   freq_idx=jnp.asarray(0, jnp.int32),
                   lag_idx=jnp.asarray(0, jnp.int32))
    # int32 block ids: a default arange is int64 under x64 (the c128
    # parity regime) and `cand.lag_idx + blk * v` would widen the
    # int32 carry mid-scan.
    best, _ = jax.lax.scan(step, init,
                           jnp.arange(nblocks, dtype=jnp.int32))
    return best


def stein_overlap_save_peak(needle, haystack, freqs_hz, sample_rate, *,
                            block_len: int = 64,
                            num_lags: Optional[int] = None,
                            refine: bool = True,
                            backend: Optional[str] = None
                            ) -> Tuple[float, int, float]:
    """Long-haystack (freq, lag, value) via segmented doppler synthesis.

    Coarse scan over all lags (Stein approximation — lag exact, freq
    within a bin), then exact refinement: the needle-length capture
    window at the found lag is re-scored by :func:`stein_caf_peak`'s
    exact top-k path, restoring bin-exact frequency.

    With ``refine=True`` the coarse pass routes through the windowed
    engine (:func:`~caf_cookoff_tpu.models.batched_stein.
    batched_stein_os_peak` at P=1): every overlap-save lag window (and,
    for grids the band planner favors, every band) is one program of
    the coarse stage.  Shapes outside its envelope (no pow2 block or
    band plan) fall back to the block scan below.  Doppler spans past
    the single-segment envelope (|f| > fs/32) can ONLY run the banded
    windowed engine (the scan has no banded mode).
    """
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep_long(needle, haystack,
                                                   freqs_hz)
    try:
        scan_block = _auto_block_len(sample_rate, freqs, block_len)
        span_err = None
    except SpanError as e:
        scan_block, span_err = None, e  # past single-segment envelope
    if refine and h_re.shape[-1] > n_re.shape[-1]:
        from caf_cookoff_tpu.models.batched_stein import (
            batched_stein_os_peak,
        )

        try:
            fr, lg, vv = batched_stein_os_peak(
                np.asarray(needle)[None], np.asarray(haystack)[None],
                freqs_hz, sample_rate, num_lags=num_lags,
                block_len=block_len, backend=backend)
            return float(fr[0]), int(lg[0]), float(vv[0])
        except EngineError:
            # Span/shape outside the windowed engine's envelope -> scan.
            # Only the typed envelope conditions reroute; an unrelated
            # ValueError (shape bug, broken invariant) propagates.
            if scan_block is None:
                raise    # the scan cannot take the span either
    if scan_block is None:
        # refine=False (or needle-length capture) with a wide span:
        # the scan has no banded mode, surface the actionable message.
        raise span_err
    block_len = scan_block
    n = n_re.shape[-1]
    lags = num_lags or h_re.shape[-1] - n + 1
    peak = _stein_os_scan_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                              float(sample_rate), n, lags, block_len,
                              backend, refine)
    lag = int(peak.lag_idx)
    if not refine:
        return float(freqs[int(peak.freq_idx)]), lag, float(peak.value)
    # Exact re-score of a guard-extended window starting slightly
    # before the coarse lag: recovers both the exact frequency bin and
    # any near-tie lag flip (the window's local lag delta re-derives
    # it).  The window carries ``n + 2*guard`` samples so the winning
    # local lag (~``guard``) correlates every needle sample against
    # real data — an n-sample window would truncate the last ``guard``
    # products to zeros and bias the reported value low.
    guard = min(lag, 64, n // 4)
    start = lag - guard
    win_len = min(n + 2 * guard, xcor_length(n))
    hay_np = np.asarray(haystack)
    window = np.zeros(win_len, dtype=hay_np.dtype)
    avail = min(win_len, hay_np.shape[-1] - start)
    window[:avail] = hay_np[start:start + avail]
    freq, delta, value = stein_caf_peak(needle, window, freqs, sample_rate,
                                        block_len=block_len,
                                        backend=backend)
    return freq, start + int(delta), value


def _prep_long(needle, haystack, freqs_hz):
    n = splitfft.split_array(needle)
    h = splitfft.split_array(haystack)
    if h[0].shape[-1] < n[0].shape[-1]:
        raise ValueError(
            f"haystack ({h[0].shape[-1]}) shorter than needle "
            f"({n[0].shape[-1]})")
    return n, h, as_grid(freqs_hz, dtype=n[0].dtype)


def stein_caf_peak(needle, haystack, freqs_hz, sample_rate, *,
                   block_len: int = 64, refine: bool = True,
                   backend: Optional[str] = None
                   ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value) via the segmented fast path.

    ``refine=True`` (default) re-scores the top candidate bins with the
    exact filterbank rows, restoring bin-exact golden answers.  The
    coarse stage A is the FFT segment correlations (the batch engines
    take the direct Hankel-row dot, :func:`~caf_cookoff_tpu.models.
    batched_stein.coarse_rank`).

    Doppler spans past the single-segment envelope (|f| > fs/32) run
    the BANDED path: the uniform grid splits into bands, the needle is
    shifted to each band center (exact — shift composition), and the
    bands sweep as the batch axis of one coarse-stage call, so the
    segmented engine covers arbitrary spans.
    """
    backend = backend or default_backend()
    (n_re, n_im), (h_re, h_im), freqs = _prep(needle, haystack, freqs_hz)
    xl = xcor_length(n_re.shape[-1])
    try:
        block_len = _auto_block_len(sample_rate, freqs, block_len)
    except SpanError:
        # Banded path: it ranks coarsely and needs the exact re-score.
        plan = _plan_bands(sample_rate, freqs) if refine else None
        if plan is None or xl % 512:
            raise
        peak = _banded_stein_peak_jit(
            n_re, n_im, h_re, h_im, jnp.asarray(plan["freqs_pad"]),
            jnp.asarray(plan["centers"]), jnp.asarray(plan["rel"]),
            float(sample_rate), xl, plan["block_len"], backend,
            len(freqs))
        return (float(plan["freqs_pad"][int(peak.freq_idx)]),
                int(peak.lag_idx), float(peak.value))
    peak = _stein_peak_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                           float(sample_rate), xl, block_len, backend,
                           refine)
    return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))
