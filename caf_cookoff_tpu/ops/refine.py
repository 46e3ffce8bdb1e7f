"""Sub-bin (FDOA, TDOA) refinement — zoom re-scoring past the grid.

Every reference implementation reports integer grid points: an injected
+35.99 Hz on a 1 Hz grid can only ever be called 36.0
(``caf_rust/tests/test.rs:162``), and lags are integer sample indices by
construction.  This module refines a coarse engine peak to
**continuous** (freq_hz, lag_samples):

* **FDOA zoom.**  At the coarse lag the product signal
  ``z[t] = conj(needle[t]) * haystack[lag + t]`` is (for a true copy) a
  complex exponential at exactly the frequency offset.  Its CAF row
  ``|Z(f)|^2 = |sum_t z[t] e^{-j2pi f t / fs}|^2`` is evaluated on a
  fine frequency grid by direct DFT (one small matmul per
  iteration), and the grid re-centers and shrinks geometrically — three
  33-point iterations take a 0.5 Hz coarse step to ~1e-4 Hz, far past
  the 0.01 Hz target, at O(iters * points * N) flops.
* **TDOA zoom.**  With the refined frequency applied, the linear
  cross-correlation around the coarse lag is band-limited, so its
  cross-spectrum ``C[k] = W[k] * conj(Y[k])`` extends to continuous lag
  by trigonometric interpolation:
  ``r(tau) = (1/M) sum_k C[k] e^{+j2pi k~ tau / M}`` with signed bin
  indices ``k~``.  The same shrink-and-re-center zoom runs over ``tau``.

Both stages are closed-form matmuls on static shapes — jit-compatible,
vmap-batchable (``refine_peaks``), and shard_map-safe.  (They replaced
the host-only parabolic ``interpolate_peak``, removed in round 5 after
its deprecation cycle: it called ``float()`` on traced values and fit
the weakest model through 3 samples of a mainlobe this module re-scores
exactly.)
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import default_backend, next_pow2
from caf_cookoff_tpu.ops import splitfft

# Guard samples around the coarse lag: the lag zoom searches
# [lag - GUARD, lag + GUARD] and the window carries enough extra data
# that every needle sample correlates against real capture.
GUARD = 8
_POINTS = 33          # odd: the current center stays on the zoom grid
_ITERS = 3            # 0.5 Hz coarse step -> ~1e-4 Hz; 1 samp -> ~2e-4


def _zoom_scores(z_re, z_im, centers, span, num, t):
    """|sum_t z[t] e^{-j2pi g t}|^2 on ``num`` grid points around
    ``centers`` (traced scalar), half-width ``span``; ``t`` is the
    per-sample axis (seconds for the frequency zoom, signed bin index
    over M for the lag zoom).  Returns (grid (num,), scores (num,))."""
    dtype = z_re.dtype
    offs = jnp.linspace(-1.0, 1.0, num, dtype=dtype) * span
    grid = centers + offs                                     # (num,)
    phase = (2.0 * jnp.pi) * grid[:, None] * t[None, :]       # (num, n)
    c, s = jnp.cos(phase), jnp.sin(phase)
    # e^{-j phase} * (z_re + j z_im), summed over t.
    re = c @ z_re + s @ z_im
    im = c @ z_im - s @ z_re
    return grid, re * re + im * im


def _zoom_argmax(z_re, z_im, center, span0, t, points, iters):
    """Iterated zoom: argmax of the score, grid shrinking each round.

    The final sub-step applies a parabolic vertex fit on the last
    (very fine) grid — at that scale the peak is exactly quadratic, so
    the fit buys one more digit for free.
    """
    center = jnp.asarray(center, z_re.dtype)
    span = span0
    for _ in range(iters):
        grid, scores = _zoom_scores(z_re, z_im, center, span, points, t)
        i = jnp.argmax(scores)
        im1 = jnp.clip(i - 1, 0, points - 1)
        ip1 = jnp.clip(i + 1, 0, points - 1)
        step = grid[1] - grid[0]
        denom = scores[im1] - 2.0 * scores[i] + scores[ip1]
        frac = jnp.where(
            (i > 0) & (i < points - 1) & (jnp.abs(denom) > 0.0),
            jnp.clip(0.5 * (scores[im1] - scores[ip1]) / denom, -0.5, 0.5),
            0.0)
        value = scores[i]
        center = grid[i] + frac * step
        span = 2.0 * step          # next grid brackets the vertex
    return center, value


def _extract_window(h_re, h_im, lag: int, n: int):
    """Host-side (n + 2*GUARD,) window covering capture samples
    [lag-GUARD, lag+n+GUARD), zero-filled outside the capture.

    Returns ``(w_re, w_im, start)`` with ``start = lag - GUARD``
    (window sample ``i`` is capture sample ``start + i``; ``start`` may
    be negative for early lags).  Doing this on the host keeps the jit
    operand a fixed small shape — one executable serves every lag and
    capture length, nothing capture-sized crosses to the device, and a
    too-short capture can never mis-align a clamped device-side slice.
    """
    win_len = n + 2 * GUARD
    start = int(lag) - GUARD
    w_re = np.zeros(win_len, h_re.dtype)
    w_im = np.zeros(win_len, h_im.dtype)
    lo = max(start, 0)
    hi = min(start + win_len, int(h_re.shape[-1]))
    if hi > lo:
        w_re[lo - start:hi - start] = h_re[lo:hi]
        w_im[lo - start:hi - start] = h_im[lo:hi]
    return w_re, w_im, start


@functools.partial(
    jax.jit,
    static_argnames=("n", "backend", "points", "iters"))
def _refine_jit(n_re, n_im, w_re, w_im, f0, coarse_step,
                sample_rate, n, backend, points, iters):
    """Core zoom on a pre-extracted window (the coarse lag sits at
    window-local position GUARD by construction)."""
    dtype = n_re.dtype
    fs = jnp.asarray(sample_rate, dtype)
    win_len = w_re.shape[-1]
    tau0 = jnp.asarray(float(GUARD), dtype)    # coarse lag, window-local

    # --- FDOA zoom on the product signal at the coarse (integer) lag.
    g_re = w_re[GUARD:GUARD + n]
    g_im = w_im[GUARD:GUARD + n]
    # z = conj(needle) * window_at_lag
    z_re = n_re * g_re + n_im * g_im
    z_im = n_re * g_im - n_im * g_re
    t_sec = jnp.arange(n, dtype=dtype) / fs
    f_hat, _ = _zoom_argmax(z_re, z_im, f0, jnp.asarray(coarse_step, dtype),
                            t_sec, points, iters)

    # --- TDOA zoom on the trig-interpolated linear correlation.
    fft_fn, ifft_fn = splitfft.get_split_fft(backend)
    m = next_pow2(win_len + n)
    phase = (2.0 * jnp.pi / fs) * f_hat * jnp.arange(n, dtype=dtype)
    cph, sph = jnp.cos(phase), jnp.sin(phase)
    y_re = n_re * cph - n_im * sph
    y_im = n_re * sph + n_im * cph
    wf = fft_fn(splitfft.pad_split((w_re, w_im), m))
    yf = fft_fn(splitfft.pad_split((y_re, y_im), m))
    c_re, c_im = splitfft.cmul_conj(wf, yf)       # W * conj(Y), (M,)
    # Signed bin frequencies: trig interpolation of the band-limited
    # linear correlation needs k in [-M/2, M/2), not [0, M).
    k = jnp.arange(m, dtype=dtype)
    k = jnp.where(k < m / 2, k, k - m)
    # r(tau) = (1/M) sum_k C[k] e^{+j 2pi k tau / M}; the zoom kernel
    # computes e^{-j phase}, so score with conj(C) (|r| is unchanged).
    tau_hat, value = _zoom_argmax(c_re, -c_im, tau0,
                                  jnp.asarray(float(GUARD), dtype),
                                  k / m, points, iters)

    # --- Second FDOA pass on the fractionally-ALIGNED window: a true
    # sub-sample delay leaves pass 1's product signal built on a
    # misaligned copy (self-noise that biases f by ~0.01 Hz at half-
    # sample offsets).  Advancing the window by the fractional part of
    # tau_hat (shift theorem on the already-computed spectrum) removes
    # it; the zoom re-brackets at 1/16 of the coarse step.
    lag_int = jnp.round(tau_hat)
    delta = tau_hat - lag_int
    ph = (2.0 * jnp.pi / m) * k * delta
    cd, sd = jnp.cos(ph), jnp.sin(ph)
    wa_re, wa_im = ifft_fn((wf[0] * cd - wf[1] * sd,
                            wf[0] * sd + wf[1] * cd))
    li = jnp.clip(lag_int.astype(jnp.int32), 0, m - n)
    a_re = jax.lax.dynamic_slice(wa_re, (li,), (n,))
    a_im = jax.lax.dynamic_slice(wa_im, (li,), (n,))
    z2_re = n_re * a_re + n_im * a_im
    z2_im = n_re * a_im - n_im * a_re
    f_hat, _ = _zoom_argmax(z2_re, z2_im, f_hat,
                            jnp.asarray(coarse_step / 16.0, dtype),
                            t_sec, points, 2)
    # Precision floor note: near the vertex the relative |Z(f)|^2
    # curvature per delta-f scales with (pi*df*T)^2, so for SHORT
    # windows it drops below f32 epsilon and the zoom saturates at
    # ~1e-4 of an fs/n bin (n=512: ~0.02 Hz; n=4096: ~1e-3 Hz — well
    # inside the golden contract).  A Kay/phase-slope correction was
    # tried and measured NO better: its lag-1 autocorrelation sum hits
    # the same f32 accumulation floor (~2e-6 relative over 4k terms).

    inv_m = 1.0 / m
    # tau_hat is window-local; the caller composes start + tau in f64
    # (at capture lags past 2^24 an f32 sum would eat the fraction).
    return f_hat, tau_hat, value * (inv_m * inv_m)


def refine_peak(needle, haystack, freq_hz: float, lag: int, sample_rate,
                *, coarse_step_hz: Optional[float] = None,
                backend: Optional[str] = None,
                points: int = _POINTS,
                iters: int = _ITERS) -> Tuple[float, float, float]:
    """Refine a coarse engine peak to continuous (freq_hz, lag, value).

    ``freq_hz``/``lag`` are any engine's grid-snapped answer;
    ``coarse_step_hz`` is the grid step the answer came from (the zoom's
    initial bracket; defaults to 0.5 Hz, the reference bench grid).
    ``lag`` is a SIGNED absolute capture offset (negative = the copy
    starts before the capture; convert raw circular xcor indices with
    :func:`caf_cookoff_tpu.ops.peak.signed_lag` first).  Returns
    ``(freq_hz, lag_samples, value)`` floats — lag is now fractional;
    ``value`` is the exact ``|r|^2`` at the refined point.

    Accuracy on the 10 golden fixtures: <=1e-2 Hz and <=2e-3 samples
    against the injected truth (tests/test_refine.py), vs the
    reference's half-grid-bin snapping (``caf_rust/tests/test.rs:162``
    calls +35.99 Hz "36.0").
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = int(n_re.shape[-1])
    w_re, w_im, start = _extract_window(h_re, h_im, int(lag), n)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    f_hat, tau_hat, value = _refine_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(w_re),
        jnp.asarray(w_im), jnp.asarray(float(freq_hz), n_re.dtype),
        step, float(sample_rate), n, backend, int(points), int(iters))
    return float(f_hat), start + float(tau_hat), float(value)


def _joint_freq_rate_scores(z_re, z_im, t_sec, f_grid, r_grid):
    """|E(f, r)|^2 = |sum_t z[t] e^{-j2pi f t} e^{-j pi r t^2}|^2 on the
    outer product of the two grids: (pf, pr) via split-complex matmuls.
    """
    # Dechirp columns: (n, pr)
    ph_r = jnp.pi * r_grid[None, :] * (t_sec * t_sec)[:, None]
    cr, sr = jnp.cos(ph_r), jnp.sin(ph_r)
    zr_re = z_re[:, None] * cr + z_im[:, None] * sr
    zr_im = z_im[:, None] * cr - z_re[:, None] * sr
    # Frequency rows: (pf, n)
    ph_f = (2.0 * jnp.pi) * f_grid[:, None] * t_sec[None, :]
    cf, sf = jnp.cos(ph_f), jnp.sin(ph_f)
    re = cf @ zr_re + sf @ zr_im
    im = cf @ zr_im - sf @ zr_re
    return re * re + im * im                       # (pf, pr)


def _zoom_freq_rate(z_re, z_im, t_sec, f0, f_span, r0, r_span, points,
                    iters):
    """Joint 2-D geometric zoom over (frequency, rate)."""
    dtype = z_re.dtype
    f_c = jnp.asarray(f0, dtype)
    r_c = jnp.asarray(r0, dtype)
    offs = jnp.linspace(-1.0, 1.0, points, dtype=dtype)
    value = jnp.asarray(0.0, dtype)
    for _ in range(iters):
        f_grid = f_c + offs * f_span
        r_grid = r_c + offs * r_span
        scores = _joint_freq_rate_scores(z_re, z_im, t_sec, f_grid,
                                         r_grid)
        flat = jnp.argmax(scores)
        fi, ri = flat // points, flat % points
        value = scores.reshape(-1)[flat]
        f_c = f_grid[fi]
        r_c = r_grid[ri]
        f_span = 2.0 * (f_grid[1] - f_grid[0])
        r_span = 2.0 * (r_grid[1] - r_grid[0])
    return f_c, r_c, value


@functools.partial(
    jax.jit,
    static_argnames=("n", "backend", "points", "iters"))
def _refine_rate_jit(n_re, n_im, w_re, w_im, f0, r0, coarse_step,
                     max_rate, sample_rate, n, backend, points,
                     iters):
    dtype = n_re.dtype
    fs = jnp.asarray(sample_rate, dtype)
    win_len = w_re.shape[-1]
    g_re = w_re[GUARD:GUARD + n]
    g_im = w_im[GUARD:GUARD + n]
    z_re = n_re * g_re + n_im * g_im
    z_im = n_re * g_im - n_im * g_re
    t_sec = jnp.arange(n, dtype=dtype) / fs
    # Centered time decorrelates the (f, r) pair: over [0, T] a rate
    # error masquerades as a frequency shift of r*T/2 (a diagonal ridge
    # an axis-aligned zoom stalls on); over [-T/2, T/2] frequency is
    # the odd moment and rate the even one, so the 2-D zoom separates.
    # The estimated frequency is then the MID-window value; convert
    # back to the window-start convention afterwards.
    half_t = t_sec[-1] * 0.5
    t_c = t_sec - half_t
    # f0 arrives in the window-START convention; the centered-time zoom
    # parameterizes the MID-window frequency, so the bracket centers at
    # f0 + r0*T/2 (for the default r0=0 the two coincide).
    f_mid0 = f0 + r0 * half_t
    f_mid, r_hat, _ = _zoom_freq_rate(
        z_re, z_im, t_c, f_mid0, jnp.asarray(coarse_step, dtype),
        r0, jnp.asarray(max_rate, dtype), points,
        iters)
    f_hat = f_mid - r_hat * half_t

    # Fractional-lag zoom with the full second-order model applied to
    # the needle (same machinery as _refine_jit's TDOA stage).
    fft_fn, _ = splitfft.get_split_fft(backend)
    m = next_pow2(win_len + n)
    phase = (2.0 * jnp.pi) * f_hat * t_sec \
        + jnp.pi * r_hat * t_sec * t_sec
    cph, sph = jnp.cos(phase), jnp.sin(phase)
    y_re = n_re * cph - n_im * sph
    y_im = n_re * sph + n_im * cph
    wf = fft_fn(splitfft.pad_split((w_re, w_im), m))
    yf = fft_fn(splitfft.pad_split((y_re, y_im), m))
    c_re, c_im = splitfft.cmul_conj(wf, yf)
    k = jnp.arange(m, dtype=dtype)
    k = jnp.where(k < m / 2, k, k - m)
    tau0 = jnp.asarray(float(GUARD), dtype)
    tau_hat, value = _zoom_argmax(c_re, -c_im, tau0,
                                  jnp.asarray(float(GUARD), dtype),
                                  k / m, points, iters)
    inv_m = 1.0 / m
    return f_hat, r_hat, tau_hat, value * (inv_m * inv_m)


def _polish_freq_rate_f64(n_c, g_c, sample_rate, f_start, r_hat,
                          f_span, r_span, points=_POINTS, iters=6,
                          r_bounds=None):
    """Host f64 joint (f, r) zoom — the precision stage past the
    on-device f32 score floor.

    Near the (f, r) vertex the score surface is flat to ~(pi dr
    sigma_{t^2})^2/2 relative — at dr ~ 2 Hz/s over a 4096-sample
    window that is ~5e-6, BELOW the f32 summation noise of a 4k-term
    coherent sum (~1e-5), so the device zoom saturates ~2 Hz/s off
    (measured, noiseless).  A few f64 zoom iterations on the already
    -extracted window (33^2 x n complex MACs per iter, microseconds on
    host) land ~1e-3 Hz/s.  ``f_start`` is window-START frequency;
    returns the same convention.

    ``r_bounds`` (lo, hi) caps every rate candidate: the re-bracketing
    span must not let the polish walk outside the caller's documented
    ``rate0 ± max_rate`` bracket (on a weak emitter the f64 argmax can
    otherwise settle several Hz/s past a sub-Hz/s bracket).
    """
    n = n_c.shape[-1]
    t = np.arange(n, dtype=np.float64) / float(sample_rate)
    half_t = t[-1] * 0.5
    t_c = t - half_t
    z = np.conj(n_c).astype(np.complex128) * g_c.astype(np.complex128)
    f_c = float(f_start) + float(r_hat) * half_t   # mid-window
    r_c = float(r_hat)
    offs = np.linspace(-1.0, 1.0, points)
    t2 = t_c * t_c
    for _ in range(iters):
        f_grid = f_c + offs * f_span
        r_grid = r_c + offs * r_span
        if r_bounds is not None:
            # Clip only the SCORED candidates; the next span derives
            # from the unclipped spacing below — re-bracketing from a
            # clipped grid would collapse the span to ~0 in one
            # iteration whenever the bracket is narrower than the
            # initial span floor, freezing the zoom at coarse
            # resolution.
            r_grid = np.clip(r_grid, r_bounds[0], r_bounds[1])
        zr = z[:, None] * np.exp(-1j * np.pi * r_grid[None, :] * t2[:, None])
        e = np.exp(-2j * np.pi * f_grid[:, None] * t_c[None, :])
        scores = np.abs(e @ zr) ** 2                   # (pf, pr)
        fi, ri = np.unravel_index(int(scores.argmax()), scores.shape)
        f_c = float(f_grid[fi])
        r_c = float(r_grid[ri])
        f_span = 2.0 * (f_grid[1] - f_grid[0])
        r_span = 2.0 * r_span * (offs[1] - offs[0])    # unclipped step
    return f_c - r_c * half_t, r_c


def refine_peak_rate(needle, haystack, freq_hz: float, lag: int,
                     sample_rate, *,
                     rate0_hz_per_s: float = 0.0,
                     max_rate_hz_per_s: Optional[float] = None,
                     coarse_step_hz: Optional[float] = None,
                     backend: Optional[str] = None,
                     points: int = _POINTS, iters: int = 4):
    """Second-order refinement: continuous (freq_hz, rate_hz_per_s,
    lag_samples, value) — estimates a LINEAR frequency sweep alongside
    the offsets.

    A capability past the reference entirely: its CAF model is
    first-order (constant offset), yet its own generator supports
    time-varying offsets via phase integration
    (``utils/generate.py:10-20``) — an emitter with doppler RATE
    (accelerating platforms) smears across the first-order surface.
    The product signal at the coarse lag is
    ``exp(j2pi f t + j pi r t^2)``; a joint geometric zoom over the
    (f, r) plane (dechirp columns x frequency rows, split-complex
    matmuls on static shapes) recovers both, then the fractional-lag
    zoom runs with the full second-order model applied to the needle.

    ``rate0_hz_per_s`` centers the rate bracket (pass the dechirp-bank
    coarse answer, :func:`caf_cookoff_tpu.models.rate.rate_caf_peak`,
    for large sweeps); ``max_rate_hz_per_s`` is its half-width — the
    default is one coarse frequency step of drift over the needle
    duration (the most a sweep can do before a FIRST-order engine's
    peak moves off its bin; chain from the rate bank with half-width =
    one rate-grid step instead).  ``freq_hz`` uses the window-START
    convention throughout.
    Returns ``(freq_hz, rate_hz_per_s, lag_samples, value)``.
    """
    backend = backend or default_backend()
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    n = int(n_re.shape[-1])
    w_re, w_im, start = _extract_window(h_re, h_im, int(lag), n)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    if max_rate_hz_per_s is None:
        duration = n / float(sample_rate)
        max_rate_hz_per_s = step / duration
    f_hat, r_hat, tau_hat, value = _refine_rate_jit(
        jnp.asarray(n_re), jnp.asarray(n_im), jnp.asarray(w_re),
        jnp.asarray(w_im), jnp.asarray(float(freq_hz), n_re.dtype),
        jnp.asarray(float(rate0_hz_per_s), n_re.dtype),
        step, float(max_rate_hz_per_s), float(sample_rate), n,
        backend, int(points), int(iters))
    # f64 host polish: the on-device zoom saturates at the f32 score
    # floor (~2 Hz/s over a 4096-sample window); re-bracket generously
    # around its answer and converge in double precision.
    n_c = np.asarray(n_re, np.float64) + 1j * np.asarray(n_im, np.float64)
    g_c = (np.asarray(w_re[GUARD:GUARD + n], np.float64)
           + 1j * np.asarray(w_im[GUARD:GUARD + n], np.float64))
    # The 4 Hz/s floor exists to out-bracket the device zoom's ~2 Hz/s
    # f32 saturation, but the CANDIDATES stay clipped to the caller's
    # rate0 ± max_rate bracket — a sub-Hz/s bracket must not come back
    # with a rate several Hz/s outside it.
    r_lo = float(rate0_hz_per_s) - float(max_rate_hz_per_s)
    r_hi = float(rate0_hz_per_s) + float(max_rate_hz_per_s)
    f_pol, r_pol = _polish_freq_rate_f64(
        n_c, g_c, sample_rate, float(f_hat), float(r_hat),
        f_span=max(step / 8.0, 0.05),
        r_span=max(float(max_rate_hz_per_s) / 16.0, 4.0),
        r_bounds=(r_lo, r_hi))
    return (f_pol, r_pol, start + float(tau_hat), float(value))


@functools.partial(
    jax.jit,
    static_argnames=("n", "backend", "points", "iters"))
def _refine_batch_jit(ns_re, ns_im, ws_re, ws_im, f0s, coarse_step,
                      sample_rate, n, backend, points, iters):
    return jax.vmap(
        lambda nr, ni, wr, wi, f0: _refine_jit.__wrapped__(
            nr, ni, wr, wi, f0, coarse_step, sample_rate, n,
            backend, points, iters)
    )(ns_re, ns_im, ws_re, ws_im, f0s)


def refine_peaks(needles, haystacks, freqs_hz, lags, sample_rate, *,
                 coarse_step_hz: Optional[float] = None,
                 backend: Optional[str] = None,
                 points: int = _POINTS, iters: int = _ITERS):
    """Batched :func:`refine_peak`: ``(B, N)`` needles, ``(B, L)``
    haystacks, ``(B,)`` coarse answers → ``(freqs (B,), lags (B,),
    values (B,))`` float arrays (lags fractional).

    One vmapped program — the batch engines' post-pass
    (``caf-tpu batch --refine``)."""
    backend = backend or default_backend()
    ns_re, ns_im = splitfft.split_array(np.asarray(needles))
    hs_re, hs_im = splitfft.split_array(np.asarray(haystacks))
    n = int(ns_re.shape[-1])
    # Per-pair window extraction on the host (fixed small jit shapes;
    # negative/short-capture lags zero-fill, never mis-align).
    ws_re, ws_im, starts = [], [], []
    for i, lag in enumerate(np.asarray(lags).astype(np.int64)):
        wr, wi, st = _extract_window(hs_re[i], hs_im[i], int(lag), n)
        ws_re.append(wr)
        ws_im.append(wi)
        starts.append(st)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    f_hat, tau_hat, value = _refine_batch_jit(
        jnp.asarray(ns_re), jnp.asarray(ns_im),
        jnp.asarray(np.stack(ws_re)), jnp.asarray(np.stack(ws_im)),
        jnp.asarray(np.asarray(freqs_hz, ns_re.dtype)), step,
        float(sample_rate), n, backend, int(points), int(iters))
    return (np.asarray(f_hat),
            np.asarray(starts, np.float64) + np.asarray(tau_hat,
                                                        np.float64),
            np.asarray(value))
