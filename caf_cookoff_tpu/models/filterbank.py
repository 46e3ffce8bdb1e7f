"""Filterbank CAF surface engine — the flagship single-chip path.

One jitted XLA program replaces all seven reference parallel strategies
(SURVEY §2.3): the doppler fan-out that the reference spreads over rayon
workers (``caf_rust/src/caf/mod.rs:185``), 400 goroutines
(``caf_go/caf.go:143-160``) or a multiprocessing pool
(``caf_python/caf.py:63-70``) is a batched (K, M) tensor program here —
phasor bank -> batched FFT -> spectral product -> batched IFFT -> fused
magnitude2/argmax — with the haystack FFT hoisted out of the bin loop
(every reference impl recomputes it per bin).

Pipeline (per `caf_rust/src/caf/mod.rs:67-116` semantics):

    needle (N,), haystack (N,)  --pad-->  (M=2N,)
    H = fft(haystack_pad)                          # once
    S_k = fft(needle_pad * exp(j 2 pi f_k n / fs)) # batched over K
    r_k = ifft(H * conj(S_k))                      # batched over K
    surface[k, tau] = |r_k[tau]|^2
    peak = argmax_{k, tau} surface
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import (CafConfig, as_grid, default_backend,
                                    xcor_length)
from caf_cookoff_tpu.ops import fft as fft_ops
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import find_peak_2d, grid_frequency
from caf_cookoff_tpu.ops.shift import phasor_bank
from caf_cookoff_tpu.ops.xcor import pad_to


def _surface_rows(needle: jax.Array, haystack: jax.Array, freqs_hz: jax.Array,
                  sample_rate, xcor_len: int, backend: str = "xla") -> jax.Array:
    """Complex correlation rows (K, M) for one signal pair.

    Complex-dtype convenience over :func:`_surface_rows_split` semantics;
    CPU-side use only (kept for notebook/oracle work — the engines run
    the split path).
    """
    fft_fn, ifft_fn = fft_ops.get_fft(backend)
    real_dtype = jnp.finfo(needle.dtype).dtype
    m = xcor_len
    h_spec = fft_fn(pad_to(haystack, m))
    shifted = pad_to(needle, m)[None, :] * phasor_bank(
        freqs_hz, m, sample_rate, real_dtype)
    s_spec = fft_fn(shifted)
    return ifft_fn(h_spec[None, :] * jnp.conj(s_spec))


def _surface_rows_split(needle, haystack, freqs_hz, sample_rate,
                        xcor_len: int, backend: str = "matmul"):
    """Split-complex correlation rows — the native (complex-free) path.

    Same pipeline as :func:`_surface_rows` (haystack FFT hoisted,
    ``mod.rs:67-116`` operand conventions) but every complex value is a
    (re, im) real pair; the FFT backend is either stacked real
    matmuls ('matmul') or a complex-HLO facade ('xla', cuFFT on the
    GPU) — :mod:`caf_cookoff_tpu.ops.splitfft`.  The phasor bank is
    evaluated only over the N needle samples (the padding region is
    zeros, so shifting it is wasted transcendentals).
    ``needle``/``haystack`` are (re, im) tuples; returns
    (rows_re, rows_im), each (K, M).
    """
    m = xcor_len
    fft_fn, ifft_fn = splitfft.get_split_fft(backend)
    n_re, n_im = needle
    real_dtype = n_re.dtype
    h_spec = fft_fn(splitfft.pad_split(haystack, m))
    rate = (2.0 * jnp.pi) * (freqs_hz.astype(real_dtype)
                             / jnp.asarray(sample_rate, real_dtype))
    phase = rate[:, None] * jnp.arange(n_re.shape[-1], dtype=real_dtype)
    cos, sin = jnp.cos(phase), jnp.sin(phase)
    shifted = splitfft.pad_split(
        (n_re[None, :] * cos - n_im[None, :] * sin,
         n_re[None, :] * sin + n_im[None, :] * cos), m)
    s_spec = fft_fn(shifted)
    prod = splitfft.cmul_conj((h_spec[0][None, :], h_spec[1][None, :]), s_spec)
    return ifft_fn(prod)


@functools.partial(jax.jit, static_argnames=("xcor_len", "backend"))
def _surface_split_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate,
                       xcor_len, backend="matmul"):
    rows = _surface_rows_split((n_re, n_im), (h_re, h_im), freqs_hz,
                               sample_rate, xcor_len, backend)
    return splitfft.mag2(rows)


@functools.partial(jax.jit, static_argnames=("xcor_len", "backend"))
def _peak_split_jit(n_re, n_im, h_re, h_im, freqs_hz, sample_rate, xcor_len,
                    backend="matmul"):
    rows = _surface_rows_split((n_re, n_im), (h_re, h_im), freqs_hz,
                               sample_rate, xcor_len, backend)
    return find_peak_2d(splitfft.mag2(rows))


def _check_pair(needle, haystack):
    if needle.shape[-1] != haystack.shape[-1]:
        raise ValueError(
            f"needle/haystack length mismatch: {needle.shape[-1]} vs "
            f"{haystack.shape[-1]} (truncate the haystack, or use the "
            "overlap_save engine for long captures)")


def _split_inputs(needle, haystack, freqs_hz):
    n_re, n_im = splitfft.split_array(needle)
    h_re, h_im = splitfft.split_array(haystack)
    _check_pair(n_re, h_re)
    return (n_re, n_im, h_re, h_im,
            as_grid(freqs_hz, dtype=n_re.dtype))


def caf_surface(needle, haystack, freqs_hz, sample_rate, *,
                backend: Optional[str] = None) -> jax.Array:
    """Compute the (K, M) magnitude-squared CAF surface.

    Mirrors ``CafSurface::caf_surface`` (``caf_rust/src/caf/mod.rs:26-27``):
    same operand order, same 2N zero-padding, |.|^2 rows (``mod.rs:96``).
    Inputs may be complex (split at this boundary) — device math is
    always split-complex.
    """
    backend = backend or default_backend()
    if backend.startswith("stein"):
        from caf_cookoff_tpu.models.stein import stein_caf_surface

        return stein_caf_surface(needle, haystack, freqs_hz, sample_rate)
    n_re, n_im, h_re, h_im, freqs = _split_inputs(needle, haystack, freqs_hz)
    return _surface_split_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                              float(sample_rate),
                              xcor_length(n_re.shape[-1]), backend)


def find_peak(surface, freqs_hz) -> Tuple[float, int]:
    """(frequency_hz, raw lag index) of the surface peak.

    Matches the Rust trait's default ``find_peak``
    (``caf_rust/src/caf/mod.rs:31-42``): raw peak index IS the lag for the
    reference's positive-lag workload.
    """
    peak = find_peak_2d(jnp.asarray(surface))
    freq = grid_frequency(peak.freq_idx, jnp.asarray(freqs_hz))
    return float(freq), int(peak.lag_idx)


def caf_peak(needle, haystack, freqs_hz, sample_rate, *,
             backend: Optional[str] = None) -> Tuple[float, int, float]:
    """Fused surface+peak: (freq_hz, lag_idx, peak_value).

    Never materializes the surface — the peak-only mode the
    reference lacks (it always keeps full rows, ``mod.rs:17-22``).
    """
    backend = backend or default_backend()
    if backend.startswith("stein"):
        from caf_cookoff_tpu.models.stein import stein_caf_peak

        return stein_caf_peak(needle, haystack, freqs_hz, sample_rate,
                              refine=not backend.endswith("-raw"))
    n_re, n_im, h_re, h_im, freqs = _split_inputs(needle, haystack, freqs_hz)
    peak = _peak_split_jit(n_re, n_im, h_re, h_im, jnp.asarray(freqs),
                           float(sample_rate), xcor_length(n_re.shape[-1]),
                           backend)
    return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


@functools.partial(jax.jit, static_argnames=("xcor_len", "out_len"))
def _amb_surf_jit(needle, haystack, freqs_hz, sample_rate, xcor_len, out_len):
    # Python convention (`caf_python/caf.py:15-18,114-116`): the xcor is
    # correlate(shifted_needle, haystack) — conjugation on the haystack
    # side, opposite of the Rust path — in scipy 'same' layout.
    real_dtype = jnp.finfo(needle.dtype).dtype
    m, n = xcor_len, out_len
    shifted = pad_to(needle, m)[None, :] * phasor_bank(
        freqs_hz, m, sample_rate, real_dtype)
    h_spec = jnp.fft.fft(pad_to(haystack, m))
    rows = jnp.fft.ifft(jnp.fft.fft(shifted, axis=-1) * jnp.conj(h_spec)[None, :],
                        axis=-1)
    lags = (np.arange(n) - n // 2) % m  # 'same' window covers lags i - N//2
    return jnp.abs(rows[..., lags])


def amb_surf(needle, haystack, freqs_hz, samp_rate) -> jax.Array:
    """Python-reference-compatible surface (``caf_python/caf.py:89-117``).

    Returns (K, N) |xcor| rows in scipy ``mode='same'`` layout, so
    ``tau = N//2 - argmax(axis=-1)`` recovers the lag exactly as the Python
    reference's ``__main__`` does (``caf_python/caf.py:144-146``).
    """
    needle = jnp.asarray(needle)
    haystack = jnp.asarray(haystack)
    freqs_hz = jnp.asarray(freqs_hz)
    n = needle.shape[-1]
    return _amb_surf_jit(needle, haystack, freqs_hz, float(samp_rate),
                         xcor_length(n), n)


class FilterbankCAF:
    """Config-bound engine object (the Rust trait-impl analog).

    >>> engine = FilterbankCAF(CafConfig())
    >>> surface = engine.surface(needle, haystack)
    >>> freq, lag = engine.peak(needle, haystack)
    """

    def __init__(self, config: Optional[CafConfig] = None):
        self.config = config or CafConfig()
        self._freqs = jnp.asarray(
            self.config.grid.frequencies(self.config.real_dtype))

    @property
    def frequencies(self) -> jax.Array:
        return self._freqs

    def _cast(self, x) -> np.ndarray:
        # Host-side cast: device placement (and complex→split
        # conversion) happens inside the dispatchers.
        return np.asarray(x, dtype=self.config.complex_dtype)

    def _backend(self) -> str:
        b = self.config.backend
        return default_backend() if b == "auto" else b

    def surface(self, needle, haystack) -> jax.Array:
        return caf_surface(self._cast(needle), self._cast(haystack),
                           self._freqs, self.config.sample_rate,
                           backend=self._backend())

    def peak(self, needle, haystack) -> Tuple[float, int]:
        freq, lag, _ = caf_peak(self._cast(needle), self._cast(haystack),
                                self._freqs, self.config.sample_rate,
                                backend=self._backend())
        return freq, lag
