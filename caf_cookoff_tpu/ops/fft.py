"""FFT backends.

The reference races four FFT libraries (FFTW via C, RustFFT, go-dsp,
scipy/pocketfft — SURVEY §2.2). The equivalents here:

* ``xla`` — ``jnp.fft`` lowered to the XLA FFT HLO (cuFFT on the GPU).
  "Plan reuse" (FFTW's ``Flag::MEASURE`` + ``AlignedVec``,
  ``xcor_fftw.rs:29-46``) is subsumed by jit compilation caching the
  tuned executable.
* ``matmul`` — a four-step (Bailey/Cooley-Tukey) decomposition N = N1*N2
  evaluated as two dense DFT matmuls plus a twiddle multiply. It spends
  O(N*(N1+N2)) FLOPs instead of O(N log N), at matmul rate (cf.
  PAPERS.md mixed-radix DFT factorizations).

Both operate on the last axis and accept arbitrary leading batch dims.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def fft_matmul(x: jax.Array, *, forward: bool = True) -> jax.Array:
    """DFT over the last axis via stacked real matmuls (four-step).

    Complex-dtype façade over :mod:`caf_cookoff_tpu.ops.splitfft` — the
    arithmetic is entirely real, with complex only at this API
    boundary.  See splitfft for the index convention.
    """
    from caf_cookoff_tpu.ops.splitfft import fft_split

    re, im = fft_split((jnp.real(x), jnp.imag(x)), forward=forward)
    return jax.lax.complex(re, im)


def _fft_xla(x: jax.Array) -> jax.Array:
    return jnp.fft.fft(x, axis=-1)


def _ifft_xla(x: jax.Array) -> jax.Array:
    return jnp.fft.ifft(x, axis=-1)


def _fft_mm(x: jax.Array) -> jax.Array:
    return fft_matmul(x, forward=True)


def _ifft_mm(x: jax.Array) -> jax.Array:
    return fft_matmul(x, forward=False)


def get_fft(backend: str) -> Tuple[Callable, Callable]:
    """(fft, ifft) pair for a backend name ('xla' | 'matmul')."""
    if backend == "xla":
        return _fft_xla, _ifft_xla
    if backend == "matmul":
        return _fft_mm, _ifft_mm
    raise ValueError(f"unknown FFT backend {backend!r} ('xla' | 'matmul')")
