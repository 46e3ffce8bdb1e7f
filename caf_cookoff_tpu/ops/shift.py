"""Frequency translation (doppler shift) ops.

The reference implements this three ways, all sequential per-sample loops:

* Rust: a recursive phasor accumulator, one complex multiply per sample
  (``caf_rust/src/caf/mod.rs:46-65``) — a serial dependence chain, fast on
  CPU but the opposite of what a vector unit wants;
* Go: per-sample ``cmplx.Exp`` (``caf_go/caf.go:118-126``);
* Python/numba: per-sample ``np.exp`` loop (``caf_python/caf.py:20-33``).

Here the closed form ``x[n] * exp(j*2*pi*f*n/fs)`` is evaluated as one
vectorized expression; a whole *bank* of K shifts is a single (K, N)
broadcasted op that XLA fuses with whatever consumes it. Phase is
accumulated in float64 on host-side grids but evaluated in the compute
dtype; for the reference workload (|f|<=100 Hz, N<=8192, fs=48 kHz) the
maximum phase is ~107 rad, where float32 still resolves ~1e-5 rad.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _phase_ramp(freq_hz, num_samples: int, sample_rate, real_dtype):
    """2*pi*f*n/fs for n in [0, num_samples), shaped (..., num_samples)."""
    n = jnp.arange(num_samples, dtype=real_dtype)
    rate = (2.0 * jnp.pi) * (jnp.asarray(freq_hz, dtype=real_dtype)
                             / jnp.asarray(sample_rate, dtype=real_dtype))
    return rate[..., None] * n if jnp.ndim(rate) else rate * n


def freq_shift(x: jax.Array, freq_hz, sample_rate) -> jax.Array:
    """Return ``x * exp(j*2*pi*freq_hz*n/sample_rate)``.

    Vectorized equivalent of the reference's ``apply_freq_shift``
    (``caf_rust/src/caf/mod.rs:46-65``) / ``apply_fdoa``
    (``caf_python/caf.py:28-33``, ``caf_go/caf.go:118-126``).
    """
    x = jnp.asarray(x)
    real_dtype = jnp.finfo(x.dtype).dtype if jnp.iscomplexobj(x) else x.dtype
    phase = _phase_ramp(freq_hz, x.shape[-1], sample_rate, real_dtype)
    return x * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


# Alias matching the Python reference's name (`caf_python/caf.py:28`).
apply_fdoa = freq_shift


def phasor_bank(freqs_hz: jax.Array, num_samples: int, sample_rate,
                real_dtype=jnp.float32) -> jax.Array:
    """(K, num_samples) complex phasor matrix ``exp(j*2*pi*f_k*n/fs)``.

    This is the dense form of the doppler fan-out: the reference's seven
    parallel strategies (rayon/goroutines/multiprocessing, SURVEY §2.3) all
    reduce to multiplying the needle by one row of this matrix. On the
    device the whole bank is one broadcasted elementwise expression.
    """
    freqs = jnp.asarray(freqs_hz, dtype=real_dtype)
    phase = _phase_ramp(freqs, num_samples, sample_rate, real_dtype)
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def shift_bank(x: jax.Array, freqs_hz: jax.Array, sample_rate) -> jax.Array:
    """Apply every frequency in ``freqs_hz`` to ``x`` at once → (K, N)."""
    x = jnp.asarray(x)
    real_dtype = jnp.finfo(x.dtype).dtype
    return x[None, :] * phasor_bank(freqs_hz, x.shape[-1], sample_rate, real_dtype)
