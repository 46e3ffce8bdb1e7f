"""Split-complex (re, im float32 pairs) DFT and arithmetic.

Every engine carries complex values as ``(re, im)`` pairs of real
arrays.  Two DFT tiers sit behind one facade (:func:`get_split_fft`):
``xla`` (the complex FFT HLO — cuFFT on the GPU) and ``matmul``, a
four-step (Bailey/Cooley-Tukey) DFT whose two butterfly stages are
*stacked real matmuls*:

    [Y_re]   [ F_re  -F_im ] [X_re]
    [Y_im] = [ F_im   F_re ] [X_im]

With N = 8192 = 64 x 128, stage 1 is a single (128, 128) real matmul and
stage 2 a (256, 256) one.  This spends O(N*(N1+N2)) FLOPs instead of
FFTW's O(N log N) (the reference's backend,
``caf_rust/src/caf/xcor_fftw.rs``) at matmul rate.

Index convention (matches :func:`caf_cookoff_tpu.ops.fft.fft_matmul`):
input n = N2*m1 + m2, output k = k1 + N1*k2:

    X[k1 + N1 k2] = sum_m2 W_N^{k1 m2} ( sum_m1 x[N2 m1 + m2] W_N1^{k1 m1} ) W_N2^{k2 m2}
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import is_pow2

SplitComplex = Tuple[jax.Array, jax.Array]

# Matmul precision tiers for the DFT.  'matmul' is an exact tier (it
# computes filterbank surfaces and the rank-then-score re-scores), so it
# runs at HIGHEST: on the GPU, HIGH and DEFAULT f32 matmuls run in TF32
# (~3e-4 relative DFT error; chip_smoke.py's numerics phase prints each
# tier's error against a complex128 DFT), which flips near-tie bins.
# 'matmul-high' / 'matmul-bf16' select the reduced tiers explicitly.
_PRECISIONS = {
    "": jax.lax.Precision.HIGHEST,
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "bf16": jax.lax.Precision.DEFAULT,
}
_PRECISION = jax.lax.Precision.HIGHEST


def factor_two(n: int) -> Tuple[int, int]:
    """n = n1 * n2, factors near sqrt(n); pow2 n gives (2^floor(b/2), ...).

    PRIME ``n`` factors as (1, n): the four-step DFT then degrades to
    one dense O(n^2) matmul — correct, but the (n1+n2) MAC/point
    economy is gone.  Unreachable from the engines (every
    ``xcor_length`` is a power of two); direct ``fft_split`` callers
    with awkward lengths should zero-pad to the next power of two
    instead (warned at the call site).
    """
    if is_pow2(n):
        half = n.bit_length() - 1
        n1 = 1 << (half // 2)
        return n1, n // n1
    best = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            best = d
    return best, n // best


@functools.lru_cache(maxsize=64)
def _dft_constants_np(n: int, forward: bool, dtype_name: str):
    """Host-side stacked butterfly matrices + twiddles (numpy, cached).

    Built in float64 and cast once, so f32 constants carry full-precision
    roundings of the true roots of unity.
    """
    rdtype = np.dtype(dtype_name)
    n1, n2 = factor_two(n)
    if n > 64 and min(n1, n2) == 1:
        import warnings

        warnings.warn(
            f"length {n} has no useful factorization — the four-step "
            f"DFT degrades to one dense O(n^2) matmul (correct but "
            f"slow); zero-pad to {1 << n.bit_length()} instead",
            RuntimeWarning, stacklevel=3)
    sign = -2.0 if forward else 2.0
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    a1 = sign * np.pi * np.outer(k1, k1) / n1
    a2 = sign * np.pi * np.outer(k2, k2) / n2
    at = sign * np.pi * np.outer(k1, k2) / n

    def stacked_left(c, s):
        # [[C, -S], [S, C]] for contraction from the left: Y = FS @ X.
        return np.block([[c, -s], [s, c]]).astype(rdtype)

    def stacked_right(c, s):
        # [[C, S], [-S, C]] for contraction from the right: Y = X @ FS.
        return np.block([[c, s], [-s, c]]).astype(rdtype)

    f1 = stacked_left(np.cos(a1), np.sin(a1))          # (2*n1, 2*n1)
    f2 = stacked_right(np.cos(a2), np.sin(a2))         # (2*n2, 2*n2)
    tw_re = np.cos(at).astype(rdtype)                  # (n1, n2)
    tw_im = np.sin(at).astype(rdtype)
    return n1, n2, f1, f2, tw_re, tw_im


def cmul(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    """(a_re + j a_im) * (b_re + j b_im), elementwise on the VPU."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def cmul_conj(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    """a * conj(b) — the spectral-product step of the xcor
    (``caf_rust/src/caf/xcor_rustfft.rs:51-78`` conjugates operand b)."""
    ar, ai = a
    br, bi = b
    return ar * br + ai * bi, ai * br - ar * bi


def mag2(a: SplitComplex) -> jax.Array:
    ar, ai = a
    return ar * ar + ai * ai


def fft_split(x: SplitComplex, *, forward: bool = True,
              precision=None) -> SplitComplex:
    """Batched DFT over the last axis of a split-complex array.

    Accepts any leading batch dims; the three hot contractions lower to
    matmuls (stage 1 stacked (2n1, 2n1), stage 2 stacked (2n2, 2n2))
    plus an elementwise twiddle multiply.
    """
    precision = _PRECISION if precision is None else precision
    xr, xi = x
    n = xr.shape[-1]
    dtype = xr.dtype
    n1, n2, f1, f2, tw_re, tw_im = _dft_constants_np(
        n, forward, np.dtype(dtype.name).name)
    f1 = jnp.asarray(f1)
    f2 = jnp.asarray(f2)
    tw = (jnp.asarray(tw_re), jnp.asarray(tw_im))

    lead = xr.shape[:-1]
    # [m1, m2] layout; stack re over im along m1 for the left matmul.
    xs = jnp.concatenate(
        [xr.reshape(*lead, n1, n2), xi.reshape(*lead, n1, n2)], axis=-2)
    ys = jnp.einsum("ab,...bc->...ac", f1, xs, precision=precision)
    y = cmul((ys[..., :n1, :], ys[..., n1:, :]), tw)   # twiddle, VPU
    # Stack re beside im along m2 for the right matmul.
    zs = jnp.einsum("...ab,bc->...ac",
                    jnp.concatenate(y, axis=-1), f2, precision=precision)
    zr, zi = zs[..., :n2], zs[..., n2:]
    # Output index k = k1 + N1*k2 → transpose (k1, k2) → (k2, k1), flatten.
    zr = jnp.swapaxes(zr, -1, -2).reshape(*lead, n)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*lead, n)
    if not forward:
        scale = jnp.asarray(1.0 / n, dtype)
        zr = zr * scale
        zi = zi * scale
    return zr, zi


def ifft_split(x: SplitComplex) -> SplitComplex:
    return fft_split(x, forward=False)


def _fft_split_xla(x: SplitComplex, *, forward: bool = True) -> SplitComplex:
    """Split-pair facade over the complex XLA FFT HLO.

    pocketfft-class O(N log N) on the CPU, cuFFT on the GPU.
    """
    c = jax.lax.complex(x[0], x[1])
    r = jnp.fft.fft(c, axis=-1) if forward else jnp.fft.ifft(c, axis=-1)
    return jnp.real(r), jnp.imag(r)


def get_split_fft(backend: str):
    """(fft, ifft) over split pairs for a backend name.

    'matmul[-highest|-high|-bf16]' — stacked-real-matmul four-step DFT
    at the given matmul precision tier (default HIGHEST);
    'xla' — complex XLA FFT HLO behind a split facade.
    """
    if backend == "xla":
        return (functools.partial(_fft_split_xla, forward=True),
                functools.partial(_fft_split_xla, forward=False))
    base, _, tier = backend.partition("-")
    if base == "matmul" and tier in _PRECISIONS:
        prec = _PRECISIONS[tier]
        return (functools.partial(fft_split, forward=True, precision=prec),
                functools.partial(fft_split, forward=False, precision=prec))
    raise ValueError(f"unknown split-FFT backend {backend!r}")


def pad_split(x: SplitComplex, length: int) -> SplitComplex:
    """Zero-pad both planes along the last axis."""
    xr, xi = x
    pad = length - xr.shape[-1]
    if pad < 0:
        raise ValueError(f"cannot pad {xr.shape[-1]} down to {length}")
    if pad == 0:
        return x
    widths = [(0, 0)] * (xr.ndim - 1) + [(0, pad)]
    return jnp.pad(xr, widths), jnp.pad(xi, widths)


def split_array(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side complex → (re, im) float pair (pre-device_put).

    complex64 goes through the native threaded deinterleaver
    (``native/cafio.cpp``) when libcafio is built; other dtypes use
    numpy.
    """
    x = np.asarray(x)
    if x.ndim == 0 or x.shape[-1] == 0:
        # Catch empty signals at the host boundary: downstream the
        # failure mode is a cryptic argmax-of-empty or a silent (0, 0)
        # "peak", neither of which names the actual mistake.
        raise ValueError("empty signal (zero-length last axis)")
    if x.dtype == np.complex64:
        from caf_cookoff_tpu.utils import native

        return native.deinterleave(x)
    if np.iscomplexobj(x):
        rdtype = np.float64 if x.dtype == np.complex128 else np.float32
        return (np.ascontiguousarray(x.real, dtype=rdtype),
                np.ascontiguousarray(x.imag, dtype=rdtype))
    return np.ascontiguousarray(x), np.zeros_like(x)


def merge_split(x: SplitComplex) -> np.ndarray:
    """Host-side (re, im) → complex (for CPU-side verification only)."""
    xr = np.asarray(x[0])
    xi = np.asarray(x[1])
    cdtype = np.complex128 if xr.dtype == np.float64 else np.complex64
    out = np.empty(xr.shape, dtype=cdtype)
    out.real = xr
    out.imag = xi
    return out
