"""Batched Stein engine — one program for a (P, N) batch of pairs.

BASELINE config 2's workload (64 pairs x 400x8192).  The whole batch
runs through two matmul-shaped stages:

* **Stage A — segment correlations as a direct dot.**  For needle
  blocks of length D, ``G[b, tau] = sum_d conj(n[bD+d]) * h[bD+d+tau]``
  is a D-tap cross-correlation, evaluated directly (D MACs per lag)
  instead of through the single-pair engine's FFTs
  (``models/stein.py``).  Block ``b``'s correlations land at staircase
  column ``b*D + tau`` and the whole stage is one stacked dense
  (2B, 2*D) x (2*D, span) matmul against shifted-haystack Hankel rows.

* **Stage B — synthesis and rank** (:func:`coarse_rank`): the per-block
  staircase is un-sheared into G, the two stacked synthesis matmuls
  give every doppler row, and a |.|^2 / per-bin-max epilogue reduces
  each (pair, bin) to its best lag.

* **Exactness — batched top-k re-score.**  The coarse pass (default
  matmul precision + block-phase approximation) only RANKS bins; the
  top candidates per pair are re-scored with exact filterbank rows
  (vmapped), the same rank-then-score contract as every other engine.

Reference analog: the threadpool strategy saturating all cores on one
surface (``caf_rust/src/caf/mod.rs:388-462``) — here the batch axis is
what fills the device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import (as_grid, default_backend, floor_pow2,
                                    xcor_length)
from caf_cookoff_tpu.errors import EligibilityError, SpanError
from caf_cookoff_tpu.models.filterbank import _surface_rows_split
from caf_cookoff_tpu.models.stein import _auto_block_len
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import (
    CafPeak,
    find_peak_2d,
    merge_peaks,
)
SUPER = 128       # needle padding / haystack-extension quantum
FUSED_TILE = 512  # lag-axis quantum: coarse lag ranges pad to a multiple


def _pow2_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Largest power-of-two block length within the sinc-envelope limit
    (:func:`caf_cookoff_tpu.models.stein._auto_block_len`), capped at
    ``SUPER`` so SUPER-padded needles split into whole blocks."""
    d = floor_pow2(min(_auto_block_len(sample_rate, freqs_hz, requested),
                       SUPER))
    if d < 8:
        raise SpanError("block length below 8 after pow2 rounding")
    return d


def _needle_operator(ns_re, ns_im, d: int):
    """(P, 2B, 2*D) DENSE needle-tap operator for stage A.

    Row layout: rows [0, B) produce Re(G), rows [B, 2B) Im(G); columns
    [0, D) act on shifted-haystack real rows, [D, 2*D) on imaginary
    rows.  Block ``b``'s correlations land at staircase column
    ``b*D + tau`` (the per-block staircase).  Needles must already be
    padded to whole blocks.  Returns ``(lmat, D)`` — the second element
    rides to :func:`coarse_rank`'s ``sup`` argument.
    """
    p, n_pad = ns_re.shape
    b = n_pad // d
    tr = ns_re.reshape(p, b, d)              # Re(conj n) = nr
    ti = (-ns_im).reshape(p, b, d)           # Im(conj n) = -ni
    # G = sum conj(n)*h: Gr = nr.hr + ni.hi = tr.hr + (-ti).hi;
    #                    Gi = nr.hi - ni.hr = ti.hr + tr.hi.
    top = jnp.concatenate([tr, -ti], axis=2)   # (P, B, 2*D) Gr rows
    bot = jnp.concatenate([ti, tr], axis=2)    # Gi rows
    return jnp.concatenate([top, bot], axis=1), d


def _haystack_extension(hs_re, hs_im, m: int, span: int):
    """(P, 2, span+SUPER-1) circularly-extended haystack planes.

    The M-point FFT correlation of the single-pair engine indexes h
    mod M (zeros in [N, M)); staircase column c reads samples
    [c, c+block_len), so the extension tiles the zero-padded period.
    Columns past the masked lag range are never consumed.  (The buffer
    keeps :func:`coarse_rank`'s span+SUPER-1 sizing contract even when
    block_len < SUPER.)
    """
    p, n_h = hs_re.shape
    need = span + SUPER - 1
    reps = -(-need // m)

    def circ(hp):
        base = jnp.concatenate(
            [hp, jnp.zeros((p, m - n_h), hp.dtype)], axis=-1)
        return jnp.tile(base, (1, reps))[:, :need]

    return jnp.stack([circ(hs_re), circ(hs_im)], axis=1)


_BIG_IDX = np.int32(2 ** 30)


def fused_span(num_blocks: int, sup: int, num_lags: int,
               a_chunks: int = 4) -> int:
    """Column span of the per-block staircase layout (block ``b`` at
    column ``b*sup``), padded to whole ``a_chunks * SUPER`` quanta:
    callers size the haystack extension to ``span + SUPER - 1``
    samples."""
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    span = (num_blocks - 1) * sup + m_pad
    quantum = a_chunks * SUPER
    return -(-span // quantum) * quantum


def stein_synthesis_weights(freqs_hz, sample_rate, num_blocks: int,
                            block_len: int):
    """(ws1, ws2) = ([Wr | -Wi], [Wi | Wr]) for :func:`coarse_rank`."""
    centers = jnp.asarray(
        np.arange(num_blocks) * block_len + (block_len - 1) / 2.0,
        jnp.float32)
    w = ((-2.0 * jnp.pi) / jnp.float32(sample_rate)) * jnp.outer(
        jnp.asarray(freqs_hz, jnp.float32), centers)
    wr, wi = jnp.cos(w), jnp.sin(w)
    return (jnp.concatenate([wr, -wi], axis=1),
            jnp.concatenate([wi, wr], axis=1))


def stein_rate_synthesis_weights(freqs_hz, rates_hz_per_s, sample_rate,
                                 num_blocks: int, block_len: int):
    """(ws1, ws2) with the RATE axis folded into synthesis rows.

    The dechirp quadratic phase ``pi*r*(t/fs)^2`` is block-center
    constant to the same tolerance as the doppler phase (its
    within-block drift is a frequency of ``r * t_b / fs`` Hz — callers
    must fold ``|r|_max * T`` into the block-length envelope), so a
    trial rate is just a different phase at each block center:

        w[i*K + k, b] = -(2*pi*f_k*t_b + pi*r_i*t_b^2),  t_b in seconds

    (rate-major rows).  Stage A (the segment correlations) is shared by
    EVERY (rate, doppler) pair — the rate axis costs synthesis rows,
    not transforms.
    """
    tb = jnp.asarray(
        np.arange(num_blocks) * block_len + (block_len - 1) / 2.0,
        jnp.float32) / jnp.asarray(sample_rate, jnp.float32)
    f = jnp.asarray(freqs_hz, jnp.float32)
    r = jnp.asarray(rates_hz_per_s, jnp.float32)
    w = -(2.0 * jnp.pi) * (f[None, :, None] * tb[None, None, :]) \
        - jnp.pi * (r[:, None, None] * (tb * tb)[None, None, :])
    w = w.reshape(-1, tb.shape[0])              # (R*K, B) rate-major
    wr, wi = jnp.cos(w), jnp.sin(w)
    return (jnp.concatenate([wr, -wi], axis=1),
            jnp.concatenate([wi, wr], axis=1))


def coarse_rank(ws1, ws2, lmat, h_ext, num_blocks: int, sup: int,
                num_lags: int, *, windows: int = 1, share_h: int = 1,
                num_valid=None, want_top2: bool = False, sep: int = 0):
    """Per-(bin, program) coarse (max |R|^2, arg lag) of the Stein
    coarse stage: stage A as a direct dot against shifted-haystack
    Hankel rows, per-block staircase extraction, the two stacked
    synthesis matmuls, and the |.|^2 / per-bin max epilogue.

    ``lmat``: (P*S, 2B, 2*sup) needle-tap operators (see
    :func:`_needle_operator`); ``h_ext``: (P*W, 2, span+SUPER-1)
    haystack extensions; ``ws1``/``ws2``: (K, 2B) synthesis weights.
    Returns ``(vals, idxs)``, each (K, P_eff) with ``P_eff = P*S*W``.

    Programs run band-major, ``i = ((pair*S + band)*W + w)`` with
    ``S = share_h`` and ``W = windows``: program ``i`` pairs operator
    ``lmat[i // W]`` with haystack slice ``h_ext[(i // (S*W))*W + i %
    W]``.  ``windows > 1`` is the long-capture mode (each pair's
    overlap-save lag windows share its operator; lag indices are
    window-local); ``share_h > 1`` the banded mode (each pair's bands
    share its haystack slices).  The Hankel rows are built once per
    haystack slice and contracted against every band's operator.

    ``num_valid`` (optional (P_eff,) int32) bounds the scanned lag
    range per program: the per-bin (max, argmax) cannot be masked
    afterwards without dropping a bin's in-range peak along with an
    out-of-range shadow.

    ``want_top2=True`` returns ``(vals, idxs, vals2, idxs2)``: slot 2
    is the bin's strongest lag more than ``sep`` samples from slot 1's
    (value ``-1.0`` when none exists), taken over the whole lag range —
    so two same-bin emitters more than ``sep`` apart both survive.

    Operands are float32 at the default matmul precision: this stage
    only RANKS bins, and every engine re-scores its top candidates
    exactly (rank-then-score).
    """
    p_eff = lmat.shape[0] * windows
    if p_eff != h_ext.shape[0] * share_h:
        raise ValueError(
            f"{lmat.shape[0]} operators x {windows} windows != "
            f"{h_ext.shape[0]} h_ext slices x {share_h} bands")
    if lmat.shape[2] != 2 * sup:
        raise ValueError(
            f"operator width {lmat.shape[2]} != 2*block_len {2 * sup}")
    span = fused_span(num_blocks, sup, num_lags)
    if h_ext.shape[1:] != (2, span + SUPER - 1):
        raise ValueError(f"h_ext shape {h_ext.shape} != "
                         f"(*, 2, {span + SUPER - 1})")
    pairs = h_ext.shape[0] // windows
    b = num_blocks
    hank = jnp.concatenate([
        jnp.stack([h_ext[:, c, e:e + span] for e in range(sup)], axis=1)
        for c in range(2)], axis=1)                   # (P*W, 2*sup, span)
    hank = hank.reshape(pairs, windows, 2 * sup, span)
    lm = lmat.reshape(pairs, share_h, 2 * b, 2 * sup)
    co = jnp.einsum("pjbe,pwec->pjwbc", lm, hank).reshape(
        p_eff, 2 * b, span)                           # (P_eff, 2B, span)
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    g_top = jnp.stack(
        [co[:, blk, blk * sup:blk * sup + m_pad] for blk in range(b)],
        axis=1)
    g_bot = jnp.stack(
        [co[:, b + blk, blk * sup:blk * sup + m_pad] for blk in range(b)],
        axis=1)
    g = jnp.concatenate([g_top, g_bot], axis=1)       # (P_eff, 2B, m_pad)
    rr = jnp.einsum("kb,pbm->pkm", ws1, g)
    ri = jnp.einsum("kb,pbm->pkm", ws2, g)
    mag2 = rr * rr + ri * ri
    if num_valid is None:
        bound = num_lags
    else:
        num_valid = jnp.asarray(num_valid, jnp.int32)
        if num_valid.shape != (p_eff,):
            raise ValueError(
                f"num_valid shape {num_valid.shape} != ({p_eff},)")
        bound = num_valid[:, None, None]
    mag2 = jnp.where(jnp.arange(m_pad)[None, None, :] < bound,
                     mag2, -1.0)
    if want_top2:
        lag = jnp.arange(m_pad, dtype=jnp.int32)
        m1 = jnp.max(mag2, axis=-1, keepdims=True)
        a1 = jnp.min(jnp.where(mag2 >= m1, lag, _BIG_IDX), axis=-1,
                     keepdims=True)
        masked = jnp.where(jnp.abs(lag - a1) <= sep, -1.0, mag2)
        m2 = jnp.max(masked, axis=-1, keepdims=True)
        a2 = jnp.min(jnp.where(masked >= m2, lag, _BIG_IDX), axis=-1,
                     keepdims=True)
        a1 = jnp.where(a1 == _BIG_IDX, 0, a1)
        a2 = jnp.where(a2 == _BIG_IDX, 0, a2)
        return (m1[..., 0].T, a1[..., 0].T.astype(jnp.int32),
                m2[..., 0].T, a2[..., 0].T.astype(jnp.int32))
    vals = jnp.max(mag2, axis=-1)                     # (P_eff, K)
    idxs = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    return vals.T, idxs.T


def _batched_stein_core(ns_re, ns_im, hs_re, hs_im, freqs_hz,
                        sample_rate, xcor_len, block_len, backend,
                        refine: bool):
    """Traceable batch pipeline (also the ``shard_map`` body of
    :func:`caf_cookoff_tpu.parallel.sharded_batched_stein_peak`)."""

    b = ns_re.shape[-1] // block_len
    lmat, group = _needle_operator(ns_re, ns_im, block_len)
    span = fused_span(b, group, xcor_len)
    h_ext = _haystack_extension(hs_re, hs_im, xcor_len, span)
    ws1, ws2 = stein_synthesis_weights(freqs_hz, sample_rate, b, block_len)
    vals, idxs = coarse_rank(ws1, ws2, lmat, h_ext, b, group,
                             xcor_len)                        # (K, P)
    vals_t = vals.T                                          # (P, K)
    if not refine:
        best = jnp.argmax(vals_t, axis=1)                    # (P,)
        take = lambda a: jnp.take_along_axis(
            a.T, best[:, None], axis=1)[:, 0]
        return CafPeak(value=take(vals),
                       freq_idx=best.astype(jnp.int32),
                       lag_idx=take(idxs).astype(jnp.int32))

    return _batched_refine(ns_re, ns_im, hs_re, hs_im, freqs_hz, vals_t,
                           sample_rate, xcor_len, backend)


def _batched_refine(ns_re, ns_im, hs_re, hs_im, freqs_all, vals_t,
                    sample_rate, xcor_len: int, backend: str,
                    num_valid=None) -> CafPeak:
    """Per-pair exact re-score of a (P, K) coarse ranking — shared by
    the plain and banded batch paths.  ``num_valid`` caps the candidate
    count so -inf padded bins never enter the re-score.  Candidates are
    the hybrid plain/mainlobe-separated set (``_refine_candidates``),
    so fine grids cover distinct lobes, not one skirt."""
    from caf_cookoff_tpu.models.stein import _refine_candidates

    cand = _refine_candidates(vals_t, freqs_all, ns_re.shape[-1],
                              sample_rate, num_valid)        # (P, r)

    def rescore(nr, ni, hr, hi, fsel):
        exact = splitfft.mag2(_surface_rows_split(
            (nr, ni), (hr, hi), fsel, sample_rate, xcor_len, backend))
        rowmax = jnp.max(exact, axis=-1)                     # (r,)
        return rowmax, jnp.argmax(exact, axis=-1).astype(jnp.int32)

    rowmax, lags = jax.vmap(rescore)(
        ns_re, ns_im, hs_re, hs_im, freqs_all[cand])         # (P, r) each

    def pick(rm, cd, lg):
        best = jnp.lexsort((cd.astype(jnp.int32), -rm))[0]
        return CafPeak(value=rm[best],
                       freq_idx=cd[best].astype(jnp.int32),
                       lag_idx=lg[best])

    return jax.vmap(pick)(rowmax, cand, lags)


_batched_stein_peak_jit = functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "refine")
)(_batched_stein_core)


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "num_bins"))
def _banded_batched_jit(ns_re, ns_im, hs_re, hs_im, freqs_pad, centers,
                        rel, sample_rate, xcor_len, block_len, backend,
                        num_bins):
    """Wide-span batch: (pair, band) as the coarse stage's batch axis.

    Same construction as the single-pair banded path
    (models/stein.py:_banded_stein_peak_jit) with every pair's needle
    shifted to every band center; the exact per-pair re-score runs on
    absolute frequencies with the unshifted needles.
    """

    p = ns_re.shape[0]
    s = centers.shape[0]
    sr, si = _shift_to_centers(ns_re, ns_im, centers, sample_rate)
    b = sr.shape[-1] // block_len
    lmat, group = _needle_operator(sr, si, block_len)
    span = fused_span(b, group, xcor_len)
    # ONE extension per pair: coarse_rank's share_h mode hands the
    # same slice to all of a pair's band programs (no x S copies).
    h_ext = _haystack_extension(hs_re, hs_im, xcor_len, span)
    ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b, block_len)
    vals, _ = coarse_rank(ws1, ws2, lmat, h_ext, b, group, xcor_len,
                          share_h=s)                        # (Kb, P*S)
    kb = rel.shape[0]
    flat = vals.T.reshape(p, s * kb)                # bin = s_idx*Kb + j
    flat = jnp.where(jnp.arange(s * kb)[None, :] < num_bins, flat,
                     -jnp.inf)
    return _batched_refine(ns_re, ns_im, hs_re, hs_im, freqs_pad, flat,
                           sample_rate, xcor_len, backend,
                           num_valid=num_bins)


def _shift_to_centers(ns_re, ns_im, centers, sample_rate):
    """(P*S, N_pad) needle planes shifted to every band center (exact —
    shift composition), padded to whole SUPER tiles, band-major."""
    p, n = ns_re.shape
    s = centers.shape[0]
    t = jnp.arange(n, dtype=ns_re.dtype)
    ph = ((2.0 * jnp.pi) / jnp.asarray(sample_rate, ns_re.dtype)
          ) * centers[None, :, None] * t[None, None, :]      # (1, S, n)
    cs, sn = jnp.cos(ph), jnp.sin(ph)
    sr = (ns_re[:, None, :] * cs - ns_im[:, None, :] * sn).reshape(
        p * s, n)
    si = (ns_re[:, None, :] * sn + ns_im[:, None, :] * cs).reshape(
        p * s, n)
    pad = (-n) % SUPER
    if pad:
        sr = jnp.pad(sr, ((0, 0), (0, pad)))
        si = jnp.pad(si, ((0, 0), (0, pad)))
    return sr, si


# Device bytes one step of the windowed coarse stage may hold (the
# Hankel rows, segment correlations and synthesis rows of a group of
# lag windows).  Groups run one after another, so an engine's memory is
# bounded whatever the capture length.
WINDOW_GROUP_BYTES = 1 << 30


def window_group(pairs: int, share_h: int, rows: int, num_blocks: int,
                 sup: int, v: int, windows: int) -> int:
    """Lag windows per step of :func:`windowed_coarse_rank`: at most as
    many as fit :data:`WINDOW_GROUP_BYTES` (at least one), spread evenly
    over the fewest steps so the last step pads as few windows as
    possible.

    Per window and pair: the Hankel rows (2*sup, span), and per band
    the segment correlations (2B rows, twice) and the two synthesis row
    blocks (``rows`` each) over the padded lag tile, in float32."""
    span = fused_span(num_blocks, sup, v)
    m_pad = -(-v // FUSED_TILE) * FUSED_TILE
    per_window = 4 * pairs * (
        share_h * (2 * rows + 4 * num_blocks) * m_pad + 2 * sup * span)
    most = max(1, min(windows, WINDOW_GROUP_BYTES // per_window))
    steps = -(-windows // most)
    return -(-windows // steps)


def windowed_coarse_rank(ws1, ws2, lmat, hs_re, hs_im, num_blocks: int,
                         sup: int, v: int, windows: int, total_lags: int,
                         *, first_window=0, global_windows=None,
                         share_h: int = 1, want_top2: bool = False,
                         sep: int = 0):
    """:func:`coarse_rank` over ``windows`` overlap-save lag windows of
    (P, L) captures, a bounded group of windows per ``lax.map`` step.

    Window ``w`` covers capture lags ``[(first_window + w) * v, ... + v)``
    (``first_window`` may be traced: a mesh shard's offset); its Hankel
    rows read the raw capture from that lag on (overlap-save's implicit
    halo), zero-padded past the capture's end, and lags at or past
    ``total_lags`` are masked.  ``global_windows`` (default
    ``windows``) is the window count of the whole capture, which sizes
    that padding.  Returns what :func:`coarse_rank` returns with
    ``windows=windows``: (K, P*S*W) arrays in program order
    ``(pair*S + band)*W + w``, lags window-local.
    """
    pairs = hs_re.shape[0]
    rows = ws1.shape[0]
    grp = window_group(pairs, share_h, rows, num_blocks, sup, v, windows)
    groups = -(-windows // grp)
    win_len = fused_span(num_blocks, sup, v) + SUPER - 1
    if global_windows is None:
        global_windows = windows
    need = (global_windows + groups * grp - windows - 1) * v + win_len
    hp = jnp.stack([hs_re, hs_im], axis=1)            # (P, 2, L)
    if need > hp.shape[-1]:
        hp = jnp.pad(hp, ((0, 0), (0, 0), (0, need - hp.shape[-1])))

    def step(g):
        w0 = first_window + g * grp
        h_ext = jnp.stack(
            [jax.lax.dynamic_slice_in_dim(hp, (w0 + j) * v, win_len, axis=2)
             for j in range(grp)], axis=1).reshape(pairs * grp, 2, win_len)
        per_w = jnp.clip(
            total_lags - (w0 + jnp.arange(grp, dtype=jnp.int32)) * v, 0, v)
        return coarse_rank(ws1, ws2, lmat, h_ext, num_blocks, sup, v,
                           windows=grp, share_h=share_h,
                           num_valid=jnp.tile(per_w, pairs * share_h),
                           want_top2=want_top2, sep=sep)

    outs = jax.lax.map(step, jnp.arange(groups, dtype=jnp.int32))
    progs = pairs * share_h

    def merge(a):                                     # (G, K, progs*grp)
        a = a.reshape(groups, rows, progs, grp).transpose(1, 2, 0, 3)
        return a.reshape(rows, progs, groups * grp)[..., :windows].reshape(
            rows, progs * windows)

    return tuple(merge(a) for a in outs)


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "windows",
                     "total_lags", "needle_len"))
def _batched_stein_os_jit(ns_re, ns_im, hs_re, hs_im, freqs_hz,
                          sample_rate, xcor_len, block_len, backend,
                          windows: int, total_lags: int,
                          needle_len: int):
    """Coarse windowed scan + on-device top-k exact refinement."""

    p = ns_re.shape[0]
    b = ns_re.shape[-1] // block_len
    v = xcor_len                      # lags per window
    lmat, group = _needle_operator(ns_re, ns_im, block_len)
    ws1, ws2 = stein_synthesis_weights(freqs_hz, sample_rate, b,
                                       block_len)
    # The final window's range may end mid-window (num_lags cap): real
    # capture samples past it must not shadow in-range peaks
    # (windowed_coarse_rank bounds every window's scanned lags).
    vals, idxs = windowed_coarse_rank(ws1, ws2, lmat, hs_re, hs_im, b,
                                      group, v, windows, total_lags)
    k = freqs_hz.shape[0]
    vals = vals.reshape(k, p, windows)
    idxs = idxs.reshape(k, p, windows)
    glob = idxs + jnp.arange(windows, dtype=jnp.int32) * v
    valid = glob < total_lags
    vals = jnp.where(valid, vals, -1.0)
    # Per (bin, pair): best window -> per-pair coarse ranking over bins.
    wbest = jnp.argmax(vals, axis=-1)                    # (K, P)
    take_w = lambda a: jnp.take_along_axis(
        a, wbest[..., None], axis=-1)[..., 0]
    rowmax = take_w(vals).T                              # (P, K)
    rowlag = take_w(glob).T                              # (P, K)
    return _os_topk_refine(ns_re, ns_im, hs_re, hs_im, freqs_hz,
                           rowmax, rowlag, sample_rate, xcor_len,
                           backend, total_lags, needle_len)


def _os_topk_refine(ns_re, ns_im, hs_re, hs_im, freqs_all, rowmax,
                    rowlag, sample_rate, xcor_len: int, backend,
                    total_lags: int, needle_len: int,
                    num_valid_bins=None) -> CafPeak:
    """Windowed-coarse closer: per-pair top-k exact re-score of a
    (P, K) ranking whose per-bin best lags are ``rowlag``.

    Exact re-score happens on a guard-extended capture slice around
    each pair's coarse winning lag (the stein_overlap_save_peak refine
    contract), on-device via dynamic_slice — no host round-trip.
    ``num_valid_bins`` caps the candidate count when the ranking
    carries -inf padded bins (banded grids).  Candidates are the hybrid
    plain/mainlobe-separated set (``_refine_candidates``).
    """
    from caf_cookoff_tpu.models.stein import _refine_candidates

    cand = _refine_candidates(rowmax, freqs_all, needle_len,
                              sample_rate, num_valid_bins)   # (P, r)
    best_bin = jnp.argmax(rowmax, axis=-1)               # (P,)
    best_lag = jnp.take_along_axis(rowlag, best_bin[:, None],
                                   axis=1)[:, 0]         # (P,)
    # Slice a guard-extended window (based on the ORIGINAL needle
    # length — ns planes may carry SUPER padding): the winning local
    # lag (~``guard``) then correlates every needle sample against
    # real data; an n-sample window would truncate the last ``guard``
    # products to zeros and bias the reported value low.  The near-tie
    # guard must stay well under the needle length or the window
    # shifts off the emitter entirely.
    n = needle_len
    hay_len = hs_re.shape[-1]
    guard = min(64, n // 4, max((hay_len - n) // 2, 0))
    win = n + 2 * guard
    start = jnp.clip(best_lag - guard, 0, max(hay_len - win, 0))
    # Only local lags with full correlation energy may win, and the
    # absolute lag must stay inside the requested range.
    local = jnp.arange(xcor_len, dtype=jnp.int32)

    def rescore(nr, ni, hr, hi, s, fsel):
        wr = jax.lax.dynamic_slice(hr, (s,), (win,))
        wi = jax.lax.dynamic_slice(hi, (s,), (win,))
        exact = splitfft.mag2(_surface_rows_split(
            (nr, ni), (wr, wi), fsel, sample_rate, xcor_len, backend))
        ok = (local <= 2 * guard) & (s + local < total_lags)
        exact = jnp.where(ok[None, :], exact, -1.0)
        return jnp.max(exact, axis=-1), jnp.argmax(
            exact, axis=-1).astype(jnp.int32)

    rowmax_e, lag_e = jax.vmap(rescore)(
        ns_re, ns_im, hs_re, hs_im, start, freqs_all[cand])  # (P, r)

    def pick(rm, cd, lg, s):
        best = jnp.lexsort((cd.astype(jnp.int32), -rm))[0]
        return CafPeak(value=rm[best],
                       freq_idx=cd[best].astype(jnp.int32),
                       lag_idx=(s + lg[best]).astype(jnp.int32))

    return jax.vmap(pick)(rowmax_e, cand, lag_e, start)


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "windows",
                     "total_lags", "needle_len", "num_bins"))
def _banded_stein_os_jit(ns_re, ns_im, hs_re, hs_im, freqs_pad, centers,
                         rel, sample_rate, xcor_len, block_len, backend,
                         windows: int, total_lags: int, needle_len: int,
                         num_bins: int):
    """Banded long-capture coarse scan: (pair, band, window) programs.

    The windows x share_h composition of :func:`coarse_rank`: each pair
    contributes one needle operator per band (needle shifted to the
    band center) and one haystack extension per overlap-save window —
    S*W programs per pair.  For
    fine uniform grids this beats the unbanded windowed engine by
    design: the block length rises from the envelope-limited
    ``fs/(4*f_max)`` to ``min(128, sqrt(fs/2g))`` (see
    models/stein._plan_bands), cutting the dominant synthesis term
    K*B*M by the same factor.  Exact per-pair re-score on absolute
    frequencies with the unshifted needles.
    """

    p = ns_re.shape[0]
    s = centers.shape[0]
    v = xcor_len
    sr, si = _shift_to_centers(ns_re, ns_im, centers, sample_rate)
    b = sr.shape[-1] // block_len
    lmat, sup = _needle_operator(sr, si, block_len)
    ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b, block_len)
    vals, idxs = windowed_coarse_rank(ws1, ws2, lmat, hs_re, hs_im, b,
                                      sup, v, windows, total_lags,
                                      share_h=s)
    kb = rel.shape[0]
    vals = vals.reshape(kb, p, s, windows)
    idxs = idxs.reshape(kb, p, s, windows)
    glob = idxs + jnp.arange(windows, dtype=jnp.int32) * v
    vals = jnp.where(glob < total_lags, vals, -1.0)
    wbest = jnp.argmax(vals, axis=-1)                    # (Kb, P, S)
    take_w = lambda a: jnp.take_along_axis(
        a, wbest[..., None], axis=-1)[..., 0]
    # Global bin = band*Kb + j (freqs_pad's ascending lattice).
    rowmax = take_w(vals).transpose(1, 2, 0).reshape(p, s * kb)
    rowlag = take_w(glob).transpose(1, 2, 0).reshape(p, s * kb)
    rowmax = jnp.where(jnp.arange(s * kb)[None, :] < num_bins, rowmax,
                       -jnp.inf)
    return _os_topk_refine(ns_re, ns_im, hs_re, hs_im, freqs_pad,
                           rowmax, rowlag, sample_rate, xcor_len,
                           backend, total_lags, needle_len,
                           num_valid_bins=num_bins)


def batched_stein_os_peak(needles, haystacks, freqs_hz, sample_rate, *,
                          num_lags: Optional[int] = None,
                          block_len: int = 64,
                          backend: Optional[str] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Long-capture per-pair peaks: (freqs (P,), lags (P,), values (P,)).

    BASELINE config 4's workload (16 pairs x 1024 bins x 32768 lags):
    each pair's lag axis splits into M-lag overlap-save windows and
    every (pair, window) is one program of the coarse stage — the
    batch and window axes together fill the device.  Coarse ranking is
    window-global; the
    exact top-k re-score happens on a guard-extended slice at the
    coarse winning lag (the :func:`stein_overlap_save_peak` refine
    contract).

    Uniform grids route through the BANDED windowed engine
    (``_banded_stein_os_jit``) whenever the band plan's modeled cost —
    ``s + K_pad/D_band`` vs ``1 + K/D_plain`` MACs per lag column, in
    units of 4N — wins, which covers both wide spans the single-band
    envelope cannot take at all and fine grids where banding lifts the
    block length toward 128 and slashes the dominant synthesis term.
    """
    from caf_cookoff_tpu.models.stein import _band_routing

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.ndim != 2 \
            or needles.shape[0] != haystacks.shape[0]:
        raise ValueError(
            f"need (P, N) needles and (P, L) haystacks, got "
            f"{needles.shape} vs {haystacks.shape}")
    n = needles.shape[-1]
    if haystacks.shape[-1] <= n:
        raise ValueError("use batched_stein_peak for equal-length pairs")
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        d = None                     # span needs banding (or raises below)
    use_banded, d, freqs_pad, centers, rel = _band_routing(
        sample_rate, freqs, d)
    if d is None:
        _pow2_block_len(sample_rate, freqs, block_len)   # re-raise
    m = xcor_length(n)
    total_lags = num_lags or haystacks.shape[-1] - n + 1
    windows = -(-total_lags // m)
    if use_banded:
        peak = _banded_stein_os_jit(
            jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
            jnp.asarray(hs_im), jnp.asarray(freqs_pad),
            jnp.asarray(centers), jnp.asarray(rel),
            float(sample_rate), m, d, backend, windows,
            total_lags, n, len(freqs))
        return (freqs_pad[np.asarray(peak.freq_idx)],
                np.asarray(peak.lag_idx), np.asarray(peak.value))
    pad = (-n) % SUPER
    if pad:
        ns_re = np.pad(ns_re, ((0, 0), (0, pad)))
        ns_im = np.pad(ns_im, ((0, 0), (0, pad)))
    peak = _batched_stein_os_jit(
        jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
        jnp.asarray(hs_im), jnp.asarray(freqs), float(sample_rate), m, d,
        backend, windows, total_lags, n)
    return (freqs[np.asarray(peak.freq_idx)], np.asarray(peak.lag_idx),
            np.asarray(peak.value))


def batched_stein_peak(needles, haystacks, freqs_hz, sample_rate, *,
                       block_len: int = 64, refine: bool = True,
                       backend: Optional[str] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair peaks for a (P, N) batch: (freqs (P,), lags (P,), values).

    The config-2 path: one stage-A dot, one synthesis + rank and one
    batched re-score for the whole batch.  Bin-exact (same answers as
    :func:`caf_cookoff_tpu.models.stein.stein_caf_peak` per pair).
    """
    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.shape != needles.shape:
        raise ValueError(
            f"need matching (P, N) batches, got {needles.shape} vs "
            f"{haystacks.shape}")
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    n = ns_re.shape[-1]
    m = xcor_length(n)
    if m % FUSED_TILE:
        raise EligibilityError(
            f"xcor length {m} not a multiple of {FUSED_TILE}")
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        # Wide-span batch: band the grid, (pair, band) as the batch
        # axis — same construction as the single-pair banded path.
        from caf_cookoff_tpu.models.stein import _plan_bands

        plan = _plan_bands(sample_rate, freqs) if refine else None
        if plan is None:
            raise
        peak = _banded_batched_jit(
            jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
            jnp.asarray(hs_im), jnp.asarray(plan["freqs_pad"]),
            jnp.asarray(plan["centers"]), jnp.asarray(plan["rel"]),
            float(sample_rate), m, plan["block_len"], backend,
            len(freqs))
        return (plan["freqs_pad"][np.asarray(peak.freq_idx)],
                np.asarray(peak.lag_idx), np.asarray(peak.value))
    # Pad the NEEDLE to whole super-blocks (appended zero blocks add
    # nothing to any correlation); the haystack and M are untouched, so
    # lag semantics match the single-pair engine exactly.
    pad = (-n) % SUPER
    if pad:
        ns_re = np.pad(ns_re, ((0, 0), (0, pad)))
        ns_im = np.pad(ns_im, ((0, 0), (0, pad)))
    peak = _batched_stein_peak_jit(
        jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
        jnp.asarray(hs_im), jnp.asarray(freqs), float(sample_rate), m, d,
        backend, refine)
    return (freqs[np.asarray(peak.freq_idx)], np.asarray(peak.lag_idx),
            np.asarray(peak.value))


# ---------------------------------------------------------------------------
# Multi-emitter lattices through the coarse stage
# ---------------------------------------------------------------------------
#
# The coarse stage's top-2-separated epilogue (``want_top2`` — two
# ``> exclude_lag``-separated lag candidates per doppler bin per
# program) feeds an NMS lattice, so BASELINE config 4/5's
# "streaming multi-emitter" workload runs through the segmented engine
# instead of the filterbank lattice scan (``parallel/sharded.
# _batched_os_peaks_jit``).  Coarse lattice entries are then re-scored
# EXACTLY on a guard-extended capture window around each entry's lag
# (per-entry rank-then-score — the same contract as the stein stream's
# carried windows, ``models/streaming.py``), and the lattice re-sorts
# and re-dedups on the exact values.
#
# Exactness contract (same as the stein stream): exact for emitters in
# distinct doppler bins, and for same-bin pairs separated by more than
# ``exclude_lag`` samples (the top-2 is taken over the whole lag
# range).  3+ same-bin emitters in one window need the filterbank
# lattice engines.  The reference has only a global argmax
# (``caf_rust/src/caf/mod.rs:31-42``).


def _lattice_from_bin_candidates(vals_j, lags_j, num_peaks: int,
                                 exclude_freq: int, exclude_lag: int,
                                 bin_offset=0,
                                 num_bins: Optional[int] = None,
                                 lag_period: Optional[int] = None):
    """NMS lattice from per-bin candidate slots.

    ``vals_j``/``lags_j``: (K, J) per-bin candidates (J slots per bin —
    the coarse top-2, possibly stacked over windows).  Negative
    values are sentinels (no separated second / fully-masked
    program) and become ``-inf`` so they can neither win nor suppress.
    ``bin_offset``/``num_bins``: banded grids report GLOBAL bins
    ``offset + row`` on the ascending ``freqs_pad`` lattice, with pad
    rows past ``num_bins`` masked out.
    """
    k, j = vals_j.shape
    rows = bin_offset + jnp.arange(k, dtype=jnp.int32)
    bins = jnp.broadcast_to(rows[:, None], (k, j))
    v = jnp.where(vals_j < 0, -jnp.inf, vals_j)
    if num_bins is not None:
        v = jnp.where(bins < num_bins, v, -jnp.inf)
    cands = CafPeak(v.reshape(-1), bins.reshape(-1),
                    lags_j.reshape(-1).astype(jnp.int32))
    return merge_peaks(cands, num_peaks, exclude_freq, exclude_lag,
                       lag_period=lag_period)


def _entry_candidate_bins(vals_flat, lags_flat, lag_e, bin_e,
                          exclude_lag: int, exclude_freq: int,
                          num_bins: int,
                          lag_period: Optional[int] = None):
    """Exact-re-score candidate bins for ONE lattice entry.

    ``vals_flat``/``lags_flat``: (K, J) coarse per-bin candidates with
    lags in the entry's lag coordinates.  The ranking is DOUBLY
    restricted — to candidates within one lag exclusion cell of the
    entry's lag AND to bins within one freq exclusion cell of the
    entry's OWN coarse bin: the coarse bin sits on this emitter's
    mainlobe (bf16/block-phase perturbation moves it at most within the
    cell), and without the freq restriction a same-lag STRONGER emitter
    farther away in frequency would capture the re-score argmax and
    collapse this entry onto it (the post-re-score NMS then dedups
    them, silently dropping a real emitter).  Anything outside the cell
    is by definition a different detection.  Top-``_REFINE_BINS`` of
    the masked ranking.
    """
    from caf_cookoff_tpu.models.stein import _REFINE_BINS

    from caf_cookoff_tpu.ops.peak import _lag_distance

    ok = ((_lag_distance(lags_flat, lag_e, lag_period) <= exclude_lag)
          & (vals_flat >= 0))
    rank = jnp.max(jnp.where(ok, vals_flat, -jnp.inf), axis=-1)  # (K,)
    bins_all = jnp.arange(num_bins, dtype=jnp.int32)
    rank = jnp.where(jnp.abs(bins_all - bin_e) <= exclude_freq, rank,
                     -jnp.inf)
    r = min(_REFINE_BINS, num_bins)
    sel_rank, bins = jax.lax.top_k(rank, r)
    # (bins, valid): a cell narrower than the refine width leaves -inf
    # slots whose bins are arbitrary — their exact rows must be masked,
    # not scored (they could lie outside the entry's freq cell).
    return bins, jnp.isfinite(sel_rank)


def _rescore_guards(needle_len: int, auto_lag_cell: int,
                    hay_len: int) -> Tuple[int, int]:
    """(guard, rescore_win) for the per-entry exact re-score windows.

    The window must hold the whole needle plus ``guard`` samples each
    side; the argmax slack around the coarse candidate is
    resolution-derived (floored at 4 samples for bf16 flat-top tie
    ambiguity) and clamped to the guard so the constrained argmax stays
    inside the window.
    """
    win = max(int(auto_lag_cell), 4)
    guard = min(max(64, win), max(needle_len // 4, 1),
                max((hay_len - needle_len) // 2, 1))
    return guard, min(win, guard)


def _rescore_entries_circular(ns, circ, freqs, vals_j, lags_j, lat,
                              sample_rate, xcor_len: int, guard: int,
                              rescore_win: int, exclude_lag: int,
                              exclude_freq: int, backend: str):
    """Exact re-score of one pair's coarse lattice — CIRCULAR lags.

    ``circ``: (2, M + wlen) circularly-extended haystack planes (the
    zero-padded M-period tiled past the wrap), so a window starting at
    ``(lag - guard) mod M`` reads the exact samples circular lag
    ``lag`` correlates against; local lag ``d`` of the window equals
    circular lag ``(start + d) mod M`` for ``d <= 2*guard`` (every
    needle sample hits in-window data).  The argmax is constrained to
    ``|d - guard| <= rescore_win`` — one resolution cell of slack
    around the entry's OWN coarse lag, so a nearby stronger emitter
    cannot capture the argmax and collapse two entries (see
    ``models/streaming._stein_lattice_rescore_jit``).
    """
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split

    m = xcor_len
    n = ns[0].shape[-1]
    wlen = n + 2 * guard
    k = freqs.shape[0]

    def one(lag_e, bin_e, coarse_ok):
        bins, bok = _entry_candidate_bins(vals_j, lags_j, lag_e, bin_e,
                                          exclude_lag, exclude_freq, k,
                                          lag_period=m)
        start = jnp.mod(lag_e - guard, m)
        wr = jax.lax.dynamic_slice(circ[0], (start,), (wlen,))
        wi = jax.lax.dynamic_slice(circ[1], (start,), (wlen,))
        exact = splitfft.mag2(_surface_rows_split(
            ns, (wr, wi), freqs[bins], sample_rate, m, backend))
        d = jax.lax.broadcasted_iota(jnp.int32, exact.shape, 1)
        keep = (bok[:, None] & (d <= 2 * guard)
                & (jnp.abs(d - guard) <= rescore_win))
        pk = find_peak_2d(jnp.where(keep, exact, -jnp.inf))
        return (jnp.where(coarse_ok, pk.value, -jnp.inf),
                bins[pk.freq_idx].astype(jnp.int32),
                jnp.mod(lag_e + pk.lag_idx - guard, m).astype(jnp.int32))

    vals_e, bins_e, lags_e = jax.vmap(one)(
        lat.lag_idx, lat.freq_idx, jnp.isfinite(lat.value))
    return vals_e, bins_e, lags_e


def _rescore_entries_windowed(ns, hs, freqs, vals_j, lags_j, lat,
                              sample_rate, xcor_len: int,
                              needle_len: int, total_lags: int,
                              guard: int, rescore_win: int,
                              exclude_lag: int, exclude_freq: int,
                              backend: str):
    """Exact re-score of one pair's coarse lattice — LINEAR capture lags
    (the overlap-save path): a guard-extended slice of the raw capture
    around each entry's lag, local lags constrained to full-overlap
    range, the requested lag bound, and one resolution cell around the
    entry's own coarse lag (see :func:`_rescore_entries_circular`)."""
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split

    n = needle_len
    wlen = n + 2 * guard
    hay_len = hs[0].shape[-1]
    k = freqs.shape[0]

    def one(lag_e, bin_e, coarse_ok):
        bins, bok = _entry_candidate_bins(vals_j, lags_j, lag_e, bin_e,
                                          exclude_lag, exclude_freq, k)
        start = jnp.clip(lag_e - guard, 0, max(hay_len - wlen, 0))
        wr = jax.lax.dynamic_slice(hs[0], (start,), (wlen,))
        wi = jax.lax.dynamic_slice(hs[1], (start,), (wlen,))
        exact = splitfft.mag2(_surface_rows_split(
            ns, (wr, wi), freqs[bins], sample_rate, xcor_len, backend))
        d = jax.lax.broadcasted_iota(jnp.int32, exact.shape, 1)
        keep = (bok[:, None] & (d <= 2 * guard) & (start + d < total_lags)
                & (jnp.abs(start + d - lag_e) <= rescore_win))
        pk = find_peak_2d(jnp.where(keep, exact, -jnp.inf))
        return (jnp.where(coarse_ok, pk.value, -jnp.inf),
                bins[pk.freq_idx].astype(jnp.int32),
                (start + pk.lag_idx).astype(jnp.int32))

    vals_e, bins_e, lags_e = jax.vmap(one)(
        lat.lag_idx, lat.freq_idx, jnp.isfinite(lat.value))
    return vals_e, bins_e, lags_e


def _batched_stein_peaks_core(ns_re, ns_im, hs_re, hs_im, freqs,
                              sample_rate, xcor_len: int, block_len: int,
                              backend: str, num_peaks: int,
                              exclude_freq: int, exclude_lag: int,
                              guard: int, rescore_win: int) -> CafPeak:
    """Traceable equal-length multi-emitter batch pipeline (also the
    ``shard_map`` body of ``parallel.sharded.
    sharded_batched_stein_peaks``).  Fields (P_pairs, num_peaks)."""

    pad = (-ns_re.shape[-1]) % SUPER
    np_re = jnp.pad(ns_re, ((0, 0), (0, pad)))
    np_im = jnp.pad(ns_im, ((0, 0), (0, pad)))
    b = np_re.shape[-1] // block_len
    lmat, group = _needle_operator(np_re, np_im, block_len)
    span = fused_span(b, group, xcor_len)
    h_ext = _haystack_extension(hs_re, hs_im, xcor_len, span)
    ws1, ws2 = stein_synthesis_weights(freqs, sample_rate, b, block_len)
    v1, i1, v2, i2 = coarse_rank(
        ws1, ws2, lmat, h_ext, b, group, xcor_len,
        want_top2=True, sep=exclude_lag)
    # (K, P) x4 -> per-pair (K, 2) candidate slots.
    vals_j = jnp.stack([v1, v2], axis=-1).transpose(1, 0, 2)
    lags_j = jnp.stack([i1, i2], axis=-1).transpose(1, 0, 2)
    lat = jax.vmap(lambda vj, lj: _lattice_from_bin_candidates(
        vj, lj, num_peaks, exclude_freq, exclude_lag,
        lag_period=xcor_len))(vals_j, lags_j)
    # Circular haystack extension for the re-score windows: period M
    # (the haystack zero-padded to the FFT length) tiled past the wrap.
    m = xcor_len
    base_re = jnp.pad(hs_re, ((0, 0), (0, m - hs_re.shape[-1])))
    base_im = jnp.pad(hs_im, ((0, 0), (0, m - hs_im.shape[-1])))
    n = ns_re.shape[-1]
    wlen = n + 2 * guard
    circ = jnp.stack(
        [jnp.concatenate([base_re, base_re[:, :wlen]], axis=-1),
         jnp.concatenate([base_im, base_im[:, :wlen]], axis=-1)], axis=1)

    def close(nr, ni, cp, vj, lj, lat_p):
        vals_e, bins_e, lags_e = _rescore_entries_circular(
            (nr, ni), cp, freqs, vj, lj, lat_p, sample_rate, m, guard,
            rescore_win, exclude_lag, exclude_freq, backend)
        # Two coarse cells can re-score onto the same exact peak (e.g.
        # a doppler sidelobe beyond the bin exclusion) — re-dedup and
        # re-sort on the exact values, circularly (a wrap-around skirt
        # collapses onto its mainlobe instead of claiming a slot).
        return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                           exclude_freq, exclude_lag,
                           lag_period=xcor_len)

    return jax.vmap(close)(ns_re, ns_im, circ, vals_j, lags_j, lat)


_batched_stein_peaks_jit = functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "num_peaks",
                     "exclude_freq", "exclude_lag", "guard",
                     "rescore_win"))(_batched_stein_peaks_core)


def _stein_model_floor(needles: np.ndarray, haystacks: np.ndarray,
                       valid_len=None) -> np.ndarray:
    """(P,) per-pair model noise floor: ``sum|n|^2 * mean|h|^2``.

    A noise-only xcor cell is a complex-Gaussian sum with that second
    moment (the same exponential-cell model as
    :meth:`caf_cookoff_tpu.models.streaming.StreamingCAF.noise_floor`)
    — the coarse stage reduces bins to (max, argmax), so there are no
    cells to measure.  ``valid_len`` (scalar, or per-pair sequence for
    batches padded to one length) restricts each haystack mean to the
    REAL capture samples: averaging zero padding in would bias the
    floor low and inflate every SNR by the padding ratio.
    """
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    n_energy = np.sum(np.abs(needles) ** 2, axis=-1, dtype=np.float64)
    if valid_len is None:
        h_mean = np.mean(np.abs(haystacks) ** 2, axis=-1,
                         dtype=np.float64)
    else:
        lens = np.broadcast_to(
            np.asarray(valid_len, np.int64), (haystacks.shape[0],))
        h_mean = np.array([
            np.mean(np.abs(haystacks[i, :lens[i]]) ** 2,
                    dtype=np.float64)
            for i in range(haystacks.shape[0])])
    return n_energy * h_mean


def batched_stein_peaks(needles, haystacks, freqs_hz, sample_rate,
                        num_peaks: int, *, block_len: int = 64,
                        exclude_freq: Optional[int] = None,
                        exclude_lag: Optional[int] = None,
                        backend: Optional[str] = None,
                        min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR through the segmented batch
    engine: ``(freqs (P, k), lags (P, k), values (P, k)[, snr_db])``,
    strongest first, empty slots ``-inf``.

    The multi-emitter sibling of :func:`batched_stein_peak` — config
    2's batch shape with config 4's lattice semantics (the coarse
    stage's ``want_top2`` epilogue carries two separated
    same-bin candidates per bin; see the module-level exactness
    contract).  Lags are CIRCULAR xcor indices like
    :func:`batched_stein_peak` (unwrap with :func:`caf_cookoff_tpu.
    ops.peak.unwrap_lag`).  ``min_snr_db`` / ``with_snr`` apply the
    detection threshold against the per-pair model floor
    (:func:`_stein_model_floor`).  Wide-span grids that need banding
    are not supported here — use :func:`caf_cookoff_tpu.models.
    filterbank.caf_surface` + :func:`caf_cookoff_tpu.ops.peak.
    find_peaks`, or the overlap-save lattice engines.
    """
    from caf_cookoff_tpu.models.overlap_save import detection_rows
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.shape != needles.shape:
        raise ValueError(
            f"need matching (P, N) batches, got {needles.shape} vs "
            f"{haystacks.shape}")
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    n = ns_re.shape[-1]
    m = xcor_length(n)
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError as e:
        raise EligibilityError(
            f"{e} — the multi-emitter batch engine does not band wide "
            "spans; use find_peaks on caf_surface or the overlap-save "
            "lattice engines for this grid") from e
    auto = resolve_exclusions(needles[0], freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    # The circular extension (period m) imposes no window-fit limit —
    # pass m, not n, or the guard collapses to 1 and the re-score
    # cannot correct a bf16 flat-top argmax more than 1 sample off.
    guard, rescore_win = _rescore_guards(n, auto[1], m)
    pk = _batched_stein_peaks_jit(
        jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
        jnp.asarray(hs_im), jnp.asarray(freqs), float(sample_rate), m, d,
        backend, int(num_peaks), exclude_freq, exclude_lag, guard,
        rescore_win)
    if min_snr_db is None and not with_snr:
        return (freqs[np.asarray(pk.freq_idx)], np.asarray(pk.lag_idx),
                np.asarray(pk.value))
    return detection_rows(freqs, pk, _stein_model_floor(needles, haystacks),
                          len(freqs) * m, min_snr_db, with_snr)


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "windows",
                     "total_lags", "needle_len", "num_peaks",
                     "exclude_freq", "exclude_lag", "guard",
                     "rescore_win"))
def _batched_stein_os_peaks_jit(ns_re, ns_im, hs_re, hs_im, freqs,
                                sample_rate, xcor_len, block_len, backend,
                                windows: int, total_lags: int,
                                needle_len: int, num_peaks: int,
                                exclude_freq: int, exclude_lag: int,
                                guard: int, rescore_win: int) -> CafPeak:
    """Windowed multi-emitter coarse scan + per-entry exact re-score.

    One coarse program per (pair, window) with the top-2 per-bin
    epilogue; per-window NMS lattices fold across windows (hierarchical
    — same 'sidelobe-level slots may differ from a flat fold' caveat as
    every hierarchical lattice merge in the framework), then each
    surviving entry re-scores exactly on a guard-extended capture
    slice.  Fields (P_pairs, num_peaks); lags are absolute capture
    offsets.
    """

    p = ns_re.shape[0]
    n = needle_len
    pad = (-ns_re.shape[-1]) % SUPER
    np_re = jnp.pad(ns_re, ((0, 0), (0, pad)))
    np_im = jnp.pad(ns_im, ((0, 0), (0, pad)))
    b = np_re.shape[-1] // block_len
    v = xcor_len
    lmat, group = _needle_operator(np_re, np_im, block_len)
    ws1, ws2 = stein_synthesis_weights(freqs, sample_rate, b, block_len)
    v1, i1, v2, i2 = windowed_coarse_rank(
        ws1, ws2, lmat, hs_re, hs_im, b, group, v, windows, total_lags,
        want_top2=True, sep=exclude_lag)
    k = freqs.shape[0]
    # (K, P*W) x4 -> (P, W, K, 2) candidates with GLOBAL lags.
    woff = jnp.arange(windows, dtype=jnp.int32) * v
    vals_j = jnp.stack([v1, v2], axis=-1).reshape(k, p, windows, 2)
    lags_j = (jnp.stack([i1, i2], axis=-1).reshape(k, p, windows, 2)
              + woff[None, None, :, None])
    vals_j = jnp.where(lags_j < total_lags, vals_j, -1.0)
    vals_j = vals_j.transpose(1, 2, 0, 3)            # (P, W, K, 2)
    lags_j = lags_j.transpose(1, 2, 0, 3)

    def window_lattices(vw, lw):                     # (W, K, 2) each
        return jax.vmap(lambda vj, lj: _lattice_from_bin_candidates(
            vj, lj, num_peaks, exclude_freq, exclude_lag))(vw, lw)

    wlat = jax.vmap(window_lattices)(vals_j, lags_j)  # (P, W, k) fields
    flat = CafPeak(*(f.reshape(p, -1) for f in wlat))
    lat = jax.vmap(lambda c: merge_peaks(c, num_peaks, exclude_freq,
                                         exclude_lag))(flat)

    # Per-pair candidate slots as (K, W*2) for the re-score's
    # lag-restricted bin ranking.
    vflat = vals_j.transpose(0, 2, 1, 3).reshape(p, k, -1)
    lflat = lags_j.transpose(0, 2, 1, 3).reshape(p, k, -1)

    def close(nr, ni, hr, hi, vj, lj, lat_p):
        vals_e, bins_e, lags_e = _rescore_entries_windowed(
            (nr, ni), (hr, hi), freqs, vj, lj, lat_p, sample_rate,
            xcor_len, n, total_lags, guard, rescore_win, exclude_lag,
            exclude_freq, backend)
        # Re-dedup + re-sort on the exact values (two coarse cells can
        # re-score onto one exact peak).
        return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                           exclude_freq, exclude_lag)

    return jax.vmap(close)(ns_re, ns_im, hs_re, hs_im, vflat, lflat, lat)


@functools.partial(
    jax.jit,
    static_argnames=("xcor_len", "block_len", "backend", "windows",
                     "total_lags", "needle_len", "num_bins", "num_peaks",
                     "exclude_freq", "exclude_lag", "guard",
                     "rescore_win"))
def _banded_stein_os_peaks_jit(ns_re, ns_im, hs_re, hs_im, freqs_pad,
                               centers, rel, sample_rate, xcor_len,
                               block_len, backend, windows: int,
                               total_lags: int, needle_len: int,
                               num_bins: int, num_peaks: int,
                               exclude_freq: int, exclude_lag: int,
                               guard: int, rescore_win: int) -> CafPeak:
    """Banded long-capture multi-emitter scan: (pair, band, window)
    coarse programs with the top-2 per-bin epilogue, lattices on the
    ascending ``freqs_pad`` global-bin lattice (bin = band*Kb + j; pad
    rows masked), per-entry exact re-score on ABSOLUTE frequencies with
    the unshifted needles — the ``windows x share_h`` composition of
    :func:`_batched_stein_os_peaks_jit` (see its hierarchical-merge
    caveat) for grids the single-band envelope cannot take."""

    p = ns_re.shape[0]
    s = centers.shape[0]
    v = xcor_len
    n = needle_len
    sr, si = _shift_to_centers(ns_re, ns_im, centers, sample_rate)
    b = sr.shape[-1] // block_len
    lmat, sup = _needle_operator(sr, si, block_len)
    ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b, block_len)
    v1, i1, v2, i2 = windowed_coarse_rank(
        ws1, ws2, lmat, hs_re, hs_im, b, sup, v, windows, total_lags,
        share_h=s, want_top2=True, sep=exclude_lag)
    kb = rel.shape[0]
    woff = jnp.arange(windows, dtype=jnp.int32) * v
    vals_j = jnp.stack([v1, v2], axis=-1).reshape(kb, p, s, windows, 2)
    lags_j = (jnp.stack([i1, i2], axis=-1).reshape(kb, p, s, windows, 2)
              + woff[None, None, None, :, None])
    vals_j = jnp.where(lags_j < total_lags, vals_j, -1.0)
    vals_j = vals_j.transpose(1, 2, 3, 0, 4)        # (P, S, W, Kb, 2)
    lags_j = lags_j.transpose(1, 2, 3, 0, 4)
    offs = jnp.arange(s, dtype=jnp.int32) * kb

    def band_lattices(vb, lb, off):                 # (W, Kb, 2), scalar
        return jax.vmap(lambda vj, lj: _lattice_from_bin_candidates(
            vj, lj, num_peaks, exclude_freq, exclude_lag,
            bin_offset=off, num_bins=num_bins))(vb, lb)

    wlat = jax.vmap(lambda vp, lp: jax.vmap(band_lattices)(
        vp, lp, offs))(vals_j, lags_j)              # (P, S, W, k) fields
    flat = CafPeak(*(f.reshape(p, -1) for f in wlat))
    lat = jax.vmap(lambda c: merge_peaks(c, num_peaks, exclude_freq,
                                         exclude_lag))(flat)
    # Candidate slots on the global lattice: (P, S*Kb, W*2); pad rows
    # go negative so the re-score's bin ranking excludes them.
    vflat = vals_j.transpose(0, 1, 3, 2, 4).reshape(p, s * kb, -1)
    lflat = lags_j.transpose(0, 1, 3, 2, 4).reshape(p, s * kb, -1)
    rows = jnp.arange(s * kb)
    vflat = jnp.where(rows[None, :, None] < num_bins, vflat, -1.0)

    def close(nr, ni, hr, hi, vj, lj, lat_p):
        vals_e, bins_e, lags_e = _rescore_entries_windowed(
            (nr, ni), (hr, hi), freqs_pad, vj, lj, lat_p, sample_rate,
            xcor_len, n, total_lags, guard, rescore_win, exclude_lag,
            exclude_freq, backend)
        return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                           exclude_freq, exclude_lag)

    return jax.vmap(close)(ns_re, ns_im, hs_re, hs_im, vflat, lflat, lat)


def batched_stein_os_peaks(needles, haystacks, freqs_hz, sample_rate,
                           num_peaks: int,
                           num_lags: Optional[int] = None, *,
                           block_len: int = 64,
                           exclude_freq: Optional[int] = None,
                           exclude_lag: Optional[int] = None,
                           backend: Optional[str] = None,
                           min_snr_db=None, with_snr: bool = False,
                           capture_lens=None):
    """Top-``num_peaks`` emitters PER PAIR of long captures through the
    segmented engine — BASELINE config 4's "streaming multi-emitter"
    workload through :func:`coarse_rank`.

    The multi-emitter sibling of :func:`batched_stein_os_peak`:
    ``(freqs (P, k), lags (P, k), values (P, k)[, snr_db (P, k)])``,
    strongest first per pair, lags absolute capture offsets, empty and
    sub-threshold slots ``-inf``.  Exclusion windows default to the
    first needle's resolution cell; ``min_snr_db`` / ``with_snr``
    threshold against the per-pair model floor
    (:func:`_stein_model_floor` — the coarse stage emits per-bin
    maxima, not cells, so the floor is modeled, not measured; the
    filterbank lattice :func:`caf_cookoff_tpu.parallel.sharded.
    batched_overlap_save_peaks` measures it).  See the module-level
    same-bin exactness contract.  Uniform grids route through the
    BANDED windowed engine whenever the band plan's modeled cost wins
    (same routing as :func:`batched_stein_os_peak`); non-uniform
    wide-span grids that cannot band raise and should use the XLA
    lattice engines.
    """
    from caf_cookoff_tpu.models.overlap_save import detection_rows
    from caf_cookoff_tpu.models.stein import _band_routing
    from caf_cookoff_tpu.ops.peak import resolve_exclusions

    backend = backend or default_backend()
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    if needles.ndim != 2 or haystacks.ndim != 2 \
            or needles.shape[0] != haystacks.shape[0]:
        raise ValueError(
            f"need (P, N) needles and (P, L) haystacks, got "
            f"{needles.shape} vs {haystacks.shape}")
    n = needles.shape[-1]
    if haystacks.shape[-1] <= n:
        raise ValueError("use batched_stein_peaks for equal-length pairs")
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(haystacks)
    freqs = as_grid(freqs_hz, dtype=ns_re.dtype)
    try:
        d = _pow2_block_len(sample_rate, freqs, block_len)
    except SpanError:
        d = None
    use_banded, d, freqs_pad_r, centers_r, rel_r = _band_routing(
        sample_rate, freqs, d)
    if d is None:
        try:
            _pow2_block_len(sample_rate, freqs, block_len)   # re-raise
        except SpanError as e:
            raise EligibilityError(
                f"{e} — this grid neither fits the single-band envelope "
                "nor bands cleanly; use batched_overlap_save_peaks (XLA "
                "lattice) for it") from e
    m = xcor_length(n)
    total_lags = num_lags or haystacks.shape[-1] - n + 1
    windows = -(-total_lags // m)
    auto = resolve_exclusions(needles[0], freqs, sample_rate, None, None)
    exclude_freq = auto[0] if exclude_freq is None else int(exclude_freq)
    exclude_lag = auto[1] if exclude_lag is None else int(exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto[1], haystacks.shape[-1])
    if use_banded:
        pk = _banded_stein_os_peaks_jit(
            jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
            jnp.asarray(hs_im), jnp.asarray(freqs_pad_r),
            jnp.asarray(centers_r), jnp.asarray(rel_r),
            float(sample_rate), m, d, backend, windows,
            total_lags, n, len(freqs), int(num_peaks), exclude_freq,
            exclude_lag, guard, rescore_win)
        out_freqs = freqs_pad_r
    else:
        pk = _batched_stein_os_peaks_jit(
            jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
            jnp.asarray(hs_im), jnp.asarray(freqs), float(sample_rate),
            m, d, backend, windows, total_lags, n, int(num_peaks),
            exclude_freq, exclude_lag, guard, rescore_win)
        out_freqs = freqs
    if min_snr_db is None and not with_snr:
        return (out_freqs[np.asarray(pk.freq_idx)],
                np.asarray(pk.lag_idx), np.asarray(pk.value))
    return detection_rows(
        out_freqs, pk,
        _stein_model_floor(needles, haystacks, valid_len=capture_lens),
        len(freqs) * total_lags, min_snr_db, with_snr)
