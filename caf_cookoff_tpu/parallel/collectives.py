"""Collective peak reduction.

The reference gathers per-bin rows through in-process channels and scans
them on one thread (`caf_rust/src/caf/mod.rs:31-42` over rows received at
:367-372; `caf_go/caf.go:154-158` drains a buffered chan).  The mesh
equivalent reduces ``(value, freq_idx, lag_idx)`` triples across mesh axes
with XLA collectives — no host gather, no surface materialization on one
chip.

Reduction strategy: ``pmax`` on the value, then hierarchical ``pmin``
tie-breaks on (freq_idx, lag_idx) among max-holding shards — the
deterministic "first maximum in row-major order wins" semantics of the
reference's serial scans, without any index flattening that could
overflow int32 at pod-scale surface sizes.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax
import jax.numpy as jnp

from caf_cookoff_tpu.ops.peak import CafPeak, merge_peaks

_AxisNames = Union[str, Sequence[str]]

_INT_MAX = jnp.iinfo(jnp.int32).max


def global_peak(local: CafPeak, axis_names: _AxisNames) -> CafPeak:
    """Reduce per-shard peak triples to the replicated global peak.

    Must be called inside ``shard_map``.  ``local`` carries *global*
    indices (the caller offsets them by ``axis_index * shard_extent``).
    """
    value = jnp.asarray(local.value)
    freq_idx = local.freq_idx.astype(jnp.int32)
    lag_idx = local.lag_idx.astype(jnp.int32)

    m = jax.lax.pmax(value, axis_names)
    is_max = value >= m
    f_min = jax.lax.pmin(jnp.where(is_max, freq_idx, _INT_MAX), axis_names)
    l_min = jax.lax.pmin(
        jnp.where(is_max & (freq_idx == f_min), lag_idx, _INT_MAX),
        axis_names)
    return CafPeak(value=m, freq_idx=f_min, lag_idx=l_min)


def global_peaks(local: CafPeak, axis_names: _AxisNames, num_peaks: int,
                 exclude_freq: int, exclude_lag: int) -> CafPeak:
    """Reduce per-shard top-``num_peaks`` lattices to the global lattice.

    Must be called inside ``shard_map``; ``local``'s fields are
    ``(num_peaks,)`` with *global* indices, empty slots ``-inf``.  The
    candidate lattices ``all_gather`` over the reduction axes (3 tiny
    ``N*P`` vectors — far cheaper than any surface traffic) and every
    shard runs the same deterministic NMS merge, so the result is
    replicated by construction.  Cross-shard NMS is what makes this
    more than a concatenate: an emitter whose mainlobe straddles a
    time-shard boundary is detected by both neighbors and must collapse
    to one entry.
    """
    names = ((axis_names,) if isinstance(axis_names, str)
             else tuple(axis_names))
    value = jnp.asarray(local.value)
    # TWO collectives total, independent of axis count: the value
    # vector gathers over the full axis product in one op, and the two
    # int fields ride a single gather as a packed (2, P) block.  (The
    # original per-axis x per-field fold issued 3 x len(names) gathers
    # — at ms-scale per-call transport latency, the collective term of
    # a 2-axis mesh step was 6x one gather's latency for 24 B of
    # payload.)
    value = jax.lax.all_gather(value, names, tiled=True)
    idx = jnp.stack([local.freq_idx.astype(jnp.int32),
                     local.lag_idx.astype(jnp.int32)])
    idx = jax.lax.all_gather(idx, names, axis=1, tiled=True)
    return merge_peaks(CafPeak(value, idx[0], idx[1]), num_peaks,
                       exclude_freq, exclude_lag)


def global_rate_peak(value, rate_idx, freq_idx, lag_idx,
                     axis_names: _AxisNames):
    """Reduce per-shard (value, rate_idx, freq_idx, lag_idx) quads to
    the replicated global second-order peak.

    The rate-axis extension of :func:`global_peak`: ``pmax`` on the
    value, then the hierarchical ``pmin`` tie-break walks
    (rate, freq, lag) — deterministic "earliest rate, then row-major"
    order matching the single-chip rate scan's strict-> carry.  Must be
    called inside ``shard_map`` with *global* indices.
    """
    value = jnp.asarray(value)
    r = rate_idx.astype(jnp.int32)
    f = freq_idx.astype(jnp.int32)
    lg = lag_idx.astype(jnp.int32)
    m = jax.lax.pmax(value, axis_names)
    is_max = value >= m
    r_min = jax.lax.pmin(jnp.where(is_max, r, _INT_MAX), axis_names)
    on_r = is_max & (r == r_min)
    f_min = jax.lax.pmin(jnp.where(on_r, f, _INT_MAX), axis_names)
    l_min = jax.lax.pmin(
        jnp.where(on_r & (f == f_min), lg, _INT_MAX), axis_names)
    return m, r_min, f_min, l_min


def global_rate_peaks(value, key, lag, rate_idx, fws, rates,
                      axis_names: _AxisNames, num_peaks: int,
                      exclude_freq: int, exclude_lag: int, half_t_bins):
    """Reduce per-shard RATE lattices to the replicated global lattice.

    Same two-collective shape as :func:`global_peaks` (value vector +
    one packed int block), but the int block carries FOUR fields
    (center-freq key, lag, rate_idx, window-start freq bin) and the
    merge is the rate-aware NMS
    (:func:`caf_cookoff_tpu.models.rate._merge_rate_lattice`) in
    window-center frequency space — physical rates rehydrate from the
    replicated ``rates`` grid, so they never ride the wire.
    """
    from caf_cookoff_tpu.models.rate import _merge_rate_lattice

    names = ((axis_names,) if isinstance(axis_names, str)
             else tuple(axis_names))
    value = jax.lax.all_gather(jnp.asarray(value), names, tiled=True)
    idx = jnp.stack([key.astype(jnp.int32), lag.astype(jnp.int32),
                     rate_idx.astype(jnp.int32), fws.astype(jnp.int32)])
    idx = jax.lax.all_gather(idx, names, axis=1, tiled=True)
    rvals = jnp.take(rates, idx[2], axis=0)
    return _merge_rate_lattice(value, idx[0], idx[1], idx[2], idx[3],
                               rvals, num_peaks, exclude_freq,
                               exclude_lag, half_t_bins)


def global_peaks_batched(local: CafPeak, axis_names: _AxisNames,
                         num_peaks: int, exclude_freq: int,
                         exclude_lag: int) -> CafPeak:
    """Batched lattice reduction: fields are ``(..., num_peaks)`` (e.g.
    one lattice per local pair) and the candidate axis — not the batch
    axes — folds across the mesh.

    Each named axis all_gathers the lattices (stacked on a new leading
    axis) and folds that axis into the trailing candidate axis, then a
    vmapped deterministic merge runs per batch element.  Same
    replicated-by-construction semantics as :func:`global_peaks`.
    """
    names = ((axis_names,) if isinstance(axis_names, str)
             else tuple(axis_names))
    value = jnp.asarray(local.value)
    idx = jnp.stack([local.freq_idx.astype(jnp.int32),
                     local.lag_idx.astype(jnp.int32)])   # (2, ..., C)

    def fold(x):
        """Gather over the FULL axis product in one collective and fold
        the gathered axis into the trailing candidate axis."""
        g = jax.lax.all_gather(x, names)         # (n_total, ..., C)
        g = jnp.moveaxis(g, 0, -2)               # (..., n_total, C)
        return g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1])

    # Two collectives total (value + packed int pair) — see
    # :func:`global_peaks` for the latency accounting.
    value = fold(value)
    idx = fold(idx)
    freq_idx, lag_idx = idx[0], idx[1]

    def merge_one(v, f, lg):
        return merge_peaks(CafPeak(v, f, lg), num_peaks, exclude_freq,
                           exclude_lag)

    flat_v = value.reshape(-1, value.shape[-1])
    flat_f = freq_idx.reshape(-1, value.shape[-1])
    flat_l = lag_idx.reshape(-1, value.shape[-1])
    out = jax.vmap(merge_one)(flat_v, flat_f, flat_l)
    lead = value.shape[:-1]
    return CafPeak(out.value.reshape(*lead, num_peaks),
                   out.freq_idx.reshape(*lead, num_peaks),
                   out.lag_idx.reshape(*lead, num_peaks))
