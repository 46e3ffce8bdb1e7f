"""Streaming CAF — continuous capture processing with carry-over state.

BASELINE config 4's shape: a long (or unbounded) capture arrives in
fixed-size chunks; the engine keeps the ``N-1`` tail samples of each
chunk so correlations spanning chunk boundaries are never lost, and
maintains the running global peak with absolute lag indexing.  The
reference has no streaming mode at all (batch files only; its GNU Radio
flowgraph ``grc/capture.grc`` records streams to disk for offline
CAF-ing — this engine is what closes that loop).

Each ``process`` call is one jitted program (fixed chunk length =>
one cached executable); state lives on-device as split planes, so
sustained throughput has no host round-trips besides the chunk feed.
Multi-emitter streaming = a vmap of this over pairs
(:func:`caf_cookoff_tpu.models.batched`), or pair-sharded over a mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caf_cookoff_tpu.config import as_grid, default_backend, xcor_length
from caf_cookoff_tpu.models.overlap_save import (
    needle_spectra_conj,
    streaming_peak,
)
from caf_cookoff_tpu.ops import splitfft
from caf_cookoff_tpu.ops.peak import (
    CafPeak,
    concat_peaks,
    merge_peaks,
    resolve_exclusions,
)

# Guard samples on EACH side of a carried re-score window: the stein
# stream slices the window so the winning lag sits ~_RESCORE_GUARD
# samples in, and sizes the carry to needle_pad + _RESCORE_PAD — the
# step jits, the carry buffers, and the re-score lag bound
# (max_lag = needle_pad + _RESCORE_PAD - needle_len) must all agree on
# this number, so it lives here and nowhere else.
_RESCORE_GUARD = 64
_RESCORE_PAD = 2 * _RESCORE_GUARD


@functools.partial(
    jax.jit,
    static_argnames=("needle_len", "chunk_len", "backend"))
def _stream_step_jit(sc_re, sc_im, tail_re, tail_im, ch_re, ch_im,
                     best_value, best_freq, best_lag, fsum, fcnt,
                     base_lag, valid_len, needle_len, chunk_len, backend):
    """One streaming step: correlate [tail | chunk], update global best.

    The window covers lags [base_lag, base_lag + chunk_len): each new
    sample admits exactly one new lag, so consecutive windows tile the
    capture's lag axis with no gaps or overlaps.  ``valid_len`` (traced,
    <= the static ``chunk_len``) masks the lags of a zero-padded short
    chunk — the same executable serves every chunk length, so an uneven
    final chunk never triggers a mid-stream recompile.

    ``fsum``/``fcnt`` are the running noise-floor accumulators ((sum,
    count) of every valid mag^2 cell seen so far); each window's
    contribution is fused into the same scan over its blocks.
    """
    window = (jnp.concatenate([tail_re, ch_re]),
              jnp.concatenate([tail_im, ch_im]))
    local, wsum, wcnt = streaming_peak(
        (sc_re, sc_im), window, needle_len, chunk_len,
        lag_offset=base_lag, total_lags=base_lag + valid_len,
        backend=backend, with_floor=True)
    take = local.value > best_value
    new_best = CafPeak(
        value=jnp.where(take, local.value, best_value),
        freq_idx=jnp.where(take, local.freq_idx, best_freq),
        lag_idx=jnp.where(take, local.lag_idx, best_lag),
    )
    halo = needle_len - 1
    # The next tail ends at the last VALID sample (padding excluded).
    new_tail = tuple(
        jax.lax.dynamic_slice(p, (valid_len,), (halo,)) for p in window)
    return new_best, local, new_tail, fsum + wsum, fcnt + wcnt


@functools.partial(
    jax.jit,
    static_argnames=("needle_len", "chunk_len", "backend", "num_peaks",
                     "exclude_freq", "exclude_lag"))
def _stream_lattice_step_jit(sc_re, sc_im, tail_re, tail_im, ch_re, ch_im,
                             best_value, best_freq, best_lag, fsum, fcnt,
                             base_lag, valid_len, needle_len, chunk_len,
                             backend, num_peaks, exclude_freq, exclude_lag):
    """Multi-emitter streaming step: this window's top-``num_peaks``
    lattice NMS-merged into the running global lattice.

    Same window/lag bookkeeping as :func:`_stream_step_jit` (including
    the running floor accumulators); the merge deduplicates an emitter
    whose mainlobe skirt leaks into the next chunk's window (detected
    once per window, within one exclusion cell), so chunk boundaries
    never double-count.
    """
    window = (jnp.concatenate([tail_re, ch_re]),
              jnp.concatenate([tail_im, ch_im]))
    local, wsum, wcnt = streaming_peak(
        (sc_re, sc_im), window, needle_len, chunk_len,
        lag_offset=base_lag, total_lags=base_lag + valid_len,
        backend=backend, num_peaks=num_peaks,
        exclude_freq=exclude_freq, exclude_lag=exclude_lag,
        with_floor=True)
    new_best = merge_peaks(
        concat_peaks(CafPeak(best_value, best_freq, best_lag), local),
        num_peaks, exclude_freq, exclude_lag)
    halo = needle_len - 1
    new_tail = tuple(
        jax.lax.dynamic_slice(p, (valid_len,), (halo,)) for p in window)
    return new_best, local, new_tail, fsum + wsum, fcnt + wcnt


@functools.partial(
    jax.jit,
    static_argnames=("num_blocks", "group", "chunk_len", "needle_pad",
                     "halo"))
def _stein_stream_step_jit(ws1, ws2, lmat, tail_re, tail_im, ch_re,
                           ch_im, best_value, best_freq, best_lag,
                           bw_re, bw_im, bw_start, base_lag, valid_len,
                           num_blocks, group, chunk_len, needle_pad,
                           halo):
    """One stein-mode streaming step: the coarse stage over
    [tail | chunk].

    The window's lags [base_lag, base_lag + chunk_len) run through
    :func:`caf_cookoff_tpu.models.batched_stein.coarse_rank` at P=1 —
    per-chunk cost is one stage-A dot and one synthesis matmul instead
    of K inverse FFTs.
    Bins whose best lag falls past ``valid_len`` (zero-padded short
    chunks: incomplete data) are masked; those lags re-scan with full
    data next chunk.  Alongside the best triple, the step carries a
    guard-extended window slice AROUND the running best lag so
    :meth:`StreamingCAF.best` can re-score it exactly without the
    engine retaining capture history.
    """
    from caf_cookoff_tpu.models.batched_stein import (SUPER, coarse_rank,
                                                      fused_span)

    window = (jnp.concatenate([tail_re, ch_re]),
              jnp.concatenate([tail_im, ch_im]))
    win_len = halo + chunk_len
    # The carried slice is guard-extended (_RESCORE_GUARD samples each
    # side): the winning lag sits ~_RESCORE_GUARD samples in, so every
    # needle sample correlates against real data in best()'s exact
    # re-score (a needle_pad-sized carry would zero-truncate the last
    # products).
    carry = needle_pad + _RESCORE_PAD
    ext_len = max(win_len, carry)
    span = fused_span(num_blocks, group, chunk_len)
    need = span + SUPER - 1
    h_ext = jnp.stack([jnp.pad(window[0], (0, max(0, need - win_len))),
                       jnp.pad(window[1], (0, max(0, need - win_len)))]
                      )[None, :, :need]
    # valid_len rides into the coarse stage as the scanned-lag bound:
    # masking the per-bin (max, argmax) afterwards would drop a bin's
    # valid peak along with a zero-padded-region shadow (see
    # coarse_rank's num_valid note).
    vals, idxs = coarse_rank(
        ws1, ws2, lmat, h_ext, num_blocks, group, chunk_len,
        num_valid=jnp.reshape(jnp.asarray(valid_len, jnp.int32), (1,)))
    vals = vals[:, 0]
    k_loc = jnp.argmax(vals).astype(jnp.int32)
    tau_loc = idxs[k_loc, 0]
    local = CafPeak(vals[k_loc], k_loc, tau_loc + base_lag)
    take = local.value > best_value
    new_best = CafPeak(
        value=jnp.where(take, local.value, best_value),
        freq_idx=jnp.where(take, local.freq_idx, best_freq),
        lag_idx=jnp.where(take, local.lag_idx, best_lag),
    )
    # Window slice around the winning lag for the exact final re-score.
    wpad = tuple(jnp.pad(p, (0, ext_len - win_len)) for p in window)
    ws = jnp.clip(tau_loc - _RESCORE_GUARD, 0, ext_len - carry)
    cand = tuple(jax.lax.dynamic_slice(p, (ws,), (carry,))
                 for p in wpad)
    new_bw = tuple(jnp.where(take, c, b) for c, b in zip(cand,
                                                         (bw_re, bw_im)))
    new_bw_start = jnp.where(take, base_lag + ws, bw_start)
    new_tail = tuple(
        jax.lax.dynamic_slice(p, (valid_len,), (halo,)) for p in window)
    return new_best, local, new_tail, new_bw, new_bw_start


@functools.partial(
    jax.jit,
    static_argnames=("num_blocks", "group", "chunk_len", "needle_pad",
                     "halo", "num_peaks", "exclude_freq",
                     "exclude_lag"))
def _stein_stream_lattice_step_jit(ws1, ws2, lmat, tail_re, tail_im,
                                   ch_re, ch_im, best_value, best_freq,
                                   best_lag, bws, bw_starts, base_lag,
                                   valid_len, num_blocks, group,
                                   chunk_len, needle_pad, halo,
                                   num_peaks, exclude_freq, exclude_lag):
    """Stein-mode multi-emitter step: top-``num_peaks`` lattice through
    the coarse stage's per-bin TOP-2-SEPARATED (max, argmax), each
    entry carrying its own guard-extended window slice for the exact
    final re-score.

    The ``want_top2`` epilogue carries two ``>exclude_lag``-separated
    lag candidates per doppler bin per chunk window, so two emitters
    sharing a doppler bin at distinct lags BOTH reach the lattice.
    Three-plus same-bin emitters in ONE window still need the
    filterbank streaming lattice.
    """
    from caf_cookoff_tpu.models.batched_stein import (SUPER, coarse_rank,
                                                      fused_span)
    from caf_cookoff_tpu.ops.peak import merge_peaks

    window = (jnp.concatenate([tail_re, ch_re]),
              jnp.concatenate([tail_im, ch_im]))
    win_len = halo + chunk_len
    carry = needle_pad + _RESCORE_PAD
    ext_len = max(win_len, carry)
    span = fused_span(num_blocks, group, chunk_len)
    need = span + SUPER - 1
    h_ext = jnp.stack([jnp.pad(window[0], (0, max(0, need - win_len))),
                       jnp.pad(window[1], (0, max(0, need - win_len)))]
                      )[None, :, :need]
    vals, idxs, vals2, idxs2 = coarse_rank(
        ws1, ws2, lmat, h_ext, num_blocks, group, chunk_len,
        num_valid=jnp.reshape(jnp.asarray(valid_len, jnp.int32), (1,)),
        want_top2=True, sep=exclude_lag)
    k = vals.shape[0]
    bins = jnp.arange(k, dtype=jnp.int32)
    # Slot-2 sentinel (-1.0: no separated second candidate) -> -inf so
    # the merge can neither keep nor suppress with it.
    v2 = jnp.where(vals2[:, 0] < 0, -jnp.inf, vals2[:, 0])
    cands = CafPeak(jnp.concatenate([vals[:, 0], v2]),
                    jnp.concatenate([bins, bins]),
                    jnp.concatenate([idxs[:, 0], idxs2[:, 0]])
                    + base_lag)
    chunk_lat, _ = merge_peaks(cands, num_peaks, exclude_freq,
                               exclude_lag, return_indices=True)
    # Window slice per chunk-lattice entry (vmapped dynamic_slice).
    wpad = jnp.stack([jnp.pad(p, (0, ext_len - win_len))
                      for p in window])                     # (2, ext)
    tau_loc = chunk_lat.lag_idx - base_lag
    starts_loc = jnp.clip(tau_loc - _RESCORE_GUARD, 0, ext_len - carry)

    def slice_one(ws):
        return jax.lax.dynamic_slice(wpad, (0, ws), (2, carry))

    chunk_bws = jax.vmap(slice_one)(starts_loc)             # (P, 2, carry)
    chunk_starts = base_lag + starts_loc
    # Merge the carried lattice with this chunk's, gathering windows.
    all_lat = concat_peaks(CafPeak(best_value, best_freq, best_lag),
                           chunk_lat)
    merged, sel = merge_peaks(all_lat, num_peaks, exclude_freq,
                              exclude_lag, return_indices=True)
    all_bws = jnp.concatenate([bws, chunk_bws])             # (2P, 2, c)
    all_starts = jnp.concatenate([bw_starts, chunk_starts])
    new_bws = all_bws[sel]
    new_starts = all_starts[sel]
    local = CafPeak(chunk_lat.value[0], chunk_lat.freq_idx[0],
                    chunk_lat.lag_idx[0])
    new_tail = tuple(
        jax.lax.dynamic_slice(p, (valid_len,), (halo,)) for p in window)
    return merged, new_bws, new_starts, local, new_tail


@functools.partial(
    jax.jit, static_argnames=("xl", "max_lag", "win", "backend"))
def _stein_lattice_rescore_jit(n_re, n_im, bws, offs, freqs, sample_rate,
                               xl, max_lag, win, backend):
    """Exact filterbank re-score of each carried window: (P,) fields.

    The argmax is DOUBLY constrained:

    * to window lags ``[0, max_lag]`` — the full-overlap neighborhood
      (``max_lag = carry - needle_len``); an unconstrained argmax over
      the window's circular xcor can land on a partial/wrapped
      alignment against ANOTHER emitter's content leaking into the
      slice, at a meaningless absolute lag the post-re-score NMS
      cannot dedup;
    * to ``|lag - offs[i]|`` within ``win`` (one exclusion cell) of
      entry ``i``'s OWN carried candidate — a nearby same-bin stronger
      emitter inside the slice would otherwise win the argmax and
      collapse this entry onto it (the NMS then dedups them into ONE
      peak, silently dropping a real emitter closer than the carry
      length).  One cell of slack covers any flat-top ranking
      ambiguity in the coarse argmax; anything farther is by
      definition a different detection.
    """
    from caf_cookoff_tpu.models.filterbank import _surface_rows_split
    from caf_cookoff_tpu.ops.peak import find_peak_2d

    def one(bw, off):
        rows = _surface_rows_split((n_re, n_im), (bw[0], bw[1]), freqs,
                                   sample_rate, xl, backend)
        mag2 = splitfft.mag2(rows)
        cols = jax.lax.broadcasted_iota(jnp.int32, mag2.shape, 1)
        keep = (cols <= max_lag) & (jnp.abs(cols - off) <= win)
        return find_peak_2d(jnp.where(keep, mag2, -jnp.inf))

    return jax.vmap(one)(bws, offs)


class StreamingCAF:
    """Stateful chunk-at-a-time CAF over one (needle, capture) pair.

    >>> s = StreamingCAF(needle, freqs_hz, sample_rate)
    >>> for chunk in capture_chunks:          # equal-length c64 chunks
    ...     chunk_peak = s.process(chunk)     # this chunk's local peak
    >>> freq, lag, value = s.best()           # global running peak

    ``backend='stein'`` selects the segmented per-chunk path (one
    stage-A dot and one synthesis matmul per chunk instead of K inverse
    FFTs); per-chunk
    local peaks report the coarse (bin-ranked) frequency, and
    :meth:`best` re-scores the carried best window exactly.

    Multi-emitter caveat (``backend='stein*'`` with ``num_peaks > 1``):
    the coarse stage carries TWO separated lag candidates per doppler
    bin per chunk, exact for same-bin emitter pairs more than
    ``exclude_lag`` apart; three-plus same-bin emitters in ONE chunk
    window exceed the two slots.  For that regime use the default
    filterbank backend, whose streaming lattice is exact (see
    :func:`caf_cookoff_tpu.models.batched_stein.coarse_rank`).
    """

    def __init__(self, needle, freqs_hz, sample_rate, *,
                 chunk_len: Optional[int] = None,
                 backend: Optional[str] = None,
                 num_peaks: int = 1,
                 exclude_freq: Optional[int] = None,
                 exclude_lag: Optional[int] = None):
        backend = backend or default_backend()
        self._stein = backend.startswith("stein")
        self._num_peaks = int(num_peaks)
        if backend.startswith("stein"):
            # Engine-level name: the streaming transforms themselves
            # run on a split-FFT tier; 'stein*' flips the segmented mode.
            backend = default_backend()
        self.backend = backend
        n_re, n_im = splitfft.split_array(needle)
        self.needle_len = int(n_re.shape[-1])
        self.sample_rate = float(sample_rate)
        self._freqs = as_grid(freqs_hz, dtype=n_re.dtype)
        # Resolution runs AFTER input validation (an empty needle must
        # raise "empty signal", not divide by zero), ONCE, and only
        # where consumed — the common single-peak XLA stream pays no
        # needle PSD scan at construction.
        if self._stein or (self._num_peaks > 1 and
                           (exclude_freq is None or exclude_lag is None)):
            auto = resolve_exclusions(needle, self._freqs, sample_rate,
                                      None, None)
        if self._num_peaks > 1:
            self._exclude = (
                auto[0] if exclude_freq is None else int(exclude_freq),
                auto[1] if exclude_lag is None else int(exclude_lag))
        if self._stein:
            # The exact re-score's argmax slack around each carried
            # coarse candidate is RESOLUTION-derived (floored at 4
            # samples for bf16 flat-top tie ambiguity), independent of
            # any user NMS override — exclude_lag is a dedup policy
            # knob, not a statement of how far the bf16 coarse argmax
            # may sit from the true peak.
            self._rescore_win = max(auto[1], 4)
        m = xcor_length(self.needle_len)
        rdt = n_re.dtype
        if self._stein:
            from caf_cookoff_tpu.models.batched_stein import (
                SUPER,
                _needle_operator,
                _pow2_block_len,
                stein_synthesis_weights,
            )

            self._block_len = _pow2_block_len(self.sample_rate,
                                              self._freqs, 64)
            pad = (-self.needle_len) % SUPER
            np_re = np.pad(n_re, (0, pad))
            np_im = np.pad(n_im, (0, pad))
            self._needle_pad = self.needle_len + pad
            self._n_planes = (jnp.asarray(np_re), jnp.asarray(np_im))
            self._num_blocks = self._needle_pad // self._block_len
            # One-time eager build (host-sized: (1, 2B, 2*D)); the
            # second return rides to coarse_rank's ``sup`` argument.
            self._lmat, self._group = _needle_operator(
                np_re[None], np_im[None], self._block_len)
            self._ws = stein_synthesis_weights(
                jnp.asarray(self._freqs), self.sample_rate,
                self._num_blocks, self._block_len)
            if self._num_peaks > 1:
                p = self._num_peaks
                self._bws = jnp.zeros((p, 2, self._needle_pad + _RESCORE_PAD),
                                      rdt)
                self._bw_starts = jnp.zeros(p, jnp.int32)
            else:
                self._bw = (jnp.zeros(self._needle_pad + _RESCORE_PAD, rdt),
                            jnp.zeros(self._needle_pad + _RESCORE_PAD, rdt))
                self._bw_start = jnp.asarray(0, jnp.int32)
        else:
            sc = jax.jit(
                needle_spectra_conj, static_argnames=("fft_len", "backend")
            )((jnp.asarray(n_re), jnp.asarray(n_im)),
              jnp.asarray(self._freqs), self.sample_rate, fft_len=m,
              backend=self.backend)
            self._sc_re, self._sc_im = sc
        halo = self.needle_len - 1
        self._tail = (jnp.zeros(halo, rdt), jnp.zeros(halo, rdt))
        # Noise-floor state: measured (sum, count) accumulators for the
        # XLA paths; sample-energy sums for the stein path's model
        # floor (the coarse stage emits per-bin maxima, not cells).
        self._fsum = jnp.zeros((), rdt)
        self._fcnt = jnp.zeros((), rdt)
        self._h2_sum = 0.0
        self._needle_energy = float(np.sum(np.asarray(n_re) ** 2)
                                    + np.sum(np.asarray(n_im) ** 2))
        if self._num_peaks > 1:
            p = self._num_peaks
            self._best = CafPeak(jnp.full(p, -np.inf, rdt),
                                 jnp.zeros(p, jnp.int32),
                                 jnp.zeros(p, jnp.int32))
        else:
            self._best = CafPeak(jnp.asarray(-np.inf, rdt),
                                 jnp.asarray(0, jnp.int32),
                                 jnp.asarray(0, jnp.int32))
        self._samples_seen = 0
        # One executable per stream: the chunk length is pinned (here,
        # or by the first chunk seen); shorter chunks are zero-padded
        # with their surplus lags masked, longer ones are split.
        self._chunk_len = int(chunk_len) if chunk_len else None
        # Lag t needs samples [t, t + N); the first (N-1)-sample tail is
        # synthetic zeros, so window lags start at -(N-1).
        self._base_lag = -(self.needle_len - 1)

    @property
    def samples_seen(self) -> int:
        return self._samples_seen

    def noise_floor(self) -> float:
        """Mean mag^2 per surface cell over everything seen so far.

        XLA paths: measured — the per-window scans accumulate
        (sum, count) over every valid cell (the surface never
        materializes).  Stein path: the exponential-cell model
        ``Σ|n|² · mean|h|²`` (a noise-only xcor cell is a
        complex-Gaussian sum with that second moment) — the coarse
        stage reduces each bin to its (max, argmax), so there are no
        cells to average.  Returns 0.0 before any chunk.
        """
        if self._stein:
            if self._samples_seen == 0:
                return 0.0
            return self._needle_energy * self._h2_sum / self._samples_seen
        cnt = float(self._fcnt)
        return float(self._fsum) / cnt if cnt > 0 else 0.0

    def searched_cells(self) -> int:
        """Number of (doppler, lag) cells searched so far — the ``n``
        of the false-alarm calculation in
        :func:`caf_cookoff_tpu.ops.peak.detection_threshold_db`."""
        return int(self._samples_seen) * int(len(self._freqs))

    def process(self, chunk) -> Tuple[float, int, float]:
        """Consume one chunk; returns this chunk's (freq, lag, value).

        Lags are absolute sample indices into the capture; a chunk's
        window also covers correlations that straddle the previous
        chunk boundary (negative early lags are clipped by the caller's
        interpretation — sample index 0 is the capture start).

        Any chunk length is accepted without recompiling: the stream's
        executable is specialized to one pinned length; short chunks
        (e.g. a capture's final remainder) are zero-padded and their
        surplus lags masked, oversized ones processed in slices.
        """
        ch_re, ch_im = splitfft.split_array(chunk)
        valid = int(ch_re.shape[-1])
        if valid < 1:
            raise ValueError("empty chunk")
        if self._chunk_len is None:
            self._chunk_len = valid
        fixed = self._chunk_len
        if valid > fixed:
            # Oversized chunk: process in slices; the reported local
            # peak is the best across ALL slices (the documented
            # "this chunk's peak" contract), not the last slice's.
            best = None
            for off in range(0, valid, fixed):
                local = self._step(ch_re[off:off + fixed],
                                   ch_im[off:off + fixed])
                if best is None or local[2] > best[2]:
                    best = local
            return best
        return self._step(ch_re, ch_im)

    def _step(self, ch_re, ch_im) -> Tuple[float, int, float]:
        fixed = self._chunk_len
        valid = int(ch_re.shape[-1])
        if valid < fixed:
            pad = fixed - valid
            ch_re = np.pad(np.asarray(ch_re), (0, pad))
            ch_im = np.pad(np.asarray(ch_im), (0, pad))
        if self._stein and self._num_peaks > 1:
            best, bws, starts, local, tail = _stein_stream_lattice_step_jit(
                self._ws[0], self._ws[1], self._lmat,
                self._tail[0], self._tail[1],
                jnp.asarray(ch_re), jnp.asarray(ch_im),
                self._best.value, self._best.freq_idx,
                self._best.lag_idx, self._bws, self._bw_starts,
                self._base_lag, valid, self._num_blocks, self._group,
                fixed, self._needle_pad, self.needle_len - 1,
                self._num_peaks, *self._exclude)
            self._bws = bws
            self._bw_starts = starts
        elif self._stein:
            best, local, tail, bw, bw_start = _stein_stream_step_jit(
                self._ws[0], self._ws[1], self._lmat,
                self._tail[0], self._tail[1],
                jnp.asarray(ch_re), jnp.asarray(ch_im),
                self._best.value, self._best.freq_idx,
                self._best.lag_idx, self._bw[0], self._bw[1],
                self._bw_start, self._base_lag, valid,
                self._num_blocks, self._group, fixed,
                self._needle_pad, self.needle_len - 1)
            self._bw = bw
            self._bw_start = bw_start
        elif self._num_peaks > 1:
            best, local, tail, fsum, fcnt = _stream_lattice_step_jit(
                self._sc_re, self._sc_im, self._tail[0], self._tail[1],
                jnp.asarray(ch_re), jnp.asarray(ch_im),
                self._best.value, self._best.freq_idx,
                self._best.lag_idx, self._fsum, self._fcnt,
                self._base_lag, valid, self.needle_len, fixed,
                self.backend, self._num_peaks, *self._exclude)
            self._fsum, self._fcnt = fsum, fcnt
            # The contract: report this chunk's strongest local peak.
            local = CafPeak(local.value[0], local.freq_idx[0],
                            local.lag_idx[0])
        else:
            best, local, tail, fsum, fcnt = _stream_step_jit(
                self._sc_re, self._sc_im, self._tail[0], self._tail[1],
                jnp.asarray(ch_re), jnp.asarray(ch_im),
                self._best.value, self._best.freq_idx,
                self._best.lag_idx, self._fsum, self._fcnt,
                self._base_lag, valid, self.needle_len, fixed,
                self.backend)
            self._fsum, self._fcnt = fsum, fcnt
        if self._stein:
            # Model-floor inputs: only the VALID samples of this chunk.
            self._h2_sum += float(np.sum(np.asarray(ch_re[:valid]) ** 2)
                                  + np.sum(np.asarray(ch_im[:valid]) ** 2))
        self._best = best
        self._tail = tail
        self._samples_seen += valid
        self._base_lag += valid
        return (float(self._freqs[int(local.freq_idx)]),
                int(local.lag_idx), float(local.value))

    def best(self) -> Tuple[float, int, float]:
        """Global running (freq_hz, lag, value) over everything seen.

        In stein mode the coarse running best only RANKED bins; the
        carried best window is re-scored here with exact filterbank
        rows (the rank-then-score contract), restoring bin-exact
        frequency and lag.
        """
        if self._num_peaks > 1:
            if self._stein:
                fr, lg, vv = self.peaks()
                return float(fr[0]), int(lg[0]), float(vv[0])
            return (float(self._freqs[int(self._best.freq_idx[0])]),
                    int(self._best.lag_idx[0]),
                    float(self._best.value[0]))
        if not self._stein or not np.isfinite(float(self._best.value)):
            return (float(self._freqs[int(self._best.freq_idx)]),
                    int(self._best.lag_idx), float(self._best.value))
        off = (jnp.reshape(self._best.lag_idx, (1,))
               - jnp.reshape(self._bw_start, (1,))).astype(jnp.int32)
        pk = _stein_lattice_rescore_jit(
            self._n_planes[0], self._n_planes[1],
            jnp.stack(self._bw)[None], off, jnp.asarray(self._freqs),
            self.sample_rate, xcor_length(self._needle_pad),
            self._needle_pad + _RESCORE_PAD - self.needle_len,
            self._rescore_win, self.backend)
        return (float(self._freqs[int(pk.freq_idx[0])]),
                int(self._bw_start) + int(pk.lag_idx[0]),
                float(pk.value[0]))

    def peaks(self, min_snr_db=None, with_snr: bool = False):
        """Global running top-``num_peaks`` lattice, strongest first.

        Returns ``(freqs_hz (P,), lags (P,), values (P,)[, snr_db])``
        numpy arrays; slots past the number of distinct detections
        carry ``value=-inf``.  Requires ``num_peaks > 1`` at
        construction (the single-peak stream keeps its cheaper scalar
        carry).

        Detection decisions: ``min_snr_db`` (float or ``"auto"``) masks
        slots whose peak-to-:meth:`noise_floor` dB falls below the
        threshold to ``-inf`` — a slot holding a noise maximum stops
        counting as an emitter; ``with_snr=True`` appends the per-slot
        dB.

        In stein mode the running lattice only RANKED; here each
        entry's carried window is re-scored with exact filterbank rows
        (the per-entry rank-then-score contract), then the lattice
        re-sorts on the exact values.
        """
        from caf_cookoff_tpu.ops.peak import apply_detection_threshold

        if self._num_peaks <= 1:
            raise ValueError(
                "stream was built with num_peaks=1; construct "
                "StreamingCAF(..., num_peaks=P) to track a lattice")

        def _finish(freqs, lags, values):
            if min_snr_db is None and not with_snr:
                return freqs, lags, values
            vals, snr, _ = apply_detection_threshold(
                values, self.noise_floor(), self.searched_cells(),
                min_snr_db)
            out = (freqs, lags, vals)
            return out + ((snr,) if with_snr else ())

        if not self._stein:
            freq_idx = np.asarray(self._best.freq_idx)
            return _finish(np.asarray(self._freqs)[freq_idx],
                           np.asarray(self._best.lag_idx),
                           np.asarray(self._best.value))
        offs = (jnp.asarray(self._best.lag_idx)
                - jnp.asarray(self._bw_starts)).astype(jnp.int32)
        pk = _stein_lattice_rescore_jit(
            self._n_planes[0], self._n_planes[1], self._bws, offs,
            jnp.asarray(self._freqs), self.sample_rate,
            xcor_length(self._needle_pad),
            self._needle_pad + _RESCORE_PAD - self.needle_len,
            self._rescore_win, self.backend)
        coarse_ok = np.isfinite(np.asarray(self._best.value))
        vals = np.where(coarse_ok, np.asarray(pk.value), -np.inf)
        bins = np.asarray(pk.freq_idx)
        lags = np.asarray(self._bw_starts) + np.asarray(pk.lag_idx)
        order = np.argsort(-vals, kind="stable")
        # Post-re-score NMS: two coarse cells (e.g. a doppler sidelobe
        # beyond the bin exclusion) can re-score onto the SAME exact
        # peak — dedup with the same exclusion windows (host-side; P
        # entries).
        ef, el = self._exclude
        kept = []
        for i in order:
            if np.isfinite(vals[i]) and any(
                    abs(int(bins[i]) - int(bins[j])) <= ef
                    and abs(int(lags[i]) - int(lags[j])) <= el
                    for j in kept):
                continue
            kept.append(i)
        out_f = np.full(self._num_peaks, 0.0)
        out_l = np.zeros(self._num_peaks, np.int64)
        out_v = np.full(self._num_peaks, -np.inf)
        freqs_np = np.asarray(self._freqs)
        for p, i in enumerate(kept[: self._num_peaks]):
            if not np.isfinite(vals[i]):
                break
            out_f[p] = freqs_np[int(bins[i])]
            out_l[p] = int(lags[i])
            out_v[p] = vals[i]
        return _finish(out_f, out_l, out_v)
