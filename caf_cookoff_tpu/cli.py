"""Command-line interface.

The reference hardcodes every parameter in three separate ``main``s and
left Rust CLI support as a TODO that never landed
(``caf_rust/src/main.rs:1-2``); its only runtime knob is ``GOMAXPROCS``
(``README.md:48-49``).  This CLI exposes the whole framework:

  caf-tpu generate  — synthesize the deterministic chirp fixtures
                      (``utils/generate.py`` parity)
  caf-tpu run       — CAF a (needle, haystack) pair: peak + optional
                      surface dump/plot (the three reference mains)
  caf-tpu bench     — strategy table over backends, README-style
  caf-tpu selftest  — the 10 golden fixtures on the active device
                      (the reference's ``cargo test`` lane, user-facing)
  caf-tpu info      — devices, mesh, backend resolution

Usage: ``python -m caf_cookoff_tpu <cmd> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from caf_cookoff_tpu.config import (
    BACKENDS,
    DEFAULT_SAMPLE_RATE,
    BENCH_GRID,
    FreqGrid,
    default_backend,
    enable_compile_cache,
)
from caf_cookoff_tpu.errors import EngineError


def _add_grid_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--freq-start", type=float, default=BENCH_GRID.start_hz,
                   help="doppler grid start (Hz)")
    p.add_argument("--freq-stop", type=float, default=BENCH_GRID.stop_hz,
                   help="doppler grid stop, exclusive (Hz)")
    p.add_argument("--freq-step", type=float, default=BENCH_GRID.step_hz,
                   help="doppler grid step (Hz)")
    p.add_argument("--fs", type=float, default=None,
                   help=f"sample rate (Hz; default {DEFAULT_SAMPLE_RATE:g},"
                   " or the recording's core:sample_rate for SigMF input)")
    p.add_argument("--backend", choices=("auto",) + BACKENDS,
                   default="auto", help="FFT backend (auto: xla, cuFFT "
                   "on the GPU; stein = segmented fast path + exact "
                   "refinement; stein* streaming with --num-peaks>1 "
                   "resolves same-bin emitter pairs only when separated "
                   "by more than one exclusion cell, and at most two "
                   "per bin — use the default backend for denser "
                   "same-bin scenes)")


def _resolve_backend(name: str) -> str:
    return default_backend() if name == "auto" else name


def _grid(args) -> FreqGrid:
    return FreqGrid(args.freq_start, args.freq_stop, args.freq_step)


def cmd_generate(args) -> int:
    from caf_cookoff_tpu.utils.generate import synthesize_fixtures

    pairs = synthesize_fixtures(args.out, count=args.count, seed=args.seed)
    for needle, haystack in pairs:
        print(f"{needle}  +  {haystack}")
    return 0


def _load_signal(path: str, segment: Optional[int] = None):
    """Load .c64 raw samples or a SigMF recording (either sidecar).

    Returns ``(samples, meta_fs)`` — ``meta_fs`` is the recording's own
    ``core:sample_rate`` (``None`` for raw .c64, which carries none).
    ``segment`` selects one capture segment of a multi-capture SigMF
    recording (sample indices then count from that segment's start).
    """
    from caf_cookoff_tpu.utils.io import load_c64

    if ".sigmf" in path:
        from caf_cookoff_tpu.utils.sigmf import read_sigmf

        rec = read_sigmf(path)
        if segment is not None:
            return rec.segment(segment), (rec.sample_rate or None)
        if len(rec.captures) > 1:
            print(f"note: {path} has {len(rec.captures)} capture "
                  f"segments; processing the whole stream (use "
                  f"--segment N to select one)", file=sys.stderr)
        return rec.samples, (rec.sample_rate or None)
    if segment not in (None, 0):
        raise ValueError("--segment applies only to SigMF recordings")
    return load_c64(path), None


def _effective_fs(args, *meta_rates) -> float:
    """Reconcile ``--fs`` with SigMF-recorded sample rates.

    A silently mismatched fs gives a confidently wrong doppler axis, so:
    recordings that carry a rate override the *default* fs (with a
    note), and conflict with an *explicit* ``--fs`` loudly (the explicit
    flag wins — the user may be deliberately re-labeling the axis).
    """
    explicit = args.fs is not None
    fs = args.fs if explicit else DEFAULT_SAMPLE_RATE
    rates = {float(r) for r in meta_rates if r}
    if not rates:
        return fs
    if len(rates) > 1:
        print(f"WARNING: needle/haystack recordings disagree on "
              f"core:sample_rate ({sorted(rates)}); using fs={fs:g}",
              file=sys.stderr)
        return fs
    meta = rates.pop()
    if abs(meta - fs) <= 1e-6 * max(meta, fs):
        return fs
    if not explicit:
        print(f"note: using the recording's core:sample_rate "
              f"{meta:g} Hz (no explicit --fs given)", file=sys.stderr)
        return meta
    print(f"WARNING: --fs={fs:g} != recording core:sample_rate "
          f"{meta:g}; doppler estimates use --fs", file=sys.stderr)
    return fs


_SPLIT_FFT_TIERS = ("xla", "matmul", "matmul-highest", "matmul-bf16")


def _parse_min_snr(value):
    """``--min-snr-db`` parser: 'auto' (cell-count-derived threshold),
    'none'/'off' (disable masking), or a float dB value."""
    if value is None:
        return None
    s = str(value).strip().lower()
    if s in ("none", "off"):
        return None
    if s == "auto":
        return "auto"
    try:
        return float(s)
    except ValueError:
        raise SystemExit(
            f"error: --min-snr-db wants 'auto', 'none', or a float dB "
            f"value, got {value!r}")


def _print_lattice(rows, num_peaks: int, min_snr, min_snr_arg,
                   refine_fn=None) -> None:
    """Shared multi-peak listing of ``run`` and ``stream``: the
    "Detections: N of M" line (when a threshold is active), per-peak
    rows with below-threshold / no-further-peaks tags, and an optional
    refine suffix per finite row.

    ``rows`` is ``[(freq_hz, lag, value, snr_db), ...]`` (value −inf
    for empty/masked slots); ``refine_fn(freq_hz, lag) -> (f, t)``
    appends the sub-bin estimate when given.
    """
    if min_snr is not None:
        n_det = sum(1 for r in rows if np.isfinite(r[2]))
        print(f"Detections: {n_det} of {num_peaks} lattice "
              f"slots pass the SNR threshold "
              f"(--min-snr-db {min_snr_arg})")
    for i, (f_hz, lag_i, val, snr_db) in enumerate(rows):
        if not np.isfinite(val):
            tag = ("below detection threshold" if np.isfinite(snr_db)
                   else "no further distinct peaks")
            print(f"peak {i + 1}: ({tag})")
            continue
        line = (f"peak {i + 1}: {f_hz:+9.3f} Hz "
                f"@ lag {lag_i:>6d}  ({val:.5g}, {snr_db:.1f} dB)")
        if refine_fn is not None:
            f_ref, t_ref = refine_fn(f_hz, lag_i)
            line += f"  refined {f_ref:+9.4f} Hz @ {t_ref:.4f}"
        print(line)


def _split_fft_tier(backend: str) -> str:
    """Map an engine-level backend name (stein*) to a valid split-FFT
    tier for the overlap-save streaming path, which composes transforms
    directly rather than going through a surface engine."""
    return backend if backend in _SPLIT_FFT_TIERS else default_backend()


def cmd_run(args) -> int:
    from caf_cookoff_tpu.config import xcor_length
    from caf_cookoff_tpu.models.filterbank import caf_peak, caf_surface
    from caf_cookoff_tpu.models.overlap_save import overlap_save_peak
    from caf_cookoff_tpu.utils.io import dump_surf, save_npy
    from caf_cookoff_tpu.utils.profiling import (
        RunReport,
        Stopwatch,
        peak_to_floor_db,
    )

    backend = _resolve_backend(args.backend)
    needle, n_fs = _load_signal(args.needle)
    haystack, h_fs = _load_signal(args.haystack, segment=args.segment)
    fs = _effective_fs(args, n_fs, h_fs)
    freqs = _grid(args).frequencies(np.float32)

    full = args.full_haystack and len(haystack) > len(needle)
    haystack_full = haystack        # --refine reads past any truncation
    # Which engine actually answered (fallbacks reroute, and the user
    # should see that, not infer it): solve() records it here.
    state = {"engine": f"filterbank[{backend}]", "noted": False}
    if full:
        use_stein = args.backend == "auto" or backend.startswith("stein")

        def solve():
            if use_stein:
                try:
                    from caf_cookoff_tpu.models.stein import (
                        stein_overlap_save_peak,
                    )

                    out = stein_overlap_save_peak(
                        needle, haystack, freqs, fs,
                        refine=not backend.endswith("raw"))
                    state["engine"] = "stein-os (segmented long-capture)"
                    return out
                except EngineError as exc:
                    # Only the typed envelope conditions (span, layout
                    # eligibility) reroute; a genuine bug
                    # propagates instead of silently downgrading.
                    if not state["noted"]:
                        print(f"note: segmented engine ineligible "
                              f"({exc}); using the overlap-save scan",
                              file=sys.stderr)
                        state["noted"] = True
            state["engine"] = "overlap-save scan"
            f_os, l_os, v_os, snr_os = overlap_save_peak(
                needle, haystack, freqs, fs,
                backend=_split_fft_tier(backend), with_snr=True)
            state["snr_db"] = snr_os
            return f_os, l_os, v_os
    else:
        haystack = haystack[: len(needle)]

        def solve():
            return caf_peak(needle, haystack, freqs, fs, backend=backend)

    with Stopwatch() as sw0:
        freq, lag, value = solve()      # first call pays the compile
    if sw0.ms < 2_000.0:
        with Stopwatch() as sw:
            solve()                     # cached re-run = honest timing
        elapsed_ms = sw.ms
    else:
        # A multi-second search is not worth doubling just for the
        # throughput metric; elapsed stays unreported.
        elapsed_ms = None

    # Surface for observability + surface-derived artifacts.  With
    # --full-haystack the preference order is: the FULL overlap-save
    # surface when it fits comfortably in memory (all lags — multi-peak
    # listings really cover the capture), else the needle-length window
    # around the FOUND lag (``lag_origin`` maps window lags back to
    # absolute capture lags) — never the blind truncated prefix, which
    # could contradict the reported peak.
    n = len(needle)
    # Multi-peak on a long capture runs the lattice scan (below), not a
    # materialized surface — it must see the WHOLE capture, not a
    # window around the strongest peak.
    want_artifacts = bool(args.dump_surface or args.plot
                          or (args.num_peaks > 1 and not full))
    lag_origin = 0
    surface = None
    windowed_note = False
    if full:
        total_lags = len(haystack) - n + 1
        if want_artifacts and len(freqs) * total_lags <= 2 ** 26:
            from caf_cookoff_tpu.models.overlap_save import (
                overlap_save_surface,
            )

            surface = np.asarray(overlap_save_surface(
                needle, haystack, freqs, fs,
                backend=_split_fft_tier(backend)))
        elif want_artifacts:
            lag_origin = max(0, min(lag - 64, len(haystack) - n))
            window = np.asarray(haystack[lag_origin:lag_origin + n])
            surface = np.asarray(caf_surface(needle, window, freqs, fs,
                                             backend=backend))
            windowed_note = True
    else:
        surface = np.asarray(caf_surface(needle, haystack, freqs, fs,
                                         backend=backend))

    # The reference's result lines (`caf_rust/src/main.rs:29-31`,
    # `caf_go/main.go:35`) plus the structured observability the
    # reference lacks (peak/floor confidence, surfaces/s).
    report = RunReport(
        freq_hz=freq, lag_samples=lag, peak_value=value,
        sample_rate=fs, num_doppler_bins=len(freqs),
        xcor_len=xcor_length(n), elapsed_ms=elapsed_ms,
        peak_to_floor_db=(peak_to_floor_db(surface, value)
                          if surface is not None
                          else state.get("snr_db")),
        backend=backend)
    print(report.result_lines())
    print(f"Peak value: {value:.6g}")
    print(f"Engine: {state['engine']}")
    if windowed_note:
        print(f"note: surface-derived outputs cover a {n}-sample window "
              f"at lag {lag_origin} (capture too large for the full "
              f"surface)", file=sys.stderr)

    if args.annotate and ".sigmf" in args.haystack:
        from caf_cookoff_tpu.utils.sigmf import (
            annotate_detection,
            caf_annotation,
        )

        # With --segment the lag is segment-relative; annotate_detection
        # rebases it to the absolute data-file index of that capture.
        annotate_detection(args.haystack, caf_annotation(
            lag, len(needle), freq, value, needle_id=args.needle),
            segment=args.segment)
        print(f"annotation -> {args.haystack}"
              + (f" (segment {args.segment})"
                 if args.segment is not None else ""))

    # Refinement takes SIGNED absolute capture offsets.  Full-haystack
    # lags already are; the truncated path reports the reference's raw
    # circular xcor index (wrap region = negative lags), which must be
    # un-wrapped before it can index the capture.
    def _signed(raw_lag: int) -> int:
        from caf_cookoff_tpu.ops.peak import unwrap_lag

        return int(raw_lag) if full else unwrap_lag(raw_lag,
                                                    xcor_length(n), n)

    if args.refine:
        from caf_cookoff_tpu.ops.refine import refine_peak

        f_ref, t_ref, v_ref = refine_peak(
            needle, haystack_full, freq, _signed(lag), fs,
            coarse_step_hz=args.freq_step,
            backend=_split_fft_tier(backend))
        print(f"Refined estimate: {f_ref:+.4f} Hz, {t_ref:.4f} "
              f"samples ({t_ref / fs * 1e3:.6f} ms)")
    rate_lattice_done = False
    if args.rate_grid:
        # Hard sweeps (first-order surface smeared): coarse dechirp
        # bank, then the joint refine bracketed at the bank's answer.
        from caf_cookoff_tpu.ops.peak import unwrap_lag
        from caf_cookoff_tpu.ops.refine import refine_peak_rate

        try:
            r0s, r1s, rss = args.rate_grid.split(":")
            rates = np.arange(float(r0s), float(r1s) + 1e-9, float(rss))
        except ValueError:
            print(f"error: --rate-grid wants START:STOP:STEP, got "
                  f"{args.rate_grid!r}", file=sys.stderr)
            return 2
        if full and args.num_peaks > 1:
            # Multi-emitter through the joint (rate, doppler, lag)
            # search: per-rate lattice scans cross-rate-merged in
            # window-center frequency space (a strong emitter's
            # residual-chirp ridge cannot displace a weaker real one),
            # with the same detection threshold the first-order lattice
            # paths apply.  This REPLACES the first-order lattice below
            # — a swept emitter is smeared there but coherent here.
            from caf_cookoff_tpu.models.rate import (
                rate_overlap_save_peaks,
                stein_rate_os_peaks,
            )

            min_snr = _parse_min_snr(args.min_snr_db)
            try:
                # Segmented fast path (round 5): trial rates as
                # synthesis rows; falls back to the exact serial scan
                # outside the segmented envelope.  (SNR here is
                # against the model floor — the serial engine measures
                # it — same dB scale, documented in the engine.)
                rr, fr, lg, vv, snr = stein_rate_os_peaks(
                    needle, haystack, freqs, rates, fs, args.num_peaks,
                    backend=_split_fft_tier(backend),
                    min_snr_db=min_snr, with_snr=True)
            except EngineError as exc:
                print(f"note: rate grid outside the segmented "
                      f"envelope ({exc}); using the serial scan",
                      file=sys.stderr)
                rr, fr, lg, vv, snr = rate_overlap_save_peaks(
                    needle, haystack, freqs, rates, fs, args.num_peaks,
                    backend=_split_fft_tier(backend),
                    min_snr_db=min_snr, with_snr=True)
            if min_snr is not None:
                n_det = int(np.sum(np.isfinite(vv)))
                print(f"Detections: {n_det} of {args.num_peaks} "
                      f"rate-lattice slots pass the SNR threshold "
                      f"(--min-snr-db {args.min_snr_db})")
            for i in range(args.num_peaks):
                if not np.isfinite(vv[i]):
                    tag = ("below detection threshold"
                           if np.isfinite(snr[i])
                           else "no further distinct peaks")
                    print(f"peak {i + 1}: ({tag})")
                    continue
                line = (f"peak {i + 1}: {fr[i]:+9.3f} Hz "
                        f"{rr[i]:+8.1f} Hz/s @ lag {int(lg[i]):>6d}  "
                        f"({vv[i]:.5g}, {snr[i]:.1f} dB)")
                if args.refine:
                    f2, r2, t2, _ = refine_peak_rate(
                        needle, haystack_full, float(fr[i]),
                        int(lg[i]), fs, rate0_hz_per_s=float(rr[i]),
                        max_rate_hz_per_s=float(rss),
                        coarse_step_hz=args.freq_step,
                        backend=_split_fft_tier(backend))
                    line += (f"  refined {f2:+9.4f} Hz "
                             f"{r2:+8.3f} Hz/s @ {t2:.4f}")
                print(line)
            rate_lattice_done = True
        elif full:
            # Joint (rate, doppler, lag) search over the WHOLE capture:
            # the dechirp bank rides the overlap-save block scan, so an
            # accelerating emitter at ANY lag is found (the bank on a
            # needle-length prefix would miss everything past it).
            # Overlap-save lags are linear — no circular unwrap.
            from caf_cookoff_tpu.models.rate import (
                rate_overlap_save_peak,
                stein_rate_os_peak,
            )

            try:
                r_c, f_c, lag_c, v_c = stein_rate_os_peak(
                    needle, haystack, freqs, rates, fs,
                    backend=_split_fft_tier(backend))
            except EngineError as exc:
                print(f"note: rate grid outside the segmented "
                      f"envelope ({exc}); using the serial scan",
                      file=sys.stderr)
                r_c, f_c, lag_c, v_c = rate_overlap_save_peak(
                    needle, haystack, freqs, rates, fs,
                    backend=_split_fft_tier(backend))
            lag_signed = int(lag_c)
        else:
            from caf_cookoff_tpu.models.rate import rate_caf_peak

            r_c, f_c, lag_c, v_c = rate_caf_peak(
                needle, haystack[: len(needle)], freqs, rates, fs,
                backend=backend)
            # The bank's lag is a raw CIRCULAR xcor index from the
            # truncated window — a wrap-region (negative) lag must not
            # reach the refiner as a huge positive capture offset.
            lag_signed = unwrap_lag(lag_c, xcor_length(n), n)
        if not rate_lattice_done:
            print(f"Rate-bank peak: {f_c:+.3f} Hz {r_c:+.1f} Hz/s "
                  f"@ lag {lag_signed} ({v_c:.5g})")
            f2, r2, t2, _ = refine_peak_rate(
                needle, haystack_full, f_c, lag_signed, fs,
                rate0_hz_per_s=r_c,
                max_rate_hz_per_s=float(rss),
                coarse_step_hz=args.freq_step,
                backend=_split_fft_tier(backend))
            print(f"Second-order estimate: {f2:+.4f} Hz "
                  f"{r2:+.3f} Hz/s @ {t2:.4f} samples")
    elif args.rate:
        from caf_cookoff_tpu.ops.refine import refine_peak_rate

        f2, r2, t2, _ = refine_peak_rate(
            needle, haystack_full, freq, _signed(lag), fs,
            coarse_step_hz=args.freq_step,
            backend=_split_fft_tier(backend))
        print(f"Second-order estimate: {f2:+.4f} Hz "
              f"{r2:+.3f} Hz/s @ {t2:.4f} samples")
    if args.num_peaks > 1 and not rate_lattice_done:
        from caf_cookoff_tpu.ops.peak import (
            apply_detection_threshold,
            find_peaks,
            resolution_cell,
        )

        min_snr = _parse_min_snr(args.min_snr_db)
        # Exclusion windows = the waveform's resolution cell (doppler
        # mainlobe fs/N Hz in grid bins, lag mainlobe fs/bandwidth
        # samples), so mainlobe skirts don't re-detect on any grid.
        excl_f, excl_l = resolution_cell(needle, freqs, fs)
        if full:
            # Lattice over the WHOLE capture — no surface ever
            # materializes, so distant emitters are never windowed out.
            # The fused multi-emitter engine (round 5) when the shape
            # fits; the XLA lattice scan otherwise.
            from caf_cookoff_tpu.models.batched_stein import (
                batched_stein_os_peaks,
            )
            from caf_cookoff_tpu.models.overlap_save import (
                overlap_save_peaks,
            )

            try:
                # SNR here is against the engine's MODEL floor
                # (sum|n|^2 * mean|h|^2); the XLA fallback MEASURES its
                # floor — same dB scale, near-threshold slots can flip
                # between the two engines (documented in the engine).
                lf, ll, lv, lsnr = batched_stein_os_peaks(
                    np.asarray(needle)[None], np.asarray(haystack)[None],
                    freqs, fs, args.num_peaks, exclude_freq=excl_f,
                    exclude_lag=excl_l, backend=_split_fft_tier(backend),
                    min_snr_db=min_snr, with_snr=True)
                fr, lg, vv, snr = lf[0], ll[0], lv[0], lsnr[0]
            except EngineError as exc:
                print(f"note: lattice shape outside the fused engine's "
                      f"envelope ({exc}); using the XLA lattice scan",
                      file=sys.stderr)
                fr, lg, vv, snr = overlap_save_peaks(
                    needle, haystack, freqs, fs, args.num_peaks,
                    exclude_freq=excl_f, exclude_lag=excl_l,
                    backend=_split_fft_tier(backend),
                    min_snr_db=min_snr, with_snr=True)
            rows = list(zip(fr.tolist(), lg.tolist(), vv.tolist(),
                            snr.tolist()))
        else:
            # Truncated haystack -> CIRCULAR xcor surface: pass the lag
            # period so a peak's wrap-around skirt cannot take a slot.
            pks = find_peaks(surface, args.num_peaks,
                             exclude_freq=excl_f, exclude_lag=excl_l,
                             lag_period=surface.shape[-1])
            # Materialized surface: the floor is its mean directly.
            vals, snr, _ = apply_detection_threshold(
                np.asarray(pks.value), float(surface.mean()),
                surface.size, min_snr)
            # Raw circular surface columns un-wrap to SIGNED lags:
            # a wrap-region peak (capture leading the needle) is a
            # negative lag, not a huge positive one.
            rows = [(float(freqs[int(pks.freq_idx[i])]),
                     _signed(int(pks.lag_idx[i])) + lag_origin,
                     float(vals[i]), float(snr[i]))
                    for i in range(args.num_peaks)]
        refine_fn = None
        if args.refine:
            from caf_cookoff_tpu.ops.refine import refine_peak

            # One cached executable serves every peak (same shapes).
            refine_fn = lambda f_hz, lag_i: refine_peak(
                needle, haystack_full, f_hz, lag_i, fs,
                coarse_step_hz=args.freq_step,
                backend=_split_fft_tier(backend))[:2]
        _print_lattice(rows, args.num_peaks, min_snr, args.min_snr_db,
                       refine_fn)
    if args.dump_surface:
        if args.dump_surface.endswith(".npy"):
            save_npy(args.dump_surface, surface)
        else:
            # Go parity: raw little-endian f64 rows
            # (`caf_go/caf.go:14-29`, main.go:37 dumps to /tmp/derp).
            dump_surf(args.dump_surface, surface.astype(np.float64))
        origin_note = (f", lag axis offset +{lag_origin}" if lag_origin
                       else "")
        print(f"surface ({surface.shape[0]}x{surface.shape[1]}) -> "
              f"{args.dump_surface}{origin_note}")
    if args.plot:
        _plot_surface(surface, freqs, args.plot, lag_origin=lag_origin)
    return 0


def _plot_surface(surface: np.ndarray, freqs: np.ndarray,
                  out_path: str, lag_origin: int = 0) -> None:
    """imshow of the delay-doppler surface (caf_python/caf.py:150-163
    parity, minus its left-right mirror quirk noted at :120)."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("error: --plot needs matplotlib (install the "
                         "'plot' extra: pip install .[plot])") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kmax, tmax = np.unravel_index(surface.argmax(), surface.shape)
    fig, ax = plt.subplots(figsize=(8, 6))
    extent = (lag_origin, lag_origin + surface.shape[1],
              float(freqs[-1]), float(freqs[0]))
    ax.imshow(10 * np.log10(surface + 1e-20), aspect="auto", extent=extent,
              cmap="viridis")
    ax.plot(lag_origin + tmax + 0.5, freqs[kmax], "rx", markersize=12)
    ax.set_xlabel("lag (samples)")
    ax.set_ylabel("doppler (Hz)")
    ax.set_title(f"CAF surface — peak {freqs[kmax]:+.2f} Hz @ "
                 f"{lag_origin + tmax} samp")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print(f"plot -> {out_path}")


def cmd_stream(args) -> int:
    """Chunked live-capture processing (StreamingCAF)."""
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    backend = _resolve_backend(args.backend)
    needle, n_fs = _load_signal(args.needle)
    if args.follow:
        import json as _json

        from caf_cookoff_tpu.utils.sigmf import _base, follow_sigmf

        # Only the tiny .sigmf-meta is read — the (possibly huge, still
        # growing) data file streams chunk-by-chunk below.
        with open(_base(args.capture) + ".sigmf-meta") as f:
            c_fs = _json.load(f).get("global", {}).get(
                "core:sample_rate") or None
        chunks = follow_sigmf(args.capture, chunk=args.chunk,
                              idle_timeout_s=args.idle_timeout)
    else:
        capture, c_fs = _load_signal(args.capture, segment=args.segment)
        chunks = (capture[s:s + args.chunk]
                  for s in range(0, len(capture), args.chunk))
    args.fs = _effective_fs(args, n_fs, c_fs)
    freqs = _grid(args).frequencies(np.float32)

    engine = StreamingCAF(needle, freqs, args.fs, chunk_len=args.chunk,
                          backend=backend, num_peaks=args.num_peaks)
    t0 = time.perf_counter()
    start = 0
    for chunk in chunks:
        freq, lag, value = engine.process(chunk)
        if args.verbose:
            print(f"chunk @{start:>10d}: local peak {freq:+8.2f} Hz "
                  f"@ lag {lag:>8d}  ({value:.4g})")
        start += len(chunk)
    elapsed = time.perf_counter() - t0
    freq, lag, value = engine.best()
    rate_ms = engine.samples_seen / args.fs * 1e3
    print(f"Frequency offset: {freq:.3f} Hz")
    print(f"Time offset: {lag} samples ({lag / args.fs * 1e3:.4f} ms)")
    print(f"Peak value: {value:.6g}")
    if args.refine and args.follow:
        print("note: --refine needs the capture bytes around each lag; "
              "--follow discards consumed chunks, so refine is skipped",
              file=sys.stderr)
    if args.refine and not args.follow:
        # Refinement needs the capture bytes around each lag; --follow
        # streams a growing file we no longer hold, so refine applies
        # to file-backed streams only.
        from caf_cookoff_tpu.ops.refine import refine_peak

        f_ref, t_ref, _ = refine_peak(needle, capture, freq, lag,
                                      args.fs,
                                      coarse_step_hz=args.freq_step,
                                      backend=_split_fft_tier(backend))
        print(f"Refined estimate: {f_ref:+.4f} Hz, {t_ref:.4f} samples "
              f"({t_ref / args.fs * 1e3:.6f} ms)")
    if args.num_peaks > 1:
        min_snr = _parse_min_snr(args.min_snr_db)
        fr, lg, vv, snr = engine.peaks(min_snr_db=min_snr, with_snr=True)
        rows = [(float(fr[i]), int(lg[i]), float(vv[i]), float(snr[i]))
                for i in range(args.num_peaks)]
        refine_fn = None
        if args.refine and not args.follow:
            from caf_cookoff_tpu.ops.refine import refine_peak

            refine_fn = lambda f_hz, lag_i: refine_peak(
                needle, capture, f_hz, lag_i, args.fs,
                coarse_step_hz=args.freq_step,
                backend=_split_fft_tier(backend))[:2]
        _print_lattice(rows, args.num_peaks, min_snr, args.min_snr_db,
                       refine_fn)
    print(f"[{engine.samples_seen} samples ({rate_ms:.0f} ms of capture) "
          f"in {elapsed:.2f} s, chunk={args.chunk}, {backend}]")
    return 0


def cmd_capture(args) -> int:
    """Record a live audio-band capture to SigMF (grc/capture.grc
    analog; needs the optional sounddevice package)."""
    from caf_cookoff_tpu.utils.sigmf import record_capture

    try:
        data, meta = record_capture(
            args.out, args.fs or DEFAULT_SAMPLE_RATE,
            seconds=args.seconds, device=args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"capture -> {data} + {meta}")
    return 0


def cmd_batch(args) -> int:
    """Many (needle, capture) pairs in one fused program — the
    config-2/4 engines behind a CLI (the reference processes exactly
    one hardcoded pair per run)."""
    from caf_cookoff_tpu.models.batched_stein import (
        batched_stein_os_peak,
        batched_stein_peak,
    )
    from caf_cookoff_tpu.models.filterbank import caf_peak

    parsed = []
    for spec in args.pairs:
        if ":" not in spec:
            print(f"error: pair {spec!r} is not needle:capture",
                  file=sys.stderr)
            return 2
        parsed.append(spec.split(":", 1))
    needles, captures, rates = [], [], []
    for n_path, c_path in parsed:
        nd, n_fs = _load_signal(n_path)
        cp, c_fs = _load_signal(c_path)
        needles.append(nd)
        captures.append(cp)
        rates.extend([n_fs, c_fs])
    fs = _effective_fs(args, *rates)
    n_lens = {len(n) for n in needles}
    c_lens = {len(c) for c in captures}
    if len(n_lens) != 1:
        print(f"error: needles must share one length, got {n_lens}",
              file=sys.stderr)
        return 2
    n = n_lens.pop()
    backend = _resolve_backend(args.backend)
    freqs = _grid(args).frequencies(np.float32)
    full = args.full_haystack and max(c_lens) > n
    if any(len(c) < n for c in captures):
        print("error: capture shorter than needle", file=sys.stderr)
        return 2
    # --refine reads capture bytes past any engine truncation: keep the
    # originals, padded to one length (zeros past each capture's end).
    pad_all = max(c_lens)
    cap_lens = [len(c) for c in captures]     # pre-padding real lengths
    captures_full = np.stack([np.pad(c, (0, pad_all - len(c)))
                              for c in captures])
    try:
        if full:
            if any(len(c) <= n for c in captures):
                print("error: --full-haystack needs every capture "
                      "longer than the needle", file=sys.stderr)
                return 2
            pad_to = max(c_lens)
            captures = [np.pad(c, (0, pad_to - len(c)))
                        for c in captures]
            fr, lg, vv = batched_stein_os_peak(
                np.stack(needles), np.stack(captures), freqs, fs,
                backend=backend)
        else:
            captures = [c[:n] for c in captures]
            fr, lg, vv = batched_stein_peak(
                np.stack(needles), np.stack(captures), freqs, fs,
                backend=backend)
    except EngineError as exc:
        # Shapes outside the fused engine's envelope (very wide doppler
        # spans, tiny needles): fall back to per-pair engines.  Only
        # the typed envelope conditions reroute — an unrelated
        # ValueError is a bug and propagates.
        from caf_cookoff_tpu.models.overlap_save import overlap_save_peak

        print(f"note: batch shape outside the fused engine's envelope "
              f"({exc}); falling back to per-pair runs", file=sys.stderr)
        results = []
        for nd, cp in zip(needles, captures):
            if full:
                results.append(overlap_save_peak(
                    nd, cp, freqs, fs,
                    backend=_split_fft_tier(backend)))
            else:
                results.append(caf_peak(nd, cp[:n], freqs, fs,
                                        backend=backend))
        fr = np.array([r[0] for r in results])
        lg = np.array([r[1] for r in results])
        vv = np.array([r[2] for r in results])
    lattices = None
    if args.num_peaks > 1:
        from caf_cookoff_tpu.ops.peak import (
            apply_detection_threshold,
            find_peaks,
            resolution_cell,
        )

        min_snr = _parse_min_snr(args.min_snr_db)
        excl_f, excl_l = resolution_cell(needles[0], freqs, fs)
        if full:
            # The fused multi-emitter engine (round 5) when the shape
            # fits its envelope; the XLA vmapped lattice scan otherwise.
            from caf_cookoff_tpu.models.batched_stein import (
                batched_stein_os_peaks,
            )
            from caf_cookoff_tpu.models.overlap_save import (
                batched_overlap_save_peaks_local,
            )

            try:
                # capture_lens: the per-pair REAL lengths, so zero
                # padding to one batch length cannot bias the model
                # floor low (and SNRs high) for shorter captures.
                lf, ll, lv = batched_stein_os_peaks(
                    np.stack(needles), np.stack(captures), freqs, fs,
                    args.num_peaks, exclude_freq=excl_f,
                    exclude_lag=excl_l, backend=_split_fft_tier(backend),
                    min_snr_db=min_snr, capture_lens=cap_lens)
            except EngineError as exc:
                print(f"note: lattice shape outside the fused engine's "
                      f"envelope ({exc}); using the XLA lattice scan",
                      file=sys.stderr)
                lf, ll, lv = batched_overlap_save_peaks_local(
                    np.stack(needles), np.stack(captures), freqs, fs,
                    args.num_peaks, exclude_freq=excl_f,
                    exclude_lag=excl_l,
                    backend=_split_fft_tier(backend),
                    min_snr_db=min_snr)
        else:
            # Equal-length pairs: the fused multi-emitter batch engine
            # (circular lags, model floor) when eligible; the per-pair
            # materialized-surface scan otherwise.
            from caf_cookoff_tpu.models.batched_stein import (
                batched_stein_peaks,
            )
            from caf_cookoff_tpu.models.filterbank import caf_surface

            try:
                lf, ll, lv = batched_stein_peaks(
                    np.stack(needles),
                    np.stack([c[:n] for c in captures]), freqs, fs,
                    args.num_peaks, exclude_freq=excl_f,
                    exclude_lag=excl_l,
                    backend=_split_fft_tier(backend),
                    min_snr_db=min_snr)
            except EngineError as exc:
                print(f"note: lattice shape outside the fused engine's "
                      f"envelope ({exc}); using per-pair surfaces",
                      file=sys.stderr)
                rows_f, rows_l, rows_v = [], [], []
                for nd, cp in zip(needles, captures):
                    surf = np.asarray(caf_surface(
                        nd, cp[:n], freqs, fs, backend=backend))
                    pks = find_peaks(surf, args.num_peaks, excl_f,
                                     excl_l,
                                     lag_period=surf.shape[-1])
                    vals, _, _ = apply_detection_threshold(
                        np.asarray(pks.value), float(surf.mean()),
                        surf.size, min_snr)
                    rows_f.append(freqs[np.asarray(pks.freq_idx)])
                    rows_l.append(np.asarray(pks.lag_idx))
                    rows_v.append(vals)
                lf, ll, lv = (np.stack(rows_f), np.stack(rows_l),
                              np.stack(rows_v))
        lattices = [
            [(float(lf[i, p]), int(ll[i, p]), float(lv[i, p]))
             for p in range(args.num_peaks)
             if np.isfinite(float(lv[i, p]))]
            for i in range(len(needles))]
    refined = None
    if args.refine:
        from caf_cookoff_tpu.config import xcor_length
        from caf_cookoff_tpu.ops.refine import refine_peaks

        # One vmapped zoom program over the whole batch, against the
        # UNTRUNCATED captures (the engines may have cut to needle
        # length; refine must read past that).  Truncated-mode raw
        # circular lags un-wrap to signed capture offsets first.
        from caf_cookoff_tpu.ops.peak import unwrap_lag

        if full:
            lags_signed = np.asarray(lg, np.int64)
        else:
            lags_signed = np.array(
                [unwrap_lag(v, xcor_length(n), n) for v in lg], np.int64)
        f_ref, t_ref, _ = refine_peaks(
            np.stack(needles), captures_full, fr, lags_signed, fs,
            coarse_step_hz=args.freq_step,
            backend=_split_fft_tier(backend))
        refined = list(zip(f_ref.tolist(), t_ref.tolist()))
    records = []
    for i, (n_path, c_path) in enumerate(parsed):
        rec = {
            "needle": n_path, "capture": c_path,
            "freq_hz": float(fr[i]), "lag_samples": int(lg[i]),
            "lag_ms": int(lg[i]) / fs * 1e3, "peak_value": float(vv[i]),
        }
        if refined is not None:
            rec["refined_freq_hz"] = refined[i][0]
            rec["refined_lag_samples"] = refined[i][1]
        if lattices is not None:
            rec["peaks"] = [{"freq_hz": f, "lag_samples": lg,
                             "peak_value": v}
                            for f, lg, v in lattices[i]]
        records.append(rec)
    if args.json:
        print(json.dumps(records, indent=2))
        return 0
    for i, r in enumerate(records):
        line = (f"{r['needle']} x {r['capture']}: "
                f"{r['freq_hz']:+9.3f} Hz @ lag {r['lag_samples']:>7d} "
                f"({r['lag_ms']:.4f} ms)  peak {r['peak_value']:.5g}")
        if refined is not None:
            line += (f"  refined {r['refined_freq_hz']:+9.4f} Hz @ "
                     f"{r['refined_lag_samples']:.4f}")
        print(line)
        if lattices is not None:
            for p, (f, lg, v) in enumerate(lattices[i]):
                print(f"    peak {p + 1}: {f:+9.3f} Hz @ lag {lg:>7d}  "
                      f"({v:.5g})")
    return 0


def cmd_bench(args) -> int:
    from caf_cookoff_tpu.utils.bench import (
        apply_shift_microbench,
        run_benchmarks,
    )

    results = run_benchmarks(
        grid=_grid(args), sample_rate=args.fs or DEFAULT_SAMPLE_RATE,
        rounds=args.rounds,
        backends=args.backends.split(","), data_dir=args.data)
    micro = apply_shift_microbench() if args.micro else None
    if args.json:
        print(json.dumps(results + ([micro] if micro else []), indent=2))
        return 0
    print(f"{'strategy':<26}{'ms/surface':>11}{'surfaces/s':>11}"
          f"{'TFLOP/s':>9}{'peak%':>7}  golden")
    for row in results:
        tf = f"{row['tflops']:>9.2f}" if "tflops" in row else f"{'—':>9}"
        pct = (f"{row['peak_pct']:>7.1f}" if "peak_pct" in row
               else f"{'—':>7}")
        print(f"{row['strategy']:<26}{row['ms']:>11.3f}"
              f"{1e3 / row['ms']:>11.1f}{tf}{pct}  "
              f"{row.get('golden', '—')}")
    if micro:
        print(f"\napply_shift ({micro['samples']} samp): "
              f"{micro['us_per_call']} us  "
              f"(reference best {micro['reference_best_us']} us, "
              f"README.md:117)")
    return 0


def cmd_selftest(args) -> int:
    """Run the ten golden fixtures through the active backend on the
    active device — the user-facing analog of the reference's
    ``cargo test`` golden lane (``caf_rust/tests/test.rs:14-316``):
    generates the fixtures (bit-identical, seed-pinned), recovers each
    injected (freq, lag) from the filename, and requires the exact
    answer from the live engine."""
    import contextlib
    import tempfile

    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.utils.generate import ensure_fixtures
    from caf_cookoff_tpu.utils.io import load_c64, parse_ground_truth

    backend = _resolve_backend(args.backend)
    with contextlib.ExitStack() as stack:
        data_dir = args.data or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="caf_selftest_"))
        pairs = ensure_fixtures(data_dir)
        grid = FreqGrid(-100.0, 100.0, 0.25)
        freqs = grid.frequencies(np.float32)
        failures = 0
        for n_path, h_path in pairs:
            truth = parse_ground_truth(h_path)
            needle = load_c64(n_path)
            hay = load_c64(h_path, count=len(needle))
            freq, lag, _ = caf_peak(needle, hay, freqs,
                                    DEFAULT_SAMPLE_RATE, backend=backend)
            # The injected frequency is generally OFF-grid (continuous
            # draw, filename rounded to 0.01 Hz); the engine contract
            # is the nearest grid bin — lag exact, freq within one
            # grid step of the encoded truth (the golden lane's bound,
            # tests/test_golden.py).
            ok = (lag == truth.lag_samples
                  and abs(freq - truth.freq_hz) <= grid.step_hz)
            if ok:
                print(f"chirp_{truth.index}: ok "
                      f"({freq:+.2f} Hz, lag {lag})")
            else:
                failures += 1
                print(f"chirp_{truth.index}: FAIL got ({freq:+.2f}, "
                      f"{lag}) want ({truth.freq_hz:+.2f} "
                      f"+-{grid.step_hz}, {truth.lag_samples})")
        total = len(pairs)
        print(f"{total - failures}/{total} golden fixtures exact "
              f"(backend={backend})")
        return 1 if failures else 0


def cmd_info(args) -> int:
    import jax

    from caf_cookoff_tpu.utils import native

    devices = jax.devices()
    print(f"jax {jax.__version__}")
    print(f"default backend: {jax.default_backend()}")
    print(f"devices: {len(devices)} x {devices[0].device_kind}")
    print(f"resolved FFT backend: {default_backend()}")
    state = ("loaded" if native.available()
             else "absent (numpy fallback; build with `make native`)")
    print(f"native libcafio: {state}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="caf-tpu",
        description="cross-ambiguity-function (CAF) engine")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="force the compute platform; 'cpu' runs every "
                   "command on the host even where an accelerator is "
                   "present")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="synthesize chirp fixtures")
    g.add_argument("--out", default="data", help="output directory")
    g.add_argument("--count", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="CAF one (needle, haystack) pair")
    r.add_argument("needle", help=".c64 or .sigmf needle (signal of "
                   "interest)")
    r.add_argument("haystack", help=".c64 or .sigmf haystack (capture)")
    _add_grid_args(r)
    r.add_argument("--full-haystack", action="store_true",
                   help="search the whole capture via overlap-save "
                   "(reference truncates to needle length)")
    r.add_argument("--dump-surface", metavar="PATH",
                   help="write the surface (.npy, or raw f64 Go-parity)")
    r.add_argument("--plot", metavar="PNG", help="save an imshow plot")
    r.add_argument("--annotate", action="store_true",
                   help="write the detection back to the haystack's "
                   ".sigmf-meta as a caf: annotation")
    r.add_argument("--refine", action="store_true",
                   help="zoom re-score the peak to continuous "
                   "(freq, lag): ~1e-3 Hz / 1e-3 sample on the golden "
                   "fixtures vs the grid's half-bin snap")
    r.add_argument("--rate", action="store_true",
                   help="also estimate a linear doppler RATE (Hz/s) "
                   "via the second-order (freq, rate, lag) zoom — "
                   "capability past the reference's first-order model")
    r.add_argument("--rate-grid", metavar="START:STOP:STEP",
                   help="hard sweeps: coarse dechirp-bank search over "
                   "this rate grid (Hz/s) first, then the joint refine "
                   "(use when the sweep smears the first-order "
                   "surface; steps <= 1/T^2); with --full-haystack and "
                   "--num-peaks N lists the N strongest ACCELERATING "
                   "emitters (per-rate lattices cross-rate-merged, "
                   "detection-thresholded)")
    r.add_argument("--num-peaks", type=int, default=1,
                   help="list the N strongest peaks (multi-emitter, "
                   "non-max suppressed)")
    r.add_argument("--min-snr-db", default="auto",
                   help="detection threshold over the measured noise "
                   "floor for --num-peaks listings: 'auto' (derived "
                   "from the searched cell count at 1e-3 false-alarm), "
                   "'none' (list all slots, pre-round-4 behavior), or "
                   "a dB value; slots below it report as non-detections "
                   "instead of emitters (default: auto).  The floor is "
                   "the mean over ALL cells incl. emitter energy, so a "
                   "strong emitter's sidelobes beyond the exclusion "
                   "cell can still pass — raise the threshold or "
                   "tighten --num-peaks for dense scenes")
    r.add_argument("--segment", type=int, default=None,
                   help="capture segment index for multi-capture SigMF "
                   "recordings (lags count from the segment start; "
                   "annotations rebase to absolute indices)")
    r.set_defaults(fn=cmd_run)

    st = sub.add_parser("stream", help="chunked live-capture CAF "
                        "(StreamingCAF)")
    st.add_argument("needle", help=".c64 or .sigmf needle")
    st.add_argument("capture", help=".c64 or .sigmf capture (any length)")
    _add_grid_args(st)
    st.add_argument("--chunk", type=int, default=4096,
                    help="samples per streamed chunk")
    st.add_argument("--verbose", action="store_true",
                    help="print each chunk's local peak")
    st.add_argument("--num-peaks", type=int, default=1,
                    help="track a top-P multi-emitter lattice through "
                    "the stream (NMS windows auto-sized to the "
                    "waveform's resolution cell)")
    st.add_argument("--min-snr-db", default="auto",
                    help="detection threshold over the stream's running "
                    "noise floor for --num-peaks listings: 'auto', "
                    "'none', or a dB value (default: auto)")
    st.add_argument("--refine", action="store_true",
                    help="zoom re-score the final peak(s) to continuous "
                    "(freq, lag); file-backed streams only (--follow "
                    "discards consumed bytes)")
    st.add_argument("--segment", type=int, default=None,
                    help="capture segment of a multi-capture SigMF "
                    "recording to stream")
    st.add_argument("--follow", action="store_true",
                    help="tail a GROWING .sigmf-data file (live-capture "
                    "mode; ends after --idle-timeout of no growth)")
    st.add_argument("--idle-timeout", type=float, default=5.0,
                    help="seconds of no file growth before --follow "
                    "ends")
    st.set_defaults(fn=cmd_stream)

    c = sub.add_parser("capture", help="record a live audio-band SigMF "
                       "capture (grc/capture.grc analog; optional "
                       "sounddevice)")
    c.add_argument("out", help="output base path (.sigmf-data/-meta)")
    c.add_argument("--fs", type=float, default=None,
                   help=f"sample rate (default {DEFAULT_SAMPLE_RATE:g})")
    c.add_argument("--seconds", type=float, default=5.0)
    c.add_argument("--device", type=int, default=None,
                   help="sounddevice input index")
    c.set_defaults(fn=cmd_capture)

    bt = sub.add_parser("batch", help="CAF many needle:capture pairs in "
                        "one fused batched program")
    bt.add_argument("pairs", nargs="+", metavar="NEEDLE:CAPTURE",
                    help="colon-separated path pairs (.c64 or .sigmf)")
    _add_grid_args(bt)
    bt.add_argument("--full-haystack", action="store_true",
                    help="search whole captures (windowed fused "
                    "overlap-save engine)")
    bt.add_argument("--json", action="store_true")
    bt.add_argument("--refine", action="store_true",
                    help="batched zoom re-score to continuous "
                    "(freq, lag) per pair")
    bt.add_argument("--num-peaks", type=int, default=1,
                    help="top-P multi-emitter lattice per pair (NMS "
                    "windows auto-sized to the first needle's "
                    "resolution cell)")
    bt.add_argument("--min-snr-db", default="auto",
                    help="per-pair detection threshold over each "
                    "pair's measured noise floor for --num-peaks "
                    "lattices: 'auto', 'none', or a dB value "
                    "(default: auto)")
    bt.set_defaults(fn=cmd_batch)

    b = sub.add_parser("bench", help="README-style strategy table")
    _add_grid_args(b)
    b.add_argument("--rounds", type=int, default=3,
                   help="timing rounds (reference uses 3, caf.py:137)")
    b.add_argument("--backends", default="xla,matmul,stein",
                   help="comma list, or 'all' for every backend "
                   "(xla, matmul[-highest|-bf16], stein[-raw])")
    b.add_argument("--data", default="data")
    b.add_argument("--json", action="store_true")
    b.add_argument("--micro", action="store_true",
                   help="include the apply_shift microbench "
                   "(README.md:114-157 parity)")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("selftest", help="run the 10 golden fixtures "
                        "on the active device; exit 0 iff all exact")
    st.add_argument("--backend", choices=("auto",) + BACKENDS,
                    default="auto")
    st.add_argument("--data", default=None,
                    help="fixture directory (default: a temp dir)")
    st.set_defaults(fn=cmd_selftest)

    i = sub.add_parser("info", help="devices and backend resolution")
    i.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform == "cpu":
        # Takes effect only before the first backend initialization.
        import jax

        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
