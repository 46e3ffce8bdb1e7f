"""Typed engine errors (round-2 verdict item 4).

The engines' legitimate reroutes (doppler span past the segmented
envelope, layout-contract shape limits) are named exceptions
(:mod:`caf_cookoff_tpu.errors`); fallback sites catch exactly those, so
an unrelated ``ValueError`` — a genuine bug — propagates instead of
silently downgrading the engine.  The reference's posture is fail-loud
(``unwrap()``, ``caf_rust/src/main.rs:13``); these tests pin that ours
is too, *except* where a typed envelope condition sanctions a reroute.
"""

import numpy as np
import pytest

from caf_cookoff_tpu.errors import (
    EligibilityError,
    EngineError,
    SpanError,
)

FS = 48_000.0


def test_error_taxonomy():
    """All engine errors are ValueErrors (stable user contract) and
    EngineErrors (the only legal reroute catch)."""
    for cls in (SpanError, EligibilityError):
        assert issubclass(cls, EngineError)
        assert issubclass(cls, ValueError)


def test_auto_block_len_raises_span_error():
    from caf_cookoff_tpu.models.stein import _auto_block_len

    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    with pytest.raises(SpanError):
        _auto_block_len(FS, freqs, 64)


def test_batch_engine_ineligible_length_raises_eligibility_error():
    """A correlation length off the coarse stage's 512-lag tile is a
    typed layout condition, not a bare ValueError."""
    from caf_cookoff_tpu.models.batched_stein import batched_stein_peak

    rng = np.random.default_rng(0)
    n = 100  # xcor_length(100) = 256, not a 512 multiple
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    freqs = np.arange(-10.0, 10.0, 1.0, dtype=np.float32)
    with pytest.raises(EligibilityError, match="512"):
        batched_stein_peak(x, x, freqs, FS)


def _long_capture_pair():
    rng = np.random.default_rng(7)
    n, total, lag, f_true = 512, 16384, 9_000, -30.0
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-100.0, 100.0, 10.0, dtype=np.float32)
    return needle, hay, freqs, f_true, lag


def test_unrelated_error_propagates_through_stein_os(monkeypatch):
    """An unrelated ValueError inside the windowed fused engine must NOT
    silently reroute stein_overlap_save_peak to the scan path."""
    import caf_cookoff_tpu.models.batched_stein as bs
    import caf_cookoff_tpu.models.stein as stein_mod

    needle, hay, freqs, _, _ = _long_capture_pair()

    def boom(*a, **k):
        raise ValueError("unrelated internal bug")

    monkeypatch.setattr(bs, "batched_stein_os_peak", boom)
    # Force the windowed-engine branch even on CPU (it normally runs
    # only when the scan cannot take the span): make the scan
    # ineligible so the code path under test is reached with certainty.
    monkeypatch.setattr(stein_mod, "_auto_block_len",
                        lambda *a, **k: (_ for _ in ()).throw(
                            SpanError("forced")))
    with pytest.raises(ValueError, match="unrelated internal bug"):
        stein_mod.stein_overlap_save_peak(needle, hay, freqs, FS)


def test_typed_error_reroutes_stein_os_to_scan(monkeypatch):
    """A typed envelope error from the windowed engine falls back to the
    segmented scan and still recovers the emitter."""
    import caf_cookoff_tpu.models.batched_stein as bs
    import caf_cookoff_tpu.models.stein as stein_mod

    needle, hay, freqs, f_true, lag = _long_capture_pair()

    def ineligible(*a, **k):
        raise EligibilityError("forced: shape outside the layout contract")

    monkeypatch.setattr(bs, "batched_stein_os_peak", ineligible)
    freq, got_lag, _ = stein_mod.stein_overlap_save_peak(
        needle, hay, freqs, FS)
    assert (freq, got_lag) == (f_true, lag)


def test_cli_full_haystack_propagates_unrelated_error(
        fixture_pairs, monkeypatch):
    """The CLI's engine fallback catches only EngineError — a real bug
    inside the segmented engine reaches the user."""
    import caf_cookoff_tpu.models.stein as stein_mod
    from caf_cookoff_tpu.cli import main

    def boom(*a, **k):
        raise ValueError("unrelated CLI-visible bug")

    monkeypatch.setattr(stein_mod, "stein_overlap_save_peak", boom)
    needle, haystack = fixture_pairs[0]
    with pytest.raises(ValueError, match="unrelated CLI-visible bug"):
        main(["run", str(needle), str(haystack), "--full-haystack",
              "--freq-step", "0.25"])


def test_cli_full_haystack_reroutes_and_names_engine(
        fixture_pairs, monkeypatch, capsys):
    """A typed envelope error reroutes to the overlap-save scan, the
    note says why, and the report names the engine that answered."""
    import caf_cookoff_tpu.models.stein as stein_mod
    from caf_cookoff_tpu.cli import main

    def ineligible(*a, **k):
        raise SpanError("forced span condition")

    monkeypatch.setattr(stein_mod, "stein_overlap_save_peak", ineligible)
    needle, haystack = fixture_pairs[0]
    rc = main(["run", str(needle), str(haystack), "--full-haystack",
               "--freq-step", "0.25"])
    assert rc == 0
    captured = capsys.readouterr()
    assert "Time offset: 202 samples" in captured.out
    assert "Engine: overlap-save scan" in captured.out
    assert "forced span condition" in captured.err


def test_cli_run_names_engine(fixture_pairs, capsys):
    needle, haystack = fixture_pairs[0]
    rc = main_run = None
    from caf_cookoff_tpu.cli import main

    rc = main(["run", str(needle), str(haystack), "--full-haystack",
               "--freq-step", "0.25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Engine: stein-os (segmented long-capture)" in out
