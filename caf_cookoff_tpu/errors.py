"""Typed engine errors.

The reference fails loud (``unwrap()``, ``caf_rust/src/main.rs:13``;
``log.Fatal``, ``caf_go/caf.go:47``).  The engines here have *legitimate*
reroutes — a doppler span outside the segmented engine's envelope, a
shape outside an engine's layout contract — and those used to be
signalled with bare ``ValueError``, which meant a blanket ``except
ValueError`` at the fallback sites could silently swallow a *real* bug
(a shape error, a broken invariant) and downgrade the engine instead of
surfacing it.

These classes name exactly the conditions a caller may legally catch
and reroute; anything else propagates.  All subclass ``ValueError`` so
user-facing contracts ("raises ValueError on bad input") stay true.
"""

from __future__ import annotations


class EngineError(ValueError):
    """Base class for engine-envelope conditions a caller may reroute.

    Catching ``EngineError`` at a fallback site is the sanctioned way to
    try a faster engine first; catching ``ValueError`` there is not —
    it would also swallow genuine bugs.
    """


class SpanError(EngineError):
    """The doppler span is outside the segmented (Stein) engine's
    block-constant phase envelope (``models/stein._auto_block_len``):
    no segment length >= 8 keeps the phase error bounded, so the
    engine cannot pay off.  Legal reroutes: the banded engines, or the
    filterbank/overlap-save paths."""


class EligibilityError(EngineError):
    """The shapes violate a segmented engine's layout contract
    (non-pow2 transform length, tile-misaligned bin count, ...).  The
    same math is always available on an XLA tier — reroute there."""
