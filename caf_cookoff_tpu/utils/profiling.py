"""Observability: profiler traces and structured run reports.

The reference's observability is ad-hoc timers and prints
(``caf_python/caf.py:140-148`` 3-round wall clock, ``caf_go/main.go:32-34``
``time.Sub``, ``println!`` result lines ``caf_rust/src/main.rs:29-31`` —
SURVEY §5).  Here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory of device timelines;
* :class:`RunReport` — the structured result record: peak estimate,
  peak-to-floor ratio (detection confidence, which no reference impl
  reports), throughput, and the reference-format result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Iterator, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace('/tmp/caf-trace'): run()`` → profiler trace.

    A profiler that cannot start or stop raises: a run asked to be
    traced never carries on untraced.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RunReport:
    """Structured record of one CAF run."""

    freq_hz: float
    lag_samples: int
    peak_value: float
    sample_rate: float
    num_doppler_bins: int
    xcor_len: int
    elapsed_ms: Optional[float] = None
    peak_to_floor_db: Optional[float] = None
    backend: Optional[str] = None

    @property
    def lag_ms(self) -> float:
        return self.lag_samples / self.sample_rate * 1e3

    @property
    def surfaces_per_second(self) -> Optional[float]:
        return None if not self.elapsed_ms else 1e3 / self.elapsed_ms

    def result_lines(self) -> str:
        """The reference's two result lines (``main.rs:29-31``), plus
        the observability the reference lacks."""
        lines = [
            f"Frequency offset: {self.freq_hz:.3f} Hz",
            f"Time offset: {self.lag_samples} samples "
            f"({self.lag_ms:.4f} ms)",
        ]
        extra = []
        if self.peak_to_floor_db is not None:
            extra.append(f"peak/floor {self.peak_to_floor_db:.1f} dB")
        if self.elapsed_ms is not None:
            extra.append(f"{self.elapsed_ms:.3f} ms/surface")
            extra.append(f"{self.surfaces_per_second:.1f} surfaces/s")
        if self.backend:
            extra.append(self.backend)
        if extra:
            lines.append("[" + ", ".join(extra) + "]")
        return "\n".join(lines)

    def to_json(self) -> str:
        record = dataclasses.asdict(self)
        record["lag_ms"] = self.lag_ms
        record["surfaces_per_second"] = self.surfaces_per_second
        return json.dumps(record, sort_keys=True)


def peak_to_floor_db(surface: np.ndarray, peak_value: float,
                     guard_fraction: float = 0.01) -> float:
    """Detection confidence: peak over the surface's median floor (dB).

    The median is robust to the peak's own sidelobes; ``guard_fraction``
    exists for API symmetry with classic CFAR cell-averaging but the
    median already excludes the peak cells for any realistic surface.
    """
    del guard_fraction  # median estimator needs no guard cells
    floor = float(np.median(surface))
    if floor <= 0:
        return float("inf")
    return 10.0 * float(np.log10(peak_value / floor))


def report_run(surface: np.ndarray, freqs_hz: np.ndarray,
               sample_rate: float, *, elapsed_ms: Optional[float] = None,
               backend: Optional[str] = None) -> RunReport:
    """Build a :class:`RunReport` from a materialized surface."""
    surface = np.asarray(surface)
    k, t = np.unravel_index(int(surface.argmax()), surface.shape)
    peak = float(surface[k, t])
    return RunReport(
        freq_hz=float(np.asarray(freqs_hz)[k]),
        lag_samples=int(t),
        peak_value=peak,
        sample_rate=float(sample_rate),
        num_doppler_bins=int(surface.shape[0]),
        xcor_len=int(surface.shape[1]),
        elapsed_ms=elapsed_ms,
        peak_to_floor_db=peak_to_floor_db(surface, peak),
        backend=backend,
    )


class Stopwatch:
    """Tiny timing helper for ad-hoc ms measurements."""

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        self.ms: Optional[float] = None
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3
