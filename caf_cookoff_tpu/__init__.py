"""caf_cookoff_tpu — a cross-ambiguity-function (CAF) engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
Teque5/caf_cookoff reference (Rust/Go/Python CPU cook-off), redesigned for
an accelerator:

* the doppler-bin fan-out (reference: rayon / goroutines / multiprocessing,
  ``caf_rust/src/caf/mod.rs``, ``caf_go/caf.go:143-173``,
  ``caf_python/caf.py:36-117``) becomes a single batched XLA program
  (``vmap`` over the doppler axis) and, across chips, ``shard_map`` over a
  device mesh;
* the FFT backends (FFTW / RustFFT / go-dsp / pocketfft) become XLA FFT
  HLO (cuFFT on the GPU) plus a matmul-DFT tier and the segmented
  (Stein) engines;
* peak extraction is a fused reduction carrying (value, freq-idx, lag-idx)
  triples through collectives instead of materializing rows on one host.

Public API mirrors the reference's surface: ``caf_surface`` /
``find_peak`` (``caf_rust/src/caf/mod.rs:23-66``) and ``amb_surf``
(``caf_python/caf.py:89-117``).
"""

from caf_cookoff_tpu.config import CafConfig, FreqGrid
from caf_cookoff_tpu.errors import (
    EligibilityError,
    EngineError,
    SpanError,
)
from caf_cookoff_tpu.models.batched_stein import (
    batched_stein_os_peak,
    batched_stein_os_peaks,
    batched_stein_peak,
    batched_stein_peaks,
)
from caf_cookoff_tpu.models.filterbank import (
    FilterbankCAF,
    amb_surf,
    caf_peak,
    caf_surface,
    find_peak,
)
from caf_cookoff_tpu.models.overlap_save import (
    batched_overlap_save_peaks_local,
    overlap_save_peak,
    overlap_save_peaks,
    overlap_save_surface,
)
from caf_cookoff_tpu.models.rate import (
    rate_caf_peak,
    rate_overlap_save_peak,
    rate_overlap_save_peaks,
    stein_rate_os_peak,
    stein_rate_os_peaks,
)
from caf_cookoff_tpu.models.streaming import StreamingCAF
from caf_cookoff_tpu.ops.peak import (
    apply_detection_threshold,
    detection_threshold_db,
    find_peaks,
    merge_peaks,
    resolution_cell,
)
from caf_cookoff_tpu.ops.refine import (
    refine_peak,
    refine_peak_rate,
    refine_peaks,
)
from caf_cookoff_tpu.ops.shift import apply_fdoa, freq_shift, phasor_bank
from caf_cookoff_tpu.ops.xcor import xcor, xcor_pair

__version__ = "0.2.0"

__all__ = [
    "CafConfig",
    "EligibilityError",
    "EngineError",
    "FreqGrid",
    "FilterbankCAF",
    "SpanError",
    "StreamingCAF",
    "amb_surf",
    "apply_detection_threshold",
    "apply_fdoa",
    "batched_overlap_save_peaks_local",
    "batched_stein_os_peak",
    "batched_stein_os_peaks",
    "batched_stein_peak",
    "batched_stein_peaks",
    "caf_peak",
    "caf_surface",
    "detection_threshold_db",
    "find_peak",
    "find_peaks",
    "freq_shift",
    "merge_peaks",
    "overlap_save_peak",
    "overlap_save_peaks",
    "overlap_save_surface",
    "phasor_bank",
    "rate_caf_peak",
    "rate_overlap_save_peak",
    "rate_overlap_save_peaks",
    "stein_rate_os_peak",
    "stein_rate_os_peaks",
    "refine_peak",
    "refine_peak_rate",
    "refine_peaks",
    "resolution_cell",
    "xcor",
    "xcor_pair",
    "__version__",
]
