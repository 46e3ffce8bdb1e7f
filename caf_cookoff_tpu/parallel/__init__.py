"""Multi-device parallelism: meshes, collectives, sharded CAF engines.

The device-mesh replacement for the reference's thread/process fan-out
(rayon / goroutines / multiprocessing — SURVEY §2.3) and its in-process
channel "communication backend" (SURVEY §2.4): named mesh axes
(``pair``, ``doppler``, ``time``), ``shard_map`` engines, ``ppermute``
halo exchange and pmax/pmin peak reduction over the device links.
"""

from caf_cookoff_tpu.parallel.collectives import (
    global_peak,
    global_peaks,
    global_peaks_batched,
)
from caf_cookoff_tpu.parallel.mesh import (
    AXIS_DOPPLER,
    AXIS_PAIR,
    AXIS_TIME,
    default_mesh,
    factor_devices,
    make_mesh,
)
from caf_cookoff_tpu.parallel.sharded import (
    batched_caf_peak,
    batched_overlap_save_peak,
    batched_overlap_save_peaks,
    estimate_hbm_per_chip,
    sharded_batched_stein_peak,
    sharded_batched_stein_os_peaks,
    sharded_batched_stein_peaks,
    sharded_stein_os_peak,
    sharded_stein_os_peaks,
    sharded_stein_rate_os_peak,
    sharded_caf_peak,
    sharded_caf_surface,
    sharded_overlap_save_peak,
    sharded_overlap_save_peaks,
    sharded_rate_overlap_save_peak,
    sharded_rate_overlap_save_peaks,
    sharded_stein_peak,
)

__all__ = [
    "AXIS_DOPPLER",
    "AXIS_PAIR",
    "AXIS_TIME",
    "batched_caf_peak",
    "batched_overlap_save_peak",
    "batched_overlap_save_peaks",
    "default_mesh",
    "estimate_hbm_per_chip",
    "factor_devices",
    "global_peak",
    "global_peaks",
    "global_peaks_batched",
    "make_mesh",
    "sharded_batched_stein_peak",
    "sharded_batched_stein_os_peaks",
    "sharded_batched_stein_peaks",
    "sharded_stein_os_peak",
    "sharded_stein_os_peaks",
    "sharded_stein_rate_os_peak",
    "sharded_caf_peak",
    "sharded_caf_surface",
    "sharded_overlap_save_peak",
    "sharded_overlap_save_peaks",
    "sharded_rate_overlap_save_peak",
    "sharded_rate_overlap_save_peaks",
    "sharded_stein_peak",
]
