"""Multi-host initialization.

The reference has no multi-node story at all (SURVEY §2.4: in-process
channels only).  Here, scaling past one host is the standard JAX
recipe: every host calls :func:`initialize_cluster`, builds the same
global mesh over ``jax.devices()`` (all devices of all hosts), and
feeds the sharded engines — XLA routes the collectives over NVLink
within a host and the network across hosts.  Keep the ``time`` axis
(halo ppermute traffic) within a host.

Typical pod-scale run (BASELINE config 5):

    from caf_cookoff_tpu.parallel import multihost, make_mesh, sharded_overlap_save_peak
    multihost.initialize_cluster()                 # on every host
    mesh = multihost.global_mesh(pair=8, doppler=4)
    peak = sharded_overlap_save_peak(needle, capture, freqs, fs, mesh)
"""

from __future__ import annotations

from typing import Optional

import jax

from caf_cookoff_tpu.parallel.mesh import make_mesh


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` with env autodetection.

    On managed clusters the arguments may autodetect; elsewhere pass
    ``coordinator_address``, ``num_processes`` and ``process_id``.
    Safe to call once per process, before any JAX computation.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(pair: int = 1, doppler: Optional[int] = None,
                time: int = 1):
    """Mesh over ALL hosts' devices; ``doppler`` defaults to the rest."""
    n = len(jax.devices())
    if doppler is None:
        if n % (pair * time):
            raise ValueError(
                f"{n} devices not divisible by pair*time = {pair * time}")
        doppler = n // (pair * time)
    return make_mesh(pair=pair, doppler=doppler, time=time)


def process_info() -> str:
    """One-line cluster summary for logs."""
    return (f"process {jax.process_index()}/{jax.process_count()}, "
            f"{len(jax.local_devices())} local / "
            f"{len(jax.devices())} global devices")


def put_global(x, mesh, spec):
    """Form a GLOBAL array on a multi-host mesh from host-local numpy.

    In multi-controller JAX a host cannot jit over data it merely holds
    as numpy — every process must contribute its addressable shards of
    one global array.  Each host passes the (identical) full-value
    array; ``make_array_from_callback`` slices out the shards this
    process owns.  ``spec=P()`` replicates, ``P('doppler')`` shards the
    leading axis, etc.
    """
    import numpy as np
    from jax.sharding import NamedSharding

    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def multihost_caf_peak(needle, haystack, freqs_hz, sample_rate, mesh,
                       *, backend: Optional[str] = None):
    """(freq_hz, lag, value) with doppler bins sharded across HOSTS.

    The multi-controller twin of
    :func:`caf_cookoff_tpu.parallel.sharded_caf_peak`: every process
    calls this with the same host-local inputs; signals replicate,
    the padded doppler grid shards over the global mesh, and the fully
    replicated peak triple is readable on every host.  Proven by the
    2-process CPU-backend test (``tests/test_multihost_2proc.py``).
    """
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from caf_cookoff_tpu.config import default_backend, xcor_length
    from caf_cookoff_tpu.parallel.mesh import AXIS_DOPPLER
    from caf_cookoff_tpu.parallel.sharded import (
        _sharded_peak_jit,
        _split_host,
        pad_axis_to,
    )

    backend = backend or default_backend()
    n_re, n_im = _split_host(needle)
    h_re, h_im = _split_host(haystack)
    freqs_p = pad_axis_to(np.asarray(freqs_hz, dtype=n_re.dtype),
                          mesh.shape[AXIS_DOPPLER])
    rep = lambda a: put_global(a, mesh, P())
    peak = _sharded_peak_jit(
        rep(n_re), rep(n_im), rep(h_re), rep(h_im),
        put_global(freqs_p, mesh, P(AXIS_DOPPLER)),
        float(sample_rate), mesh, xcor_length(n_re.shape[-1]), backend)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))
