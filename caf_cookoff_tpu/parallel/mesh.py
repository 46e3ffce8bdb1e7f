"""Device-mesh construction for the CAF engine.

The reference's only parallel resource is a pool of CPU cores fed by
rayon / goroutines / multiprocessing (SURVEY §2.3).  Here the resource is
a named `jax.sharding.Mesh` of devices with three first-class axes:

* ``pair``    — independent (needle, haystack) pairs: the data-parallel
  axis (the reference processes one pair at a time,
  ``caf_python/caf.py:89-108`` defines the unit of work);
* ``doppler`` — the frequency-bin axis the reference fans over threads
  (``caf_rust/src/caf/mod.rs:185``, ``caf_go/caf.go:143-160``);
* ``time``    — lag/time blocks of a long haystack (overlap-save
  segmented correlation; absent in the reference, which truncates the
  haystack, ``caf_go/main.go:20``).

Every GPU of a host reaches every other over NVLink at the same rate, so
the mesh follows the algorithm alone; multi-host meshes put the ``pair``
axis (no halo traffic) across hosts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

AXIS_PAIR = "pair"
AXIS_DOPPLER = "doppler"
AXIS_TIME = "time"

ALL_AXES = (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME)


def factor_devices(n: int, num_axes: int) -> Tuple[int, ...]:
    """Split ``n`` devices into ``num_axes`` balanced factors.

    Greedy largest-prime-first round-robin; for the common power-of-two
    chip counts this yields near-square factorizations, e.g.
    8 -> (2, 2, 2), 16 -> (4, 2, 2).
    """
    if n < 1 or num_axes < 1:
        raise ValueError(f"need n >= 1, num_axes >= 1, got {n}, {num_axes}")
    factors = [1] * num_axes
    remaining = n
    primes = []
    d = 2
    while d * d <= remaining:
        while remaining % d == 0:
            primes.append(d)
            remaining //= d
        d += 1
    if remaining > 1:
        primes.append(remaining)
    for p in sorted(primes, reverse=True):
        factors[int(np.argmin(factors))] *= p
    return tuple(sorted(factors, reverse=True))


def make_mesh(pair: int = 1, doppler: int = 1, time: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ``(pair, doppler, time)`` mesh over ``devices``.

    Axis sizes must multiply to the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    want = pair * doppler * time
    if want != len(devices):
        raise ValueError(
            f"mesh {pair}x{doppler}x{time} = {want} devices, "
            f"got {len(devices)}")
    arr = np.asarray(devices).reshape(pair, doppler, time)
    return Mesh(arr, ALL_AXES)


def default_mesh(devices: Optional[Sequence[jax.Device]] = None,
                 batch: int = 1) -> Mesh:
    """Auto-factored mesh: ``pair`` gets min(batch, n), rest to ``doppler``.

    The doppler axis is the embarrassing one (no collectives during the
    surface build), so spare capacity goes there.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    pair = math.gcd(batch, n) if batch > 1 else 1
    return make_mesh(pair=pair, doppler=n // pair, time=1, devices=devices)
