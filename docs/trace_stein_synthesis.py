#!/usr/bin/env python3
"""Profiler trace of the Stein coarse stage at the headline (400x8192)
and batch-64 shapes on the GPU, reduced to per-op device time.

The question it answers: how long the synthesis matmuls and the fused
|.|^2 + per-bin max that reads their rows back take on the card, beside
the least time the rows' bytes need at the card's published bandwidth
(the case for a synthesis + |.|^2 + rank epilogue kernel that never
stores the rows).

    python docs/trace_stein_synthesis.py     # on a GPU

Prints, per shape, the device ops by time per call: the median over
``REPS`` separately traced repetitions of ``CALLS`` calls, with the
least and greatest, from ONE op line per GPU plane: "XLA Ops" where the
trace has it, else the plane's one compute stream (a line named
"Stream #N(...)" whose parenthesised kinds include Compute; the copy
streams' host-to-device transfers are not device ops of the program).  A plane with no such line, or several,
is an error: summing lines could count an op twice.  Writes the same to
``chiprun_out/trace_stein_synthesis.json``.
"""

from __future__ import annotations

import collections
import glob
import json
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CALLS = 5
REPS = 5


def op_line(plane):
    """The plane's one op line: "XLA Ops", else its compute stream."""
    lines = list(plane.lines)
    named = [ln for ln in lines if ln.name == "XLA Ops"]
    if not named:
        named = [ln for ln in lines if ln.name.startswith("Stream #")
                 and "Compute" in ln.name.partition("(")[2].rstrip(")")
                 .split(",")]
    if len(named) != 1:
        raise RuntimeError(f"{plane.name}: no single op line among "
                           f"{[ln.name for ln in lines]}")
    return named[0]


def op_times(trace_dir: str, calls: int):
    """{op: device ns per call} from the op line of every GPU plane."""
    from jax.profiler import ProfileData

    path = glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb")[0]
    totals = collections.Counter()
    planes = [pl for pl in ProfileData.from_file(path).planes
              if pl.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError("the trace holds no GPU plane")
    for plane in planes:
        for ev in op_line(plane).events:
            totals[ev.name] += ev.duration_ns / calls
    return totals


def trace_call(fn, calls: int = CALLS, reps: int = REPS):
    """[{op: ns per call}] for ``reps`` separately traced repetitions."""
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                for _ in range(calls):
                    jax.block_until_ready(fn())
            out.append(op_times(d, calls))
    return out


def main() -> int:
    import jax
    import jax.numpy as jnp

    from caf_cookoff_tpu.config import BENCH_GRID, enable_compile_cache
    from caf_cookoff_tpu.models.batched_stein import _batched_stein_peak_jit
    from caf_cookoff_tpu.models.stein import _stein_peak_jit
    from caf_cookoff_tpu.ops.splitfft import split_array
    from caf_cookoff_tpu.utils.bench import card_line, require_gpu
    from chip_smoke import FS, plant

    require_gpu()
    enable_compile_cache()
    card = card_line()
    rng = np.random.default_rng(0)
    freqs = BENCH_GRID.frequencies(np.float32)
    k, n, m = len(freqs), 4096, 8192
    shapes = {}
    needle, hay = plant(rng, n, n, [(300, float(freqs[123]), 1.0)])
    args = [jnp.asarray(a) for a in (*split_array(needle),
                                     *split_array(hay), freqs)]
    shapes["headline 400x8192"] = (
        lambda: _stein_peak_jit(*args, FS, m, 64, "xla", True),
        2 * k * m * 4)
    pairs = [plant(rng, n, n, [(300, float(freqs[123]), 1.0)])
             for _ in range(64)]
    bargs = [jnp.asarray(a) for a in (
        *split_array(np.stack([a for a, _ in pairs])),
        *split_array(np.stack([b for _, b in pairs])))]
    shapes["batch 64 x 400x8192"] = (
        lambda: _batched_stein_peak_jit(*bargs, jnp.asarray(freqs), FS, m,
                                        64, "xla", True),
        2 * 64 * k * m * 4)
    report = {"card": card, "calls": CALLS, "reps": REPS, "shapes": {}}
    for label, (fn, row_bytes) in shapes.items():
        reps = trace_call(fn)
        names = set().union(*reps)
        ops = sorted(((name, [r.get(name, 0.0) / 1e3 for r in reps])
                      for name in names),
                     key=lambda r: -float(np.median(r[1])))
        totals = [sum(r.values()) / 1e3 for r in reps]
        bound_us = 2 * row_bytes / 3.35e12 * 1e6    # write + read back
        print(f"{label}: synthesized rows {row_bytes / 1e6:.1f} MB, "
              f"write + read-back at 3.35 TB/s = {bound_us:.1f} us; "
              f"device ops per call {np.median(totals):.1f} us (median of "
              f"{REPS} traces, {min(totals):.1f}-{max(totals):.1f}) "
              f"({card})")
        for name, us in ops[:15]:
            print(f"  {np.median(us):10.1f} us/call  "
                  f"({min(us):.1f}-{max(us):.1f})  {name[:100]}")
        report["shapes"][label] = {
            "row_bytes": row_bytes, "rows_bandwidth_us": bound_us,
            "device_us_per_call": totals,
            "ops_us_per_call": [(name, us) for name, us in ops[:40]]}
    out = ROOT / "chiprun_out" / "trace_stein_synthesis.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
