#!/usr/bin/env python3
"""Validate ``estimate_hbm_per_chip`` against XLA's own accounting.

The model (`caf_cookoff_tpu/parallel/sharded.py:estimate_hbm_per_chip`)
prices the batched overlap-save engine's per-device working set — it
gates BASELINE config 5's "fits per device" claim.  This sweep
AOT-compiles the actual engine program (`_os_peaks_batch_jit`, the
per-pair lattice scan the sharded engines run per shard) for 4 shapes on
the attached device and reads XLA's **CompiledMemoryStats**
(`compiled.memory_analysis()`): ``argument_size`` (the resident inputs
the model prices as haystack+needles) plus ``temp_size`` (XLA's
high-water buffer assignment — the shifted needle spectra, the scan's
block scratch, and every fusion temp the model's ping-pong term
approximates).

Each shape also EXECUTES once and asserts a recovered emitter, so the
compiled program measured is the working production program.

Usage: python docs/hbm_validate.py [--out chiprun_out/hbm_validate.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (pairs B, bins K, needle N, total lags L) — spans 4x in the dominant
# spectra term and 16x in the haystack term.
SHAPES = [
    (4, 64, 1024, 32_768),
    (8, 64, 1024, 65_536),
    (4, 128, 2048, 65_536),
    (16, 64, 1024, 131_072),
]
FS = 48_000.0


def _measure_one(b, k, n, lags) -> dict:
    import numpy as np

    import jax
    import jax.numpy as jnp

    from caf_cookoff_tpu.models.overlap_save import _os_peaks_batch_jit
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu.ops.peak import resolve_exclusions
    from caf_cookoff_tpu.parallel.sharded import estimate_hbm_per_chip

    rng = np.random.default_rng(0)
    needles = (rng.standard_normal((b, n))
               + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((b, lags + n - 1)) + 1j
                    * rng.standard_normal((b, lags + n - 1)))
            ).astype(np.complex64)
    t = np.arange(n)
    true_lag = lags // 2
    hays[0, true_lag:true_lag + n] += (needles[0] * np.exp(
        2j * np.pi * 25.0 * t / FS)).astype(np.complex64)
    freqs = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    excl_f, excl_l = resolve_exclusions(needles[0], freqs, FS, None, None)
    ns_re, ns_im = splitfft.split_array(needles)
    hs_re, hs_im = splitfft.split_array(hays)
    args = (jnp.asarray(ns_re), jnp.asarray(ns_im), jnp.asarray(hs_re),
            jnp.asarray(hs_im), jnp.asarray(freqs))
    static = dict(sample_rate=FS, num_lags=lags, needle_len=n,
                  backend="xla", num_peaks=2, exclude_freq=excl_f,
                  exclude_lag=excl_l)
    compiled = _os_peaks_batch_jit.lower(*args, **static).compile()
    mem = compiled.memory_analysis()
    # sample_rate is a TRACED arg (only shape-affecting args are
    # static) — the compiled call takes it alongside the arrays.
    pk = compiled(*args, sample_rate=FS)
    lag0 = int(np.asarray(pk.lag_idx)[0, 0])
    assert lag0 == true_lag, (lag0, true_lag)

    model = estimate_hbm_per_chip(b, k, n, lags)
    measured = (mem.argument_size_in_bytes + mem.temp_size_in_bytes
                + mem.output_size_in_bytes)
    model_mb = model["total_gb"] * 1024
    measured_mb = measured / 2**20
    return {
        "shape": {"pairs": b, "bins": k, "needle": n, "lags": lags},
        "platform": jax.devices()[0].platform,
        "model_mb": round(model_mb, 1),
        "model_terms": model,
        "measured_mb": round(measured_mb, 1),
        "measured_terms": {
            "argument_mb": round(mem.argument_size_in_bytes / 2**20, 1),
            "temp_mb": round(mem.temp_size_in_bytes / 2**20, 1),
            "output_mb": round(mem.output_size_in_bytes / 2**20, 3),
        },
        "ratio_measured_over_model": (
            round(measured_mb / model_mb, 3) if model_mb else None),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/hbm_validate.json")
    args = ap.parse_args()
    rows = []
    for shape in SHAPES:
        row = _measure_one(*shape)
        rows.append(row)
        print(json.dumps(row))
    doc = {"method": "XLA CompiledMemoryStats of the AOT-compiled "
                     "_os_peaks_batch_jit program (argument + temp + "
                     "output buffer assignment) vs "
                     "estimate_hbm_per_chip (resident working-set "
                     "model); each program executed once and "
                     "truth-gated",
           "shapes": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
