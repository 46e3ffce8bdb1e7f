"""Config layer and engine-object coverage."""

import numpy as np
import pytest

from caf_cookoff_tpu.config import BENCH_GRID, CafConfig, FreqGrid, xcor_length
from caf_cookoff_tpu.models.filterbank import FilterbankCAF


class TestFreqGrid:
    def test_bench_grid_is_reference_workload(self):
        assert BENCH_GRID.num_bins == 400
        f = BENCH_GRID.frequencies()
        assert (f[0], f[-1], f[1] - f[0]) == (-100.0, 99.5, 0.5)

    def test_mhz_lattice_no_drift(self):
        """0.05 Hz steps over 100 bins: exact mHz lattice, no float
        accumulation (the reference's gen_float_shifts guarantee)."""
        g = FreqGrid(30.0, 35.0, 0.05)
        f = g.frequencies()
        assert g.num_bins == 100
        # Every value is computed from the integer-mHz lattice — exactly
        # equal to the direct (non-accumulated) formula, unlike repeated
        # float addition which drifts (test.rs:335-352 rationale).
        want = (30_000 + 50 * np.arange(100, dtype=np.int64)) / 1e3
        np.testing.assert_array_equal(f, want)

    def test_validation(self):
        with pytest.raises(ValueError):
            FreqGrid(0.0, 10.0, -1.0)
        with pytest.raises(ValueError):
            FreqGrid(10.0, 0.0, 1.0)

    def test_padded(self):
        g, valid = FreqGrid(0.0, 10.0, 1.0).padded(8)
        assert valid == 10
        assert g.num_bins == 16


class TestCafConfig:
    def test_backend_validation(self):
        with pytest.raises(ValueError):
            CafConfig(backend="fftw")
        for b in ("auto", "stein", "matmul-bf16"):
            CafConfig(backend=b)
        with pytest.raises(ValueError):
            CafConfig(backend="pallas-refine")

    def test_precision_dtypes(self):
        assert CafConfig(precision="c64").complex_dtype == np.complex64
        assert CafConfig(precision="c128").real_dtype == np.float64
        with pytest.raises(ValueError):
            CafConfig(precision="c32")


def test_xcor_length_non_pow2():
    assert xcor_length(4096) == 8192
    assert xcor_length(5000) == 16384  # 2*5000 -> next pow2
    assert xcor_length(1) == 2


def test_engine_object_golden(chirp):
    """The config-bound engine object (Rust trait-impl analog)."""
    needle, haystack, _ = chirp(0)
    engine = FilterbankCAF(CafConfig(grid=FreqGrid(-100, 100, 0.25)))
    assert engine.peak(needle, haystack) == (69.25, 202)
    surf = np.asarray(engine.surface(needle, haystack))
    assert surf.shape == (engine.frequencies.shape[0], 8192)
    k, t = np.unravel_index(surf.argmax(), surf.shape)
    assert (float(engine.frequencies[k]), t) == (69.25, 202)


def test_engine_object_stein_backend(chirp):
    needle, haystack, _ = chirp(1)
    engine = FilterbankCAF(CafConfig(grid=FreqGrid(-50, 50, 1.0),
                                     backend="stein"))
    assert engine.peak(needle, haystack) == (36.0, 78)


def test_input_validation_contracts():
    """Empty/invalid inputs fail fast at the host boundary with a
    nameable error, not a deep argmax-of-empty or a silent (0, 0)
    'peak'."""
    import pytest as _pytest

    from caf_cookoff_tpu.config import as_grid
    from caf_cookoff_tpu.models.filterbank import caf_peak
    from caf_cookoff_tpu.models.streaming import StreamingCAF

    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(256)
           + 1j * rng.standard_normal(256)).astype(np.complex64)
    ok = np.array([0.0], np.float32)

    with _pytest.raises(ValueError, match="non-empty 1-D"):
        caf_peak(sig, sig, np.array([], np.float32), 48e3)
    with _pytest.raises(ValueError, match="non-empty 1-D"):
        as_grid(np.zeros((2, 2), np.float32))
    with _pytest.raises(ValueError, match="non-finite"):
        caf_peak(sig, sig, np.array([np.nan], np.float32), 48e3)
    with _pytest.raises(ValueError, match="empty signal"):
        caf_peak(sig[:0], sig[:0], ok, 48e3)
    with _pytest.raises(ValueError, match="empty signal"):
        StreamingCAF(sig[:0], ok, 48e3)
    # as_grid passes valid grids through unchanged.
    g = as_grid([1.0, 2.0])
    assert g.dtype == np.float32 and g.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("platform,want", [("cpu", "xla"), ("gpu", "xla"),
                                           ("metal", None)])
def test_backend_for_platform(platform, want):
    """Every platform the program runs on names its FFT backend; any
    other platform is an error, not a silent default."""
    from caf_cookoff_tpu.config import backend_for_platform

    if want is None:
        with pytest.raises(ValueError, match="no default FFT backend"):
            backend_for_platform(platform)
    else:
        assert backend_for_platform(platform) == want


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(env_set, monkeypatch, tmp_path):
    """The cache follows JAX_COMPILATION_CACHE_DIR when set (and sets
    nothing itself); otherwise it is the checkout's fixed .jax_cache."""
    import pathlib

    import jax

    from caf_cookoff_tpu.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        if env_set:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            root = pathlib.Path(__file__).resolve().parents[1]
            assert path == str(root / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert enable_compile_cache() == path     # fixed, not fresh
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_peaks_table():
    """The H100 row carries the data-sheet peaks; an unlisted device
    kind raises instead of defaulting."""
    from caf_cookoff_tpu.utils.bench import device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert (h100["bf16_flops"], h100["tf32_flops"], h100["fp32_flops"],
            h100["hbm_bytes_per_s"]) == (989e12, 495e12, 67e12, 3.35e12)
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("cpu")


def test_mfu_uses_backend_tier_peak():
    """Achieved TFLOP/s over the peak of the backend's precision tier."""
    import types

    from caf_cookoff_tpu.utils.bench import _mfu

    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    row = _mfu("matmul-bf16", 989e9, 1.0, dev)      # 989 TFLOP/s
    assert row == {"tflops": 989.0, "peak": "bf16_flops",
                   "peak_pct": 100.0}
    assert _mfu("xla", 67e9, 1.0, dev)["peak"] == "fp32_flops"
    assert _mfu("matmul", 67e9, 1.0, dev)["peak"] == "fp32_flops"
    assert _mfu("matmul-high", 67e9, 1.0, dev)["peak"] == "tf32_flops"
    with pytest.raises(ValueError):
        _mfu("xla", 1.0, 1.0, types.SimpleNamespace(device_kind="cpu"))
