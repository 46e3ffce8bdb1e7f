"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
host oracle and gates are right at tiny sizes."""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FS = chip_smoke.FS


def test_refuses_without_gpu(capsys):
    """No GPU: exit 1 with a message, and no result line."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    assert "needs an NVIDIA GPU" in err
    assert '"ok"' not in out


def test_fails_alone_in_a_directory(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _direct_filterbank(needle, capture, freqs, lags, rate=0.0):
    t = np.arange(len(needle)) / FS
    cap = np.concatenate([capture, np.zeros(len(needle), capture.dtype)])
    out = np.empty((len(freqs), len(lags)))
    for k, f in enumerate(freqs):
        taps = needle * np.exp(2j * np.pi * f * t + 1j * np.pi * rate * t * t)
        for j, lag in enumerate(lags):
            out[k, j] = abs(np.vdot(taps, cap[lag:lag + len(needle)])) ** 2
    return out


@pytest.mark.parametrize("rate", [0.0, 3000.0])
def test_oracle_matches_direct_filterbank(rate):
    """The FFT-evaluated c128 oracle equals the direct sum's argmax,
    across bin chunks, with the capture zero-extended past its end."""
    rng = np.random.default_rng(3)
    n = 64
    freqs = np.arange(-2000.0, 2000.0, 250.0)
    needle, cap = chip_smoke.plant(rng, n, 300,
                                   [(250, 750.0, 1.0, rate)], noise=0.3)
    lags = np.arange(200, 300)
    surf = _direct_filterbank(needle.astype(np.complex128),
                              cap.astype(np.complex128), freqs, lags, rate)
    k, j = np.unravel_index(int(np.argmax(surf)), surf.shape)
    got = chip_smoke.oracle_peak(needle, cap, freqs, 200, 300, rate=rate,
                                 bins_per_chunk=5)
    assert got == (int(k), int(lags[j])) == (11, 250)


def test_oracle_agrees_with_engine():
    """The oracle and caf_peak agree on a planted emitter (the gate's
    three-way comparison at a tiny size)."""
    from caf_cookoff_tpu.models.filterbank import caf_peak

    rng = np.random.default_rng(4)
    n = 256
    freqs = np.arange(-400.0, 400.0, 25.0, dtype=np.float32)
    needle, hay = chip_smoke.plant(rng, n, n, [(40, 200.0, 1.0)])
    f, lag, _ = caf_peak(needle, hay, freqs, FS)
    want = chip_smoke.oracle_peak(needle, hay, freqs, 0, n // 2)
    chip_smoke.gate("tiny", (chip_smoke.bin_of(freqs, f), lag),
                    (24, 40), want)


def test_gate_and_bin_of_reject_mismatches():
    with pytest.raises(chip_smoke.GateError):
        chip_smoke.gate("x", (1, 2), (1, 2), (1, 3))
    with pytest.raises(chip_smoke.GateError):
        chip_smoke.gate("x", (0, 2), (1, 2), (1, 2))
    freqs = np.arange(0.0, 10.0, 1.0)
    assert chip_smoke.bin_of(freqs, 7.0) == 7
    with pytest.raises(chip_smoke.GateError):
        chip_smoke.bin_of(freqs, 7.5)
