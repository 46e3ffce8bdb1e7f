"""ctypes bindings for libcafio (native C++ signal I/O).

The native layer mirrors the reference's compiled I/O codecs
(``caf_rust/src/utils.rs:10-63``, ``caf_go/caf.go:31-93``) but targets
the engine's needs: files and in-memory complex buffers are
deinterleaved straight into planar split-complex (re, im) float32
planes — the exact representation ``device_put`` ships to the device —
with mmap'd reads and multi-threaded conversion for large captures.

Everything degrades gracefully: if ``libcafio.so`` is absent (or the
toolchain can't build it), callers fall back to the numpy paths in
:mod:`caf_cookoff_tpu.utils.io`.  Build with ``make -C native`` or
:func:`build_native`.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libcafio.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_native(quiet: bool = True) -> bool:
    """Compile libcafio.so via make; returns True on success."""
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=quiet,
        )
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.cafio_file_samples.argtypes = [ctypes.c_char_p]
    lib.cafio_file_samples.restype = i64
    lib.cafio_load_c64_split.argtypes = [ctypes.c_char_p, fp, fp, i64, i64]
    lib.cafio_load_c64_split.restype = i64
    lib.cafio_deinterleave_c64.argtypes = [fp, fp, fp, i64]
    lib.cafio_deinterleave_c64.restype = None
    lib.cafio_interleave_c64.argtypes = [fp, fp, fp, i64]
    lib.cafio_interleave_c64.restype = None
    lib.cafio_write_c64.argtypes = [ctypes.c_char_p, fp, fp, i64]
    lib.cafio_write_c64.restype = i64
    lib.cafio_write_f64.argtypes = [ctypes.c_char_p, dp, i64]
    lib.cafio_write_f64.restype = i64
    return lib


def get_lib(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """The bound CDLL, building it on first use if needed; None if
    unavailable (callers must fall back to numpy)."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists() and auto_build:
        build_native()
    if _LIB_PATH.exists():
        try:
            _lib = _bind(ctypes.CDLL(str(_LIB_PATH)))
        except OSError:
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def file_samples(path) -> int:
    lib = get_lib()
    if lib is None:
        return os.path.getsize(os.fspath(path)) // 8
    n = lib.cafio_file_samples(os.fspath(path).encode())
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)


def load_c64_split(path, count: int = -1,
                   offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """mmap + deinterleave a .c64 file into (re, im) float32 planes."""
    lib = get_lib()
    path = os.fspath(path)
    if lib is None:
        data = np.fromfile(path, dtype="<c8",
                           count=count, offset=offset * 8)
        return (np.ascontiguousarray(data.real),
                np.ascontiguousarray(data.imag))
    total = file_samples(path)
    n = total - offset if count < 0 else min(count, total - offset)
    n = max(n, 0)
    re = np.empty(n, dtype=np.float32)
    im = np.empty(n, dtype=np.float32)
    got = lib.cafio_load_c64_split(path.encode(), _fptr(re), _fptr(im),
                                   n, offset)
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return re[:got], im[:got]


def deinterleave(interleaved_c64: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """complex64 array -> (re, im) planes, threaded for large inputs."""
    x = np.ascontiguousarray(interleaved_c64, dtype=np.complex64)
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    flat = x.view(np.float32).reshape(-1)
    n = x.size
    re = np.empty(x.shape, dtype=np.float32)
    im = np.empty(x.shape, dtype=np.float32)
    lib.cafio_deinterleave_c64(_fptr(flat), _fptr(re.reshape(-1)),
                               _fptr(im.reshape(-1)), n)
    return re, im


def write_c64_split(path, re: np.ndarray, im: np.ndarray) -> int:
    """(re, im) planes -> interleaved .c64 file."""
    lib = get_lib()
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    if lib is None:
        out = np.empty(re.size, dtype=np.complex64)
        out.real, out.imag = re.reshape(-1), im.reshape(-1)
        out.tofile(os.fspath(path))
        return re.size
    n = lib.cafio_write_c64(os.fspath(path).encode(),
                            _fptr(re.reshape(-1)), _fptr(im.reshape(-1)),
                            re.size)
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)


def write_f64(path, data: np.ndarray) -> int:
    """Raw little-endian f64 dump (Go dump_surf parity) via native IO."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if lib is None:
        data.tofile(os.fspath(path))
        return data.size
    n = lib.cafio_write_f64(
        os.fspath(path).encode(),
        data.reshape(-1).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        data.size)
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)
