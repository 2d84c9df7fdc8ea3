"""Host-side IQ layout and framing: the native library, or NumPy.

Counterpart of ``amcpy_tpu/data/native_io.py``. ``native/amc_io.cc`` (the
same source the JAX package builds) is compiled at first use with
``g++ -O3 -shared -fPIC -pthread`` into
``build/amcpy_tpu_torch/libamc_io-<hash>.so`` (the hash covers the source
and the flags, as ``ops/_build.py`` does for the CUDA kernels; the JAX
package writes its own library into ``native/``) and loaded with
``ctypes``. Every entry point has a NumPy path that gives the same arrays,
taken where no compiler or library is available: the native code is a
host throughput optimization (threaded deinterleave, fused read and
framing), not a dependency. :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "planarize",
    "deplanarize",
    "read_stream_frames",
    "standardize",
]

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "amc_io.cc"
_BUILD_DIR = _REPO / "build" / "amcpy_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libamc_io-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library's path, compiled unless it is built already; None when
    the source or a compiler is missing or the build fails."""
    if not _SRC.exists():
        return None
    out = _lib_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=out.name, suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        Path(tmp).unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.amc_planarize.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64]
        lib.amc_planarize.restype = None
        lib.amc_deplanarize.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64]
        lib.amc_deplanarize.restype = None
        lib.amc_read_stream_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _F32P,
        ]
        lib.amc_read_stream_frames.restype = ctypes.c_int64
        lib.amc_standardize.argtypes = [
            _F32P, _F32P, _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.amc_standardize.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (else NumPy runs)."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _planarize_numpy(frames: np.ndarray) -> np.ndarray:
    out = np.empty((*frames.shape[:-1], 2, frames.shape[-1]), np.float32)
    out[..., 0, :] = frames.real
    out[..., 1, :] = frames.imag
    return out


def planarize(frames: np.ndarray) -> np.ndarray:
    """Complex64 ``(..., N)`` -> planar float32 ``(..., 2, N)``."""
    frames = np.ascontiguousarray(frames, dtype=np.complex64)
    lib = _load()
    if lib is None:
        return _planarize_numpy(frames)
    lead, n = frames.shape[:-1], frames.shape[-1]
    b = int(np.prod(lead)) if lead else 1
    out = np.empty((b, 2, n), dtype=np.float32)
    lib.amc_planarize(_ptr(frames.reshape(b, n).view(np.float32)), _ptr(out), b, n)
    return out.reshape(*lead, 2, n)


def deplanarize(planar: np.ndarray) -> np.ndarray:
    """Planar float32 ``(..., 2, N)`` -> complex64 ``(..., N)``."""
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    lib = _load()
    if lib is None:
        return (planar[..., 0, :] + 1j * planar[..., 1, :]).astype(np.complex64)
    lead, n = planar.shape[:-2], planar.shape[-1]
    b = int(np.prod(lead)) if lead else 1
    out = np.empty((b, n), dtype=np.complex64)
    lib.amc_deplanarize(_ptr(planar.reshape(b, 2, n)), _ptr(out.view(np.float32)), b, n)
    return out.reshape(*lead, n)


def read_stream_frames(
    path: str | Path,
    frame_size: int,
    *,
    skip: int = 2400,
    max_frames: int | None = None,
) -> np.ndarray:
    """GNU Radio complex64 capture -> planar ``(frames, 2, frame_size)``.

    ``skip`` samples of warm-up transient are dropped; only the window of
    ``max_frames`` frames after it is read, so a capture read in chunks
    costs O(total) IO. A ragged tail is dropped.
    """
    path = Path(path)
    if max_frames is None:
        total = path.stat().st_size // 8  # complex64
        max_frames = max((total - skip) // frame_size, 0)
    lib = _load()
    if lib is None:
        from amcpy_tpu_torch.data.legacy import frame_stream, read_gnuradio_stream

        stream = read_gnuradio_stream(path, skip=skip, limit=max_frames * frame_size)
        return _planarize_numpy(frame_stream(stream, frame_size, max_frames))
    out = np.empty((max_frames, 2, frame_size), dtype=np.float32)
    got = lib.amc_read_stream_frames(str(path).encode(), skip, frame_size, max_frames,
                                     _ptr(out))
    if got < 0:
        raise IOError(f"failed to read {path}")
    return out[:got]


def standardize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """``(x - mean) / std`` over the last axis (native threads or NumPy)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    lib = _load()
    if lib is None:
        return (x - mean) / std
    out = np.empty_like(x)
    rows = int(np.prod(x.shape[:-1]))
    lib.amc_standardize(_ptr(x), _ptr(mean), _ptr(std), _ptr(out), rows, x.shape[-1])
    return out
