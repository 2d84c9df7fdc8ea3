"""Host-side IQ framing in NumPy.

Counterpart of the NumPy paths of ``amcpy_tpu/data/native_io.py``:
:func:`planarize` and :func:`read_stream_frames`. The native
``libamc_io.so`` loader of the JAX package is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["planarize", "read_stream_frames"]


def planarize(frames: np.ndarray) -> np.ndarray:
    """Complex64 ``(..., N)`` -> planar float32 ``(..., 2, N)``."""
    frames = np.asarray(frames, dtype=np.complex64)
    out = np.empty((*frames.shape[:-1], 2, frames.shape[-1]), np.float32)
    out[..., 0, :] = frames.real
    out[..., 1, :] = frames.imag
    return out


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
    stream = np.fromfile(
        str(path), dtype=np.complex64, offset=skip * 8,
        count=max_frames * frame_size,
    )
    got = min(len(stream) // frame_size, max_frames)
    return planarize(stream[: got * frame_size].reshape(got, frame_size))
