"""MATLAB ``.mat`` interchange — dataset ingestion and feature artifacts.

Counterpart of ``amcpy_tpu/data/io_mat.py`` with the same on-disk layout,
so the artifacts of either package are read by the other and by the
downstream MATLAB/ARM tooling:

* input dataset ``mat-data/all_modulations.mat`` with per-modulation
  variables ``signal_bpsk``..``signal_noise`` shaped
  ``(num_snr, num_frames, frame_size)`` complex;
* per-modulation feature files ``calculated-features/{MOD}_features.mat``
  holding ``{"Modulation": name, <mat_var>: (num_snr, num_frames, 18)}``.

**The direct route.** Extraction reads a modulation's I and Q planes
straight from the file's bytes where it can (:func:`locate_planes`,
:func:`read_planes`): one ``readinto`` a plane, into page-locked memory on
a card, in the file's own (Fortran) order, reordered on the device by
:func:`planes_to_frames`. It takes a little-endian MAT v5 file (what
``scipy.io.savemat`` writes by default and MATLAB's ``save -v6``) whose
variable is stored uncompressed, 3-D and complex, of class single stored as
``miSINGLE`` or of class double stored as ``miDOUBLE``, with sizes that
match its dims. Everything else takes ``scipy.io.loadmat``
(:func:`load_modulation`): a compressed element before the variable
(MATLAB's default ``save``, ``savemat(do_compression=True)``), a
big-endian, v4 or v7.3 (HDF5) file, a missing, real-only or 2-D variable,
or a storage type that differs from the class. The counters
:data:`direct_reads` and :data:`loadmat_reads` count each route's reads.
"""

from __future__ import annotations

import math
import os
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import scipy.io
import torch

from amcpy_tpu_torch.config import Config

__all__ = [
    "save_dataset",
    "load_dataset",
    "load_modulation",
    "PlaneLayout",
    "locate_planes",
    "read_planes",
    "planes_to_frames",
    "save_features",
    "load_features",
    "stacked_batch",
]

#: modulations read by :func:`read_planes`, the direct route
direct_reads = 0
#: modulations read through ``scipy.io.loadmat`` (:func:`load_modulation`)
loadmat_reads = 0


def save_dataset(cfg: Config, data: dict[str, np.ndarray]) -> Path:
    """Write ``{modulation: (num_snr, num_frames, N) complex}`` as
    ``mat-data/all_modulations.mat`` (one variable per modulation)."""
    cfg.paths.ensure_dirs()
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    scipy.io.savemat(
        str(path),
        {cfg.signals.mat_info[m]: np.asarray(a) for m, a in data.items()},
    )
    return path


def load_dataset(cfg: Config) -> dict[str, np.ndarray]:
    """Read all modulations from ``all_modulations.mat`` in one pass.

    Returns ``{modulation_name: (num_snr, num_frames, frame_size) complex64}``.
    """
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    raw = scipy.io.loadmat(str(path))
    out = {}
    for mod in cfg.signals.modulations_with_noise:
        var = cfg.signals.mat_info[mod]
        if var not in raw:
            raise KeyError(f"{path} has no variable {var!r} for {mod}")
        arr = np.asarray(raw[var])[..., : cfg.signals.frame_size]
        out[mod] = np.ascontiguousarray(arr, dtype=np.complex64)
    return out


def load_modulation(cfg: Config, mod: str) -> np.ndarray:
    """One modulation's ``(num_snr, num_frames, frame_size)`` complex64,
    through ``scipy.io.loadmat`` (counted in :data:`loadmat_reads`)."""
    global loadmat_reads
    loadmat_reads += 1
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    var = cfg.signals.mat_info[mod]
    raw = scipy.io.loadmat(str(path), variable_names=[var])
    if var not in raw:
        raise KeyError(f"{path} has no variable {var!r} for {mod}")
    arr = np.asarray(raw[var])[..., : cfg.signals.frame_size]
    return np.ascontiguousarray(arr, dtype=np.complex64)


# MAT v5 element types, and the array flags' complex bit
_MI_INT8, _MI_INT32, _MI_UINT32, _MI_SINGLE, _MI_DOUBLE, _MI_MATRIX = 1, 5, 6, 7, 9, 14
_COMPLEX = 0x0800
#: array class -> the element type its planes are stored as on the direct
#: route, and the dtype they are read as (mxSINGLE_CLASS 7, mxDOUBLE_CLASS 6)
_PLANE_TYPES = {7: (_MI_SINGLE, torch.float32), 6: (_MI_DOUBLE, torch.float64)}


class PlaneLayout(NamedTuple):
    """Where a variable's planes lie in a MAT v5 file (:func:`locate_planes`)."""

    #: ``(S, F, N)`` as the file states them
    dims: tuple[int, int, int]
    #: ``torch.float32`` (class single) or ``torch.float64`` (class double)
    dtype: torch.dtype
    #: byte offsets of the real and the imaginary plane
    offsets: tuple[int, int]


def _element(f, at: int, end: int) -> tuple[int, int, int, int]:
    """The element whose tag is at ``at``: (type, byte count, offset of its
    data, offset of the next element), in the small or the regular form;
    type 0 where it would pass ``end``."""
    if at + 8 > end:
        return 0, 0, at, end
    f.seek(at)
    word, count = struct.unpack("<II", f.read(8))
    if word >> 16:  # small element: count and type in one word, data in the next four bytes
        kind, count, data, nxt = word & 0xFFFF, word >> 16, at + 4, at + 8
    else:
        kind, data = word, at + 8
        nxt = data + -(-count // 8) * 8
    return (kind, count, data, nxt) if max(nxt, data + count) <= end else (0, 0, at, end)


def locate_planes(path: Path | str, var: str) -> PlaneLayout | None:
    """Where ``var``'s real and imaginary planes lie in the ``.mat`` file
    at ``path``, or None where it takes ``loadmat``'s route (the module
    docstring says which files do). Walks the top-level tags from the
    128-byte header and reads only tags, flags, dims and names."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 136 or f.read(128)[124:] != b"\x00\x01IM":
            return None
        at = 128
        while at + 8 <= size:
            kind, count, body, _ = _element(f, at, size)
            end = body + count  # top-level elements are not padded
            if kind != _MI_MATRIX:
                return None
            flags = _element(f, body, end)
            dims = _element(f, flags[3], end)
            name = _element(f, dims[3], end)
            f.seek(name[2])
            if name[0] == _MI_INT8 and f.read(name[1]) == var.encode():
                return _planes_of(f, flags, dims, name[3], end)
            at = end
    return None


def _planes_of(f, flags, dims, at: int, end: int) -> PlaneLayout | None:
    """The layout of the variable whose array flags and dims elements are
    ``flags`` and ``dims`` and whose planes start at ``at``, or None where
    the direct route does not take it."""
    if flags[:2] != (_MI_UINT32, 8) or dims[:2] != (_MI_INT32, 12):
        return None
    f.seek(flags[2])
    (word,) = struct.unpack("<I", f.read(4))
    f.seek(dims[2])
    shape = struct.unpack("<3i", f.read(12))
    if not word & _COMPLEX or word & 0xFF not in _PLANE_TYPES or min(shape) < 0:
        return None
    kind, dtype = _PLANE_TYPES[word & 0xFF]
    nbytes = math.prod(shape) * dtype.itemsize
    re = _element(f, at, end)
    im = _element(f, re[3], end)
    if any(p[:2] != (kind, nbytes) for p in (re, im)):
        return None
    return PlaneLayout(shape, dtype, (re[2], im[2]))


def read_planes(
    path: Path | str, layout: PlaneLayout, frame_size: int, *, pin: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``min(frame_size, N)`` samples of every frame of a located
    variable: its real and its imaginary plane as the file holds them, each
    ``(n, F*S)`` of the layout's dtype (the Fortran order's prefix), one
    ``readinto`` a plane, in page-locked memory when ``pin``. Counted in
    :data:`direct_reads`; :func:`planes_to_frames` makes them frames."""
    global direct_reads
    s, f, n = layout.dims
    n = min(frame_size, n)
    planes = tuple(torch.empty((n, f * s), dtype=layout.dtype, pin_memory=pin)
                   for _ in layout.offsets)
    with open(path, "rb", buffering=0) as fh:
        for plane, at in zip(planes, layout.offsets):
            fh.seek(at)
            view = memoryview(plane.numpy()).cast("B")
            got = 0
            while got < len(view):
                k = fh.readinto(view[got:])
                if not k:
                    raise EOFError(f"{path} ends inside the plane at byte {at}")
                got += k
    direct_reads += 1
    return planes


def planes_to_frames(plane: torch.Tensor, s: int, f: int) -> torch.Tensor:
    """A plane of :func:`read_planes`, ``(n, F*S)`` in the file's order, as
    the float32 frames ``(S*F, n)`` in (SNR, frame) order, contiguous and on
    the plane's device; a double plane is rounded to nearest, as
    ``np.complex64`` rounds it."""
    n = plane.shape[0]
    return plane.to(torch.float32).view(n, f, s).permute(2, 1, 0).reshape(s * f, n).contiguous()


def stacked_batch(data: dict[str, np.ndarray], cfg: Config) -> np.ndarray:
    """Stack per-mod arrays into one ``(M*S*F, frame_size)`` complex batch,
    ordered (modulation, snr, frame)."""
    mods = cfg.signals.modulations_with_noise
    info = cfg.signals.mat_info
    arr = np.stack(
        [data[m] if m in data else data[info[m]] for m in mods]
    )  # (M, S, F, N)
    m, s, f, n = arr.shape
    return arr.reshape(m * s * f, n)


def save_features(
    cfg: Config, mod: str, features: np.ndarray, path: Path | None = None
) -> Path:
    """Write ``{MOD}_features.mat`` in the reference artifact layout."""
    cfg.paths.ensure_dirs()
    out = path or cfg.paths.calculated_features / f"{mod}_features.mat"
    scipy.io.savemat(
        str(out),
        {
            "Modulation": mod,
            cfg.signals.mat_info[mod]: np.asarray(features, dtype=np.float32),
        },
    )
    return out


def load_features(cfg: Config, mod: str) -> np.ndarray:
    """Read one modulation's ``(num_snr, num_frames, 18)`` feature matrix."""
    path = cfg.paths.calculated_features / f"{mod}_features.mat"
    raw = scipy.io.loadmat(str(path))
    return np.asarray(raw[cfg.signals.mat_info[mod]], dtype=np.float32)
