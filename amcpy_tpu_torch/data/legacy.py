"""Legacy dataset tooling: DeepSig HDF5 slicing, GNU Radio binary
streams, pickle/.mat conversion, time-domain plots.

Counterpart of ``amcpy_tpu/data/legacy.py``, in NumPy and scipy.

Native replacements for the reference's ``old/`` scripts:

* DeepSig RadioML 2018.01 slicing (``old/dataset.py:8-65``): pull one
  modulation's frames out of ``GOLD_XYZ_OSC.0001_1024.hdf5``.
* GNU Radio ``complex64`` capture reader (``old/read_binary_stream.py:19-75``):
  skip the warm-up transient, frame the stream.
* pickle -> ``.mat`` conversion (``old/convert_to_mat.py:6-16``).
* time-domain frame plotting (``old/dataset_analysis.py:15-44``).

All functions are importable APIs rather than interactive scripts; heavy
dependencies (h5py, matplotlib) are imported lazily. The hot path (stream
framing) can use the native C++ framer
(:func:`amcpy_tpu_torch.data.native_io.read_stream_frames`) when built.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

__all__ = [
    "DEEPSIG_CLASSES",
    "load_deepsig_modulation",
    "read_gnuradio_stream",
    "frame_stream",
    "pickle_to_mat",
    "plot_time_domain",
]

#: DeepSig RadioML 2018.01 class order (old/dataset.py:11-34).
DEEPSIG_CLASSES: tuple[str, ...] = (
    "32PSK", "16APSK", "32QAM", "FM", "GMSK", "32APSK", "OQPSK", "8ASK",
    "BPSK", "8PSK", "AM-SSB-SC", "4ASK", "16PSK", "64APSK", "128QAM",
    "128APSK", "AM-DSB-SC", "AM-SSB-WC", "64QAM", "QPSK", "256QAM",
    "AM-DSB-WC", "OOK", "16QAM",
)

#: Frames per modulation block in the DeepSig 2018.01 file.
DEEPSIG_FRAMES_PER_MOD = 106_496

#: GNU Radio capture warm-up samples to skip (old/read_binary_stream.py:56).
GR_WARMUP_SAMPLES = 300 * 8


def load_deepsig_modulation(
    path: str | Path,
    modulation: str,
    *,
    as_complex: bool = True,
    max_frames: int | None = None,
) -> np.ndarray:
    """Slice one modulation's frames from the DeepSig 2018.01 HDF5.

    Returns ``(frames, 1024)`` complex64 (or the raw ``(frames, 1024, 2)``
    planar float32 when ``as_complex=False``).
    """
    import h5py

    idx = DEEPSIG_CLASSES.index(modulation)
    start = idx * DEEPSIG_FRAMES_PER_MOD
    end = start + DEEPSIG_FRAMES_PER_MOD
    if max_frames is not None:
        end = min(end, start + max_frames)
    with h5py.File(str(path), "r") as f:
        raw = np.asarray(f["X"][start:end])  # (frames, 1024, 2) float32
    if not as_complex:
        return raw.astype(np.float32)
    return (raw[..., 0] + 1j * raw[..., 1]).astype(np.complex64)


def read_gnuradio_stream(
    path: str | Path,
    *,
    skip: int = GR_WARMUP_SAMPLES,
    limit: int | None = None,
) -> np.ndarray:
    """Read a GNU Radio ``complex64`` binary capture, skipping the warm-up
    transient (old/read_binary_stream.py:46-57).

    Bounded IO: ``skip``/``limit`` map to ``np.fromfile(offset=, count=)``
    so only the requested window is ever read — a multi-GB capture read in
    chunks costs O(total), not O(total^2)."""
    return np.fromfile(
        str(path),
        dtype=np.complex64,
        offset=skip * 8,  # complex64 = 8 bytes
        count=-1 if limit is None else limit,
    )


def frame_stream(
    stream: np.ndarray, frame_size: int, num_frames: int | None = None
) -> np.ndarray:
    """Cut a 1-D sample stream into ``(num_frames, frame_size)`` frames
    (drops the ragged tail)."""
    total = len(stream) // frame_size
    if num_frames is not None:
        total = min(total, num_frames)
    return stream[: total * frame_size].reshape(total, frame_size)


def pickle_to_mat(
    pickle_path: str | Path,
    mat_path: str | Path,
    var_name: str,
) -> Path:
    """Convert a pickled array to ``.mat`` (old/convert_to_mat.py:6-16)."""
    import scipy.io

    with open(pickle_path, "rb") as f:
        data = pickle.load(f)
    scipy.io.savemat(str(mat_path), {var_name: np.asarray(data)})
    return Path(mat_path)


def plot_time_domain(
    frames: np.ndarray,
    out_path: str | Path,
    *,
    num_frames: int = 4,
    title: str = "",
):
    """I/Q time-domain plot of the first frames
    (old/dataset_analysis.py:15-44)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.atleast_2d(frames)[:num_frames]
    fig, axes = plt.subplots(
        len(frames), 1, figsize=(8, 2 * len(frames)), squeeze=False
    )
    for k, frame in enumerate(frames):
        ax = axes[k, 0]
        ax.plot(np.real(frame), linewidth=0.7, label="I")
        ax.plot(np.imag(frame), linewidth=0.7, label="Q")
        ax.set_ylabel(f"frame {k}")
        if k == 0:
            ax.legend(loc="upper right", fontsize=7)
            if title:
                ax.set_title(title)
    axes[-1, 0].set_xlabel("sample")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return Path(out_path)
