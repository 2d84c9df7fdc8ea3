"""MATLAB ``.mat`` interchange — dataset ingestion and feature artifacts.

Counterpart of ``amcpy_tpu/data/io_mat.py`` with the same on-disk layout,
so the artifacts of either package are read by the other and by the
downstream MATLAB/ARM tooling:

* input dataset ``mat-data/all_modulations.mat`` with per-modulation
  variables ``signal_bpsk``..``signal_noise`` shaped
  ``(num_snr, num_frames, frame_size)`` complex;
* per-modulation feature files ``calculated-features/{MOD}_features.mat``
  holding ``{"Modulation": name, <mat_var>: (num_snr, num_frames, 18)}``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io

from amcpy_tpu_torch.config import Config

__all__ = [
    "load_dataset",
    "load_modulation",
    "save_features",
    "load_features",
    "stacked_batch",
]


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
    """One modulation's ``(num_snr, num_frames, frame_size)`` complex64."""
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    var = cfg.signals.mat_info[mod]
    raw = scipy.io.loadmat(str(path), variable_names=[var])
    if var not in raw:
        raise KeyError(f"{path} has no variable {var!r} for {mod}")
    arr = np.asarray(raw[var])[..., : cfg.signals.frame_size]
    return np.ascontiguousarray(arr, dtype=np.complex64)


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
