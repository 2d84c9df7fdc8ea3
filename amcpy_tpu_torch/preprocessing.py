"""Feature standardization, dataset assembly and the stratified split.

Counterpart of ``amcpy_tpu/preprocessing.py``, in NumPy: a z-score with
sklearn-compatible (biased) statistics, persisted with the model
checkpoint; the ``(frames, features)`` and raw planar ``(frames, 2, N)``
datasets with their labels, in row order (modulation, SNR, frame); and a
stratified split whose indices are a pure function of ``(labels,
test_size, seed)``, identical to the JAX package's, so both packages hold
out the same frames of a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.ops.features import to_planar

__all__ = [
    "Standardizer",
    "build_dataset",
    "build_raw_dataset",
    "stratified_split",
    "stratified_split_indices",
    "train_frame_mask",
    "preprocess",
    "preprocess_raw",
]


@dataclass
class Standardizer:
    """z-score transform with sklearn-compatible (biased) statistics."""

    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, x: "np.ndarray | torch.Tensor") -> "Standardizer":
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        mean = x.mean(axis=0)
        std = np.sqrt(np.square(x - mean).mean(axis=0))  # biased, like sklearn
        std = np.where(std == 0, 1.0, std).astype(x.dtype)  # constants pass
        return cls(mean=mean, std=std)

    def transform(self, x):
        if isinstance(x, torch.Tensor):
            mean = torch.as_tensor(self.mean, dtype=x.dtype, device=x.device)
            std = torch.as_tensor(self.std, dtype=x.dtype, device=x.device)
            return (x - mean) / std
        return (np.asarray(x) - self.mean) / self.std

    def to_dict(self) -> dict:
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "Standardizer":
        return cls(
            mean=np.asarray(d["mean"], np.float32),
            std=np.asarray(d["std"], np.float32),
        )


def _snr_axis(cfg: Config, mode: str) -> list[int]:
    t = cfg.training
    return list(t.training_snr if mode == "training" else t.all_snr)


def build_dataset(
    features: dict[str, np.ndarray],
    cfg: Config,
    mode: str = "training",
) -> tuple[np.ndarray, np.ndarray]:
    """The ``(samples, used_features)`` float32 matrix and int32 labels.

    ``features`` maps modulation -> ``(num_snr, num_frames, 18)``.
    ``mode="training"`` keeps the training SNR levels, ``"test"`` all of
    them. Row order: (modulation, SNR, frame).
    """
    snr_axis = _snr_axis(cfg, mode)
    cols = list(cfg.features.used_columns)
    xs, ys = [], []
    for mod_idx, mod in enumerate(cfg.signals.modulations_with_noise):
        sel = features[mod][snr_axis][:, :, cols]  # (s, F, used)
        xs.append(sel.reshape(-1, len(cols)))
        ys.append(
            np.full(sel.shape[0] * sel.shape[1], cfg.signals.labels[mod_idx],
                    dtype=np.int32)
        )
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def build_raw_dataset(
    data: dict[str, np.ndarray],
    cfg: Config,
    mode: str = "training",
) -> tuple[np.ndarray, np.ndarray]:
    """Planar float32 frames ``(samples, 2, frame_size)`` and int32 labels
    for the raw-IQ CNN, from ``{modulation: (num_snr, num_frames, N)}``
    complex frames; SNR selection and row order as :func:`build_dataset`.
    No standardizer: the CNN normalizes each frame itself."""
    snr_axis = _snr_axis(cfg, mode)
    xs, ys = [], []
    for mod_idx, mod in enumerate(cfg.signals.modulations_with_noise):
        frames = data[mod][snr_axis]  # (s, F, N) complex
        n = frames.shape[0] * frames.shape[1]
        xs.append(to_planar(frames.reshape(n, frames.shape[2])).astype(np.float32))
        ys.append(np.full(n, cfg.signals.labels[mod_idx], dtype=np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def stratified_split_indices(
    y: np.ndarray,
    test_size: float,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic stratified split as ``(train_idx, test_idx)`` row
    indices: per class, a permutation from ``np.random.default_rng(seed)``
    with ``round(len * test_size)`` rows held out; then both sides
    permuted. The same draws in the same order as the JAX package."""
    rng = np.random.default_rng(seed)
    test_idx: list[np.ndarray] = []
    train_idx: list[np.ndarray] = []
    for cls in np.unique(y):
        idx = rng.permutation(np.nonzero(y == cls)[0])
        n_test = int(round(len(idx) * test_size))
        test_idx.append(idx[:n_test])
        train_idx.append(idx[n_test:])
    tr = rng.permutation(np.concatenate(train_idx))
    te = rng.permutation(np.concatenate(test_idx))
    return tr, te


def stratified_split(
    x: np.ndarray,
    y: np.ndarray,
    test_size: float,
    seed: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``x_train, x_test, y_train, y_test`` of
    :func:`stratified_split_indices`."""
    tr, te = stratified_split_indices(y, test_size, seed)
    return x[tr], x[te], y[tr], y[te]


def train_frame_mask(
    cfg: Config, train_idx: np.ndarray, mode: str = "training"
) -> np.ndarray:
    """Train-split row indices -> ``(mods, num_snr, num_frames)`` bool mask
    of the frames seen in training (row order (modulation, selected SNR,
    frame)); frames at SNR levels outside the selection stay False."""
    snr_sel = _snr_axis(cfg, mode)
    n_mods = len(cfg.signals.modulations_with_noise)
    n_f = cfg.signals.num_frames
    mask = np.zeros((n_mods, cfg.signals.num_snr, n_f), dtype=bool)
    idx = np.asarray(train_idx)
    block = idx // n_f
    snr_i = np.asarray(snr_sel)[block % len(snr_sel)]
    mask[block // len(snr_sel), snr_i, idx % n_f] = True
    return mask


def preprocess(
    features: dict[str, np.ndarray],
    cfg: Config,
    mode: str = "training",
    *,
    return_indices: bool = False,
):
    """Assemble -> standardize (fit on every row) -> stratified split:
    ``x_train, x_test, y_train, y_test, scaler`` and, with
    ``return_indices=True``, ``(train_idx, test_idx)``."""
    x, y = build_dataset(features, cfg, mode)
    scaler = Standardizer.fit(x)
    xs = scaler.transform(x).astype(np.float32)
    tr, te = stratified_split_indices(y, cfg.training.test_size, cfg.training.seed)
    out = (xs[tr], xs[te], y[tr], y[te], scaler)
    return out + ((tr, te),) if return_indices else out


def preprocess_raw(
    data: dict[str, np.ndarray],
    cfg: Config,
    mode: str = "training",
    *,
    return_indices: bool = False,
):
    """Assemble planar frames -> stratified split (no standardization):
    ``x_train, x_test, y_train, y_test`` and, with ``return_indices=True``,
    ``(train_idx, test_idx)``."""
    x, y = build_raw_dataset(data, cfg, mode)
    tr, te = stratified_split_indices(y, cfg.training.test_size, cfg.training.seed)
    out = (x[tr], x[te], y[tr], y[te])
    return out + ((tr, te),) if return_indices else out
