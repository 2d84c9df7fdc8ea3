"""Feature standardization.

Counterpart of the :class:`Standardizer` of ``amcpy_tpu/preprocessing.py``:
a z-score with sklearn-compatible (biased) statistics, persisted with the
model checkpoint. The dataset builders and the stratified split wait for
the training slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Standardizer"]


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
