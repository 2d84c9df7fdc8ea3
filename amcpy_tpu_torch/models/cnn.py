"""Raw-IQ convolutional classifier, the second model family.

Counterpart of ``amcpy_tpu/models/cnn.py`` (flax ``IQConvNet``): per-frame
RMS normalization of planar ``(B, 2, N)`` frames, one Conv -> BatchNorm ->
ReLU block per entry of ``channels``/``kernel_sizes``/``strides``, mean and
max pooling over time, then Dense -> ReLU -> Dropout -> Dense to logits.

The eval forward rounds where flax rounds for ``dtype="bfloat16"``:

* the RMS runs in float32, ``sqrt(mean(x^2) + 1e-12)`` over both planes,
  and the normalized frame is rounded to bf16;
* each conv takes bf16 input, kernel and bias; its product is rounded to
  bf16 and the bias added in bf16, as ``nn.Conv`` does;
* BatchNorm runs in float32 (flax's running mean and variance promote it)
  and rounds to bf16; ReLU in bf16;
* the time mean sums in float32 and rounds to bf16 (``jnp.mean`` upcasts
  bf16); the max is taken in bf16;
* ``dense`` runs in bf16 with its ReLU; the logits layer in float32.

On the card an f32 model (``dtype="float32"``) runs without TF32: the
forward holds both TF32 flags at False and restores them after it.

Convolutions pad ``"SAME"`` as flax does: ``pad_total = max((ceil(N/s) - 1)
* s + k - N, 0)`` with ``pad_total // 2`` on the low side, padded
explicitly because ``nn.Conv1d(padding="same")`` refuses strides.

The ``aug_*`` fields are kept so that checkpoints round-trip. They act only
in training, which is not ported: a train-mode forward with augmentation
raises. Parameter names (``conv.k``, ``norm.k``, ``dense``, ``out``) are
the counterparts of the flax ``Conv_k``/``BatchNorm_k``/``Dense_0``/
``Dense_1``; :func:`amcpy_tpu_torch.train.checkpoint.cnn_params_from_flax`
maps one onto the other.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from amcpy_tpu_torch.utils.device import no_tf32

__all__ = ["IQConvNet", "same_padding"]

#: the compute dtypes of the JAX package's checkpoints (``jnp.dtype`` names)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of flax's ``"SAME"`` for length ``n``, kernel
    ``k`` and stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class IQConvNet(nn.Module):
    """1-D CNN over raw planar IQ frames ``(B, 2, N)``; float32 logits."""

    def __init__(
        self,
        n_classes: int,
        channels: Sequence[int] = (32, 64, 128),
        kernel_sizes: Sequence[int] = (1, 1, 1),
        strides: Sequence[int] = (1, 1, 1),
        dense: int = 128,
        dropout: float = 0.5,
        dtype: str = "bfloat16",
        aug_phase: bool = False,
        aug_noise_snr_db: "tuple[float, float] | None" = None,
        aug_noise_prob: float = 0.75,
    ):
        super().__init__()
        if not len(channels) == len(kernel_sizes) == len(strides):
            raise ValueError("channels/kernel_sizes/strides length mismatch")
        if str(dtype) not in _DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        self.n_classes = n_classes
        self.channels = tuple(int(c) for c in channels)
        self.kernel_sizes = tuple(int(k) for k in kernel_sizes)
        self.strides = tuple(int(s) for s in strides)
        self.dense_width = int(dense)
        self.dropout = dropout
        self.dtype = str(dtype)
        self.aug_phase = aug_phase
        self.aug_noise_snr_db = (
            None if aug_noise_snr_db is None else tuple(aug_noise_snr_db)
        )
        self.aug_noise_prob = aug_noise_prob
        widths = (2, *self.channels)
        self.conv = nn.ModuleList(
            nn.Conv1d(a, b, k, stride=s)
            for a, b, k, s in zip(widths[:-1], widths[1:], self.kernel_sizes,
                                  self.strides)
        )
        self.norm = nn.ModuleList(
            nn.BatchNorm1d(c, eps=1e-5, momentum=0.1) for c in self.channels
        )
        self.dense = nn.Linear(2 * self.channels[-1], self.dense_width)
        self.drop = nn.Dropout(dropout)
        self.out = nn.Linear(self.dense_width, n_classes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def arch(self) -> dict:
        """The sidecar's ``model.arch`` (keys of the JAX CLI's)."""
        return {
            "channels": list(self.channels),
            "kernel_sizes": list(self.kernel_sizes),
            "strides": list(self.strides),
            "dense": self.dense_width,
            "dropout": self.dropout,
            "dtype": self.dtype,
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and (self.aug_phase or self.aug_noise_snr_db is not None):
            raise NotImplementedError(
                "CNN training augmentation is not ported yet (ROADMAP Queue A, "
                "item 15)"
            )
        with no_tf32():
            dt = self.compute_dtype
            x = x.float()
            n2 = x.shape[-2] * x.shape[-1]
            rms = torch.sqrt(x.square().sum(dim=(-2, -1), keepdim=True) / n2 + 1e-12)
            x = (x / rms).to(dt)
            for conv, norm, k, s in zip(self.conv, self.norm, self.kernel_sizes,
                                        self.strides):
                lo, hi = same_padding(x.shape[-1], k, s)
                if lo or hi:
                    x = F.pad(x, (lo, hi))
                w = conv.weight.to(dt)
                if k == 1 and s == 1:  # a matrix product (cuBLAS on the card)
                    y = torch.matmul(w[:, :, 0], x)
                else:
                    y = F.conv1d(x, w, None, stride=s)
                y = y + conv.bias.to(dt)[:, None]
                x = torch.relu(norm(y.float()).to(dt))
            pooled = torch.cat(
                [(x.float().sum(-1) / x.shape[-1]).to(dt), x.amax(-1)], dim=-1
            )
            h = pooled @ self.dense.weight.to(dt).T + self.dense.bias.to(dt)
            h = self.drop(torch.relu(h))
            return self.out(h.float())
