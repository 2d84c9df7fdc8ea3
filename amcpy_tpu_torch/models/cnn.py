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

Training follows flax (``models/layers.py``): flax's default
initialization; train-mode BatchNorm takes its statistics over (batch,
time) in float32 from the bf16 conv output, normalizes and rounds to bf16,
and moves the running statistics as flax does; dropout and the
augmentation draw from the generator the forward is given. The
augmentation (``aug_phase``, ``aug_noise_snr_db``, ``aug_noise_prob``) acts
in training only: :func:`augmentation_draws` makes one batch's draws and
:func:`augment` applies them, the JAX formula of
``amcpy_tpu/models/cnn.py:110-134``. Parameter names (``conv.k``,
``norm.k``, ``dense``, ``out``) are the counterparts of the flax
``Conv_k``/``BatchNorm_k``/``Dense_0``/``Dense_1``;
:func:`amcpy_tpu_torch.train.checkpoint.cnn_params_from_flax` maps one onto
the other.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from amcpy_tpu_torch.models.layers import FlaxBatchNorm1d, dropout, init_flax_defaults
from amcpy_tpu_torch.utils.device import no_tf32

__all__ = ["IQConvNet", "augment", "augmentation_draws", "conv_bias_report",
           "same_padding"]

#: the compute dtypes of the JAX package's checkpoints (``jnp.dtype`` names)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of flax's ``"SAME"`` for length ``n``, kernel
    ``k`` and stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def augmentation_draws(
    b: int,
    n: int,
    *,
    phase: bool,
    noise_snr_db: "tuple[float, float] | None",
    noise_prob: float,
    generator: torch.Generator | None = None,
    device: "torch.device | None" = None,
    shard=None,
) -> tuple:
    """One batch's augmentation draws from ``generator``, as
    ``(theta, snr_db, keep, noise)`` for :func:`augment`: ``theta`` (B, 1)
    ~ U(0, 2 pi) when ``phase``; with ``noise_snr_db = (lo, hi)``, ``snr_db``
    (B, 1, 1) ~ U(lo, hi), ``keep`` (B, 1, 1) True with probability
    ``noise_prob`` and ``noise`` (B, 2, N) standard normal. What is not
    drawn is None. With a ``shard`` (:class:`~amcpy_tpu_torch.parallel.mesh.DataShard`)
    the draws are made for the global batch of ``B * shard.size`` rows and
    the rank's rows of each are returned."""
    if shard is not None:
        return tuple(None if v is None else shard.local(v) for v in augmentation_draws(
            b * shard.size, n, phase=phase, noise_snr_db=noise_snr_db,
            noise_prob=noise_prob, generator=generator, device=device))
    theta = snr_db = keep = noise = None
    if phase:
        theta = torch.rand((b, 1), generator=generator, device=device) * (2 * math.pi)
    if noise_snr_db is not None:
        lo, hi = noise_snr_db
        snr_db = lo + (hi - lo) * torch.rand((b, 1, 1), generator=generator, device=device)
        keep = torch.rand((b, 1, 1), generator=generator, device=device) < noise_prob
        noise = torch.randn((b, 2, n), generator=generator, device=device)
    return theta, snr_db, keep, noise


def augment(
    x: torch.Tensor,
    theta: "torch.Tensor | None",
    snr_db: "torch.Tensor | None",
    keep: "torch.Tensor | None",
    noise: "torch.Tensor | None",
) -> torch.Tensor:
    """Planar float32 frames ``(B, 2, N)`` rotated by the phase ``theta``
    and, where ``keep``, given AWGN ``noise`` at the added-noise SNR
    ``snr_db``: per-component variance ``mean(x^2) * 10^(-snr_db / 10)``,
    the mean over both planes of the rotated frame."""
    if theta is not None:
        c, s = torch.cos(theta), torch.sin(theta)
        i, q = x[:, 0, :], x[:, 1, :]
        x = torch.stack([i * c - q * s, i * s + q * c], dim=1)
    if snr_db is not None:
        p_sig = x.square().mean(dim=(-2, -1), keepdim=True)
        v = p_sig * torch.pow(10.0, -snr_db / 10.0)
        x = x + torch.where(keep, torch.sqrt(v), 0.0) * noise
    return x


class IQConvNet(nn.Module):
    """1-D CNN over raw planar IQ frames ``(B, 2, N)``; float32 logits."""

    #: the sidecar's ``model.family``
    family = "cnn"
    #: takes raw I/Q frames, of any length (the pooling is over time)
    takes_iq = True

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
        self.norm = nn.ModuleList(FlaxBatchNorm1d(c) for c in self.channels)
        self.dense = nn.Linear(2 * self.channels[-1], self.dense_width)
        self.out = nn.Linear(self.dense_width, n_classes)
        init_flax_defaults(self)

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

    def sidecar(self, cfg) -> dict:
        """The sidecar's ``model`` block, as the JAX CLI writes it: the
        family, ``input_shape`` ``[2, N]`` of the config's frame size and
        :meth:`arch`."""
        return {"family": self.family, "input_shape": [2, cfg.signals.frame_size],
                "arch": self.arch()}

    @classmethod
    def from_sidecar(cls, meta: dict) -> "IQConvNet":
        """The model a sidecar describes: its ``model.arch`` (lists as
        tuples; a missing arch is the defaults)."""
        arch = meta["config"]["model"].get("arch") or {}
        return cls(n_classes=meta["config"]["n_classes"],
                   **{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})

    def forward(
        self, x: torch.Tensor, *, generator: torch.Generator | None = None, shard=None
    ) -> torch.Tensor:
        """Logits; in training, the augmentation and dropout draw from
        ``generator``. With a :class:`~amcpy_tpu_torch.parallel.mesh.DataShard`,
        ``x`` is this rank's block of a global batch (``models/layers.py``).
        The float32 steps run in the parameters' dtype (float32 unless the
        module was cast, e.g. to float64 for a test)."""
        with no_tf32():
            base = self.out.weight.dtype
            dt = base if self.dtype == "float32" else self.compute_dtype
            x = x.to(base)
            if self.training and (self.aug_phase or self.aug_noise_snr_db is not None):
                x = augment(x, *augmentation_draws(
                    x.shape[0], x.shape[-1], phase=self.aug_phase,
                    noise_snr_db=self.aug_noise_snr_db,
                    noise_prob=self.aug_noise_prob, generator=generator,
                    device=x.device, shard=shard,
                ))
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
                x = torch.relu(norm(y.to(base), shard).to(dt))
            pooled = torch.cat(
                [(x.to(base).sum(-1) / x.shape[-1]).to(dt), x.amax(-1)], dim=-1
            )
            h = pooled @ self.dense.weight.to(dt).T + self.dense.bias.to(dt)
            h = dropout(torch.relu(h), self.dropout, self.training, generator, shard)
            return self.out(h.to(base))


@torch.no_grad()
def conv_bias_report(model: IQConvNet, x: torch.Tensor) -> list[dict[str, float]]:
    """Per conv layer of ``model`` (eval mode, on frames ``x`` on its
    device): ``max_abs_bias``, the largest |bias|; ``product_std``, the std
    of the layer's product before the bias, over batch, channels and time,
    in float32; and ``ratio``, the largest |bias_c| over its channel's std.

    A conv bias that feeds a BatchNorm gets a gradient that is zero in
    exact arithmetic, so an adaptive optimizer moves it on roundoff alone;
    in bf16 the bias is added to the product in bf16 (as ``nn.Conv`` does),
    so a bias many times the product's spread rounds the product away."""
    inputs: list[torch.Tensor] = []
    hooks = [norm.register_forward_pre_hook(lambda _, args: inputs.append(args[0]))
             for norm in model.norm]
    was_training = model.training
    model.eval()
    try:
        model(x)
    finally:
        model.train(was_training)
        for hook in hooks:
            hook.remove()
    out = []
    for conv, z in zip(model.conv, inputs):
        # each BatchNorm's input is the product plus the bias, the sum
        # rounded to the compute dtype; a channel's std is its product's
        bias = conv.bias.detach().float()
        y = z.float() - conv.bias.detach().to(model.compute_dtype).float()[:, None]
        per_channel = y.transpose(0, 1).reshape(y.shape[1], -1).std(dim=1)
        out.append({"max_abs_bias": float(bias.abs().max()), "product_std": float(y.std()),
                    "ratio": float((bias.abs() / per_channel.clamp_min(1e-30)).max())})
    return out
