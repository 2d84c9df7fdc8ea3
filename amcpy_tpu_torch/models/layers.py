"""Training behaviour shared by both model families, as flax defines it.

The JAX package trains flax modules; these helpers make the port's modules
train the same way, so that both packages start alike and take the same
steps:

* :class:`FlaxBatchNorm1d` keeps ``nn.BatchNorm1d``'s parameter and buffer
  names (``weight``, ``bias``, ``running_mean``, ``running_var``), so state
  dicts, ``params_from_flax`` and older ``.pt`` files are unchanged, and its
  eval forward. In training it computes flax's statistics and updates the
  running variance with the biased batch variance, as flax does
  (``nn.BatchNorm1d`` would take the unbiased one).
* :func:`dropout` is flax's ``nn.Dropout`` on an explicit generator, so a
  training run draws its masks from its own seeded stream.
* :func:`init_flax_defaults` is flax's default initialization in
  distribution: Dense and Conv kernels lecun-normal (a normal truncated at
  two standard deviations, scaled by fan-in), biases zero, BatchNorm scale 1
  and bias 0.

Data-parallel training passes a
:class:`~amcpy_tpu_torch.parallel.mesh.DataShard` (``shard``): the rank's
rows are one block of a global batch, as in the JAX package's SPMD step.
BatchNorm then takes the global batch's statistics (one differentiable
all-reduce of the rank's weighted means of x and x^2), and dropout draws its
mask for the global batch and keeps the rank's rows, so W ranks compute
what one process computes on the same global batch.
"""

from __future__ import annotations

import torch
from torch import nn

from amcpy_tpu_torch.parallel.audit import all_reduce_autograd

__all__ = ["FlaxBatchNorm1d", "dropout", "init_flax_defaults"]

#: flax's BatchNorm momentum (PyTorch's 0.1)
FLAX_MOMENTUM = 0.9
#: standard deviation of a unit normal truncated to [-2, 2] (flax's
#: ``variance_scaling`` divides by it)
_TRUNC_STD = 0.87962566103423978


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over ``(B, C)`` or ``(B, C, N)`` float32 inputs.

    In training: the mean and variance over every axis but the channels,
    the variance as ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), the
    input normalized as flax does, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, and the running statistics moved by momentum 0.9
    towards the batch mean and the biased batch variance. In eval: the
    running statistics, as ``nn.BatchNorm1d``.

    With a ``shard`` the batch is the global one: each rank's means of x
    and x^2, weighted by its share of the rows (1 / size), are summed over
    the shard's group by one all-reduce whose gradient is summed too (the
    JAX package's ``[sum x, sum x^2]`` over the global batch), and every
    rank moves the same running statistics.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0,) if x.dim() == 2 else (0, 2)
        stats = torch.stack([x.mean(dims), x.square().mean(dims)])
        if shard is not None:
            stats = all_reduce_autograd(stats / shard.size, shard.group)
        mean, mean_sq = stats
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        with torch.no_grad():
            m = FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) if x.dim() == 2 else (1, -1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def dropout(
    x: torch.Tensor,
    rate: float,
    training: bool,
    generator: torch.Generator | None = None,
    shard=None,
) -> torch.Tensor:
    """flax's ``nn.Dropout``: in training, keep each value with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, the mask drawn from
    ``generator`` (the default generator when None); the identity in eval
    or at rate 0. With a ``shard`` the mask is drawn for the global batch
    and the rank's rows of it are kept."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape = x.shape if shard is None else (x.shape[0] * shard.size, *x.shape[1:])
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
    if shard is not None:
        mask = shard.local(mask)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def init_flax_defaults(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """Reset ``model``'s parameters to flax's defaults in distribution, the
    kernels drawn from ``generator`` (a CPU generator; the default one when
    None): every ``nn.Linear`` and ``nn.Conv1d`` kernel lecun-normal over
    its fan-in (inputs times kernel width), biases zero; BatchNorm scale 1,
    bias 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
