"""The RadioML 2018 ResNet, the third model family (``"resnet"``).

O'Shea, Roy and Clancy, "Over-the-Air Deep Learning Based Radio Signal
Classification", IEEE J. Sel. Topics Signal Process. 12(1), 2018
(arXiv:1712.04578), Table III and Fig. 5: the deep classifier of DeepSig
RadioML 2018.01A, planar I/Q frames ``(B, 2, 1024)`` in, 24 class logits
out. The layers, as read here:

* six residual stacks, each a 1x1 linear conv to ``filters`` channels, two
  residual units (a k=3 conv with ReLU, a k=3 linear conv, the unit's input
  added, nothing after the add) and a max-pool of 2: the time axis goes
  1024 -> 16;
* flatten, channel-major (``filters * N / 2**stacks`` = 512), FC 128
  SELU, FC 128 SELU, FC 24 to logits. No normalisation layer.

Three of these are readings, not certainties: the units' kernel size of 3,
that nothing follows the add, and ``"same"`` padding. The published model
trains with alpha dropout after each SELU layer; alpha dropout is the
identity in eval, so serving leaves it out. Under this reading the model
has 165,144 parameters at the published widths: 79,872 in the convs and
85,272 in the FCs.

The forward runs in float32 with TF32 held off, as published
(``utils/device.no_tf32``). The flatten ties the model to its
``frame_size``; :attr:`frame_size` is what the server holds requests to.
Parameter names: ``stacks.s.proj``, ``stacks.s.units.u.conv1``/``conv2``,
``dense.j``, ``out``.

Spans (``utils/metrics.py``): ``amc.resnet.stack`` once a stack (counts
``stack``, ``frames``) and ``amc.resnet.head`` for the flatten and the
FCs (``frames``, :meth:`head`). Counters: :attr:`forwards` and
:attr:`frames`. On the card the serving pipeline runs the stacks as one
kernel each (``ops/resnet_trunk.py::resnet_logits_fused``), with the same
spans and counters, then :meth:`head`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from amcpy_tpu_torch.utils.device import no_tf32
from amcpy_tpu_torch.utils.metrics import span

__all__ = ["RadioResNet"]


class _Unit(nn.Module):
    """One residual unit: conv, ReLU, linear conv, plus the input."""

    def __init__(self, filters: int, kernel_size: int):
        super().__init__()
        self.conv1 = nn.Conv1d(filters, filters, kernel_size, padding="same")
        self.conv2 = nn.Conv1d(filters, filters, kernel_size, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(x)))


class _Stack(nn.Module):
    """One residual stack: 1x1 linear conv, the units, max-pool of 2."""

    def __init__(self, c_in: int, filters: int, kernel_size: int, units: int):
        super().__init__()
        self.proj = nn.Conv1d(c_in, filters, 1)
        self.units = nn.ModuleList(_Unit(filters, kernel_size) for _ in range(units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        for unit in self.units:
            x = unit(x)
        return F.max_pool1d(x, 2)


class RadioResNet(nn.Module):
    """The RadioML 2018 ResNet over planar I/Q frames ``(B, 2, frame_size)``;
    float32 logits ``(B, n_classes)``."""

    #: the published widths (Table III, Fig. 5)
    N_CLASSES = 24
    FRAME_SIZE = 1024
    STACKS = 6
    FILTERS = 32
    KERNEL_SIZE = 3
    UNITS = 2
    DENSE = (128, 128)

    #: the sidecar's ``model.family``
    family = "resnet"
    #: takes raw I/Q frames, not features
    takes_iq = True

    def __init__(
        self,
        n_classes: int = N_CLASSES,
        frame_size: int = FRAME_SIZE,
        stacks: int = STACKS,
        filters: int = FILTERS,
        kernel_size: int = KERNEL_SIZE,
        dense: Sequence[int] = DENSE,
    ):
        super().__init__()
        if frame_size <= 0 or frame_size % (1 << stacks):
            raise ValueError(f"frame_size {frame_size} is not a positive multiple of "
                             f"2**stacks = {1 << stacks}")
        self.n_classes = int(n_classes)
        self.frame_size = int(frame_size)
        self.filters = int(filters)
        self.kernel_size = int(kernel_size)
        self.dense_widths = tuple(int(d) for d in dense)
        self.stacks = nn.ModuleList(
            _Stack(2 if s == 0 else filters, filters, kernel_size, self.UNITS)
            for s in range(stacks)
        )
        widths = [filters * (frame_size >> stacks), *self.dense_widths]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], n_classes)
        #: forward calls, and the frames they carried
        self.forwards = 0
        self.frames = 0

    def arch(self) -> dict:
        """The sidecar's ``model.arch``."""
        return {"stacks": len(self.stacks), "filters": self.filters,
                "kernel_size": self.kernel_size, "dense": list(self.dense_widths)}

    def sidecar(self, cfg) -> dict:
        """The sidecar's ``model`` block: the family, ``input_shape``
        ``[2, frame_size]`` of the model's own frame size and :meth:`arch`."""
        return {"family": self.family, "input_shape": [2, self.frame_size],
                "arch": self.arch()}

    @classmethod
    def from_sidecar(cls, meta: dict) -> "RadioResNet":
        """The model a sidecar describes: ``model.arch`` at the frame size
        of ``model.input_shape``."""
        m = meta["config"]["model"]
        return cls(n_classes=meta["config"]["n_classes"], frame_size=m["input_shape"][1],
                   **m["arch"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        self.forwards += 1
        self.frames += b
        with no_tf32():
            x = x.to(self.out.weight.dtype)
            for s, stack in enumerate(self.stacks):
                with span("amc.resnet.stack", stack=s, frames=b):
                    x = stack(x)
            return self.head(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits from the last stack's ``(B, filters, N / 2**stacks)``
        output: the flatten and the FCs, in float32 with TF32 off."""
        with span("amc.resnet.head", frames=x.shape[0]), no_tf32():
            x = x.flatten(1)
            for dense in self.dense:
                x = F.selu(dense(x))
            return self.out(x)
