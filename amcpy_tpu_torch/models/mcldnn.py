"""MCLDNN, the multi-channel conv + LSTM classifier, the fourth model family
(``"mcldnn"``).

Xu, Luo, Parr and Luo, "A Spatiotemporal Multi-Channel Learning Framework
for Automatic Modulation Recognition", IEEE Wireless Communications
Letters 9(10), 2020 (doi:10.1109/LWC.2020.2999453), with the authors'
Keras code (github.com/wzjialang/MCLDNN). Planar I/Q frames ``(B, 2, N)``
in, class logits out. The layers, as the published code has them (Keras,
channels last; written here in NCHW):

* part A, three input channels: ``a = ReLU(Conv2d(1 -> 50, (2, 8),
  'same'))`` on the I/Q plane ``(1, 2, N)``; ``b_I = ReLU(Conv1d(1 -> 50,
  8, 'causal'))`` on I alone and ``b_Q`` likewise on Q, stacked along the
  height into ``(50, 2, N)``, then ``b = ReLU(Conv2d(50 -> 50, (1, 8),
  'same'))``; ``c`` = ``a``'s channels then ``b``'s, ``(100, 2, N)``;
  ``d = ReLU(Conv2d(100 -> 100, (2, 5), 'valid'))``, ``(100, 1, N - 4)``;
* part B: ``d`` read as ``N - 4`` steps of 100 features through LSTM(128)
  returning the sequence, then LSTM(128); the last step's hidden state is
  kept. Gates i, f, g, o; two bias vectors a layer (cuDNN's, and Keras'
  ``CuDNNLSTM``);
* the head: FC 128 SELU, FC 128 SELU, FC to logits. The published dropout
  of 0.5 is the identity in eval and is left out.

Keras' ``'same'`` with an even kernel pads 3 columns before and 4 after on
the time axis, and on the height axis a height-2 kernel pads 0 rows above
and 1 below; ``'causal'`` pads 7 before and none after. The pads are
explicit ``F.pad`` calls (:func:`same_pad`, :func:`causal_pad`), since
PyTorch's ``padding='same'`` puts the odd pad on the other side. At 11
classes and the published 2 x 128 frames the model has 406,199
parameters, at 24 classes 407,876.

The forward runs in float32 with TF32 held off (``utils/device.no_tf32``;
the LSTM is ``nn.LSTM`` on cuDNN on a card). The published ``Reshape``
fixes the step count, so the model is tied to its ``frame_size``, which the
server holds requests to. Its activations grow with the step count
(several MB a frame at N = 1024): :meth:`activation_bytes` states them, and
the serving pipeline runs a dispatch in row chunks that fit the card
(``serve.py``). Parameter names: ``conv_iq``, ``conv_i``, ``conv_q``,
``conv_pair``, ``conv_merge``, ``lstm``, ``dense.j``, ``out``.

Spans (``utils/metrics.py``): ``amc.mcldnn.convs`` (part A, ``frames``),
``amc.mcldnn.lstm`` (part B, ``frames``, ``steps``) and ``amc.mcldnn.head``
(``frames``). Counters: :attr:`forwards`, :attr:`frames` and
:attr:`steps` (the recurrent steps a layer ran, ``N - 4`` a forward).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from amcpy_tpu_torch.utils.device import no_tf32
from amcpy_tpu_torch.utils.metrics import span

__all__ = ["RadioMCLDNN", "causal_pad", "same_pad"]


def same_pad(x: torch.Tensor, kernel: tuple[int, ...]) -> torch.Tensor:
    """``x`` zero-padded as Keras' stride-1 ``'same'`` pads it for
    ``kernel`` over its last ``len(kernel)`` axes: ``(k - 1) // 2`` before,
    the rest after."""
    pads: list[int] = []
    for k in reversed(kernel):
        pads += [(k - 1) // 2, k // 2]
    return F.pad(x, pads)


def causal_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` zero-padded as Keras' ``'causal'`` pads it for a kernel of
    ``k`` taps over its last axis: ``k - 1`` before, none after."""
    return F.pad(x, (k - 1, 0))


class RadioMCLDNN(nn.Module):
    """MCLDNN over planar I/Q frames ``(B, 2, frame_size)``; float32 logits
    ``(B, n_classes)``."""

    #: the published widths (the authors' code), at RadioML 2018's frames
    #: and classes
    N_CLASSES = 24
    FRAME_SIZE = 1024
    #: filters of the I/Q conv, of each single-channel conv, of the conv
    #: over the stacked pair, and of the merging conv
    FILTERS = (50, 50, 50, 100)
    LSTM_UNITS = 128
    LSTM_LAYERS = 2
    DENSE = (128, 128)
    #: the published kernels: I/Q conv, single-channel convs, pair conv,
    #: merging conv ('valid')
    KERNEL_IQ = (2, 8)
    KERNEL_SINGLE = 8
    KERNEL_PAIR = (1, 8)
    KERNEL_MERGE = (2, 5)

    #: float32 values the forward holds at its peak a recurrent step, for
    #: each unit of each layer (:meth:`activation_bytes`)
    FLOATS_PER_UNIT_STEP = 13

    #: the sidecar's ``model.family``
    family = "mcldnn"
    #: takes raw I/Q frames, not features
    takes_iq = True

    def __init__(
        self,
        n_classes: int = N_CLASSES,
        frame_size: int = FRAME_SIZE,
        filters: Sequence[int] = FILTERS,
        lstm_units: int = LSTM_UNITS,
        lstm_layers: int = LSTM_LAYERS,
        dense: Sequence[int] = DENSE,
    ):
        super().__init__()
        if frame_size < self.KERNEL_MERGE[1]:
            raise ValueError(f"frame_size {frame_size} is shorter than the merging conv's "
                             f"{self.KERNEL_MERGE[1]} taps")
        f_iq, f_single, f_pair, f_merge = (int(f) for f in filters)
        self.n_classes = int(n_classes)
        self.frame_size = int(frame_size)
        self.filters = (f_iq, f_single, f_pair, f_merge)
        self.lstm_units = int(lstm_units)
        self.dense_widths = tuple(int(d) for d in dense)
        self.conv_iq = nn.Conv2d(1, f_iq, self.KERNEL_IQ)
        self.conv_i = nn.Conv1d(1, f_single, self.KERNEL_SINGLE)
        self.conv_q = nn.Conv1d(1, f_single, self.KERNEL_SINGLE)
        self.conv_pair = nn.Conv2d(f_single, f_pair, self.KERNEL_PAIR)
        self.conv_merge = nn.Conv2d(f_iq + f_pair, f_merge, self.KERNEL_MERGE)
        self.lstm = nn.LSTM(f_merge, self.lstm_units, num_layers=int(lstm_layers),
                            batch_first=True)
        widths = [self.lstm_units, *self.dense_widths]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], n_classes)
        #: forward calls, the frames they carried, and the recurrent steps
        #: a layer ran in them
        self.forwards = 0
        self.frames = 0
        self.steps = 0

    @property
    def n_steps(self) -> int:
        """The recurrence's length: the frame after the merging conv."""
        return self.frame_size - self.KERNEL_MERGE[1] + 1

    def arch(self) -> dict:
        """The sidecar's ``model.arch``."""
        return {"filters": list(self.filters), "lstm_units": self.lstm_units,
                "lstm_layers": self.lstm.num_layers, "dense": list(self.dense_widths)}

    def sidecar(self, cfg) -> dict:
        """The sidecar's ``model`` block: the family, ``input_shape``
        ``[2, frame_size]`` of the model's own frame size and :meth:`arch`."""
        return {"family": self.family, "input_shape": [2, self.frame_size],
                "arch": self.arch()}

    @classmethod
    def from_sidecar(cls, meta: dict) -> "RadioMCLDNN":
        """The model a sidecar describes: ``model.arch`` at the frame size
        of ``model.input_shape``."""
        m = meta["config"]["model"]
        return cls(n_classes=meta["config"]["n_classes"], frame_size=m["input_shape"][1],
                   **m["arch"])

    def activation_bytes(self) -> int:
        """The device bytes a frame's forward holds at its peak: the
        recurrence's, which outweigh part A's at every frame size worth
        serving. cuDNN's LSTM keeps, for the whole sequence, a workspace of
        ~11.4 MB a frame at 1020 steps, and the forward's peak was 12.73 MB
        a frame at 1,024-4,096 frames (cuDNN 9.2 on an H100): ~12.5 floats
        a step for each unit of each layer, stated as
        :attr:`FLOATS_PER_UNIT_STEP`."""
        return (4 * self.n_steps * self.lstm.num_layers * self.lstm_units
                * self.FLOATS_PER_UNIT_STEP)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        self.forwards += 1
        self.frames += b
        self.steps += self.n_steps
        with no_tf32():
            x = x.to(self.out.weight.dtype)
            with span("amc.mcldnn.convs", frames=b):
                seq = self.convs(x)
            with span("amc.mcldnn.lstm", frames=b, steps=seq.shape[1]):
                _, (h, _) = self.lstm(seq)
            return self.head(h[-1])

    def convs(self, x: torch.Tensor) -> torch.Tensor:
        """Part A: ``(B, 2, N)`` frames to the recurrence's input ``(B, N -
        4, filters[3])``, one step a column of the merging conv's output."""
        a = torch.relu(self.conv_iq(same_pad(x[:, None], self.KERNEL_IQ)))
        k = self.KERNEL_SINGLE
        b = torch.stack([torch.relu(self.conv_i(causal_pad(x[:, :1], k))),
                         torch.relu(self.conv_q(causal_pad(x[:, 1:], k)))], dim=2)
        b = torch.relu(self.conv_pair(same_pad(b, self.KERNEL_PAIR)))
        d = torch.relu(self.conv_merge(torch.cat([a, b], dim=1)))
        return d[:, :, 0].transpose(1, 2)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits from the last layer's final hidden state ``(B,
        lstm_units)``: the FCs."""
        with span("amc.mcldnn.head", frames=h.shape[0]):
            for dense in self.dense:
                h = F.selu(dense(h))
            return self.out(h)
