"""Each residual stack of the RadioML 2018 ResNet in one CUDA kernel.

The module forward of :class:`~amcpy_tpu_torch.models.resnet.RadioResNet`
runs a stack as cuDNN convolutions and aten elementwise passes (the bias
adds, the ReLUs, the residual adds, the max-pool), each reading and writing
its activation in device memory. The kernel, ``amc_resnet_stack`` in
``csrc/resnet_trunk.cu``, does a whole stack in one launch with the
activations in shared memory: the 1x1 projection and its bias, two residual
units (k=3 conv, bias, ReLU, k=3 conv, bias, the unit's input added) and
the max-pool of 2, reading ``(B, C_in, L)`` and writing ``(B, 32, L / 2)``.
It replaces no TPU kernel: the JAX package has no ResNet.

Numerics: float32 FMAs on the CUDA cores, no TF32 and no tensor cores, as
the model states; only the order of the float32 sums differs from the
module forward (cuDNN, TF32 off). The kernel's plain version is the
module's own stack, ``RadioResNet.stacks[s]``: the tests and the smoke
hold each launch against it.

The kernel takes the published widths (32 filters, k = 3, two units a
stack) and a length L a stack can cut into passes of 512 positions:
a power of two from 32 to 512 (whole frames a pass), or for the two
input channels of the first stack also a multiple of 512 (tiles with a
halo) (:func:`stack_fits`, the library's ``amc_resnet_stack_fits``).
:func:`supports_fused` says whether a model's every stack fits; any other
model keeps the module forward.

Spans and counters: :func:`resnet_logits_fused` opens the module's spans
(``amc.resnet.stack`` a stack, ``amc.resnet.head``) and counts the model's
``forwards`` and ``frames``; :attr:`resnet_stack.launches` counts launches.
"""

from __future__ import annotations

import torch

from amcpy_tpu_torch.models.resnet import RadioResNet
from amcpy_tpu_torch.utils.metrics import span

__all__ = [
    "PARAMS",
    "serving_route",
    "stack_fits",
    "supports_fused",
    "pack_params",
    "resnet_stack",
    "resnet_logits_fused",
]

FILTERS = 32
KERNEL_SIZE = 3
#: positions a block of the kernel holds at once
PASS = 512
#: the packed parameters of one stack, in floats: the four k=3 convs'
#: weights ``[c_in][tap][c_out]``, the 1x1 conv's ``[c_in][c_out]`` (room for
#: 32 input channels; stack 0 uses 2), then five biases of 32 (the 1x1
#: conv's and the four k=3 convs', in order)
CONV_W = FILTERS * KERNEL_SIZE * FILTERS
PROJ_OFF = 4 * CONV_W
BIAS_OFF = PROJ_OFF + FILTERS * FILTERS
PARAMS = BIAS_OFF + 5 * FILTERS


def stack_fits(c_in: int, length: int) -> bool:
    """Whether the kernel takes a stack of ``c_in`` input channels and
    length ``length``, as the library decides (``amc_resnet_stack_fits``):
    2 or 32 channels and a power of two from 32 to 512, or 2 channels and
    a multiple of 512. A plain function: it needs no card and builds
    nothing."""
    if c_in not in (2, FILTERS):
        return False
    if 32 <= length <= PASS:
        return PASS % length == 0
    return c_in == 2 and length % PASS == 0


def supports_fused(model) -> bool:
    """True for a float32 :class:`RadioResNet` of 32 filters, k = 3, two
    units a stack, whose every stack's length :func:`stack_fits`."""
    if not isinstance(model, RadioResNet):
        return False
    return (
        model.filters == FILTERS
        and model.kernel_size == KERNEL_SIZE
        and model.out.weight.dtype == torch.float32
        and all(len(st.units) == 2 for st in model.stacks)
        and all(
            stack_fits(st.proj.in_channels, model.frame_size >> s)
            for s, st in enumerate(model.stacks)
        )
    )


def _convs(stack) -> list:
    return [conv for unit in stack.units for conv in (unit.conv1, unit.conv2)]


@torch.no_grad()
def pack_params(model) -> list[torch.Tensor]:
    """Each stack's weights and biases as one float32 tensor of
    :data:`PARAMS` on the model's device, in the kernel's layout. The
    serving pipeline packs once."""
    if not supports_fused(model):
        raise ValueError("the fused ResNet stack takes 32 filters, k = 3, two units a stack "
                         "and stack lengths that stack_fits")
    packed = []
    for st in model.stacks:
        buf = torch.zeros(PARAMS, dtype=torch.float32, device=st.proj.weight.device)
        for k, conv in enumerate(_convs(st)):
            buf[k * CONV_W:(k + 1) * CONV_W] = conv.weight.permute(1, 2, 0).reshape(-1)
        c_in = st.proj.in_channels
        buf[PROJ_OFF:PROJ_OFF + c_in * FILTERS] = st.proj.weight[:, :, 0].T.reshape(-1)
        buf[BIAS_OFF:] = torch.cat([st.proj.bias] + [conv.bias for conv in _convs(st)])
        packed.append(buf)
    return packed


def resnet_stack(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """One stack, ``(B, C_in, L)`` -> ``(B, 32, L / 2)``, from its packed
    parameters (:func:`pack_params`), on CUDA tensors: launches
    ``amc_resnet_stack`` (``resnet_stack.launches`` counts every launch) or
    raises. A shape, layout or device the kernel does not take raises
    ``ValueError`` before any launch."""
    if x.ndim != 3 or packed.shape != (PARAMS,):
        raise ValueError(f"expected (B, C_in, L) frames and {PARAMS} packed parameters, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    if x.device != packed.device:
        raise ValueError(f"frames on {x.device} but parameters on {packed.device}")
    if x.dtype != torch.float32 or packed.dtype != torch.float32:
        raise TypeError("the ResNet stack takes float32 frames and parameters")
    b, c_in, length = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"the ResNet stack kernel runs on CUDA tensors, not on {x.device}")
    if not stack_fits(c_in, length):
        raise ValueError(f"the ResNet stack kernel cannot take {c_in} channels of length "
                         f"{length}: 2 or 32 channels and a power of two from 32 to 512, "
                         "or 2 channels and a multiple of 512")
    if not x.is_contiguous() or not packed.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous tensors")
    # it reads the frames and parameters in 16-byte words
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes tensors that start on a 16-byte boundary")
    from amcpy_tpu_torch.ops import _build

    lib = _build.load("resnet_trunk")
    out = torch.empty((b, FILTERS, length // 2), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.amc_resnet_stack(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), b, c_in, length,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "amc_resnet_stack")
    resnet_stack.launches += 1
    return out


resnet_stack.launches = 0


def resnet_logits_fused(model, planes: torch.Tensor, packed: list[torch.Tensor]) -> torch.Tensor:
    """Logits ``(B, n_classes)`` of a :func:`supports_fused` model from
    planar ``(B, 2, frame_size)`` float32 frames: a :func:`resnet_stack` a
    stack, then the module's head. Opens the module forward's spans and
    counts its ``forwards`` and ``frames``."""
    if planes.ndim != 3 or tuple(planes.shape[1:]) != (2, model.frame_size):
        raise ValueError(f"expected (B, 2, {model.frame_size}) frames, got {tuple(planes.shape)}")
    b = planes.shape[0]
    model.forwards += 1
    model.frames += b
    x = planes
    for s, p in enumerate(packed):
        with span("amc.resnet.stack", stack=s, frames=b):
            x = resnet_stack(x, p)
    return model.head(x)


def serving_route(model, kernel: str, device: torch.device):
    """The stack kernels' serving route for ``model`` on ``device``:
    ``("resnet_stacks", forward, False)`` for a :func:`supports_fused`
    model on a CUDA device, whatever the extraction ``kernel``, else None.
    The weights are packed once, here; ``forward(planes)`` takes packed
    ``(B, 2, N)`` frames (the ``False``) and runs
    :func:`resnet_logits_fused`: six stack launches and the head."""
    if device.type != "cuda" or not supports_fused(model):
        return None
    packed = pack_params(model)
    return "resnet_stacks", lambda planes: resnet_logits_fused(model, planes, packed), False
