"""Inference trunk of the raw-IQ CNN in one CUDA kernel (K3).

Replaces the Pallas kernel ``amcpy_tpu/ops/cnn_infer.py::_trunk_kernel``
(wrapper ``cnn_logits_fused``). The module forward of
:class:`~amcpy_tpu_torch.models.cnn.IQConvNet` writes every block's
activations to device memory; the kernel, ``amc_cnn_trunk`` in
``csrc/cnn_trunk.cu``, reads each frame's I and Q planes and writes only the
pooled ``(B, 2 * C_out)`` features:

* each BatchNorm is folded into its conv (``fold_bn_params``; the
  inference identity ``y = x (W s) + (b - mu) s + beta`` with
  ``s = gamma / sqrt(var + 1e-5)``);
* the per-frame RMS normalization, the k=1 conv stack with bias and ReLU,
  and the mean and max over time run inside the kernel, tile by tile along
  the time axis, with the activations in registers or shared memory.

The library has two kernels and routes by the widths (:func:`trunk_path`):
the default stack ``(2, 32, 64, 128)`` runs on ``wgmma`` with the
activations chained from layer to layer in registers and the weights
resident in shared memory (``"wgmma"``); every other stack it can hold runs
on ``mma.sync`` with the activations of a tile in shared memory
(``"mma_sync"``).

Numerics, held by :func:`cnn_trunk_plain` (the kernel's plain version):
the RMS ``rsqrt(sum(I^2 + Q^2) / 2N + 1e-12)`` in float32; layer 0
(C_in = 2) as two float32 products per output channel; every later layer
on bf16-rounded weights and activations with float32 accumulation; bias
and ReLU in float32; float32 mean and max pooling. The dense head runs in
plain PyTorch with the JAX wrapper's cast points (:func:`cnn_head`).

Only the k=1/stride-1 bf16 stack runs here (:func:`supports_fused`); every
other model takes the module forward.
"""

from __future__ import annotations

import ctypes

import torch

from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.utils.device import no_tf32

__all__ = [
    "serving_route",
    "supports_fused",
    "fold_bn_params",
    "trunk_path",
    "cnn_trunk",
    "cnn_trunk_plain",
    "cnn_head",
    "cnn_logits_fused",
]


def supports_fused(model) -> bool:
    """True for the kernel's contract: a k=1/stride-1 stack in bf16. An f32
    model keeps the module forward, whose numerics are float32."""
    return (
        all(int(k) == 1 for k in model.kernel_sizes)
        and all(int(s) == 1 for s in model.strides)
        and len(model.channels) >= 1
        and str(model.dtype) in ("bfloat16", "bf16")
    )


@torch.no_grad()
def fold_bn_params(model) -> dict:
    """Fold each BatchNorm into its k=1 conv.

    ``{"convs": [(w, b)], "dense": [(w_h, b_h), (w_o, b_o)]}``, float32 on
    the model's device: ``w`` is ``(C_out, C_in)``, ``b`` is ``(C_out, 1)``;
    the dense weights are ``(in, out)``, as flax keeps them.
    """
    convs = []
    for conv, norm in zip(model.conv, model.norm):
        if conv.weight.shape[-1] != 1:
            raise ValueError("the fused trunk takes k=1 convolutions only")
        w = conv.weight[:, :, 0].float()
        s = norm.weight.float() * torch.rsqrt(norm.running_var.float() + 1e-5)
        b = (conv.bias.float() - norm.running_mean.float()) * s + norm.bias.float()
        convs.append(((w * s[:, None]).contiguous(), b[:, None].contiguous()))
    dense = [
        (lin.weight.detach().float().T.contiguous(), lin.bias.detach().float())
        for lin in (model.dense, model.out)
    ]
    return {"convs": convs, "dense": dense}


def cnn_trunk_plain(
    i: torch.Tensor, q: torch.Tensor, convs: list[tuple[torch.Tensor, torch.Tensor]]
) -> torch.Tensor:
    """The trunk in plain PyTorch, at the kernel's cast points: ``(B, N)``
    planes -> ``(B, 2 * C_out)`` float32 (mean, then max)."""
    n = i.shape[-1]
    inv = torch.rsqrt((i * i + q * q).sum(-1, keepdim=True) / (2.0 * n) + 1e-12)
    w0, b0 = convs[0]
    i_n, q_n = (i * inv)[:, None, :], (q * inv)[:, None, :]
    h = torch.relu(w0[None, :, 0:1] * i_n + w0[None, :, 1:2] * q_n + b0[None])
    for w, b in convs[1:]:
        # bf16 values are exact in float32 and TF32, so the products are
        # exact and only the float32 sum order differs from the kernel
        w16 = w.to(torch.bfloat16).float()
        h = torch.relu(torch.matmul(w16, h.to(torch.bfloat16).float()) + b[None])
    return torch.cat([h.mean(-1), h.amax(-1)], dim=-1)


def _check_trunk_args(i, q, convs) -> list[int]:
    """Widths ``[2, C_0, ..., C_{L-1}]`` of a well-formed stack."""
    if i.ndim != 2 or i.shape != q.shape:
        raise ValueError(
            f"expected two (B, N) planes of one shape, got {tuple(i.shape)} "
            f"and {tuple(q.shape)}"
        )
    if i.device != q.device:
        raise ValueError(f"I on {i.device} but Q on {q.device}")
    if i.shape[1] == 0:
        raise ValueError("frames of zero samples have no RMS")
    if not convs:
        raise ValueError("the trunk needs at least one layer")
    widths = [2]
    for w, b in convs:
        if w.ndim != 2 or w.shape[1] != widths[-1] or b.shape != (w.shape[0], 1):
            raise ValueError(
                f"layer weights {tuple(w.shape)}/{tuple(b.shape)} do not follow "
                f"width {widths[-1]}"
            )
        widths.append(int(w.shape[0]))
    return widths


#: the stack ``trunk_wgmma_kernel`` is compiled for: I/Q in, then
#: ``IQConvNet``'s default channels
WGMMA_WIDTHS = (2, 32, 64, 128)
#: ``amc_cnn_trunk_path``'s codes; 0 means the library cannot hold the stack
_LIB_PATHS = {2: "wgmma", 1: "mma_sync"}


def trunk_path(widths) -> str:
    """The kernel ``amc_cnn_trunk`` routes a stack of widths
    ``[2, C_0, ..., C_{L-1}]`` to, as the library does
    (``amc_cnn_trunk_path``): ``"wgmma"`` for the default stack
    ``(2, 32, 64, 128)``, else ``"mma_sync"``. Which other stacks the
    mma.sync kernel can hold (1 to 8 layers, multiples of 16 channels after
    the first layer, within 227 KB of shared memory) only the library
    says: :func:`cnn_trunk` raises for the rest. A plain function: it
    needs no card and builds nothing."""
    return "wgmma" if tuple(int(w) for w in widths) == WGMMA_WIDTHS else "mma_sync"


def cnn_trunk(
    i: torch.Tensor, q: torch.Tensor, convs: list[tuple[torch.Tensor, torch.Tensor]]
) -> torch.Tensor:
    """Pooled trunk features ``(B, 2 * C_out)`` from ``(B, N)`` planes and
    folded layers (:func:`fold_bn_params`). A CUDA tensor launches
    ``amc_cnn_trunk`` (``cnn_trunk.launches`` counts every launch), which
    runs the kernel :func:`trunk_path` names for the widths
    (``cnn_trunk.launches_by_path`` counts by the kernel the library
    chose), or raises; a CPU tensor takes :func:`cnn_trunk_plain`. On
    CUDA, widths the library cannot hold raise ``ValueError`` before any
    launch."""
    widths = _check_trunk_args(i, q, convs)
    if i.device.type == "cpu":
        return cnn_trunk_plain(i, q, convs)
    if i.device.type != "cuda":
        raise ValueError(f"unsupported device {i.device}")
    tensors = [i, q] + [t for wb in convs for t in wb]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the CUDA kernel takes float32 planes and weights")
    if any(not t.is_contiguous() or t.device != i.device for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors on one device")
    from amcpy_tpu_torch.ops import _build

    lib = _build.load("cnn_trunk")
    n_layers = len(convs)
    c_widths = (ctypes.c_int * (n_layers + 1))(*widths)
    path = _LIB_PATHS.get(lib.amc_cnn_trunk_path(c_widths, n_layers))
    if path is None:
        raise ValueError(
            f"the CNN trunk kernel cannot hold widths {widths}: layers after "
            "the first take multiples of 16 channels, at most "
            "8 layers, within 227 KB of shared memory"
        )
    b, n = i.shape
    out = torch.empty((b, 2 * widths[-1]), dtype=torch.float32, device=i.device)
    if b == 0:
        return out
    w_ptrs = (ctypes.c_void_p * n_layers)(*(w.data_ptr() for w, _ in convs))
    b_ptrs = (ctypes.c_void_p * n_layers)(*(bb.data_ptr() for _, bb in convs))
    with torch.cuda.device(i.device):
        err = lib.amc_cnn_trunk(
            i.data_ptr(), q.data_ptr(), w_ptrs, b_ptrs, c_widths, n_layers,
            out.data_ptr(), b, n, torch.cuda.current_stream(i.device).cuda_stream,
        )
    _build.check(lib, err, "amc_cnn_trunk")
    cnn_trunk.launches += 1
    cnn_trunk.launches_by_path[path] += 1
    return out


cnn_trunk.launches = 0
#: the same launches, by the kernel that ran (:func:`trunk_path`)
cnn_trunk.launches_by_path = {"wgmma": 0, "mma_sync": 0}


def cnn_head(pooled: torch.Tensor, dense) -> torch.Tensor:
    """Dense head at the flax model's cast points: pooled features and
    ``w_h`` rounded to bf16, float32 accumulation, bias and ReLU; the hidden
    layer rounded to bf16; float32 logits. No TF32 on the card."""
    (w_h, b_h), (w_o, b_o) = dense
    bf = torch.bfloat16
    with no_tf32():
        h = torch.relu(pooled.to(bf).float() @ w_h.to(bf).float() + b_h)
        return h.to(bf).float() @ w_o + b_o


def cnn_logits_fused(
    model, i: torch.Tensor, q: torch.Tensor, *, folded: dict | None = None
) -> torch.Tensor:
    """Logits ``(B, n_classes)`` of a :func:`supports_fused` model from
    ``(B, N)`` I and Q planes: the trunk (:func:`cnn_trunk`, K3 on the card)
    and the dense head. ``folded`` reuses :func:`fold_bn_params` of the
    model (the serving pipeline folds once)."""
    if not supports_fused(model):
        raise ValueError("the fused CNN trunk takes a k=1/stride-1 bf16 stack")
    folded = folded or fold_bn_params(model)
    return cnn_head(cnn_trunk(i, q, folded["convs"]), folded["dense"])


def serving_route(model, kernel: str, device: torch.device):
    """K3's serving route for ``model`` under the resolved extraction
    ``kernel``: ``("k3", forward, True)`` for an :class:`IQConvNet` when
    ``kernel`` is ``"fused"`` and :func:`supports_fused` holds, on any
    ``device`` (the CPU runs the plain trunk), else None. The BatchNorm is
    folded once, here; ``forward(i, q)`` takes the ``(B, N)`` I and Q
    planes (the ``True``) and runs :func:`cnn_logits_fused`."""
    if not (isinstance(model, IQConvNet) and kernel == "fused" and supports_fused(model)):
        return None
    folded = fold_bn_params(model)
    return "k3", lambda i, q: cnn_logits_fused(model, i, q, folded=folded), True
