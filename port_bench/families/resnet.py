"""The RadioML 2018 ResNet (``family: "resnet"``): six residual stacks of
float32 convs with max-pools, a flatten and a SELU head, served as the
module forward (cuDNN, TF32 off) on planar ``(B, 2, N)`` frames.

The model takes no features: its checkpoint's scaler is a zero and a one,
and the reference needs no state of its own. The reference is the plain
float32 forward (``reference/resnet.py``); the control rounds each conv's
and linear's input and weight to TF32, the precision this card drops to
when the TF32 flags are left on.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import common, work
from port_bench.reference import resnet as ref_resnet

#: frames of the reference at once (its activations are ~0.6 MB a frame)
REFERENCE_BLOCK = 512


def params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return ref_resnet.resnet_params(cfg, seed, device)


def scaler(cfg: dict, pool: np.ndarray, params: dict, device):
    """The program's ``Standardizer`` (a zero and a one, never read), and no
    reference state."""
    from amcpy_tpu_torch.preprocessing import Standardizer

    return Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32)), None


def program_model(cfg: dict, params: dict[str, torch.Tensor]):
    from amcpy_tpu_torch.models.resnet import RadioResNet

    m = cfg["model"]
    return common.holding(RadioResNet(len(cfg["signals"]["modulations"]),
                                      cfg["signals"]["frame_size"], m["stacks"], m["filters"],
                                      m["kernel_size"], m["dense"]), params)


@torch.no_grad()
def reference_logits(cfg: dict, params: dict, state, frames: np.ndarray, device,
                     control: bool) -> torch.Tensor:
    rnd = ref_resnet.tf32 if control else None
    out = []
    for lo in range(0, len(frames), REFERENCE_BLOCK):
        x = torch.view_as_real(torch.from_numpy(frames[lo : lo + REFERENCE_BLOCK])).to(device)
        out.append(ref_resnet.resnet_logits(params, x.transpose(1, 2), rnd))
    return torch.cat(out)


def frame_work(cfg: dict) -> dict[str, float]:
    """The multiply-accumulates of one frame, each one FP32 lane operation:
    every stack's 1x1 conv and its units' two k-tap convs at the stack's
    length (N halved a stack), then the head's products. Biases, ReLUs,
    adds, pools and SELUs are left out."""
    m, n = cfg["model"], cfg["signals"]["frame_size"]
    f, k = m["filters"], m["kernel_size"]
    macs, c_in = 0, 2
    for s in range(m["stacks"]):
        length = n >> s
        macs += length * (c_in * f + 2 * ref_resnet.UNITS * f * f * k)
        c_in = f
    head = [f * (n >> m["stacks"]), *m["dense"], len(cfg["signals"]["modulations"])]
    return {"fp32_lane_ops": float(macs + work.dense_macs(head))}
