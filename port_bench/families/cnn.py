"""The raw-IQ ``IQConvNet`` (``family: "cnn"``): per-frame RMS, k=1 conv
blocks in bfloat16 (K3 on the card, batch norms folded), mean and max
pooling, a dense head.

The model takes no features: its checkpoint's scaler is zeros and ones,
and the reference needs no state of its own. The reference follows the
served route's cast points; the control rounds at them to float8 (e4m3),
the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import common, work
from port_bench.reference import models as ref_models

#: frames of the reference at once (its activations are ~1 MB a frame)
REFERENCE_BLOCK = 256


def params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return ref_models.cnn_params(cfg, seed, device)


def scaler(cfg: dict, pool: np.ndarray, params: dict, device):
    """The program's ``Standardizer`` (zeros and ones), and no reference
    state."""
    from amcpy_tpu_torch.preprocessing import Standardizer

    used = len(cfg["features"]["used"])
    return Standardizer(np.zeros(used, np.float32), np.ones(used, np.float32)), None


def program_model(cfg: dict, params: dict[str, torch.Tensor]):
    from amcpy_tpu_torch.models.cnn import IQConvNet

    m = cfg["model"]
    return common.holding(IQConvNet(len(cfg["signals"]["modulations"]), m["channels"],
                                    m["kernel_sizes"], m["strides"], m["dense"], m["dropout"],
                                    m["dtype"]), params)


@torch.no_grad()
def reference_logits(cfg: dict, params: dict, state, frames: np.ndarray, device,
                     control: bool) -> torch.Tensor:
    rnd = ref_models.fp8 if control else ref_models.bf16
    out = []
    for lo in range(0, len(frames), REFERENCE_BLOCK):
        x = torch.view_as_real(torch.from_numpy(frames[lo : lo + REFERENCE_BLOCK])).to(device)
        out.append(ref_models.cnn_logits(params, x[..., 0], x[..., 1], rnd))
    return torch.cat(out)


def frame_work(cfg: dict) -> dict[str, float]:
    """The CNN trunk (K3's count) and its head's products."""
    _, tensor, fp32 = work.k3_work(1, cfg["signals"]["frame_size"], work.cnn_widths(cfg))
    return {"bf16_tensor_flop": tensor,
            "fp32_lane_ops": fp32 + work.dense_macs(work.head_widths(cfg))}
