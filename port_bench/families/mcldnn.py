"""MCLDNN (``family: "mcldnn"``): three input channels of float32 convs,
two LSTM layers over the ``N - 4`` steps the convs leave, and a SELU head,
served as the module forward (cuDNN's convs and LSTM, TF32 off) on planar
``(B, 2, N)`` frames, in row chunks that fit the card.

The model takes no features: its checkpoint's scaler is a zero and a one,
and the reference needs no state of its own. The reference is the plain
float32 forward with the recurrence written out step by step
(``reference/mcldnn.py``); the control rounds each conv's, LSTM product's
and linear's input and weight to TF32, the precision this card drops to
when the TF32 flags are left on.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import common, work
from port_bench.reference import mcldnn as ref_mcldnn

#: frames of the reference at once: each LSTM layer's input products for
#: every step are ~2.1 MB a frame at N = 1024
REFERENCE_BLOCK = 2048


def params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return ref_mcldnn.mcldnn_params(cfg, seed, device)


def scaler(cfg: dict, pool: np.ndarray, params: dict, device):
    """The program's ``Standardizer`` (a zero and a one, never read), and no
    reference state."""
    from amcpy_tpu_torch.preprocessing import Standardizer

    return Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32)), None


def program_model(cfg: dict, params: dict[str, torch.Tensor]):
    from amcpy_tpu_torch.models.mcldnn import RadioMCLDNN

    m = cfg["model"]
    return common.holding(RadioMCLDNN(len(cfg["signals"]["modulations"]),
                                      cfg["signals"]["frame_size"], m["filters"],
                                      m["lstm_units"], m["lstm_layers"], m["dense"]), params)


@torch.no_grad()
def reference_logits(cfg: dict, params: dict, state, frames: np.ndarray, device,
                     control: bool) -> torch.Tensor:
    rnd = ref_mcldnn.tf32 if control else None
    out = []
    for lo in range(0, len(frames), REFERENCE_BLOCK):
        x = torch.view_as_real(torch.from_numpy(frames[lo : lo + REFERENCE_BLOCK])).to(device)
        out.append(ref_mcldnn.mcldnn_logits(params, x.transpose(1, 2), rnd))
    return torch.cat(out)


def frame_work(cfg: dict) -> dict[str, float]:
    """The multiply-accumulates of one frame, each one FP32 lane operation:
    part A's four convs at their output sizes (the I/Q conv and the pair
    conv over two rows of N, the single-channel convs over N each, the
    merging conv over N - 4), each LSTM layer's input and recurrent
    products at every one of the N - 4 steps, and the head's products.
    Biases, activations, the gates' elementwise work and concatenations
    are left out."""
    m, n = cfg["model"], cfg["signals"]["frame_size"]
    f_iq, f_single, f_pair, f_merge = m["filters"]
    k = ref_mcldnn.KERNELS
    kh, kw = k["iq"]
    steps = n - k["merge"][1] + 1
    convs = (2 * n * f_iq * kh * kw + 2 * n * f_single * k["single"]
             + 2 * n * f_pair * f_single * k["pair"][1]
             + steps * f_merge * (f_iq + f_pair) * k["merge"][0] * k["merge"][1])
    h, width, lstm = m["lstm_units"], f_merge, 0
    for _ in range(m["lstm_layers"]):
        lstm += steps * 4 * h * (width + h)
        width = h
    head = work.dense_macs([h, *m["dense"], len(cfg["signals"]["modulations"])])
    return {"fp32_lane_ops": float(convs + lstm + head)}
