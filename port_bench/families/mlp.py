"""The feature MLP (``family: "mlp"``): the 18 features of a frame (K1 on
the card), the configured ones standardized, then ``AMCClassifier``.

The served model's weights come from the seed; its scaler is fitted to the
reference's features of the pool's first ``SCALER_FRAMES`` frames, and the
reference standardizes with the same statistics. The control is the
reference in bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import common, work
from port_bench.reference import features as ref_features
from port_bench.reference import models as ref_models

#: pool frames whose reference features fit the scaler
SCALER_FRAMES = 4096


def _columns(cfg: dict) -> list[int]:
    return [f - 1 for f in cfg["features"]["used"]]


def params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return ref_models.mlp_params(cfg, seed, device)


def scaler(cfg: dict, pool: np.ndarray, params: dict, device):
    """The program's ``Standardizer``, and the reference's ``(mean, std)``:
    the statistics of the reference's features of the pool's first
    frames."""
    from amcpy_tpu_torch.preprocessing import Standardizer

    feats = ref_features.features_of_frames(pool[:SCALER_FRAMES], device)
    x = feats[:, _columns(cfg)].double()
    mean, std = x.mean(0), x.std(0, unbiased=False)
    return (Standardizer(mean.cpu().numpy().astype(np.float32),
                         std.cpu().numpy().astype(np.float32)),
            (mean.float(), std.float()))


def program_model(cfg: dict, params: dict[str, torch.Tensor]):
    from amcpy_tpu_torch.models.classifier import AMCClassifier

    t = cfg["training"]
    return common.holding(AMCClassifier(len(cfg["signals"]["modulations"]),
                                        tuple(t["hidden_sizes"]), t["dropout"],
                                        t["activation"], len(cfg["features"]["used"])), params)


@torch.no_grad()
def reference_logits(cfg: dict, params: dict, state, frames: np.ndarray, device,
                     control: bool) -> torch.Tensor:
    dt = torch.bfloat16 if control else torch.float32
    feats = ref_features.features_of_frames(frames, device, dt)[:, _columns(cfg)].to(dt)
    mean, std = state
    return ref_models.mlp_logits(params, (feats - mean.to(dt)) / std.to(dt)).float()


def frame_work(cfg: dict) -> dict[str, float]:
    """The features (K1's count) and the MLP's products."""
    n = cfg["signals"]["frame_size"]
    return {"fp32_lane_ops": work.k1_work(1, n)[1] + work.dense_macs(work.mlp_widths(cfg))}
