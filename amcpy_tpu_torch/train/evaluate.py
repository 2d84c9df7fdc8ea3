"""Evaluation: the per-SNR accuracy matrix and the confusion matrix.

Counterpart of ``amcpy_tpu/train/evaluate.py``. Both families run their
module forward, as the JAX package's ``predict_logits`` runs
``model.apply``: the MLP on standardized feature artifacts
(:func:`evaluate_by_snr`), the raw-IQ CNN on raw frames streamed to the
device in chunks of ``chunk`` rows (:func:`evaluate_by_snr_raw`).
Evaluation does not take the serving kernels (K1, K3). The accuracy
matrix is written as ``figures/{id}_figure_data.mat``, as in the JAX
package.

Entry points take ``device=None``, meaning the CUDA card, and raise when
there is none; pass ``device="cpu"`` for the CPU.

With a process group of more than one rank up, every rank calls the same
entry point and the logits are computed over the ranks
(:func:`~amcpy_tpu_torch.train.training.predict_logits_global`, as the JAX
package's ``_logits_np`` routes, ``evaluate.py:34-44``); every rank gets
the whole result.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import scipy.io
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.ops.features import to_planar
from amcpy_tpu_torch.parallel.mesh import world_size
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.utils.device import no_tf32, resolve_device

__all__ = [
    "evaluate_by_snr",
    "evaluate_by_snr_raw",
    "confusion_counts",
    "save_confusion_matrix",
    "save_figure_data",
]


@torch.inference_mode()
def _predict_classes(
    model: torch.nn.Module,
    x: np.ndarray,
    chunk: int | None,
    device: torch.device,
) -> np.ndarray:
    """argmax class per row of ``x``, ``chunk`` rows at a time (all rows in
    one call when ``chunk`` is None). The model is moved to ``device`` and
    runs in eval mode there, in full float32 (no TF32); a ragged last chunk
    runs as it is. With more than one rank, each chunk's rows are split
    over them."""
    from amcpy_tpu_torch.train.training import predict_logits_global

    model = model.to(device).eval()
    step = x.shape[0] if chunk is None else chunk
    spread = world_size() > 1
    preds = []
    with no_tf32():
        for start in range(0, x.shape[0], max(step, 1)):
            xb = np.ascontiguousarray(x[start : start + step], dtype=np.float32)
            if spread:
                logits = predict_logits_global(model, xb, device=device)
            else:
                logits = model(torch.from_numpy(xb).to(device))
            preds.append(logits.argmax(dim=-1).cpu().numpy())
    return np.concatenate(preds) if preds else np.zeros(0, np.int64)


def _masked_block_accuracy(
    correct: np.ndarray, exclude_mask: np.ndarray | None
) -> np.ndarray:
    """Mean over the frame axis of ``(M, S, F)`` correctness, optionally
    restricted to the frames NOT in ``exclude_mask``."""
    if exclude_mask is None:
        return correct.mean(axis=-1)
    keep = ~np.asarray(exclude_mask, dtype=bool)
    n = np.maximum(keep.sum(axis=-1), 1)
    return (correct & keep).sum(axis=-1) / n


def evaluate_by_snr(
    model: torch.nn.Module,
    scaler: Standardizer,
    features: dict[str, np.ndarray],
    cfg: Config,
    exclude_mask: np.ndarray | None = None,
    *,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Accuracy per (modulation, SNR), ``(n_mods, n_snr)`` in [0, 1], of the
    feature MLP on ``{modulation: (num_snr, num_frames, 18)}`` artifacts,
    standardized with the checkpoint's scaler (not refit).

    ``exclude_mask``, a ``(n_mods, n_snr, n_frames)`` bool (e.g. the
    training split from :func:`~amcpy_tpu_torch.preprocessing.train_frame_mask`),
    leaves those frames out of the accuracy.
    """
    dev = resolve_device(device)
    cols = list(cfg.features.used_columns)
    blocks = np.stack([features[m][:, :, cols] for m in cfg.signals.modulations_with_noise])
    m, n_snr, n_frames, u = blocks.shape
    x = scaler.transform(blocks.reshape(-1, u).astype(np.float32))
    pred = _predict_classes(model, x, None, dev).reshape(m, n_snr, n_frames)
    true = np.asarray(cfg.signals.labels)[:, None, None]
    return _masked_block_accuracy(pred == true, exclude_mask)


def evaluate_by_snr_raw(
    model: torch.nn.Module,
    data: dict[str, np.ndarray],
    cfg: Config,
    chunk: int = 2048,
    exclude_mask: np.ndarray | None = None,
    *,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Per-(modulation, SNR) accuracy of a raw-IQ model on
    ``{modulation: (num_snr, num_frames, N)}`` complex frames, sent to the
    device as planar float32 in chunks of ``chunk`` rows, so the dataset
    never sits on the device at once. ``exclude_mask`` as in
    :func:`evaluate_by_snr`."""
    dev = resolve_device(device)
    s = cfg.signals
    mods = s.modulations_with_noise
    correct = np.zeros((len(mods), s.num_snr, s.num_frames), dtype=bool)
    for mod_idx, mod in enumerate(mods):
        frames = np.asarray(data[mod])  # (S, F, N) complex
        n_snr, n_frames, n = frames.shape
        pred = _predict_classes(model, to_planar(frames.reshape(-1, n)), chunk, dev)
        correct[mod_idx] = pred.reshape(n_snr, n_frames) == s.labels[mod_idx]
    return _masked_block_accuracy(correct, exclude_mask)


def confusion_counts(
    model: torch.nn.Module,
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    chunk: int | None = None,
    *,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Row-normalized confusion matrix (true x predicted), 2 decimals."""
    pred = _predict_classes(model, np.asarray(x), chunk, resolve_device(device))
    cm = np.zeros((n_classes, n_classes), dtype=np.float64)
    np.add.at(cm, (np.asarray(y), pred), 1.0)
    return np.around(cm / np.maximum(cm.sum(axis=1, keepdims=True), 1), 2)


def save_figure_data(cfg: Config, model_id: str, acc: np.ndarray) -> None:
    """``figures/{model_id}_figure_data.mat`` holding ``acc``."""
    cfg.paths.ensure_dirs()
    scipy.io.savemat(
        str(cfg.paths.figures / f"{model_id}_figure_data.mat"), {"acc": acc}
    )


def save_confusion_matrix(
    cfg: Config, model_id: str, cm: np.ndarray, tag: str = "cm"
) -> Path:
    """``figures/{tag}-{model_id}.json``: the confusion matrix (true x
    predicted) with its class names, the numbers the JAX package draws as
    ``figures/{tag}-{model_id}.png``."""
    cfg.paths.ensure_dirs()
    path = cfg.paths.figures / f"{tag}-{model_id}.json"
    path.write_text(json.dumps({
        "classes": list(cfg.signals.modulations_with_noise),
        "cm": np.asarray(cm).tolist(),
    }))
    return path
