"""Serving: raw IQ -> modulation label, extract -> standardize -> classify.

Counterpart of ``amcpy_tpu/serve.py`` (``AMCPipeline``) for the feature
MLP on one device:

    pipe = AMCPipeline.from_checkpoint(cfg, model_id)   # device=None: CUDA
    labels = pipe.predict(frames)            # (B, N) complex or (B, 2, N)
    probs = pipe.predict_proba(frames)
    pipe.classify_stream("capture.bin")      # GNU Radio complex64 capture

A request is copied to the device once; the features, the standardized
vector and the logits never leave it. The extractor is the one
:func:`amcpy_tpu_torch.extraction.resolve_kernel` picks, so serving and
extraction route alike. The exact batch is dispatched: eager PyTorch has
no retrace to bound, so the JAX package's power-of-two buckets are not
needed (they return with CUDA-graph capture). The MLP runs in full float32,
as the JAX MLP does: ``torch.backends.cuda.matmul.allow_tf32`` is held at
False for the MLP's call only and restored after it.

Not ported here: the raw-IQ CNN family, multi-device fan-out and the int24
wire program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.extraction import _kernel_fn, resolve_kernel, resolve_wire_format
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.utils.device import resolve_device

__all__ = ["AMCPipeline"]


class AMCPipeline:
    """Extract + standardize + classify inference pipeline."""

    def __init__(
        self,
        model: AMCClassifier,
        scaler: Standardizer,
        cfg: Config,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scaler = scaler
        self.cfg = cfg
        self._cols = torch.as_tensor(
            list(cfg.features.used_columns), device=self.device
        )
        self._mean = torch.as_tensor(
            scaler.mean, dtype=torch.float32, device=self.device
        )
        self._std = torch.as_tensor(
            scaler.std, dtype=torch.float32, device=self.device
        )
        self._kernel = resolve_kernel(cfg.compute.kernel, self.device)
        self._extract, self._wants_planes = _kernel_fn(
            self._kernel, cfg.compute.normalize_scale, cfg.compute.gmax_mode,
            self.device,
        )
        resolve_wire_format(cfg.compute.wire_format)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: Config,
        model_id: str | None = None,
        device: "str | torch.device | None" = None,
    ) -> "AMCPipeline":
        from amcpy_tpu_torch.train.checkpoint import (
            load_checkpoint,
            resolve_model_id,
        )

        model, scaler, _ = load_checkpoint(cfg, resolve_model_id(cfg, model_id))
        return cls(model, scaler, cfg, device=device)

    # ------------------------------------------------------------------

    def _to_device(self, frames: np.ndarray) -> tuple[torch.Tensor, ...]:
        """Host ``(B, N)`` complex or ``(B, 2, N)`` planar -> the extractor's
        input on the device: two contiguous ``(B, N)`` planes for the fused
        route, one packed ``(B, 2, N)`` tensor for the others."""
        frames = np.asarray(frames)
        if np.iscomplexobj(frames):
            if frames.ndim != 2:
                raise ValueError(
                    f"expected (B, N) complex frames, got {frames.shape}"
                )
            i, q = frames.real, frames.imag
        elif frames.ndim == 3 and frames.shape[1] == 2:
            i, q = frames[:, 0, :], frames[:, 1, :]
        else:
            raise ValueError(
                f"expected (B, N) complex or (B, 2, N) planar, got {frames.shape}"
            )
        planes = (i, q) if self._wants_planes else (np.stack([i, q], axis=1),)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32)).to(
                self.device
            )
            for p in planes
        )

    @torch.inference_mode()
    def logits(self, frames: np.ndarray) -> torch.Tensor:
        """Logits ``(B, n_classes)`` on the pipeline's device."""
        feats = self._extract(*self._to_device(frames))
        x = (feats[:, self._cols] - self._mean) / self._std
        return self._classify(x)

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP on standardized features, in full float32 (no TF32)."""
        flags = torch.backends.cuda.matmul
        allow_tf32 = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return self.model(x)
        finally:
            flags.allow_tf32 = allow_tf32

    def predict(self, frames: np.ndarray) -> np.ndarray:
        """Predicted class ids, one per frame."""
        return self.logits(frames).argmax(dim=-1).cpu().numpy()

    def predict_proba(self, frames: np.ndarray) -> np.ndarray:
        return torch.softmax(self.logits(frames), dim=-1).cpu().numpy()

    def predict_names(self, frames: np.ndarray) -> list[str]:
        mods = self.cfg.signals.modulations_with_noise
        return [mods[k] for k in self.predict(frames)]

    # ------------------------------------------------------------------

    def classify_stream(
        self,
        path: str | Path,
        *,
        frame_size: int | None = None,
        skip: int = 2400,
        batch_size: int = 4096,
    ) -> np.ndarray:
        """Classify a GNU Radio complex64 capture file; returns class ids
        per frame.

        Frames are read and classified in ``batch_size`` chunks, so only one
        chunk is resident on the host; chunk k+1 is read while chunk k's
        work runs on the device.
        """
        from amcpy_tpu_torch.data.native_io import read_stream_frames

        frame_size = frame_size or self.cfg.signals.frame_size
        total = max((Path(path).stat().st_size // 8 - skip) // frame_size, 0)
        out = np.empty(total, dtype=np.int64)
        pending: tuple[int, torch.Tensor] | None = None
        for start in range(0, total, batch_size):
            count = min(batch_size, total - start)
            chunk = read_stream_frames(
                path, frame_size,
                skip=skip + start * frame_size, max_frames=count,
            )
            pred = self.logits(chunk).argmax(dim=-1)
            if pending is not None:
                p_start, p_pred = pending
                out[p_start : p_start + len(p_pred)] = p_pred.cpu().numpy()
            pending = (start, pred)
        if pending is not None:
            p_start, p_pred = pending
            out[p_start : p_start + len(p_pred)] = p_pred.cpu().numpy()
        return out
