"""Structured metrics logging and stage timing.

Counterpart of ``amcpy_tpu/utils/metrics.py``: every pipeline stage emits a
JSONL record (wall time, throughput, shapes) to ``metrics/run.jsonl``.
PyTorch launches CUDA work asynchronously, so :func:`stage_timer`
synchronizes the device at both edges when given one; otherwise the wall
time would measure the enqueue, not the work.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator

import torch

from amcpy_tpu_torch.utils.device import sync

__all__ = ["MetricsLogger", "stage_timer", "trace_region"]


class MetricsLogger:
    """Append-only JSONL metrics sink. Safe to construct cheaply anywhere."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields: Any) -> dict[str, Any]:
        rec = {"ts": time.time(), "event": event, **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


@contextlib.contextmanager
def stage_timer(
    logger: MetricsLogger | None,
    event: str,
    *,
    device: torch.device | None = None,
    **fields: Any,
) -> Iterator[dict[str, Any]]:
    """Time a pipeline stage in wall-clock seconds and log it. With a CUDA
    ``device`` the clock starts and stops on a synchronized device. The
    dict yielded can be extended with result fields before the block
    exits."""
    rec: dict[str, Any] = dict(fields)
    if device is not None:
        sync(device)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        if device is not None:
            sync(device)
        rec["wall_s"] = time.perf_counter() - t0
        if logger:
            logger.log(event, **rec)


@contextlib.contextmanager
def trace_region(name: str) -> Iterator[None]:
    """Named profiler region (shows up in ``torch.profiler`` traces)."""
    with torch.profiler.record_function(name):
        yield
