"""Device selection shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card. A caller
that wants the plain PyTorch path on the CPU says so with
``device="cpu"``; a missing card is an error, never a silent switch.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["no_tf32", "resolve_device", "sync"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch path"
        )
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Full float32 matrix products and convolutions on the card (no TF32)
    inside the block; both process-wide flags are restored after it."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved
