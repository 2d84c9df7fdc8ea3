"""Device selection shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card. A caller
that wants the plain PyTorch path on the CPU says so with
``device="cpu"``; a missing card is an error, never a silent switch.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "sync"]


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
