"""Full-fusion extractor: all 18 features in one CUDA kernel (K1).

Replaces the Pallas kernel ``amcpy_tpu/ops/fused.py::_fused_kernel_entry``
(wrapper ``extract_features_fused``). The kernel, ``amc_fused_features`` in
``csrc/features.cu``, gives one thread block to each frame, reads its
separate I and Q planes once, computes the 17 statistics and gamma_max =
max|DFT|^2 / N. Where N2 of :func:`best_factorization` is a power of two
(every power-of-two N) gamma_max is an FFT in the block (its plan is
:func:`amcpy_tpu_torch.ops.fft.fft_plan`); else the direct two-stage
N1 x N2 DFT. :func:`gmax_path` says which. The tables are built on the host
and cached on the device.

A CUDA tensor launches the kernel or raises. A CPU tensor takes the plain
PyTorch version (:func:`amcpy_tpu_torch.ops.features._extract_planar` with
the four-step DFT), which is what the CPU tests run and what
``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from amcpy_tpu_torch.ops.features import NUM_FEATURES, _extract_planar
from amcpy_tpu_torch.ops.fft import (
    best_factorization,
    device_fft_twiddles,
    device_tables,
)

__all__ = [
    "extract_features_fused",
    "extract_features_fused_any",
    "gmax_path",
    "split_planes",
]


def split_planes(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side complex ``(B, N)`` -> two contiguous float32 ``(B, N)``
    planes — the fused kernel's input layout."""
    frames = np.asarray(frames)
    return (
        np.ascontiguousarray(frames.real, dtype=np.float32),
        np.ascontiguousarray(frames.imag, dtype=np.float32),
    )


def _check_planes(i: torch.Tensor, q: torch.Tensor) -> None:
    if i.ndim != 2 or i.shape != q.shape:
        raise ValueError(
            f"expected two (B, N) planes of one shape, got {tuple(i.shape)} "
            f"and {tuple(q.shape)}"
        )
    if i.device != q.device:
        raise ValueError(f"I on {i.device} but Q on {q.device}")


def extract_features_fused(
    i: torch.Tensor,
    q: torch.Tensor,
    *,
    normalize_scale: bool = True,
) -> torch.Tensor:
    """All 18 features from separate I/Q planes ``(B, N)``; ``(B, 18)``.

    Raises ``ValueError`` when N has no N1 x N2 factorization (callers
    route those shapes to the plain extractor, see
    :func:`extract_features_fused_any`). ``extract_features_fused.launches``
    counts kernel launches.
    """
    _check_planes(i, q)
    b, n = i.shape
    fac = best_factorization(n)
    if fac is None:
        raise ValueError(f"frame size {n} has no N1 x N2 factorization")
    n1, n2 = fac
    if i.device.type == "cpu":
        return _extract_planar(
            i, q, normalize_scale=normalize_scale, compute_gmax=True,
            gmax_mode="matmul",
        )
    if i.device.type != "cuda":
        raise ValueError(f"unsupported device {i.device}")
    if i.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {i.dtype}/{q.dtype}")
    if not (i.is_contiguous() and q.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous planes")
    from amcpy_tpu_torch.ops import _build

    lib = _build.load("features")
    if not lib.amc_fused_fits(n1, n2):
        raise ValueError(
            f"frame size {n} does not fit the fused kernel's shared memory"
        )
    out = torch.empty((b, NUM_FEATURES), dtype=torch.float32, device=i.device)
    if b == 0:
        return out
    # W_N^m for the FFT path, the N2 x N2 table for the direct one, null
    # where the path does not read it; W_N1 and the twiddle always
    fft = lib.amc_fused_gmax_path(n2)
    w1r, w1i, twr, twi, w2r, w2i = device_tables(n1, n2, i.device)
    tw = device_fft_twiddles(n, i.device).data_ptr() if fft else 0
    w2 = (0, 0) if fft else (w2r.data_ptr(), w2i.data_ptr())
    with torch.cuda.device(i.device):
        err = lib.amc_fused_features(
            i.data_ptr(), q.data_ptr(), tw,
            *(t.data_ptr() for t in (w1r, w1i, twr, twi)), *w2,
            out.data_ptr(), b, n, n1, n2, int(normalize_scale),
            torch.cuda.current_stream(i.device).cuda_stream,
        )
    _build.check(lib, err, "amc_fused_features")
    extract_features_fused.launches += 1
    return out


extract_features_fused.launches = 0


def gmax_path(n: int) -> str:
    """How the kernel computes gamma_max for frames of ``n`` samples, as
    its library reports it: ``"fft"`` (the in-block FFT) or ``"direct"``
    (the N2 x N2 table product). Builds the library at first use; raises
    ``ValueError`` when ``n`` has no N1 x N2 factorization."""
    fac = best_factorization(n)
    if fac is None:
        raise ValueError(f"frame size {n} has no N1 x N2 factorization")
    from amcpy_tpu_torch.ops import _build

    return "fft" if _build.load("features").amc_fused_gmax_path(fac[1]) else "direct"


def extract_features_fused_any(
    i: torch.Tensor,
    q: torch.Tensor,
    *,
    normalize_scale: bool = True,
    gmax_mode: str = "matmul",
) -> torch.Tensor:
    """The fused route for any frame size: :func:`extract_features_fused`,
    or the plain extractor when N has no N1 x N2 factorization (the only
    reroute; ``extract_features_fused_any.reroutes`` counts it)."""
    if best_factorization(i.shape[-1]) is None:
        extract_features_fused_any.reroutes += 1
        return _extract_planar(
            i, q, normalize_scale=normalize_scale, compute_gmax=True,
            gmax_mode=gmax_mode,
        )
    return extract_features_fused(i, q, normalize_scale=normalize_scale)


extract_features_fused_any.reroutes = 0
