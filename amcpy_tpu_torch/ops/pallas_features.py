"""Statistics-only extractor (K2) plus a PyTorch gamma_max epilogue.

Replaces the Pallas kernel ``amcpy_tpu/ops/pallas_features.py::_kernel``
(wrapper ``extract_features_pallas``). The kernel, ``amc_stats_features``
in ``csrc/features.cu``, takes packed planar ``(B, 2, N)`` frames, one
thread block per frame, and writes the 17 statistics with column 0 left
at zero. gamma_max is then filled in by :func:`gmax_fft` or
:func:`gmax_matmul` — plain PyTorch, as the JAX package leaves that
epilogue to XLA outside its kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch statistics. ``extract_features_pallas.launches`` counts launches.
"""

from __future__ import annotations

import torch

from amcpy_tpu_torch.ops.features import NUM_FEATURES, _extract_planar
from amcpy_tpu_torch.ops.fft import gmax_fft, gmax_matmul

__all__ = ["extract_features_pallas"]


def _stats(iq: torch.Tensor, normalize_scale: bool) -> torch.Tensor:
    b, _, n = iq.shape
    if iq.device.type == "cpu":
        return _extract_planar(
            iq[:, 0, :], iq[:, 1, :],
            normalize_scale=normalize_scale, compute_gmax=False,
        )
    if iq.device.type != "cuda":
        raise ValueError(f"unsupported device {iq.device}")
    if iq.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {iq.dtype}")
    if not iq.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous (B, 2, N) tensor")
    from amcpy_tpu_torch.ops import _build

    lib = _build.load("features")
    if n < 2 or not lib.amc_stats_fits(n):
        raise ValueError(
            f"frame size {n} does not fit the statistics kernel's shared memory"
        )
    out = torch.empty((b, NUM_FEATURES), dtype=torch.float32, device=iq.device)
    if b == 0:
        return out
    with torch.cuda.device(iq.device):
        err = lib.amc_stats_features(
            iq.data_ptr(), out.data_ptr(), b, n, int(normalize_scale),
            torch.cuda.current_stream(iq.device).cuda_stream,
        )
    _build.check(lib, err, "amc_stats_features")
    extract_features_pallas.launches += 1
    return out


def extract_features_pallas(
    iq: torch.Tensor,
    *,
    normalize_scale: bool = True,
    compute_gmax: bool = True,
    gmax_mode: str = "fft",
) -> torch.Tensor:
    """All 18 features from packed planar ``(B, 2, N)`` frames; ``(B, 18)``.

    ``gmax_mode`` picks the gamma_max epilogue (``"fft"`` or the four-step
    ``"matmul"``); with ``compute_gmax=False`` column 0 stays zero.
    """
    if iq.ndim != 3 or iq.shape[1] != 2:
        raise ValueError(f"expected (B, 2, N), got {tuple(iq.shape)}")
    feats = _stats(iq, normalize_scale)
    if compute_gmax:
        spectral = gmax_matmul if gmax_mode == "matmul" else gmax_fft
        feats[:, 0] = spectral(iq[:, 0, :], iq[:, 1, :])
    return feats


extract_features_pallas.launches = 0
