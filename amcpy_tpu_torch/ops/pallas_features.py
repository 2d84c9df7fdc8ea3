"""Statistics-only extractor (K2) plus a PyTorch gamma_max epilogue.

Replaces the Pallas kernel ``amcpy_tpu/ops/pallas_features.py::_kernel``
(wrapper ``extract_features_pallas``). The kernel, ``amc_stats_features``
in ``csrc/features.cu``, takes packed planar ``(B, 2, N)`` frames and
writes the 17 statistics with column 0 left at zero. The library routes by
N alone (:func:`stats_path`): frames of 2 <= N <= 2048 to one warpgroup a
frame with the frame in registers, longer ones to one thread block a frame
with the frame in shared memory. gamma_max is then filled in by
:func:`gmax_fft` or :func:`gmax_matmul` — plain PyTorch, as the JAX
package leaves that epilogue to XLA outside its kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch statistics. ``extract_features_pallas.launches`` counts launches,
``extract_features_pallas.launches_by_path`` the same by route.
"""

from __future__ import annotations

import torch

from amcpy_tpu_torch.ops.features import NUM_FEATURES, _extract_planar
from amcpy_tpu_torch.ops.fft import gmax_fft, gmax_matmul

__all__ = ["extract_features_pallas", "stats_path"]


#: the longest frame the warpgroup route holds in registers
WG_MAX_N = 2048
#: ``amc_stats_path``'s codes
_LIB_PATHS = {1: "warpgroup", 0: "block"}


def stats_path(n: int) -> str:
    """The kernel ``amc_stats_features`` routes frames of ``n`` samples to,
    as the library does (``amc_stats_path``): ``"warpgroup"`` for
    2 <= n <= 2048, else ``"block"``. A plain function: it needs no card
    and builds nothing."""
    return "warpgroup" if 2 <= n <= WG_MAX_N else "block"


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
    path = _LIB_PATHS[lib.amc_stats_path(n)]
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
    extract_features_pallas.launches_by_path[path] += 1
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
#: the same launches, by the route the library took (:func:`stats_path`)
extract_features_pallas.launches_by_path = {"warpgroup": 0, "block": 0}
