"""Full-fusion extractor: all 18 features in one CUDA kernel (K1).

Replaces the Pallas kernel ``amcpy_tpu/ops/fused.py::_fused_kernel_entry``
(wrapper ``extract_features_fused``). The kernel, ``amc_fused_features`` in
``csrc/features.cu``, reads each frame's separate I and Q planes once and
computes the 17 statistics and gamma_max = max|DFT|^2 / N. It has two
routes, chosen by N alone (:func:`fused_route`, the library's
``amc_fused_route``):

* ``"block"``: one thread block a frame, wherever an N1 x N2 factorization
  of :func:`best_factorization` fits one block's shared memory (N up to
  ~19,000). Where N2 is a power of two (every power-of-two N) gamma_max is
  an FFT in the block (its plan is :func:`amcpy_tpu_torch.ops.fft.fft_plan`);
  else the direct two-stage N1 x N2 DFT. :func:`gmax_path` says which.
* ``"cluster"``: one thread-block cluster of C blocks of 1024 threads a
  frame, for longer frames of N = C x M, 2 <= C <= 8 (the smallest that
  serves), M a power of two in [2048, 16384]; block r holds samples
  r M .. r M + M - 1 and the blocks read and write each other's shared
  memory. :func:`cluster_shape` gives the launch.

Frames that neither route holds (``"none"``: no factorization, or too long
and not of that form) make :func:`extract_features_fused` raise;
:func:`extract_features_fused_any` sends them, by shape and before any
launch, to the plain extractor, as the JAX package's fused route takes its
XLA extractor where Mosaic does not compile its kernel. The tables are
built on the host and cached on the device.

A CUDA tensor launches the kernel or raises. A CPU tensor takes the plain
PyTorch version (:func:`amcpy_tpu_torch.ops.features._extract_planar` with
the four-step DFT), which is what the CPU tests run and what
``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from amcpy_tpu_torch.ops.features import NUM_FEATURES, _extract_planar
from amcpy_tpu_torch.ops.fft import (
    _is_pow2,
    best_factorization,
    device_fft_twiddles,
    device_tables,
)

__all__ = [
    "cluster_occupancy",
    "cluster_shape",
    "extract_features_fused",
    "extract_features_fused_any",
    "fused_route",
    "gmax_path",
    "library_cluster_shape",
    "library_route",
    "split_planes",
]

#: bytes of shared memory a block may use on an H100 (``kSmemLimit``)
SMEM_LIMIT = 232448
#: floats of the block route's reduction scratch (``kRedFloats``) and of the
#: direct path's table tiles (``2 * kKB * kTileCols``)
_RED_FLOATS = 2 * 8 * 19
_DIRECT_FLOATS = 2 * 32 * 128
#: the cluster route: C in [2, CLUSTER_MAX], slices of M in [SLICE_MIN, SLICE_MAX]
CLUSTER_MAX = 8
SLICE_MIN, SLICE_MAX = 2048, 16384
#: threads of a cluster route block (``kClusterThreads``)
CLUSTER_THREADS = 1024
#: ``amc_fused_route``'s codes
_LIB_ROUTES = {1: "block", 2: "cluster", 0: "none"}


def split_planes(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side complex ``(B, N)`` -> two contiguous float32 ``(B, N)``
    planes — the fused kernel's input layout."""
    frames = np.asarray(frames)
    return (
        np.ascontiguousarray(frames.real, dtype=np.float32),
        np.ascontiguousarray(frames.imag, dtype=np.float32),
    )


def _block_fits(n1: int, n2: int) -> bool:
    """The library's ``block_fits``: the frame, its phase and the block
    route's scratch within one block's shared memory."""
    n = n1 * n2
    floats = 2 * ((n + 31) & ~31) + n + _RED_FLOATS
    if not _is_pow2(n2):
        floats += _DIRECT_FLOATS
    return 4 * floats <= SMEM_LIMIT


def fused_route(n: int) -> tuple[str, int]:
    """The route ``amc_fused_features`` takes for frames of ``n`` samples,
    and its cluster size C, as the library rules (``amc_fused_route``):
    ``("block", 1)`` where :func:`best_factorization` gives a split that
    fits one block; else ``("cluster", C)`` for the smallest 2 <= C <= 8
    with N / C a power of two in [2048, 16384]; else ``("none", 0)``. A
    plain function: it needs no card and builds nothing."""
    fac = best_factorization(n)
    if fac is not None and _block_fits(*fac):
        return "block", 1
    for c in range(2, CLUSTER_MAX + 1):
        m, rest = divmod(n, c)
        if rest == 0 and _is_pow2(m) and SLICE_MIN <= m <= SLICE_MAX:
            return "cluster", c
    return "none", 0


def cluster_shape(n: int) -> tuple[int, int, int]:
    """The cluster route's launch for frames of ``n`` samples, as the
    library sets it (``amc_fused_cluster_shape``): (C, M, threads a block);
    ``(0, 0, 0)`` where :func:`fused_route` does not take the cluster route.
    A plain function: it builds nothing."""
    route, c = fused_route(n)
    if route != "cluster":
        return 0, 0, 0
    return c, n // c, CLUSTER_THREADS


def library_cluster_shape(n: int) -> tuple[int, int, int, int]:
    """``amc_fused_cluster_shape`` of the built library: :func:`cluster_shape`
    and the bytes of dynamic shared memory a block (0 off the route; builds
    the library at first use)."""
    from amcpy_tpu_torch.ops import _build

    threads, smem = ctypes.c_int(-1), ctypes.c_int(-1)
    c = _build.load("features").amc_fused_cluster_shape(
        n, ctypes.byref(threads), ctypes.byref(smem))
    return c, n // c if c else 0, threads.value, smem.value


def library_route(n: int) -> tuple[str, int]:
    """``amc_fused_route`` of the built library (builds it at first use)."""
    from amcpy_tpu_torch.ops import _build

    c = ctypes.c_int(-1)
    code = _build.load("features").amc_fused_route(n, ctypes.byref(c))
    return _LIB_ROUTES[code], c.value


@lru_cache(maxsize=None)
def cluster_occupancy(n: int, device_index: int) -> tuple[int, int]:
    """The cluster route at ``n`` samples a frame on card ``device_index``:
    the clusters it holds at once (``cudaOccupancyMaxActiveClusters``) and
    the blocks one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from amcpy_tpu_torch.ops import _build

    lib = _build.load("features")
    blocks = ctypes.c_int(-1)
    with torch.cuda.device(device_index):
        clusters = lib.amc_fused_cluster_occupancy(n, ctypes.byref(blocks))
    if clusters < 0:
        _build.check(lib, -clusters, "amc_fused_cluster_occupancy")
    return clusters, blocks.value


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

    Raises ``ValueError`` when N fits neither route (:func:`fused_route`;
    callers route those shapes to the plain extractor, see
    :func:`extract_features_fused_any`). ``extract_features_fused.launches``
    counts kernel launches, ``launches_by_route`` the same by route.
    """
    _check_planes(i, q)
    b, n = i.shape
    fac = best_factorization(n)
    if fac is None:
        raise ValueError(f"frame size {n} has no N1 x N2 factorization")
    route, c = fused_route(n)
    if route == "none":
        raise ValueError(
            f"frame size {n} fits neither route of the fused kernel: not one "
            f"block's shared memory, and not C x M with 2 <= C <= {CLUSTER_MAX} "
            f"and M a power of two in [{SLICE_MIN}, {SLICE_MAX}]"
        )
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
    if route == "cluster" and cluster_occupancy(n, i.device.index or 0)[0] == 0:
        raise RuntimeError(
            f"the card cannot hold one cluster of {c} blocks of the fused "
            f"kernel at frame size {n}"
        )
    out = torch.empty((b, NUM_FEATURES), dtype=torch.float32, device=i.device)
    if b == 0:
        return out
    # block route: W_N^m for the FFT path, the N2 x N2 table for the direct
    # one, W_N1 and the twiddle always; cluster route: W_N^m and W_M^m of
    # its slices of M = N / C. Null where the route does not read a table.
    tw = tws = 0
    w1 = (0, 0, 0, 0)
    w2 = (0, 0)
    if route == "cluster":
        tw = device_fft_twiddles(n, i.device).data_ptr()
        tws = device_fft_twiddles(n // c, i.device).data_ptr()
    else:
        fft = lib.amc_fused_gmax_path(n2)
        w1r, w1i, twr, twi, w2r, w2i = device_tables(n1, n2, i.device)
        w1 = tuple(t.data_ptr() for t in (w1r, w1i, twr, twi))
        if fft:
            tw = device_fft_twiddles(n, i.device).data_ptr()
        else:
            w2 = (w2r.data_ptr(), w2i.data_ptr())
    with torch.cuda.device(i.device):
        err = lib.amc_fused_features(
            i.data_ptr(), q.data_ptr(), tw, tws, *w1, *w2,
            out.data_ptr(), b, n, n1, n2, int(normalize_scale),
            torch.cuda.current_stream(i.device).cuda_stream,
        )
    _build.check(lib, err, "amc_fused_features")
    extract_features_fused.launches += 1
    extract_features_fused.launches_by_route[route] += 1
    return out


extract_features_fused.launches = 0
#: the same launches, by the route the library took (:func:`fused_route`)
extract_features_fused.launches_by_route = {"block": 0, "cluster": 0}


def gmax_path(n: int) -> str:
    """How the kernel computes gamma_max for frames of ``n`` samples on the
    block route, as its library reports it: ``"fft"`` (the in-block FFT) or
    ``"direct"`` (the N2 x N2 table product). Builds the library at first
    use; raises ``ValueError`` when ``n`` has no N1 x N2 factorization."""
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
    or the plain extractor where N fits neither of its routes
    (:func:`fused_route`), decided by shape before any launch (the only
    reroute; ``extract_features_fused_any.reroutes`` counts it)."""
    if fused_route(i.shape[-1])[0] == "none":
        extract_features_fused_any.reroutes += 1
        return _extract_planar(
            i, q, normalize_scale=normalize_scale, compute_gmax=True,
            gmax_mode=gmax_mode,
        )
    return extract_features_fused(i, q, normalize_scale=normalize_scale)


extract_features_fused_any.reroutes = 0
