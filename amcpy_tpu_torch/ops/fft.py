"""gamma_max spectral helpers — ``torch.fft`` and a plain four-step DFT.

Counterpart of ``amcpy_tpu/ops/fft.py``. Feature 1 is
``max |FFT(x)|^2 / N``; only the maximum of the spectrum is needed, so any
output permutation works and no reordering is ever done.

``gmax_fft``     — ``torch.fft.fft``.
``gmax_matmul``  — Cooley-Tukey four-step factorization N = N1 x N2 as two
batched DFT products plus a twiddle. It is the plain version of the fused
CUDA kernel's gamma_max (``csrc/features.cu``), which runs the same two
stages on the same host-built tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["gmax_fft", "gmax_matmul", "best_factorization", "device_tables"]


def gmax_fft(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """max |FFT|^2 / N over the last axis via ``torch.fft``."""
    n = i.shape[-1]
    spec = torch.fft.fft(torch.complex(i, q), dim=-1)
    return (spec.real.square() + spec.imag.square()).amax(dim=-1) / n


def best_factorization(
    n: int, multiple_of: int = 1
) -> tuple[int, int] | None:
    """Pick N1 x N2 = n for the two DFT stages.

    A SMALL first factor with a large second factor (N=2048 -> (8, 256)),
    N2 capped at 512 where possible. None when n has no factorization with
    both factors >= 8. ``multiple_of`` additionally requires
    ``n1 % multiple_of == 0``. Copied verbatim from the JAX package so both
    pick the same split.
    """
    start = max(8, -(-n // 512))  # smallest n1 with n2 = n/n1 <= 512
    # unconstrained search keeps n1 <= sqrt(n) (small-first-factor
    # policy); a divisibility constraint may only be satisfiable by an
    # n1 ABOVE sqrt(n) (e.g. n=242, multiple_of=2 -> (22, 11)), so the
    # constrained search extends to every n1 with cofactor >= 8
    limit = n // 8 if multiple_of > 1 else int(np.sqrt(n))
    for lo in (start, 8):  # prefer n2 <= 512; then any with both >= 8
        for n1 in range(lo, limit + 1):
            if (
                n % n1 == 0
                and n // n1 >= 8
                and n1 % multiple_of == 0
            ):
                return (n1, n // n1)
    return None


@lru_cache(maxsize=16)
def _dft_tables(n1: int, n2: int) -> tuple[np.ndarray, ...]:
    """(DFT_N1 re/im, twiddle re/im, DFT_N2 re/im), built in float64 and
    rounded once to float32."""
    n = n1 * n2
    k1 = np.arange(n1)
    w1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)
    k2 = np.arange(n2)
    w2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n)  # W_N^{k1*n2}
    return (
        w1.real.astype(np.float32), w1.imag.astype(np.float32),
        tw.real.astype(np.float32), tw.imag.astype(np.float32),
        w2.real.astype(np.float32), w2.imag.astype(np.float32),
    )


@lru_cache(maxsize=32)
def device_tables(
    n1: int, n2: int, device: torch.device, dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, ...]:
    """:func:`_dft_tables` as contiguous tensors, cached per device and
    dtype (the CUDA kernel reads them from device memory on every launch)."""
    return tuple(
        torch.from_numpy(t).to(device=device, dtype=dtype).contiguous()
        for t in _dft_tables(n1, n2)
    )


def _gmax_matmul_impl(
    i: torch.Tensor, q: torch.Tensor, n1: int, n2: int
) -> torch.Tensor:
    n = n1 * n2
    w1r, w1i, twr, twi, w2r, w2i = device_tables(n1, n2, i.device, i.dtype)
    lead = i.shape[:-1]
    ar = i.reshape(*lead, n1, n2)  # sample n = n1*N2 + n2
    ai = q.reshape(*lead, n1, n2)

    # step 1: length-N1 DFT down the first factor
    cr = w1r @ ar - w1i @ ai
    ci = w1r @ ai + w1i @ ar
    # step 2: twiddle
    cr, ci = cr * twr - ci * twi, cr * twi + ci * twr
    # step 3: length-N2 DFT along the second factor
    xr = cr @ w2r - ci @ w2i
    xi = cr @ w2i + ci @ w2r
    power = xr.square() + xi.square()
    return power.reshape(*lead, n).amax(dim=-1) / n


def gmax_matmul(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """max |DFT|^2 / N via the four-step factorization; the FFT when the
    frame size has no usable factorization."""
    fac = best_factorization(i.shape[-1])
    if fac is None:
        return gmax_fft(i, q)
    return _gmax_matmul_impl(i, q, fac[0], fac[1])
