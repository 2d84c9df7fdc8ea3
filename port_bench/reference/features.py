"""The plain extractor of the 18 features, frozen for the benchmark.

A copy of ``amcpy_tpu_torch/ops/features.py::_extract_planar`` with the
four-step DFT of ``ops/fft.py::gmax_matmul`` for gamma_max (the
configuration's ``gmax_mode``), in plain PyTorch and importing nothing of
the program. It runs in the dtype it is given: float32 for the reference,
bfloat16 for the control (the cumulants are then assembled in float32 from
the bfloat16 moments, since PyTorch holds no bfloat16 complex numbers).
Matrix products run without TF32.

:func:`term_scales` is a copy of ``chip_smoke.py::term_scales`` in float64
on the frames' device: the size of each feature's terms, against which a
feature's error is judged (a cumulant's value may cancel to near zero).
"""

from __future__ import annotations

import math

import torch

__all__ = ["features", "features_of_frames", "term_scales", "best_factorization"]

_PI = math.pi
_TWO_PI = 2.0 * math.pi
NUM_FEATURES = 18


def best_factorization(n: int) -> tuple[int, int] | None:
    """N1 x N2 = n, a small first factor, N2 capped at 512 where possible,
    both factors at least 8 (the program's split, so the DFT's sums run in
    the same shape)."""
    start = max(8, -(-n // 512))
    limit = int(math.isqrt(n))
    for lo in (start, 8):
        for n1 in range(lo, limit + 1):
            if n % n1 == 0 and n // n1 >= 8:
                return n1, n // n1
    return None


def _dft_tables(n1: int, n2: int, device, dtype) -> tuple[torch.Tensor, ...]:
    k1 = torch.arange(n1, dtype=torch.float64)
    k2 = torch.arange(n2, dtype=torch.float64)
    n = n1 * n2
    a1 = -2 * math.pi * torch.outer(k1, k1) / n1
    a2 = -2 * math.pi * torch.outer(k2, k2) / n2
    at = -2 * math.pi * torch.outer(k1, k2) / n
    return tuple(t.to(device=device, dtype=dtype)
                 for t in (a1.cos(), a1.sin(), at.cos(), at.sin(), a2.cos(), a2.sin()))


def gmax(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """max |DFT|^2 / N: the four-step N1 x N2 DFT where N factorizes, else
    ``torch.fft`` (in float32 at least)."""
    n = i.shape[-1]
    fac = best_factorization(n)
    if fac is None or fac[1] > 4096:
        spec = torch.fft.fft(torch.complex(i.float(), q.float()), dim=-1)
        return ((spec.real.square() + spec.imag.square()).amax(-1) / n).to(i.dtype)
    n1, n2 = fac
    w1r, w1i, twr, twi, w2r, w2i = _dft_tables(n1, n2, i.device, i.dtype)
    lead = i.shape[:-1]
    ar, ai = i.reshape(*lead, n1, n2), q.reshape(*lead, n1, n2)
    cr = w1r @ ar - w1i @ ai
    ci = w1r @ ai + w1i @ ar
    cr, ci = cr * twr - ci * twi, cr * twi + ci * twr
    xr = cr @ w2r - ci @ w2i
    xi = cr @ w2i + ci @ w2r
    return (xr.square() + xi.square()).reshape(*lead, n).amax(-1) / n


def _std_ddof1(v):
    n = v.shape[-1]
    m = v.mean(dim=-1, keepdim=True)
    return torch.sqrt(torch.square(v - m).sum(dim=-1) / (n - 1))


def _kurtosis(v):
    c = v - v.mean(dim=-1, keepdim=True)
    c2 = torch.square(c)
    return torch.square(c2).mean(dim=-1) / torch.square(c2.mean(dim=-1))


def _wrapped_phase_diff(phase):
    d = phase[..., 1:] - phase[..., :-1]
    w = torch.remainder(d + _PI, _TWO_PI) - _PI
    return torch.where((w == -_PI) & (d > 0), torch.full_like(w, _PI), w)


def features(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """All 18 features of ``(B, N)`` I and Q planes, computed in their
    dtype; returns float32 ``(B, 18)``."""
    mm = torch.backends.cuda.matmul
    saved, mm.allow_tf32 = mm.allow_tf32, False
    try:
        return _features(i, q)
    finally:
        mm.allow_tf32 = saved


def _features(i, q):
    n = i.shape[-1]
    a_raw = torch.hypot(i, q)
    phase = torch.atan2(q, i)
    mean_a = a_raw.mean(dim=-1)
    cn = a_raw / mean_a[..., None] - 1.0
    freq = _wrapped_phase_diff(phase) / _TWO_PI
    direct = [
        gmax(i, q),
        _std_ddof1(torch.abs(phase)),
        _std_ddof1(phase),
        _std_ddof1(torch.abs(cn)),
        _std_ddof1(freq),
        mean_a,
        torch.sqrt(a_raw.sum(dim=-1)) / n,
        _kurtosis(cn),
        _kurtosis(freq),
    ]
    s = a_raw.amax(dim=-1)
    s = torch.where(s > 0, s, torch.ones_like(s))
    inv_s = (1.0 / s)[..., None]
    iu, qu = i * inv_s, q * inv_s
    a2 = iu * iu + qu * qu
    x2r = iu * iu - qu * qu
    x2i = 2.0 * iu * qu
    x4r = x2r * x2r - x2i * x2i
    x4i = 2.0 * x2r * x2i
    x6r = x4r * x2r - x4i * x2i
    x6i = x4r * x2i + x4i * x2r
    a4 = a2 * a2

    def mean(v):
        return v.mean(dim=-1).float()

    def cplx(re, im):
        return torch.complex(mean(re), mean(im))

    m20, m21, m40 = cplx(x2r, x2i), mean(a2), cplx(x4r, x4i)
    m41, m42 = cplx(x2r * a2, x2i * a2), mean(a4)
    m60, m61 = cplx(x6r, x6i), cplx(x4r * a2, x4i * a2)
    m62, m63 = mean(x2r * a4), mean(a2 * a4)
    m22, m43 = torch.conj(m20), torch.conj(m41)
    m20_sq = m20 * m20
    c20 = torch.abs(m20)
    c21 = torch.abs(m21)
    c40 = torch.abs(m40 - 3.0 * m20 * m20)
    c41 = torch.abs(m41 - 3.0 * m20 * m21)
    c42 = torch.abs(m42 - torch.square(torch.abs(m20)) - 2.0 * torch.square(m21))
    c60 = torch.abs(m60 - 15.0 * m20 * m40 + 3.0 * m20_sq * m20)
    c61 = torch.abs(m61 - 5.0 * m21 * m40 - 10.0 * m20 * m41 + 30.0 * m20_sq * m21)
    c62 = torch.abs(m62 - 6.0 * m20 * m42 - 8.0 * m21 * m41 - m22 * m40
                    + 6.0 * m20_sq * m22 + 24.0 * torch.square(m21) * m20)
    c63 = torch.abs(m63 - 9.0 * m21 * m42 + 12.0 * m21 * torch.square(m21)
                    - 3.0 * m20 * m43 - 3.0 * m22 * m41 + 18.0 * m20 * m21 * m22)
    s = s.float()
    s2 = s * s
    s4 = s2 * s2
    s6 = s4 * s2
    cum = [c20 * s2, c21 * s2, c40 * s4, c41 * s4, c42 * s4,
           c60 * s6, c61 * s6, c62 * s6, c63 * s6]
    return torch.stack([d.float() for d in direct] + cum, dim=-1)


def features_of_frames(frames, device, dtype=torch.float32, block: int = 4096) -> torch.Tensor:
    """Features ``(B, 18)`` float32 on ``device`` of host complex64 frames
    ``(B, N)``, ``block`` frames at a time, computed in ``dtype``."""
    import numpy as np

    frames = np.asarray(frames)
    out = torch.empty((frames.shape[0], NUM_FEATURES), dtype=torch.float32, device=device)
    for lo in range(0, frames.shape[0], block):
        x = torch.view_as_real(torch.from_numpy(np.ascontiguousarray(frames[lo : lo + block])))
        x = x.to(device)
        i, q = x[..., 0].to(dtype), x[..., 1].to(dtype)
        out[lo : lo + x.shape[0]] = features(i.contiguous(), q.contiguous())
    return out


def term_scales(x: torch.Tensor) -> torch.Tensor:
    """Per-frame size of each feature's terms ``(B, 18)``, float64, of
    complex frames ``x`` ``(B, N)``."""
    x = x.to(torch.complex128)
    n = x.shape[-1]
    a = x.abs()
    a2 = a * a
    p2 = a2.mean(-1)
    m20 = (x * x).mean(-1).abs()
    m40 = (x**4).mean(-1)
    m42 = (a2 * a2).mean(-1)
    m63 = (a2**3).mean(-1)
    s = torch.empty((x.shape[0], NUM_FEATURES), dtype=torch.float64, device=x.device)
    s[:, 0] = a2.sum(-1)
    s[:, 1] = s[:, 2] = math.pi
    s[:, 3] = 1.0
    s[:, 4] = 0.5
    s[:, 5] = a.mean(-1).clamp_min(1e-30)
    s[:, 6] = (a.sum(-1).sqrt() / n).clamp_min(1e-30)
    s[:, 7] = s[:, 8] = 10.0
    s[:, 9] = s[:, 10] = p2
    s[:, 11:14] = torch.maximum(torch.maximum(m42, 3 * m20**2), p2**2)[:, None]
    s[:, 14:18] = torch.maximum(torch.maximum(m63, 15 * m20 * m40.abs()), p2**3)[:, None]
    return s
