"""Plain PyTorch extractor of the 18 AMC features — the numerics spec of the
port and the plain version of both CUDA kernels (``csrc/features.cu``).

Counterpart of ``amcpy_tpu/ops/features.py`` with the same formulas in the
same order:

====  =================  ==========================================================
 id    name               definition
====  =================  ==========================================================
 1     gamma_max          max |FFT(x)|^2 / N
 2     sigma_ap           std(|angle(x)|), ddof=1
 3     sigma_dp           std(angle(x)), ddof=1
 4     sigma_aa           std(| |x|/mean|x| - 1 |), ddof=1
 5     sigma_af           std(inst_freq), ddof=1;  inst_freq = diff(unwrap(angle))/2pi
 6     X                  mean |x|
 7     X_2                sqrt(sum |x|) / N
 8     mu42_a             Pearson kurtosis (biased, fisher=False) of CN amplitude
 9     mu42_f             Pearson kurtosis of inst_freq
10-18  C20..C63           abs of higher-order cumulant combinations of the mixed
                          moments m_pq = E[x^(p-q) conj(x)^q]
====  =================  ==========================================================

It runs on any device in float32 or float64. The CUDA wrappers take it for
tensors that lie on the CPU; ``chip_smoke.py`` holds the kernels against it
on the card.

Numerics that must hold in every version (plain and CUDA):

* the wrapped phase difference is a floor-mod (``torch.remainder``, like
  ``jnp.mod``), not a truncating ``fmod``: ``d + pi`` is often negative;
* the phase follows ``torch.atan2``/``np.angle`` on signed zero
  (``atan2(-0.0, -1) = -pi``);
* frames are divided by ``s = max|x|`` before the moment sums and the
  cumulants are rescaled by s^2/s^4/s^6, so x^6 terms stay inside float32
  under a per-frame scale spread of exp(+-6); ``|x/s|^2`` is formed from
  the scaled samples (``|x|^2 / s^2`` would overflow ``1/s^2`` below
  s ~ 5.4e-20); gamma_max uses the raw frame;
* the amplitude rescales samples whose squares fall below float32's normal
  range (``torch.hypot`` here, a scale by 2^100 in the kernels), so frames
  of peak |x| down to a subnormal 1e-38 keep every column within the
  float64 oracle's budget, or within float32's subnormal step where the
  oracle's value lies below float32's range.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from amcpy_tpu_torch.ops.fft import gmax_fft, gmax_matmul

__all__ = [
    "extract_features",
    "extract_features_planar",
    "extract_features_planar_scan",
    "to_planar",
    "NUM_FEATURES",
    "SCALE_DEGREES",
]

NUM_FEATURES = 18

#: Homogeneity degree of each feature in the input scale: f(s*x) = s^d f(x).
#: Order: features 1..18. Non-integer: X_2 (feature 7) scales as sqrt(s).
SCALE_DEGREES = np.array(
    [2, 0, 0, 0, 0, 1, 0.5, 0, 0, 2, 2, 4, 4, 4, 6, 6, 6, 6], dtype=np.float64
)

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def _std_ddof1(v: torch.Tensor) -> torch.Tensor:
    """Sample standard deviation (ddof=1) over the last axis."""
    n = v.shape[-1]
    m = v.mean(dim=-1, keepdim=True)
    return torch.sqrt(torch.square(v - m).sum(dim=-1) / (n - 1))


def _kurtosis(v: torch.Tensor) -> torch.Tensor:
    """Pearson kurtosis m4/m2^2 with biased central moments
    (``scipy.stats.kurtosis(v, fisher=False)``)."""
    c = v - v.mean(dim=-1, keepdim=True)
    c2 = torch.square(c)
    m2 = c2.mean(dim=-1)
    m4 = torch.square(c2).mean(dim=-1)
    return m4 / torch.square(m2)


def _wrapped_phase_diff(phase: torch.Tensor) -> torch.Tensor:
    """Principal-value first difference of the phase, in (-pi, pi].

    Equal to ``np.diff(np.unwrap(phase))`` including NumPy's edge rule: a
    difference of exactly -pi with a positive raw diff maps to +pi.
    ``torch.remainder`` is the floor-mod of ``jnp.mod``; ``torch.fmod``
    would truncate and give a wrong result for negative ``d + pi``.
    """
    d = phase[..., 1:] - phase[..., :-1]
    w = torch.remainder(d + _PI, _TWO_PI) - _PI
    return torch.where((w == -_PI) & (d > 0), torch.full_like(w, _PI), w)


def to_planar(frames: np.ndarray) -> np.ndarray:
    """Host-side complex ``(..., N)`` -> planar ``(..., 2, N)`` float."""
    frames = np.asarray(frames)
    return np.stack([frames.real, frames.imag], axis=-2).astype(
        np.float64 if frames.dtype == np.complex128 else np.float32
    )


def _extract_planar(
    i: torch.Tensor,
    q: torch.Tensor,
    *,
    normalize_scale: bool,
    compute_gmax: bool,
    gmax_mode: str = "fft",
) -> torch.Tensor:
    """Core extractor on planar I/Q ``(..., N)`` float tensors."""
    n = i.shape[-1]

    # ---- instantaneous streams (scale-invariant features) ----------------
    # hypot, not sqrt(i^2 + q^2): on the CPU torch.sqrt hands chunks of
    # 2048 samples to MKL's VML on several threads, and the first such call
    # in a busy process has returned one chunk with ~1e-4 relative error;
    # hypot is PyTorch's own vectorized code (within an ulp of sqrt), and
    # it rescales, so samples whose squares fall below float32's normal
    # range keep their bits
    a_raw = torch.hypot(i, q)
    phase = torch.atan2(q, i)
    abs_phase = torch.abs(phase)

    mean_a = a_raw.mean(dim=-1)
    cn = a_raw / mean_a[..., None] - 1.0
    freq = _wrapped_phase_diff(phase) / _TWO_PI

    f2 = _std_ddof1(abs_phase)
    f3 = _std_ddof1(phase)
    f4 = _std_ddof1(torch.abs(cn))
    f5 = _std_ddof1(freq)
    f6 = mean_a
    f7 = torch.sqrt(a_raw.sum(dim=-1)) / n
    f8 = _kurtosis(cn)
    f9 = _kurtosis(freq)

    # ---- scale normalization for the polynomial features -----------------
    if normalize_scale:
        s = a_raw.amax(dim=-1)
        s = torch.where(s > 0, s, torch.ones_like(s))
        inv_s = (1.0 / s)[..., None]
        iu = i * inv_s
        qu = q * inv_s
    else:
        s = None
        iu, qu = i, q
    # |x/s|^2 from the scaled samples: |x|^2 (1/s)^2 would form 1/s^2, which
    # overflows float32 once s < ~5.4e-20
    a2 = iu * iu + qu * qu

    # ---- mixed moments, planar complex arithmetic ------------------------
    x2r = iu * iu - qu * qu
    x2i = 2.0 * iu * qu
    x4r = x2r * x2r - x2i * x2i
    x4i = 2.0 * x2r * x2i
    x6r = x4r * x2r - x4i * x2i
    x6i = x4r * x2i + x4i * x2r
    a4 = a2 * a2

    def mean(v):
        return v.mean(dim=-1)

    moments = {
        "m20": torch.complex(mean(x2r), mean(x2i)),
        "m21": mean(a2),
        "m40": torch.complex(mean(x4r), mean(x4i)),
        "m41": torch.complex(mean(x2r * a2), mean(x2i * a2)),
        "m42": mean(a4),
        "m60": torch.complex(mean(x6r), mean(x6i)),
        "m61": torch.complex(mean(x4r * a2), mean(x4i * a2)),
        "m62": mean(x2r * a4),
        "m63": mean(a2 * a4),
    }

    # gamma_max on the RAW i/q: the DFT is linear, so normalizing buys
    # nothing (max|FFT(x/s)|^2 * s^2 == max|FFT(x)|^2)
    if compute_gmax:
        f1 = gmax_matmul(i, q) if gmax_mode == "matmul" else gmax_fft(i, q)
    else:
        f1 = torch.zeros_like(mean_a)

    return _assemble_features(
        (f1, f2, f3, f4, f5, f6, f7, f8, f9), moments, s
    ).to(i.dtype)


def _assemble_features(direct, moments, scale) -> torch.Tensor:
    """Cumulants from moments + exact un-normalization + stacking.

    ``direct`` are features 1-9, already in raw scale; ``moments`` are the
    mixed moments of the (possibly normalized) signal; ``scale`` is the
    per-frame normalization factor or None.
    """
    f1, f2, f3, f4, f5, f6, f7, f8, f9 = direct
    m20, m21, m40 = moments["m20"], moments["m21"], moments["m40"]
    m41, m42, m60 = moments["m41"], moments["m42"], moments["m60"]
    m61, m62, m63 = moments["m61"], moments["m62"], moments["m63"]
    m22 = torch.conj(m20)
    m43 = torch.conj(m41)

    c20 = torch.abs(m20)
    c21 = torch.abs(m21)
    c40 = torch.abs(m40 - 3.0 * m20 * m20)
    c41 = torch.abs(m41 - 3.0 * m20 * m21)
    c42 = torch.abs(m42 - torch.square(torch.abs(m20)) - 2.0 * torch.square(m21))
    m20_sq = m20 * m20
    c60 = torch.abs(m60 - 15.0 * m20 * m40 + 3.0 * m20_sq * m20)
    c61 = torch.abs(
        m61 - 5.0 * m21 * m40 - 10.0 * m20 * m41 + 30.0 * m20_sq * m21
    )
    c62 = torch.abs(
        m62
        - 6.0 * m20 * m42
        - 8.0 * m21 * m41
        - m22 * m40
        + 6.0 * m20_sq * m22
        + 24.0 * torch.square(m21) * m20
    )
    c63 = torch.abs(
        m63
        - 9.0 * m21 * m42
        + 12.0 * m21 * torch.square(m21)
        - 3.0 * m20 * m43
        - 3.0 * m22 * m41
        + 18.0 * m20 * m21 * m22
    )

    if scale is not None:
        s2 = scale * scale
        s4 = s2 * s2
        s6 = s4 * s2
        c20, c21 = c20 * s2, c21 * s2
        c40, c41, c42 = c40 * s4, c41 * s4, c42 * s4
        c60, c61, c62, c63 = c60 * s6, c61 * s6, c62 * s6, c63 * s6

    return torch.stack(
        [
            f1, f2, f3, f4, f5, f6, f7, f8, f9,
            c20, c21, c40, c41, c42, c60, c61, c62, c63,
        ],
        dim=-1,
    )


def extract_features_planar(
    iq: torch.Tensor,
    *,
    normalize_scale: bool = True,
    compute_gmax: bool = True,
    gmax_mode: str = "fft",
) -> torch.Tensor:
    """All 18 features from planar I/Q input ``(..., 2, N)`` float.

    Returns ``(..., 18)`` in the input dtype, feature id ``j+1`` at column
    ``j``.
    """
    if iq.shape[-2] != 2:
        raise ValueError(f"expected (..., 2, N) planar input, got {tuple(iq.shape)}")
    return _extract_planar(
        iq[..., 0, :],
        iq[..., 1, :],
        normalize_scale=normalize_scale,
        compute_gmax=compute_gmax,
        gmax_mode=gmax_mode,
    )


def extract_features_planar_scan(
    iq: torch.Tensor,
    *,
    chunk: int = 4096,
    normalize_scale: bool = True,
    compute_gmax: bool = True,
    gmax_mode: str = "matmul",
) -> torch.Tensor:
    """Large-batch extractor with bounded live memory: a loop over chunks
    of ``(B, 2, N)`` (the JAX package's ``lax.scan``)."""
    if iq.ndim != 3 or iq.shape[-2] != 2:
        raise ValueError(f"expected (B, 2, N) planar input, got {tuple(iq.shape)}")
    if iq.shape[0] == 0:
        return iq.new_empty((0, NUM_FEATURES))
    return torch.cat([
        extract_features_planar(
            iq[start : start + chunk],
            normalize_scale=normalize_scale,
            compute_gmax=compute_gmax,
            gmax_mode=gmax_mode,
        )
        for start in range(0, iq.shape[0], chunk)
    ])


def extract_features(
    frames: "np.ndarray | torch.Tensor",
    *,
    normalize_scale: bool = True,
    compute_gmax: bool = True,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """All 18 features from complex frames ``(..., N)``.

    A NumPy array is planarized on the host and moved to ``device``
    (``None`` = the CUDA card); a complex tensor stays where it lies.
    """
    if isinstance(frames, np.ndarray):
        from amcpy_tpu_torch.utils.device import resolve_device

        iq = torch.from_numpy(to_planar(frames)).to(resolve_device(device))
    else:
        if not frames.is_complex():
            raise TypeError(f"frames must be complex, got {frames.dtype}")
        iq = torch.stack([frames.real, frames.imag], dim=-2)
    return extract_features_planar(
        iq, normalize_scale=normalize_scale, compute_gmax=compute_gmax
    )
