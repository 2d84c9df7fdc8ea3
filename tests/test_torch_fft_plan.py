"""The fused kernel's FFT plan for gamma_max (``amcpy_tpu_torch/ops/fft.py``
``fft_plan`` and ``fft_twiddles``), rendered in plain torch step by step as
``csrc/features.cu`` runs it, on the CPU.

The rendering follows the kernel's index arithmetic: a radix-R pass over
sub-transforms of length L reads x[base + m*s] (s = L/R, base = block*L +
j), takes the R-point DFT with the kernel's butterflies, multiplies output
k by the table entry j*k*(N/L) and writes it to x[base + k*s]; the last
pass keeps only max|X|^2. It is held against ``torch.fft.fft`` and the JAX
package's ``gmax_matmul`` on the same numpy-seeded frames. Tolerance: the
float32 error of a DFT output is bounded by the Parseval scale sum|x|^2,
``1e-5 * sum|x|^2`` (as ``test_torch_features.py::test_gmax_matmul_matches_fft``).
"""

import math

import numpy as np
import pytest
import torch

from amcpy_tpu.ops import fft as jax_fft
from amcpy_tpu_torch.ops import fft as port_fft

SQRT_HALF = np.float32(math.sqrt(0.5))


def _dft2(r0, i0, r1, i1):
    return r0 + r1, i0 + i1, r0 - r1, i0 - i1


def _dft4(x):
    """x: list of 4 (re, im) pairs -> natural-order outputs (dft4 in the
    kernel)."""
    (r0, i0), (r1, i1), (r2, i2), (r3, i3) = x
    a0r, a0i, a1r, a1i = _dft2(r0, i0, r2, i2)
    b0r, b0i, b1r, b1i = _dft2(r1, i1, r3, i3)
    return [(a0r + b0r, a0i + b0i), (a1r + b1i, a1i - b1r),
            (a0r - b0r, a0i - b0i), (a1r - b1i, a1i + b1r)]


def _dft(x):
    """The kernel's in-register R-point DFT, R in {2, 4, 8}."""
    if len(x) == 2:
        r0, i0, r1, i1 = _dft2(*x[0], *x[1])
        return [(r0, i0), (r1, i1)]
    if len(x) == 4:
        return _dft4(x)
    e = _dft4(x[0::2])
    o = _dft4(x[1::2])
    (o1r, o1i), (o2r, o2i), (o3r, o3i) = o[1], o[2], o[3]
    o = [o[0],
         (SQRT_HALF * (o1r + o1i), SQRT_HALF * (o1i - o1r)),
         (o2i, -o2r),
         (SQRT_HALF * (o3i - o3r), -SQRT_HALF * (o3i + o3r))]
    return ([(er + orr, ei + oi) for (er, ei), (orr, oi) in zip(e, o)]
            + [(er - orr, ei - oi) for (er, ei), (orr, oi) in zip(e, o)])


def render_gmax(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """max|DFT|^2 / N of float32 (B, N) planes by the kernel's FFT plan."""
    b, n = i.shape
    n1, n2 = port_fft.best_factorization(n)
    direct, radices = port_fft.fft_plan(n1, n2)
    xr, xi = i.clone(), q.clone()
    length = n
    if direct:  # N1-point stage with the W_N1 and twiddle tables
        w1r, w1i, twr, twi, _, _ = port_fft.device_tables(n1, n2, i.device)
        ar, ai = xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)
        cr, ci = w1r @ ar - w1i @ ai, w1r @ ai + w1i @ ar
        xr = (cr * twr - ci * twi).reshape(b, n)
        xi = (cr * twi + ci * twr).reshape(b, n)
        length = n2
    tw = torch.from_numpy(port_fft.fft_twiddles(n))
    for r in radices:
        s = length // r
        # x[blk*L + m*s + j] -> [b, blk, m, j]
        vr = xr.reshape(b, n // length, r, s)
        vi = xi.reshape(b, n // length, r, s)
        y = _dft([(vr[:, :, m], vi[:, :, m]) for m in range(r)])
        if length == r:  # the last pass: only the largest |X|^2
            power = torch.stack([yr * yr + yi * yi for yr, yi in y], dim=-1)
            return power.reshape(b, n).amax(dim=-1) / n
        idx = (torch.arange(s)[None, :] * torch.arange(r)[:, None]) * (n // length)
        wr, wi = tw[idx, 0], tw[idx, 1]  # (r, s): W_L^{jk}
        xr = torch.stack([yr * wr[k] - yi * wi[k] for k, (yr, yi) in enumerate(y)], 2)
        xi = torch.stack([yr * wi[k] + yi * wr[k] for k, (yr, yi) in enumerate(y)], 2)
        xr, xi = xr.reshape(b, n), xi.reshape(b, n)
        length = s
    raise AssertionError("the plan has no last pass")


POW2_SIZES = [2**k for k in range(6, 15)]  # 64 ... 16384


def _frames(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return x.astype(np.complex64)


def _planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real)),
            torch.from_numpy(np.ascontiguousarray(x.imag)))


def _tol(x):
    return 1e-5 * (np.abs(x.astype(np.complex128)) ** 2).sum(-1)


@pytest.mark.parametrize("n", POW2_SIZES + [12288, 4608])
def test_plan_covers_the_frame(n):
    """Every power-of-two N takes the FFT, its passes over the whole
    frame; 12288 = 24 x 512 and 4608 = 9 x 512 take the direct N1 stage
    first. The radices multiply out to the transform length."""
    n1, n2 = port_fft.best_factorization(n)
    direct, radices = port_fft.fft_plan(n1, n2)
    assert direct == (n & (n - 1) != 0)
    assert math.prod(radices) == (n2 if direct else n)
    assert all(r == 8 for r in radices[:-1]) and radices[-1] in (2, 4, 8)


@pytest.mark.parametrize("n", [1000, 88, 3000])
def test_plan_is_none_where_n2_is_not_a_power_of_two(n):
    assert port_fft.fft_plan(*port_fft.best_factorization(n)) is None


def test_twiddles_are_rounded_once_from_float64():
    n = 2048
    tw = port_fft.fft_twiddles(n)
    assert tw.shape == (n, 2) and tw.dtype == np.float32
    want = np.exp(-2j * np.pi * np.arange(n) / n)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))
    assert tuple(tw[0]) == (1.0, 0.0)


@pytest.mark.parametrize("n", POW2_SIZES + [12288])
def test_rendering_matches_torch_fft(n):
    x = _frames(3 if n > 4096 else 6, n, seed=n)
    got = render_gmax(*_planes(x)).numpy()
    spec = np.fft.fft(x.astype(np.complex128), axis=-1)
    want = (np.abs(spec) ** 2).max(-1) / n
    np.testing.assert_array_less(np.abs(got - want) * n, _tol(x))
    want32 = port_fft.gmax_fft(*_planes(x)).numpy()
    np.testing.assert_array_less(np.abs(got - want32) * n, _tol(x))


@pytest.mark.parametrize("n", POW2_SIZES + [12288])
def test_rendering_matches_jax_gmax_matmul(n):
    x = _frames(2 if n > 4096 else 5, n, seed=n + 1)
    i, q = (p.numpy() for p in _planes(x))
    want = np.asarray(jax_fft.gmax_matmul(i, q))
    got = render_gmax(*_planes(x)).numpy()
    np.testing.assert_array_less(np.abs(got - want) * n, _tol(x))


def test_rendering_finds_a_single_tone_at_any_bin():
    """A pure tone puts all its power in one bin, wherever the plan's
    digit-reversed order leaves it: max|X|^2 / N = N for unit amplitude."""
    n = 2048
    bins = np.array([0, 1, 7, 255, 256, 1023, 2047])
    x = np.exp(2j * np.pi * np.outer(bins, np.arange(n)) / n).astype(np.complex64)
    got = render_gmax(*_planes(x)).numpy()
    np.testing.assert_allclose(got, n, rtol=1e-4)
