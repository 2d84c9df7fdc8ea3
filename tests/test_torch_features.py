"""The port's plain PyTorch extractor (``amcpy_tpu_torch/ops/features.py``,
the plain version of both CUDA kernels) against the JAX package's XLA
extractor, the float64 oracle and the reference golden vector, on the CPU.

Tolerances (``tests/test_fused.py``): kernel against kernel
``2e-4 * term_scales + 2e-5 * |want|``; against the oracle
``1e-4 * term_scales + 1e-5 * |want|``; golden vector rtol 2e-5.
"""

import numpy as np
import pytest
import torch

from amcpy_tpu.ops import features as jax_features
from amcpy_tpu.ops import fft as jax_fft
from amcpy_tpu_torch.ops import features as F
from amcpy_tpu_torch.ops import fft as port_fft

from .oracle import features_batch, term_scales
from .test_features import GOLDEN, _golden_signal


def _frames(b, n, seed, scale_spread=True, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    if scale_spread:
        x *= np.exp(rng.uniform(-6, 6, (b, 1)))
    return x.astype(dtype)


def _with_negative_zeros(x, step=3):
    """Every ``step``-th sample of each frame moved to I < 0, Q = -0.0
    (set through the views: ``re + 1j * im`` would drop the sign)."""
    x = x.copy()
    x.real[:, ::step] = -np.abs(x.real[:, ::step])
    x.imag[:, ::step] = -0.0
    assert np.signbit(x.imag[:, ::step]).all()
    return x


def _port(x, **kw):
    iq = torch.from_numpy(F.to_planar(x))
    return F.extract_features_planar(iq, **kw).numpy()


def _scales(x):
    return np.stack([term_scales(f) for f in x])


def _assert_within(got, want, x, scale_tol, rel_tol):
    tol = scale_tol * _scales(x) + rel_tol * np.abs(want)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{bad.sum()} violations, features {sorted(set(np.nonzero(bad)[1] + 1))}"
    )


@pytest.mark.parametrize("gmax_mode", ["fft", "matmul"])
@pytest.mark.parametrize("n", [256, 512, 1024])
def test_plain_matches_jax_xla_extractor(n, gmax_mode):
    x = _frames(16, n, seed=n)
    want = np.asarray(
        jax_features.extract_features_planar(F.to_planar(x), gmax_mode=gmax_mode)
    )
    got = _port(x, gmax_mode=gmax_mode)
    _assert_within(got, want, x, 2e-4, 2e-5)


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_matches_oracle_with_scale_spread(n):
    x = _frames(12, n, seed=100 + n)
    _assert_within(_port(x), features_batch(x), x, 1e-4, 1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_golden(normalize):
    sig = _golden_signal().astype(np.complex64)[None, :]
    got = _port(sig, normalize_scale=normalize)[0]
    np.testing.assert_allclose(got, GOLDEN, rtol=2e-5)


def test_float64_matches_oracle():
    """In float64 the plain extractor is the oracle up to rounding."""
    x = _frames(6, 512, seed=7, dtype=np.complex128)
    got = _port(x)
    assert got.dtype == np.float64
    _assert_within(got, features_batch(x), x, 1e-10, 1e-10)


@pytest.mark.parametrize("n", [256, 2048, 1000])
def test_gmax_matmul_matches_fft(n):
    x = _frames(8, n, seed=3, scale_spread=False)
    i = torch.from_numpy(np.ascontiguousarray(x.real))
    q = torch.from_numpy(np.ascontiguousarray(x.imag))
    got = port_fft.gmax_matmul(i, q).numpy()
    want = port_fft.gmax_fft(i, q).numpy()
    # f32 DFT error is bounded by the Parseval scale sum|x|^2
    tol = 1e-5 * (np.abs(x) ** 2).sum(-1)
    np.testing.assert_array_less(np.abs(got - want), tol)


def test_best_factorization_matches_jax():
    for n in range(8, 4097):
        for m in (1, 2, 4):
            assert port_fft.best_factorization(n, m) == jax_fft.best_factorization(
                n, m
            ), (n, m)


def test_dft_tables_match_jax():
    for a, b in zip(port_fft._dft_tables(8, 256), jax_fft._dft_tables(8, 256)):
        np.testing.assert_array_equal(a, b)


def test_negative_zero_follows_oracle():
    """(I < 0, Q = -0.0) samples: the port follows np.angle (phase -pi),
    like the oracle; the JAX package's Pallas kernels give +pi there (see
    test_torch_fused.py::test_signed_zero_gap_against_jax_kernels)."""
    x = _with_negative_zeros(_frames(4, 512, seed=11, scale_spread=False))
    got = _port(x)
    _assert_within(got, features_batch(x), x, 1e-4, 1e-5)


def test_exact_pi_wrapped_differences():
    """Frames whose phase steps are exactly +-pi in float32 hit the wrap's
    edge rule (-pi with a positive raw step -> +pi); floor-mod vs a
    truncating fmod matters for the negative d + pi in between."""
    pi = np.float32(np.pi)
    phase = torch.tensor(
        [0.0, pi, 0.0, -pi, -pi, pi, 0.25, -2.9, 3.0, -0.358 - pi],
        dtype=torch.float32,
    )
    got = F._wrapped_phase_diff(phase).numpy()
    want = np.asarray(jax_features._wrapped_phase_diff(phase.numpy()))
    np.testing.assert_array_equal(got, want)
    assert got[0] == pi and got[1] == -pi  # the edge rule, both signs

    # alternating real +-1 (exact pi steps) with a little structure
    n = 256
    re = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    re[::7] *= 2.0
    im = np.zeros(n, np.float32)
    im[5::11] = 0.5
    x = (re + 1j * im).astype(np.complex64)[None, :]
    got = _port(x)
    _assert_within(got, features_batch(x), x, 1e-4, 1e-5)
    want_jax = np.asarray(jax_features.extract_features_planar(F.to_planar(x)))
    _assert_within(got, want_jax, x, 2e-4, 2e-5)


def test_scan_matches_planar():
    x = _frames(13, 256, seed=5)
    iq = torch.from_numpy(F.to_planar(x))
    whole = F.extract_features_planar(iq, gmax_mode="matmul").numpy()
    chunked = F.extract_features_planar_scan(iq, chunk=5).numpy()
    assert chunked.shape == (13, 18)
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=0)


def test_extract_features_complex_entry():
    x = _frames(5, 256, seed=6)
    from_numpy = F.extract_features(x, device="cpu").numpy()
    from_tensor = F.extract_features(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(from_numpy, from_tensor)
    np.testing.assert_array_equal(from_numpy, _port(x))
    with pytest.raises(TypeError):
        F.extract_features(torch.zeros(2, 8))
