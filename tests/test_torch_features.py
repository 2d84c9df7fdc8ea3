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


#: float32's subnormal step, 2^-149: a float32 result can neither resolve
#: a difference below it nor come closer to an oracle value that lies below
#: float32's range (a cumulant of order 4 at peak 1e-15 is ~1e-63)
F32_STEP = 2.0**-149


def _peak_frame(n, peak, seed):
    """One Gaussian frame scaled to a peak |x| of ``peak``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    return (x / np.abs(x).max() * peak).astype(np.complex64)


@pytest.mark.parametrize("peak", [1.0, 1e-15, 1e-19, 5e-20, 1e-20])
def test_tiny_peak_amplitudes(peak):
    """Frames of tiny amplitude: the plain version stays finite in all 18
    columns and within the oracle's budget (plus float32's subnormal step),
    and equals JAX's XLA extractor wherever that one is finite and within
    the same budget. ``|x|^2 (1/s)^2`` overflowed ``1/s^2`` below s ~
    5.4e-20 (c21, c41, c42, c61, c62, c63 went inf/nan); JAX's f4 and f8
    are nan from 1e-19 down (its amplitudes flush to zero there), a
    divergence pinned here."""
    x = _peak_frame(256, peak, seed=21)
    got = _port(x).astype(np.float64)
    assert np.isfinite(got).all(), np.nonzero(~np.isfinite(got))[1] + 1
    want = features_batch(x)
    budget = 1e-4 * _scales(x) + 1e-5 * np.abs(want) + F32_STEP
    bad = np.abs(got - want) > budget
    assert not bad.any(), f"features {sorted(set(np.nonzero(bad)[1] + 1))}"

    jax_got = np.asarray(
        jax_features.extract_features_planar(F.to_planar(x))
    ).astype(np.float64)
    held = np.isfinite(jax_got) & (np.abs(jax_got - want) <= budget)
    tol = 2e-4 * _scales(x) + 2e-5 * np.abs(jax_got) + 2 * F32_STEP
    bad = (np.abs(got - jax_got) > tol) & held
    assert not bad.any(), f"features {sorted(set(np.nonzero(bad)[1] + 1))}"
    if peak == 1.0:
        assert held.all()
    if peak <= 1e-19:
        assert np.isnan(jax_got[0, [3, 7]]).all()


@pytest.mark.parametrize("peak", [1e-25, 1e-30, 1e-35, 1e-38])
def test_deep_peak_amplitudes_within_the_oracle_budget(peak):
    """Below the squares' range (peak ~1e-23) the amplitude's rescale keeps
    every column within the oracle's budget (plus float32's subnormal step)
    down to a subnormal peak; below ~2.9e-39 1/max|x| overflows float32."""
    x = _peak_frame(1024, peak, seed=22)
    got = _port(x).astype(np.float64)
    assert np.isfinite(got).all(), np.nonzero(~np.isfinite(got))[1] + 1
    want = features_batch(x)
    bad = np.abs(got - want) > 1e-4 * _scales(x) + 1e-5 * np.abs(want) + F32_STEP
    assert not bad.any(), f"features {sorted(set(np.nonzero(bad)[1] + 1))}"


def test_tiny_samples_in_an_ordinary_frame():
    """Tiny (1e-30), subnormal (1e-41) and zero samples inside frames of
    ordinary amplitude: the plain version against the oracle, as
    ``test_torch_cuda.py`` holds the kernels to it on such frames."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 256)) + 1j * rng.standard_normal((4, 256))).astype(
        np.complex64
    )
    x[:, ::7] *= np.float32(1e-30)
    x[:, 3::11] *= np.float32(1e-41)
    x[:, 5::13] = 0
    got = _port(x)
    assert np.isfinite(got).all()
    want = features_batch(x)
    bad = np.abs(got - want) > 1e-4 * _scales(x) + 1e-5 * np.abs(want) + F32_STEP
    assert not bad.any(), f"features {sorted(set(np.nonzero(bad)[1] + 1))}"


#: run in a fresh process by ``test_std_over_4096_frames_in_a_fresh_process``:
#: the first float32 ``torch.sqrt`` of more than 2048 values in the process
#: is ``_std_ddof1``'s (ROADMAP C-watch 7), then the whole plain extractor
#: on 4096 frames against the float64 oracle
_FRESH_STD = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from amcpy_tpu_torch.ops import features as F
from tests.oracle import features_batch, term_scales

rng = np.random.default_rng(23)
b, n = 4096, 64
v = (rng.standard_normal((b, n)) * np.exp(rng.uniform(-3, 3, (b, 1)))).astype(np.float32)
got = F._std_ddof1(torch.from_numpy(v)).numpy()
want = np.std(v.astype(np.float64), axis=-1, ddof=1)
assert np.all(np.abs(got - want) <= 1e-5 * want), float(np.max(np.abs(got / want - 1)))
x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))) * np.exp(
    rng.uniform(-3, 3, (b, 1)))
x = x.astype(np.complex64)
feats = F.extract_features_planar(torch.from_numpy(F.to_planar(x)), gmax_mode="matmul").numpy()
ref = features_batch(x)
tol = np.stack([1e-4 * term_scales(f) for f in x]) + 1e-5 * np.abs(ref)
bad = np.abs(feats - ref) > tol
assert not bad.any(), sorted(set(np.nonzero(bad)[1] + 1))
print("ok", float(np.max(np.abs(got / want - 1))))
"""


def test_std_over_4096_frames_in_a_fresh_process():
    """ROADMAP C-watch 7: ``_std_ddof1`` takes ``torch.sqrt`` of a (B,)
    vector, which for B > 2048 on the CPU goes to MKL's vector math on
    threads, the path that once returned a wrong chunk on its first call in
    a busy process. In a fresh process, its first such call (B = 4096)
    against numpy's float64 std (rtol 1e-5), then the plain extractor on
    the 4096 frames against the float64 oracle (``1e-4 * term_scales +
    1e-5 * |want|``)."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", _FRESH_STD.format(root=root)],
                         capture_output=True, text=True, timeout=240, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
