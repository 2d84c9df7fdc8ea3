"""The port's kernel wrappers (``ops/fused.py`` for K1, ``ops/pallas_features.py``
for K2) against the JAX package's Pallas kernels run in interpret mode.

On the CPU a wrapper takes its kernel's plain PyTorch version; the CUDA
kernels themselves are held against that plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked ``tests/test_torch_cuda.py``,
which skips without a card. Tolerance: ``2e-4 * term_scales + 2e-5 *
|want|`` (``tests/test_fused.py``).
"""

import numpy as np
import pytest
import torch

from amcpy_tpu.ops.features import to_planar
from amcpy_tpu.ops.fused import extract_features_fused as jax_fused
from amcpy_tpu.ops.pallas_features import extract_features_pallas as jax_pallas
from amcpy_tpu_torch.ops import features as F
from amcpy_tpu_torch.ops.fused import (
    extract_features_fused,
    extract_features_fused_any,
    split_planes,
)
from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

from .oracle import features_batch, term_scales
from .test_features import GOLDEN, _golden_signal
from .test_torch_features import _assert_within, _frames, _with_negative_zeros


def _planes(x):
    i, q = split_planes(x)
    return torch.from_numpy(i), torch.from_numpy(q)


@pytest.mark.parametrize("b,n", [(16, 256), (12, 512), (11, 512)])
def test_fused_matches_jax_fused_interpret(b, n):
    """(11, 512) is a ragged batch: the JAX kernel pads to its tile of 8,
    the port's kernel masks its last tile."""
    x = _frames(b, n, seed=b + n)
    i, q = split_planes(x)
    want = np.asarray(jax_fused(i, q, interpret=True, tile_b=8))
    got = extract_features_fused(*_planes(x)).numpy()
    assert got.shape == (b, 18)
    _assert_within(got, want, x, 2e-4, 2e-5)


@pytest.mark.parametrize("gmax_mode", ["fft", "matmul"])
def test_pallas_matches_jax_pallas_interpret(gmax_mode):
    x = _frames(9, 256, seed=21)
    iq = to_planar(x)
    want = np.asarray(
        jax_pallas(iq, tile_b=8, interpret=True, gmax_mode=gmax_mode)
    )
    got = extract_features_pallas(
        torch.from_numpy(iq), gmax_mode=gmax_mode
    ).numpy()
    _assert_within(got, want, x, 2e-4, 2e-5)


def test_pallas_without_gmax_leaves_column_zero():
    x = _frames(4, 256, seed=2)
    got = extract_features_pallas(
        torch.from_numpy(to_planar(x)), compute_gmax=False
    ).numpy()
    assert (got[:, 0] == 0).all()
    full = F.extract_features_planar(torch.from_numpy(to_planar(x))).numpy()
    np.testing.assert_array_equal(got[:, 1:], full[:, 1:])


def test_fused_rejects_unfactorizable_frame():
    i = torch.zeros((4, 10))
    with pytest.raises(ValueError, match="factorization"):
        extract_features_fused(i, i)


def test_fused_any_reroutes_unfactorizable_frame():
    """N = 10 has no N1 x N2 split: the fused route takes the plain
    extractor and counts the reroute; the golden vector passes through it."""
    sig = _golden_signal().astype(np.complex64)[None, :]
    before = extract_features_fused_any.reroutes
    got = extract_features_fused_any(*_planes(sig)).numpy()[0]
    assert extract_features_fused_any.reroutes == before + 1
    np.testing.assert_allclose(got, GOLDEN, rtol=2e-5)


def test_fused_rejects_mismatched_planes():
    with pytest.raises(ValueError, match="planes"):
        extract_features_fused(torch.zeros((4, 256)), torch.zeros((3, 256)))
    with pytest.raises(ValueError, match=r"\(B, 2, N\)"):
        extract_features_pallas(torch.zeros((4, 3, 256)))


def test_cpu_path_leaves_launch_counters():
    x = _frames(8, 256, seed=4)
    k1, k2 = extract_features_fused.launches, extract_features_pallas.launches
    extract_features_fused(*_planes(x))
    extract_features_fused_any(*_planes(x))
    extract_features_pallas(torch.from_numpy(to_planar(x)))
    assert extract_features_fused.launches == k1
    assert extract_features_pallas.launches == k2


def test_signed_zero_gap_against_jax_kernels():
    """ROADMAP C-watch 1: for (I < 0, Q = -0.0) the JAX package's Pallas
    ``_atan2`` returns +pi where np.angle returns -pi, so its kernels miss
    the oracle on sigma_dp (feature 3); the port follows the oracle."""
    x = _with_negative_zeros(_frames(4, 256, seed=8, scale_spread=False), 2)
    want = features_batch(x)
    scales = np.stack([term_scales(f) for f in x])
    tol = 1e-4 * scales + 1e-5 * np.abs(want)
    got = extract_features_fused(*_planes(x)).numpy()
    assert (np.abs(got - want) <= tol).all()
    i, q = split_planes(x)
    jax_got = np.asarray(jax_fused(i, q, interpret=True, tile_b=8))
    assert (np.abs(jax_got[:, 2] - want[:, 2]) > tol[:, 2]).all()
