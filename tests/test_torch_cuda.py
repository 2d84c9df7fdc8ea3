"""The port's CUDA kernels on the card (``cuda`` marker; each test skips
without a CUDA device).

This file imports nothing of JAX, so it runs on a machine that has the
card and no JAX. ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (``tests/test_fused.py``): kernel against its plain PyTorch
version on the card ``2e-4 * term_scales + 2e-5 * |want|``; kernel against
the float64 oracle ``1e-4 * term_scales + 1e-5 * |want|``.
"""

import numpy as np
import pytest
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.ops import features as F
from amcpy_tpu_torch.ops.fused import extract_features_fused, split_planes
from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

from .oracle import features_batch, term_scales

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(b, n, seed, spread=6.0):
    """Gaussian frames, per-frame scale exp(U(-spread, spread)); every
    fifth sample of the first two frames is (I < 0, Q = -0.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    x = (x * np.exp(rng.uniform(-spread, spread, (b, 1)))).astype(np.complex64)
    x.real[:2, ::5] = -np.abs(x.real[:2, ::5])
    x.imag[:2, ::5] = -0.0
    return x


def _assert_within(got, want, x, scale_tol, rel_tol):
    tol = scale_tol * np.stack([term_scales(f) for f in x]) + rel_tol * np.abs(want)
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"features {sorted(set(np.nonzero(bad)[1] + 1))}"


def _planes(x, dev):
    return tuple(torch.from_numpy(p).to(dev) for p in split_planes(x))


@pytest.mark.parametrize(
    "b,n", [(37, 1024), (64, 256), (130, 2048), (1, 512), (50, 1000)]
)
def test_kernels_match_plain_on_card(cuda, b, n):
    x = _frames(b, n, seed=n)
    i, q = _planes(x, cuda)
    k1, k2 = extract_features_fused.launches, extract_features_pallas.launches
    got = extract_features_fused(i, q).cpu().numpy()
    want = F._extract_planar(
        i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
    ).cpu().numpy()
    _assert_within(got, want, x, 2e-4, 2e-5)
    iq = torch.from_numpy(F.to_planar(x)).to(cuda)
    got2 = extract_features_pallas(iq, gmax_mode="matmul").cpu().numpy()
    _assert_within(got2, want, x, 2e-4, 2e-5)
    assert extract_features_fused.launches == k1 + 1
    assert extract_features_pallas.launches == k2 + 1


@pytest.mark.parametrize("normalize", [True, False])
def test_kernels_match_oracle_on_card(cuda, normalize):
    """Without normalization the x^6 sums need a narrower scale spread to
    stay inside float32."""
    x = _frames(24, 1024, seed=5, spread=6.0 if normalize else 1.0)
    want = features_batch(x)
    i, q = _planes(x, cuda)
    got = extract_features_fused(i, q, normalize_scale=normalize).cpu().numpy()
    _assert_within(got, want, x, 1e-4, 1e-5)
    iq = torch.from_numpy(F.to_planar(x)).to(cuda)
    got2 = extract_features_pallas(iq, normalize_scale=normalize).cpu().numpy()
    _assert_within(got2, want, x, 1e-4, 1e-5)


def test_empty_batch_and_bad_inputs(cuda):
    empty = torch.zeros((0, 256), device=cuda)
    assert extract_features_fused(empty, empty).shape == (0, 18)
    i = torch.zeros((4, 256), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        extract_features_fused(i, i)
    j = torch.zeros((256, 4), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        extract_features_fused(j, j)


def test_serving_routes_agree_on_card(cuda, tmp_path):
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    x = _frames(300, 1024, seed=9, spread=1.0)
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals={"frame_size": 1024})
    cols = list(cfg.features.used_columns)
    feats = F.extract_features(x, device="cpu").numpy()
    scaler = Standardizer.fit(feats[:, cols])
    torch.manual_seed(0)
    model = AMCClassifier(6)
    pipes = {
        k: AMCPipeline(model, scaler, cfg.replace(compute={"kernel": k}), device=cuda)
        for k in ("auto", "pallas", "xla")
    }
    assert pipes["auto"]._kernel == "fused"
    ref = pipes["xla"].logits(x)
    for k in ("auto", "pallas"):
        torch.testing.assert_close(pipes[k].logits(x), ref, atol=1e-3, rtol=1e-3)


def test_cuda_tensor_without_kernel_library_raises(cuda, monkeypatch, tmp_path):
    """A CUDA tensor runs the kernel or raises: with no library and no
    compiler it must not fall back to the plain version."""
    from amcpy_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    i = torch.zeros((4, 256), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc"):
        extract_features_fused(i, i)
    with pytest.raises(RuntimeError, match="nvcc"):
        extract_features_pallas(torch.zeros((4, 2, 256), device=cuda))
