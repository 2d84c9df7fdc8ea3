"""Sequence-parallel extraction (``amcpy_tpu_torch/parallel/sp.py``) and the
multi-rank routes of ``run_extraction``, on gloo worlds of CPU ranks,
against the JAX package's ``extract_features_sp`` on a sub-mesh of the
conftest's CPU devices and against the port's plain extractor.

One world is spawned a mesh, (1, 2), (2, 2) and (1, 4); it runs every
frame size and gamma_max mode (``test_torch_parallel._case_sp``) and each
case is its own test. Tolerance, kernel against kernel as
``tests/test_fused.py:49``: ``2e-4 * term_scales + 2e-5 * |want|``. The
collective audit holds the JAX package's invariants
(``tests/test_scaling_audit.py:97-122``): where a factorization N1 x N2
with N1 a multiple of the seq axis exists, no all-gather, a reduce-scatter
and all-reduces, and fewer bytes than ``2 (B/d)(N/n_seq) 4 + 40 B 4 +
4096``; where none exists (N = 48), the documented all-gather.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from amcpy_tpu.parallel.sp import extract_features_sp as jax_sp
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat, synth
from amcpy_tpu_torch.extraction import run_extraction
from amcpy_tpu_torch.ops.features import extract_features_planar
from amcpy_tpu_torch.ops.fft import best_factorization

from .oracle import term_scales
from .test_torch_parallel import EXTRACT_SIGNALS, SP_FRAMES, SP_SIZES, run_world, sp_modes

SHAPES = ((1, 2), (2, 2), (1, 4))
CASES = [(n, mode) for n in SP_SIZES for mode in sp_modes(n)]


def _frames(n: int) -> np.ndarray:
    """Complex Gaussian frames with a per-frame scale spread of exp(U(-2,
    2)), as planar ``(B, 2, n)`` float32."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((SP_FRAMES, n)) + 1j * rng.standard_normal((SP_FRAMES, n))
    x = x * np.exp(rng.uniform(-2, 2, (SP_FRAMES, 1)))
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def _tolerance(planar: np.ndarray, want: np.ndarray) -> np.ndarray:
    scales = np.stack([term_scales(f[0] + 1j * f[1]) for f in planar.astype(np.float64)])
    return 2e-4 * scales + 2e-5 * np.abs(want)


def _extraction_cfg(root, **compute) -> Config:
    return Config().replace(paths={"root": str(root)}, signals=EXTRACT_SIGNALS,
                            compute=compute)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, tmp_path_factory):
    """(mesh shape, the world's directory) after the world ran."""
    shape = request.param
    root = tmp_path_factory.mktemp(f"sp_{shape[0]}x{shape[1]}")
    for n in SP_SIZES:
        np.save(root / f"frames_{n}.npy", _frames(n))
    if shape in ((1, 2), (2, 2)):
        for rank in range(shape[0] * shape[1]):
            synth.write_dataset(_extraction_cfg(root / f"rank{rank}"), seed=5, device="cpu")
        np.save(root / "batch.npy", synth.generate_modulation(
            "QPSK", _extraction_cfg(root), 6, "cpu").reshape(-1, 128)[:64])
    outs = run_world(f"sp_{shape[0]}x{shape[1]}", shape[0] * shape[1], root)
    return shape, root, outs


def _jax_reference(shape, planar, mode):
    d, s = shape
    mesh = Mesh(np.array(jax.devices()[: d * s]).reshape(d, s), ("data", "seq"))
    x = jax.device_put(planar, NamedSharding(mesh, P("data", None, "seq")))
    return np.asarray(jax_sp(x, mesh, gmax_mode=mode))


@pytest.mark.parametrize("n,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_sp_matches_jax_and_plain(world, n, mode):
    shape, root, _ = world
    planar = _frames(n)
    got = np.load(root / "sp.npz")[f"{n}_{mode}"]
    assert got.shape == (SP_FRAMES, 18) and np.isfinite(got).all()
    jax_want = _jax_reference(shape, planar, mode)
    plain = extract_features_planar(torch.from_numpy(planar), gmax_mode=mode).numpy()
    for name, want in (("JAX", jax_want), ("plain", plain)):
        bad = np.abs(got - want) > _tolerance(planar, want)
        assert not bad.any(), (f"{name}: frames/features {np.argwhere(bad)[:5].tolist()}: "
                               f"got {got[bad][:5]} want {want[bad][:5]}")


@pytest.mark.parametrize("n,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_sp_collectives_are_bounded(world, n, mode):
    shape, root, _ = world
    d, n_seq = shape
    audit = json.loads((root / "sp_audit.json").read_text())[f"{n}_{mode}"]
    divisible = mode == "matmul" and best_factorization(n, multiple_of=n_seq) is not None
    assert "all-reduce" in audit and "collective-permute" in audit, audit
    if not divisible:  # the whole frame is gathered for the local gamma_max
        assert audit["all-gather"]["count"] == 1, audit
        return
    assert "all-gather" not in audit, f"SP gamma_max re-assembled the frame: {audit}"
    assert audit["reduce-scatter"]["count"] == 1, audit
    budget = 2 * (SP_FRAMES // d) * (n // n_seq) * 4 + 40 * SP_FRAMES * 4 + 4096
    total = sum(r["bytes"] for r in audit.values())
    assert total < budget, (total, budget, audit)


@pytest.mark.parametrize("world", [(1, 2)], indirect=True, ids=["1x2"])
def test_round_robin_extraction(world, tmp_path):
    """(1, 2): modulation k on rank k % 2 with no collective while it
    extracts, then the owners' broadcasts (shape and features, 12 in all);
    both roots end with all six artifacts, equal bit for bit, and equal to
    one process's extraction of the same dataset."""
    _, root, outs = world
    mods = Config().signals.modulations_with_noise
    assert "[BPSK]" in outs[0] and "[BPSK]" not in outs[1]
    assert "[QPSK]" in outs[1] and "[QPSK]" not in outs[0]
    one = _extraction_cfg(tmp_path)
    synth.write_dataset(one, seed=5, device="cpu")
    want = run_extraction(one, device="cpu")
    for rank in (0, 1):
        audit = json.loads((root / f"rank{rank}" / "audit.json").read_text())
        assert audit["extract_batch"] == {}
        assert set(audit["run_extraction"]) == {"collective-broadcast"}
        assert audit["run_extraction"]["collective-broadcast"]["count"] == 2 * len(mods)
    for mod in mods:
        a, b = (io_mat.load_features(_extraction_cfg(root / f"rank{r}"), mod) for r in (0, 1))
        np.testing.assert_array_equal(a, b, err_msg=mod)
        np.testing.assert_allclose(a, want[mod], rtol=1e-6, atol=1e-7, err_msg=mod)


@pytest.mark.parametrize("world", [(2, 2)], indirect=True, ids=["2x2"])
def test_sequence_parallel_extraction(world, tmp_path):
    """(2, 2): ``run_extraction`` with ``mesh_shape`` (2, 2) takes the
    sequence-parallel route on every rank; the four roots' artifacts are
    equal bit for bit and within the kernel bar of one process's plain
    extraction."""
    _, root, outs = world
    assert all("sequence-parallel, mesh 2 x 2" in o for o in outs)
    one = _extraction_cfg(tmp_path)
    synth.write_dataset(one, seed=5, device="cpu")
    want = run_extraction(one, device="cpu")
    data = io_mat.load_dataset(one)
    for mod in one.signals.modulations_with_noise:
        got = [io_mat.load_features(_extraction_cfg(root / f"rank{r}"), mod) for r in range(4)]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0], err_msg=mod)
        frames = data[mod].reshape(-1, 128)
        planar = np.stack([frames.real, frames.imag], axis=1)
        w, g = want[mod].reshape(-1, 18), got[0].reshape(-1, 18)
        assert not (np.abs(g - w) > _tolerance(planar, w)).any(), mod
