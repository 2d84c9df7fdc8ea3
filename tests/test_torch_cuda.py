"""The port's CUDA kernels on the card (``cuda`` marker; each test skips
without a CUDA device).

This file imports nothing of JAX, so it runs on a machine that has the
card and no JAX. ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (``tests/test_fused.py``): kernel against its plain PyTorch
version on the card ``2e-4 * term_scales + 2e-5 * |want|``; kernel against
the float64 oracle ``1e-4 * term_scales + 1e-5 * |want|``.

The CNN trunk kernel (K3) against its plain version: ``|got - want| <=
2e-2 + 2e-2 * |want|`` on the pooled features. Both round the activations
of layers 0 and 1 to bf16, from float32 values whose last bits differ
(float32 sums in another order, ``rsqrtf``); where a value lies next to a
bf16 rounding boundary the two round it 2^-8 apart, and the next layer
carries that on.
"""

import re

import numpy as np
import pytest
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.ops import features as F
from amcpy_tpu_torch.ops.cnn_infer import cnn_trunk, cnn_trunk_plain, trunk_path
from amcpy_tpu_torch.ops.fused import (
    extract_features_fused,
    extract_features_fused_any,
    fused_route,
    split_planes,
)
from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas, stats_path

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


def _k1_launch(i, q, **kw):
    """K1 on (i, q); the routes its launch was counted on."""
    by_route = dict(extract_features_fused.launches_by_route)
    got = extract_features_fused(i, q, **kw)
    torch.cuda.synchronize()
    ran = [r for r, c in extract_features_fused.launches_by_route.items() if c > by_route[r]]
    return got, ran


@pytest.mark.parametrize(
    "b,n",
    [(37, 1024), (64, 256), (130, 2048), (1, 512), (50, 1000), (4096, 2048),
     (3, 4096), (2, 8192), (1, 16384), (3, 12288), (7, 88)],
)
def test_kernels_match_plain_on_card(cuda, b, n):
    """K1's FFT path (N2 a power of two; 12288 = 24 x 512 with the direct
    N1 stage first) and its direct path (1000 = 8 x 125, 88 = 8 x 11); K2
    on its warpgroup route (N <= 2048, the frame in registers) and its block
    route (longer frames, recomputed per pass)."""
    x = _frames(b, n, seed=n)
    i, q = _planes(x, cuda)
    k1, k2 = extract_features_fused.launches, extract_features_pallas.launches
    got, ran = _k1_launch(i, q)
    assert ran == ["block"] and fused_route(n) == ("block", 1)
    want = F._extract_planar(
        i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
    ).cpu().numpy()
    _assert_within(got.cpu().numpy(), want, x, 2e-4, 2e-5)
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


def _exact_pi_frame():
    """Alternating real +-1 (phase steps of exactly +-pi) with a little
    structure (``test_torch_features.py::test_exact_pi_wrapped_differences``)."""
    n = 256
    re = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    re[::7] *= 2.0
    im = np.zeros(n, np.float32)
    im[5::11] = 0.5
    return (re + 1j * im).astype(np.complex64)[None, :]


def _negative_zero_frames():
    """Every third sample at I < 0, Q = -0.0
    (``test_torch_features.py::test_negative_zero_follows_oracle``)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 512)) + 1j * rng.standard_normal((4, 512))).astype(
        np.complex64
    )
    x.real[:, ::3] = -np.abs(x.real[:, ::3])
    x.imag[:, ::3] = -0.0
    assert np.signbit(x.imag[:, ::3]).all()
    return x


def _axes_frames():
    """Gaussian frames with every fourth sample moved onto an axis, signed
    zeros included: (+-r, +-0), (+-0, +-r) and (+-0, +-0)."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((6, 1024)) + 1j * rng.standard_normal((6, 1024))).astype(
        np.complex64
    )
    r = np.abs(x.real[:, ::4])
    sign = np.where(rng.random(r.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    zero = np.where(rng.random(r.shape) < 0.5, -0.0, 0.0).astype(np.float32)
    on_real = rng.random(r.shape) < 0.5
    x.real[:, ::4] = np.where(on_real, sign * r, zero)
    x.imag[:, ::4] = np.where(on_real, zero[:, ::-1], sign * r)
    x.real[:, 2::64] = zero[:, : x[:, 2::64].shape[1]]
    x.imag[:, 2::64] = -zero[:, : x[:, 2::64].shape[1]]
    return x


EDGE_FRAMES = {"exact_pi": _exact_pi_frame, "negative_zero": _negative_zero_frames,
               "axes": _axes_frames}


@pytest.mark.parametrize("frames", sorted(EDGE_FRAMES))
def test_fused_edge_phases_follow_oracle_on_card(cuda, frames):
    """The one-step wrap keeps the floor-mod and the +-pi edge rule, and
    the kernels' phase numpy's signed zero and axes: K1 and K2 against the
    float64 oracle."""
    x = EDGE_FRAMES[frames]()
    want = features_batch(x)
    got = extract_features_fused(*_planes(x, cuda)).cpu().numpy()
    _assert_within(got, want, x, 1e-4, 1e-5)
    iq = torch.from_numpy(F.to_planar(x)).to(cuda)
    by_path = dict(extract_features_pallas.launches_by_path)
    got2 = extract_features_pallas(iq).cpu().numpy()
    _assert_within(got2, want, x, 1e-4, 1e-5)
    assert extract_features_pallas.launches_by_path == {
        **by_path, "warpgroup": by_path["warpgroup"] + 1
    }


def _k2_launch(iq):
    """K2 on ``iq`` with gamma_max by the matmul epilogue; the route the
    launch was counted on."""
    by_path = dict(extract_features_pallas.launches_by_path)
    got = extract_features_pallas(iq, gmax_mode="matmul")
    torch.cuda.synchronize()
    ran = [p for p, c in extract_features_pallas.launches_by_path.items() if c > by_path[p]]
    return got, ran


@pytest.mark.parametrize(
    "b,n",
    [(5, 1023), (3, 6), (1, 2), (5, 2048), (2, 2048), (2, 2049), (9, 88), (3, 1001),
     (4, 130)],
)
def test_k2_routes_match_plain_on_card(cuda, b, n):
    """K2 on both sides of its route: scalar loads (N % 4 != 0: 1023, 6,
    1001, 130 and the shortest frame, N = 2), ragged last blocks (odd B),
    N = 2048 on the warpgroup route and 2049 on the block route."""
    x = _frames(b, n, seed=n + b)
    iq = torch.from_numpy(F.to_planar(x)).to(cuda)
    got, ran = _k2_launch(iq)
    assert ran == [stats_path(n)]
    want = F._extract_planar(
        iq[:, 0], iq[:, 1], normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
    )
    _assert_within(got.cpu().numpy(), want.cpu().numpy(), x, 2e-4, 2e-5)


#: float32's subnormal step: below it two float32 results cannot differ
#: by less, nor a float32 result come closer to a value below its range
F32_STEP = 2.0**-149

#: peak |x| of the tiny-amplitude frames (ROADMAP C-watch 21), down to a
#: subnormal peak (1e-38: every sample subnormal, mean|x| below the range
#: of its reciprocal)
TINY_PEAKS = [1.0, 1e-15, 1e-19, 5e-20, 1e-20, 1e-30, 1e-38]


def _peak_frames(b, n, peak, seed):
    """Gaussian frames, each scaled to a peak |x| of ``peak``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (x / np.abs(x).max(axis=-1, keepdims=True) * peak).astype(np.complex64)


def _tiny_sample_frames(b, n, seed):
    """Gaussian frames of ordinary amplitude with every 7th sample scaled
    by 1e-30, every 11th from the 3rd by 1e-41 (float32 subnormals) and
    every 13th from the 5th set to 0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    x[:, ::7] *= np.float32(1e-30)
    x[:, 3::11] *= np.float32(1e-41)
    x[:, 5::13] = 0
    return x


def _assert_kernels_match_plain(x, dev, k2=True):
    """K1 and K2 (K1 alone with ``k2=False``) on ``x`` finite and within
    the kernel bar of the plain version (plus two subnormal steps, one a
    side)."""
    n = x.shape[-1]
    i, q = _planes(x, dev)
    want = F._extract_planar(
        i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
    ).cpu().numpy().astype(np.float64)
    assert np.isfinite(want).all()
    k1, ran = _k1_launch(i, q)
    assert ran == [fused_route(n)[0]]
    results = [("K1", k1.cpu().numpy().astype(np.float64))]
    if k2:
        got2, ran = _k2_launch(torch.from_numpy(F.to_planar(x)).to(dev))
        assert ran == [stats_path(n)]
        results.append(("K2", got2.cpu().numpy().astype(np.float64)))
    tol = (2e-4 * np.stack([term_scales(f) for f in x]) + 2e-5 * np.abs(want)
           + 2 * F32_STEP)
    for name, got in results:
        assert np.isfinite(got).all(), (name, np.nonzero(~np.isfinite(got))[1] + 1)
        bad = np.abs(got - want) > tol
        assert not bad.any(), (name, sorted(set(np.nonzero(bad)[1] + 1)))


@pytest.mark.parametrize("peak", TINY_PEAKS)
@pytest.mark.parametrize("n", [256, 4096])
def test_kernels_at_tiny_peaks_match_plain_on_card(cuda, n, peak):
    """K1 and K2 (the warpgroup route at N = 256, the block route at 4096)
    on frames of tiny peak amplitude, whose samples all take the kernels'
    2^100 rescale below peak ~2^-50: against the plain version, which
    ``test_torch_features.py::test_tiny_peak_amplitudes`` holds to the
    oracle."""
    assert stats_path(n) == ("warpgroup" if n <= 2048 else "block")
    _assert_kernels_match_plain(
        _peak_frames(4, n, peak, seed=int(n + 1e3 * -np.log10(peak))), cuda)


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_kernels_with_tiny_samples_match_plain_on_card(cuda, n):
    """Tiny, subnormal and zero samples inside ordinary frames: the threads
    that hold one go over their samples again through polar(), the others
    keep the plain root and phase."""
    _assert_kernels_match_plain(_tiny_sample_frames(5, n, seed=n), cuda)


def test_k2_unaligned_input_on_card(cuda):
    """A contiguous input that starts 4 bytes past a 16-byte boundary takes
    the warpgroup route's scalar loads, N % 4 == 0 or not."""
    for b, n in ((3, 1024), (2, 1022)):
        x = _frames(b, n, seed=b * n)
        base = torch.empty(1 + b * 2 * n, device=cuda)
        iq = base[1:].view(b, 2, n)
        iq.copy_(torch.from_numpy(F.to_planar(x)))
        assert iq.is_contiguous() and iq.data_ptr() % 16 == 4
        got, ran = _k2_launch(iq)
        assert ran == ["warpgroup"]
        want = F._extract_planar(
            iq[:, 0], iq[:, 1], normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
        )
        _assert_within(got.cpu().numpy(), want.cpu().numpy(), x, 2e-4, 2e-5)


#: frame sizes of K1's cluster route, C = 2 ... 8 (``fused_route``)
CLUSTER_SIZES = [20480, 24576, 28672, 32768, 40960, 49152, 57344, 65536, 81920, 98304,
                 114688, 131072]
#: the long frame of the edge cases: four slices of 16384 samples
LONG_N = 65536
LONG_M = 16384
#: batches around the waves of clusters an H100 holds at once (30 of C = 4
#: at 65536, 15 of C = 8 at 131072): a lone frame, a wave less one, one
#: wave, one more, and several waves with a ragged last one
WAVE_BATCHES = {65536: (1, 29, 30, 31, 121, 128, 257), 131072: (1, 15, 16, 64)}


@pytest.mark.parametrize("n", CLUSTER_SIZES)
def test_cluster_route_matches_plain_on_card(cuda, n):
    """Frames past one block's shared memory: one cluster of C blocks a
    frame, within K1's bar of the plain version, counted on the cluster
    route alone; normalized and not (the x^6 sums then need a narrower
    scale spread); at 65536 and 131072 also batches across the waves of
    clusters the card holds at once, every frame to the last."""
    route, c = fused_route(n)
    assert route == "cluster" and 2 <= c <= 8
    cases = [(3, True, 6.0, n), (3, False, 1.0, n)]
    cases += [(b, True, 6.0, n + b) for b in WAVE_BATCHES.get(n, ())]
    for b, normalize, spread, seed in cases:
        x = _frames(b, n, seed=seed, spread=spread)
        i, q = _planes(x, cuda)
        got, ran = _k1_launch(i, q, normalize_scale=normalize)
        assert ran == ["cluster"]
        want = F._extract_planar(
            i, q, normalize_scale=normalize, compute_gmax=True, gmax_mode="matmul"
        )
        _assert_within(got.cpu().numpy(), want.cpu().numpy(), x, 2e-4, 2e-5)


def test_cluster_route_follows_oracle_on_card(cuda):
    """K1's cluster route against the float64 oracle."""
    x = _frames(4, LONG_N, seed=31)
    got, ran = _k1_launch(*_planes(x, cuda))
    assert ran == ["cluster"]
    _assert_within(got.cpu().numpy(), features_batch(x), x, 1e-4, 1e-5)


@pytest.mark.parametrize("peak", [1.0, 1e-20, 1e-30, 1e-38])
def test_cluster_route_at_tiny_peaks_matches_plain_on_card(cuda, peak):
    """Frames of tiny peak amplitude (every sample rescaled by 2^100; at
    1e-38 every sample subnormal and mean|x| below the range of its
    reciprocal, so the frame-wide mean_scale() applies) on the cluster
    route."""
    _assert_kernels_match_plain(
        _peak_frames(3, LONG_N, peak, seed=int(-np.log10(peak))), cuda, k2=False)


def _last_slice_frames(seed):
    """Ordinary Gaussian frames whose tiny (1e-30), subnormal (1e-41) and
    zero samples all lie in the cluster's last slice, and, in frame 1, the
    frame's peak |x| too (near its end); frame 2 has a tiny sample as the
    last sample of every slice."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, LONG_N)) + 1j * rng.standard_normal((3, LONG_N))
         ).astype(np.complex64)
    last = LONG_N - LONG_M
    x[:, last::7] *= np.float32(1e-30)
    x[:, last + 3::11] *= np.float32(1e-41)
    x[:, last + 5::13] = 0
    x[1, LONG_N - 3] = np.complex64(40 - 30j)
    x[2, LONG_M - 1::LONG_M] *= np.float32(1e-30)
    return x


def test_cluster_route_last_slice_tiny_samples_and_peak_on_card(cuda):
    """A tiny sample in the last block moves only its own thread to polar(),
    which gives every other sample the plain root and phase; a peak in the
    last block sets every block's normalization."""
    x = _last_slice_frames(seed=32)
    assert np.abs(x[1]).argmax() >= LONG_N - LONG_M
    _assert_kernels_match_plain(x, cuda, k2=False)


def _slice_step_frames():
    """Frames whose phase jumps at every slice boundary: samples of phase
    2.9 r plus noise in slice r (steps of ~2.9 rad between slices, which
    wrap past pi) and log-normal amplitudes (a constant one would leave
    |x| / mean|x| - 1 to roundoff); real samples whose sign flips every 64
    samples and so at each boundary (steps of exactly +-pi, np.unwrap's
    edge rule); and every third sample (I < 0, Q = -0.0), which puts -0.0
    samples on both sides of the boundaries."""
    k = np.arange(LONG_N)
    rng = np.random.default_rng(33)
    jump = np.exp(0.3 * rng.standard_normal(LONG_N)
                  + 1j * (2.9 * (k // LONG_M) + 0.3 * rng.standard_normal(LONG_N)))
    flip = np.where((k // 64) % 2 == 0, 1.0, -1.0) * (1 + 0.5 * (k % 3 == 0))
    nz = (rng.standard_normal(LONG_N) + 1j * rng.standard_normal(LONG_N)).astype(np.complex64)
    nz.real[::3] = -np.abs(nz.real[::3])
    nz.imag[::3] = -0.0
    x = np.stack([jump, flip, nz]).astype(np.complex64)
    x.imag[1] = 0.0
    assert np.signbit(x.imag[2, ::3]).all()
    assert np.signbit(x.imag[2, LONG_M * 3])  # the last slice's first sample
    return x


def test_cluster_route_phase_steps_across_slices_follow_oracle_on_card(cuda):
    """The phase step after each slice's last sample reads the next block's
    first phase: the wrap's floor-mod, the +-pi edge rule and numpy's signed
    zero across the boundaries, against the float64 oracle."""
    x = _slice_step_frames()
    got, ran = _k1_launch(*_planes(x, cuda))
    assert ran == ["cluster"]
    _assert_within(got.cpu().numpy(), features_batch(x), x, 1e-4, 1e-5)


def test_frames_of_neither_route_reroute_by_shape_on_card(cuda):
    """N = 2^19 fits neither route: ``extract_features_fused`` raises before
    any launch, and ``extract_features_fused_any`` answers through the plain
    extractor, counted as a reroute."""
    n = 1 << 19
    assert fused_route(n) == ("none", 0)
    x = _frames(2, n, seed=34)
    i, q = _planes(x, cuda)
    launches = extract_features_fused.launches
    with pytest.raises(ValueError, match="neither route"):
        extract_features_fused(i, q)
    reroutes = extract_features_fused_any.reroutes
    got = extract_features_fused_any(i, q)
    assert extract_features_fused_any.reroutes == reroutes + 1
    assert extract_features_fused.launches == launches
    want = F._extract_planar(i, q, normalize_scale=True, compute_gmax=True,
                             gmax_mode="matmul")
    assert torch.equal(got, want)


def test_fused_route_follows_the_library(cuda):
    """``fused_route`` names the route and C that ``amc_fused_route`` takes,
    at every multiple of 32 up to 140,000 and at the edges; every cluster
    size can be held by the card (``cudaOccupancyMaxActiveClusters``)."""
    from amcpy_tpu_torch.ops.fused import cluster_occupancy, library_route

    sizes = list(range(32, 140_000, 32)) + [10, 88, 1000, 16383, 18944, 18945, 36864,
                                            1 << 19]
    wrong = [n for n in sizes if library_route(n) != fused_route(n)]
    assert not wrong, wrong[:10]
    for c in range(2, 9):
        assert fused_route(c * LONG_M) == ("cluster", c)
        assert cluster_occupancy(c * LONG_M, 0)[0] > 0


def test_cluster_shape_follows_the_library(cuda):
    """``cluster_shape``, the plain mirror of the cluster route's launch (C,
    M, threads a block), equals the library's ``amc_fused_cluster_shape`` at
    every multiple of 32 up to 140,000 and at the edges, (0, 0, 0) off the
    route; the library gives no shared memory off the route; and at the
    route's C = 2 ... 8 a block fits one block's shared memory and the card
    holds a cluster of such blocks, at least one an SM."""
    from amcpy_tpu_torch.ops.fused import (
        SMEM_LIMIT,
        cluster_occupancy,
        cluster_shape,
        library_cluster_shape,
    )

    sizes = list(range(32, 140_000, 32)) + [10, 88, 1000, 16383, 18944, 18945, 20480,
                                            36864, 1 << 19]
    lib = {n: library_cluster_shape(n) for n in sizes}
    wrong = [n for n in sizes
             if lib[n][:3] != cluster_shape(n) or (lib[n][0] == 0) != (lib[n][3] == 0)]
    assert not wrong, [(n, cluster_shape(n), lib[n]) for n in wrong[:5]]
    for n in CLUSTER_SIZES:
        c, m, threads, smem = library_cluster_shape(n)
        assert (c, m) == (fused_route(n)[1], n // c) and threads == 1024
        clusters, blocks = cluster_occupancy(n, 0)
        assert 0 < smem <= SMEM_LIMIT and clusters > 0 and blocks >= 1


def test_long_frames_through_the_entry_points_on_card(cuda, tmp_path):
    """``extract_batch`` (kernel "auto") and ``AMCPipeline`` at N = 65536
    run the cluster route and agree with the plain versions."""
    from amcpy_tpu_torch.extraction import extract_batch
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    x = _frames(12, LONG_N, seed=35, spread=1.0)
    by_route = dict(extract_features_fused.launches_by_route)
    got = extract_batch(x, kernel="auto", device=cuda)
    assert extract_features_fused.launches_by_route["cluster"] > by_route["cluster"]
    assert extract_features_fused.launches_by_route["block"] == by_route["block"]
    want = extract_batch(x, kernel="xla", device=cuda)
    _assert_within(np.asarray(got), np.asarray(want), x, 2e-4, 2e-5)
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals={"frame_size": LONG_N})
    cols = list(cfg.features.used_columns)
    scaler = Standardizer.fit(np.asarray(want)[:, cols])
    torch.manual_seed(0)
    model = AMCClassifier(6)
    pipes = {k: AMCPipeline(model, scaler, cfg.replace(compute={"kernel": k}), device=cuda)
             for k in ("auto", "xla")}
    assert pipes["auto"].route == "k1"
    torch.testing.assert_close(pipes["auto"].logits(x), pipes["xla"].logits(x),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("n", [2, 6, 88, 1000, 1023, 2048, 2049, 16384])
def test_stats_path_follows_the_library(cuda, n):
    """``stats_path`` names the route ``amc_stats_path`` takes."""
    from amcpy_tpu_torch.ops import _build

    code = _build.load("features").amc_stats_path(n)
    assert stats_path(n) == {1: "warpgroup", 0: "block"}[code]


def test_gmax_path_follows_n2(cuda):
    """The library's own choice: the in-block FFT wherever N2 is a power of
    two, the direct stage 2 elsewhere; the host plan agrees."""
    from amcpy_tpu_torch.ops.fft import best_factorization, fft_plan
    from amcpy_tpu_torch.ops.fused import gmax_path

    assert gmax_path(2048) == "fft" and gmax_path(16384) == "fft"
    assert gmax_path(1000) == "direct" and gmax_path(88) == "direct"
    for n in (64, 256, 1000, 2048, 4096, 4608, 12288, 16384, 88, 3000):
        want = "fft" if fft_plan(*best_factorization(n)) else "direct"
        assert gmax_path(n) == want, n


def test_fft_path_reads_no_dft_table(cuda):
    """At N = 2048 the kernel is given the W_N twiddles and null pointers
    for the cluster route's W_M, the W_N1, twiddle and W_N2 tables: a read
    of any of them would fault. Its output equals the wrapper's."""
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fft import device_fft_twiddles

    x = _frames(16, 2048, seed=12)
    i, q = _planes(x, cuda)
    want = extract_features_fused(i, q)
    lib = _build.load("features")
    out = torch.empty_like(want)
    err = lib.amc_fused_features(
        i.data_ptr(), q.data_ptr(), device_fft_twiddles(2048, cuda).data_ptr(),
        0, 0, 0, 0, 0, 0, 0, out.data_ptr(), 16, 2048, 8, 256, 1,
        torch.cuda.current_stream(cuda).cuda_stream,
    )
    _build.check(lib, err, "amc_fused_features")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


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
    assert pipes["auto"].route == "k1"
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


K3_TOL = 2e-2
DEFAULT_WIDTHS = (2, 32, 64, 128)


def _stack(widths, dev, seed=1):
    """A folded k=1 stack: (C_out, C_in) weights of scale 1/sqrt(C_in) and
    (C_out, 1) biases, numpy-seeded."""
    rng = np.random.default_rng(seed)
    return [
        (torch.from_numpy(rng.normal(0, a**-0.5, (b, a)).astype(np.float32)).to(dev),
         torch.from_numpy(rng.normal(0, 0.1, (b, 1)).astype(np.float32)).to(dev))
        for a, b in zip(widths[:-1], widths[1:])
    ]


def _assert_trunk_matches(i, q, convs):
    launches = cnn_trunk.launches
    got = cnn_trunk(i, q, convs)
    torch.cuda.synchronize()
    assert cnn_trunk.launches == launches + 1
    want = cnn_trunk_plain(i, q, convs)
    assert got.shape == want.shape == (i.shape[0], 2 * convs[-1][0].shape[0])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=K3_TOL, rtol=K3_TOL)


def _library_path(widths):
    """The library's own route for a stack: "wgmma", "mma_sync" or None
    (refused)."""
    import ctypes

    from amcpy_tpu_torch.ops import _build

    c_widths = (ctypes.c_int * len(widths))(*widths)
    code = _build.load("cnn_trunk").amc_cnn_trunk_path(c_widths, len(widths) - 1)
    return {2: "wgmma", 1: "mma_sync", 0: None}[code]


@pytest.mark.parametrize(
    "b,n",
    [(4096, 2048), (1000, 2048), (37, 1024), (64, 256), (5, 1000), (3, 100),
     (3, 40), (1, 2048), (3, 64), (2, 1)],
)
def test_cnn_trunk_matches_plain_on_card(cuda, b, n):
    """The default stack on its wgmma route: the smoke's shapes, time axes
    that end in a ragged tile (1000, 100 and 40 samples are not multiples
    of the kernel's 64; 40 and 1 are shorter than one tile) and batches
    smaller than the warpgroups resident on the card (1, 2, 3, 5)."""
    assert trunk_path(DEFAULT_WIDTHS) == _library_path(DEFAULT_WIDTHS) == "wgmma"
    x = _frames(b, n, seed=b + n)
    _assert_trunk_matches(*_planes(x, cuda), _stack(DEFAULT_WIDTHS, cuda))


def _one_hot(n_out, n_in, mult, add, dev):
    """(n_out, n_in) weights whose row o holds a single 1 at column
    (mult * o + add) % n_in, and zero (n_out, 1) biases."""
    cols = (mult * np.arange(n_out) + add) % n_in
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), cols] = 1.0
    return (torch.from_numpy(w).to(dev), torch.zeros((n_out, 1), device=dev)), cols


@pytest.mark.parametrize("n", [2048, 100])
def test_cnn_trunk_wgmma_layout_with_one_hot_weights(cuda, n):
    """With one-hot (permutation) weights and zero biases each output
    channel of the default stack copies one channel of layer 0, so a wrong
    descriptor, core-matrix layout or fragment mapping shows as a readable
    permutation: each pooled output is matched to the layer-0 channel whose
    pooled (mean, max) it equals, and the map is compared with the one the
    weights name."""
    rng = np.random.default_rng(17)
    w0 = torch.from_numpy(rng.normal(0, 1, (32, 2)).astype(np.float32)).to(cuda)
    layer0 = (w0, torch.zeros((32, 1), device=cuda))
    layer1, cols1 = _one_hot(64, 32, 13, 7, cuda)
    layer2, cols2 = _one_hot(128, 64, 37, 5, cuda)
    want_map = cols1[cols2]
    x = _frames(8, n, seed=18)
    i, q = _planes(x, cuda)
    got = cnn_trunk(i, q, [layer0, layer1, layer2]).cpu().double().numpy()
    # layer 0 pooled after its bf16 rounding (an identity layer rounds it)
    eye = (torch.eye(32, device=cuda), torch.zeros((32, 1), device=cuda))
    h0 = cnn_trunk_plain(i, q, [layer0, eye]).cpu().double().numpy()  # (8, 2 * 32)
    h0 = np.stack([h0[:, :32], h0[:, 32:]], -1)  # (frame, channel, mean/max)
    out = np.stack([got[:, :128], got[:, 128:]], -1)  # (frame, o, mean/max)
    dist = np.abs(out[:, :, None, :] - h0[:, None, :, :]).sum(axis=(0, 3))
    seen_map = dist.argmin(axis=1)
    wrong = np.nonzero(seen_map != want_map)[0]
    assert wrong.size == 0, {
        "output channels": wrong[:16].tolist(),
        "copy layer-0 channel": seen_map[wrong[:16]].tolist(),
        "should copy": want_map[wrong[:16]].tolist(),
    }
    _assert_trunk_matches(i, q, [layer0, layer1, layer2])


@pytest.mark.parametrize("log_scale", [-6.0, 6.0])
def test_cnn_trunk_extreme_scales(cuda, log_scale):
    """Frames at exp(+-6) neither overflow nor underflow the sum of squares."""
    x = _frames(64, 2048, seed=3, spread=0.0) * np.float32(np.exp(log_scale))
    _assert_trunk_matches(*_planes(x, cuda), _stack(DEFAULT_WIDTHS, cuda))


@pytest.mark.parametrize(
    "widths",
    [(2, 32), (2, 32, 64), (2, 20), (2, 16, 48, 32, 16), (2, 1), (2, 32, 64, 128, 16),
     (2, 32, 64, 112), (2, 16, 64, 128), (2, 16, 1024), (2,) + (16,) * 8],
)
def test_cnn_trunk_other_stacks(cuda, widths):
    """L = 1 (no tensor-core layer, any width), L = 2, deeper stacks, the
    default stack with a layer more or a width changed, a wide last layer
    and eight layers: the mma.sync route, launched and counted as such."""
    assert trunk_path(widths) == _library_path(widths) == "mma_sync"
    x = _frames(50, 700, seed=4)
    by_path = dict(cnn_trunk.launches_by_path)
    _assert_trunk_matches(*_planes(x, cuda), _stack(widths, cuda))
    assert cnn_trunk.launches_by_path == {**by_path, "mma_sync": by_path["mma_sync"] + 1}


@pytest.mark.parametrize(
    "widths",
    [(2, 24, 40), (2, 32, 64, 72), (2,) + (16,) * 9, (2, 3000), (2, 16, 2048),
     (2, 256, 256), (2, 512, 512)],
)
def test_cnn_trunk_refuses_widths_it_cannot_hold(cuda, widths):
    """Layers after the first need multiples of 16 channels; at most eight
    layers; at most 227 KB of shared memory. The library refuses
    (``amc_cnn_trunk_path`` and ``amc_cnn_trunk_smem`` give 0), and the
    wrapper raises before any launch, never computing a wrong answer."""
    import ctypes

    from amcpy_tpu_torch.ops import _build

    assert _library_path(widths) is None
    c_widths = (ctypes.c_int * len(widths))(*widths)
    assert _build.load("cnn_trunk").amc_cnn_trunk_smem(c_widths, len(widths) - 1) == 0
    i, q = _planes(_frames(4, 64, seed=5), cuda)
    launches = cnn_trunk.launches
    with pytest.raises(ValueError, match="cannot hold"):
        cnn_trunk(i, q, _stack(widths, cuda))
    assert cnn_trunk.launches == launches


def test_cnn_pipeline_launches_the_trunk_once_per_request(cuda, tmp_path):
    """A default IQConvNet checkpoint under kernel="auto" runs K3 once per
    request; a k>1 or float32 checkpoint runs the module forward (no
    launch). The two routes agree within the JAX package's 0.08."""
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint

    cfg = Config().replace(paths={"root": str(tmp_path)}, signals={"frame_size": 512})
    identity = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    torch.manual_seed(0)
    for name, arch in (("default", {}), ("wide", {"kernel_sizes": (3, 1, 1)}),
                       ("f32", {"dtype": "float32"})):
        save_checkpoint(cfg, name, IQConvNet(6, **arch), identity)
    x = _frames(300, 512, seed=6, spread=1.0)
    pipe = AMCPipeline.from_checkpoint(cfg, "default", device=cuda)
    assert pipe.route == "k3"
    for frames in (x, F.to_planar(x), x[:1]):
        launches = cnn_trunk.launches
        on_wgmma = cnn_trunk.launches_by_path["wgmma"]
        pipe.logits(frames)
        assert cnn_trunk.launches == launches + 1
        assert cnn_trunk.launches_by_path["wgmma"] == on_wgmma + 1
    module = AMCPipeline.from_checkpoint(
        cfg.replace(compute={"kernel": "xla"}), "default", device=cuda
    )
    torch.testing.assert_close(pipe.logits(x), module.logits(x), atol=0.08, rtol=0)
    for name in ("wide", "f32"):
        other = AMCPipeline.from_checkpoint(cfg, name, device=cuda)
        assert other.route == "module"
        launches = cnn_trunk.launches
        assert other.logits(x).shape == (300, 6)
        assert cnn_trunk.launches == launches


def _data_free(key: str) -> bool:
    """Biases of the layers that feed a BatchNorm, and the running means
    that absorb them: their gradient is zero in exact arithmetic, so one
    step moves them by roundoff that an adaptive optimizer scales up."""
    return re.fullmatch(r"(dense|conv)\.\d+\.bias", key) is not None or key.endswith(
        "running_mean")


def _step_on(device, model, cfg, x, y):
    """(loss, state_dict on the CPU) after one optimizer step of a copy of
    ``model`` on ``device``."""
    import copy

    from amcpy_tpu_torch.train.training import make_optimizer, train_step
    from amcpy_tpu_torch.utils.device import no_tf32

    model = copy.deepcopy(model).to(device)
    with no_tf32():
        loss, _ = train_step(model, make_optimizer(cfg, model.parameters()),
                             x.to(device), y.to(device))
    return float(loss), {k: v.cpu() for k, v in model.state_dict().items()}


def _assert_steps_agree(got, want, loss_rtol, rel):
    """Losses within ``loss_rtol``; every tensor a step determines within
    ``rel`` of its largest value."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    for key, w in want[1].items():
        if _data_free(key) or key.endswith("num_batches_tracked"):
            continue
        err = float((got[1][key].double() - w.double()).abs().max())
        assert err <= rel * float(w.double().abs().max()), (key, err)


def test_mlp_train_step_on_card_matches_cpu(cuda):
    """One RMSprop step of the default MLP (dropout 0, TF32 off) on the
    card from the CPU's weights and batch: the CPU's parameters and batch
    statistics within 1e-5 of each tensor's largest value."""
    from amcpy_tpu_torch.models.classifier import AMCClassifier

    torch.manual_seed(1)
    model = AMCClassifier(6, dropout=0.0)
    x = torch.randn(128, 6) * 1.5
    y = torch.randint(0, 6, (128,))
    cfg = Config()
    _assert_steps_agree(_step_on(cuda, model, cfg, x, y),
                        _step_on(torch.device("cpu"), model, cfg, x, y), 1e-5, 1e-5)


def test_bf16_cnn_train_step_on_card_matches_cpu(cuda):
    """One Adam step of the default bf16 IQConvNet (dropout 0) on 32 frames
    of 2048 samples, card against CPU: loss rtol 5e-3, every tensor the
    step determines within 1e-2 of its largest value (bf16 activations and
    their gradients rounded from float32 values whose last bits differ, as
    in ``tests/test_torch_cnn_train.py``)."""
    from amcpy_tpu_torch.models.cnn import IQConvNet

    torch.manual_seed(2)
    model = IQConvNet(6, dropout=0.0)
    x = torch.from_numpy(F.to_planar(_frames(32, 2048, seed=7, spread=1.0)))
    y = torch.randint(0, 6, (32,))
    cfg = Config().replace(training={"optimizer": "adam", "learning_rate": 3e-4})
    _assert_steps_agree(_step_on(cuda, model, cfg, x, y),
                        _step_on(torch.device("cpu"), model, cfg, x, y), 5e-3, 1e-2)


def test_wide_stack_training_on_card_matches_cpu(cuda):
    """The k=8 stride-2 stack of the CNN record's control arm (default
    widths, dropout 0) trained 30 RMSprop steps at the config's lr on 1,280
    frames of 512 samples, batch 128, on the card and on the CPU from the
    same weights and orders, in float32 and in bf16 (the card's strided
    convolutions are cuDNN's): at every step the loss, every weight tensor
    and every weight's gradient within 4 times the devices' own spreads up
    to that step (the same steps from a start moved by 2^-20, the
    data-free conv biases at +-lr, and with the rows of each batch
    permuted) or the floor, and each conv layer's max|bias| within 4 of the
    CPU's and below its product's std; a fault planted in the card's
    strided convolution (kernels, or their gradient, flipped in time)
    leaves those bars (``scripts/torch_training_card_vs_cpu.py``)."""
    from scripts.torch_training_card_vs_cpu import PLANTS, card_vs_cpu

    for dtype in ("float32", "bfloat16"):
        result = card_vs_cpu(dtype, cuda)
        assert result["steps"] == 30
        assert result["ok"], (dtype, result["failures"])
        assert all(result["planted"][f]["caught"] for f in PLANTS), dtype


def _mlp_pipeline(cuda, tmp_path, n, **compute):
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    cfg = Config().replace(paths={"root": str(tmp_path)}, signals={"frame_size": n},
                           compute=compute)
    feats = F.extract_features(_frames(64, n, seed=12, spread=1.0), device="cpu").numpy()
    scaler = Standardizer.fit(feats[:, list(cfg.features.used_columns)])
    torch.manual_seed(3)
    return AMCPipeline(AMCClassifier(6), scaler, cfg, device=cuda)


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_pinned_host_path_gives_the_cpu_planes(cuda, tmp_path, kernel):
    """The staged copy and the split on the card give the planes (K1, K3)
    or the packed frames (the other routes) that the CPU path gives, for
    complex64, complex128, planar and non-contiguous requests."""
    pipe = _mlp_pipeline(cuda, tmp_path, 256, kernel=kernel)
    cpu = _mlp_pipeline(torch.device("cpu"), tmp_path, 256, kernel=kernel)
    cpu._wants_planes = pipe._wants_planes
    x = _frames(33, 256, seed=13)
    for frames in (x, x.astype(np.complex128), F.to_planar(x), x[::2],
                   np.asfortranarray(F.to_planar(x))):
        got, want = pipe._to_device(frames), cpu._to_device(frames)
        assert len(got) == len(want) == (2 if kernel == "auto" else 1)
        for g, w in zip(got, want):
            assert g.is_cuda and g.is_contiguous() and g.dtype == torch.float32
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    # complex128 crosses as complex64: 8 bytes a sample at most
    assert pipe._staging.capacity == 1 << (33 * 256 * 8 - 1).bit_length()


def test_staging_buffer_reuse_is_safe_across_two_requests_in_flight(cuda):
    """The second upload waits until the first copy has left the buffer:
    with the stream held back by a spin kernel, request A's copy is still
    queued when request B is written, and A arrives intact."""
    from amcpy_tpu_torch.serve import _Staging

    stage = _Staging(cuda)
    a = np.arange(1 << 20, dtype=np.float32)
    b = -np.arange(1 << 20, dtype=np.float32)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning ahead of A's copy
    (got_a,) = stage.upload([(a, np.float32)])
    (got_b,) = stage.upload([(b, np.float32)])
    torch.testing.assert_close(got_a.cpu(), torch.from_numpy(a), rtol=0, atol=0)
    torch.testing.assert_close(got_b.cpu(), torch.from_numpy(b), rtol=0, atol=0)
    c = np.ones((3, 5), np.int16)
    got = stage.upload([(c, np.int16), (a[:7], np.float32), (c.astype(np.uint8), np.uint8)])
    assert [t.dtype for t in got] == [torch.int16, torch.float32, torch.uint8]
    assert [tuple(t.shape) for t in got] == [(3, 5), (7,), (3, 5)]
    torch.testing.assert_close(got[1].cpu(), torch.from_numpy(a[:7]), rtol=0, atol=0)


def _bits(a) -> np.ndarray:
    """The bytes of a host array or of a tensor's copy on the host."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a).view(np.uint8)


def test_staging_upload_of_pieces_is_the_upload_of_their_concatenate(cuda):
    """A part given as a list of arrays arrives as the upload of their
    concatenate, bit for bit: complex64 ``(B, N)`` pieces, planar float32
    ``(B, 2, N)`` pieces, one piece of one frame, and a list beside an
    ordinary part."""
    from amcpy_tpu_torch.serve import _Staging

    stage = _Staging(cuda)
    x = _frames(9, 256, seed=15)
    cplx = [x[:4], x[4:5], x[5:]]
    planar = [F.to_planar(p) for p in cplx]
    for pieces, dt in ((cplx, np.complex64), (planar, np.float32), (cplx[1:2], np.complex64)):
        (got,) = stage.upload([(pieces, dt)])
        (want,) = stage.upload([(np.concatenate(pieces), dt)])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    extra = np.arange(7, dtype=np.float32)
    got = stage.upload([(cplx, np.complex64), (extra, np.float32)])
    assert [tuple(t.shape) for t in got] == [(9, 256), (7,)]
    np.testing.assert_array_equal(_bits(got[0]), _bits(x))
    np.testing.assert_array_equal(_bits(got[1]), _bits(extra))


def test_staging_of_pieces_waits_for_the_last_copy(cuda):
    """The buffer's reuse stays safe when a part is written in pieces:
    with the stream held back by a spin kernel, request A's copy is still
    queued when request B's pieces are written, and A arrives intact."""
    from amcpy_tpu_torch.serve import _Staging

    stage = _Staging(cuda)
    a = np.arange(1 << 20, dtype=np.float32).reshape(1024, 1024)
    b = -a
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning ahead of A's copy
    (got_a,) = stage.upload([([a[:500], a[500:501], a[501:]], np.float32)])
    (got_b,) = stage.upload([([b[:1], b[1:]], np.float32)])
    np.testing.assert_array_equal(_bits(got_a), _bits(a))
    np.testing.assert_array_equal(_bits(got_b), _bits(b))


def test_a_coalesced_request_gives_the_logits_of_its_concatenate(cuda, tmp_path):
    """A request of several arrays (the server's coalesced group) is
    written into the staging buffer in pieces, runs K1 and the MLP, or K3
    and the head, once, and gives exactly the logits of its concatenate."""
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint

    mlp = _mlp_pipeline(cuda, tmp_path / "mlp", 256)
    assert mlp.route == "k1"
    cfg = Config().replace(paths={"root": str(tmp_path / "cnn")}, signals={"frame_size": 512})
    torch.manual_seed(0)
    save_checkpoint(cfg, "cnn", IQConvNet(6),
                    Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32)))
    cnn = AMCPipeline.from_checkpoint(cfg, "cnn", device=cuda)
    assert cnn.route == "k3"
    for pipe, n, counter in ((mlp, 256, extract_features_fused), (cnn, 512, cnn_trunk)):
        x = _frames(40, n, seed=16, spread=1.0)
        for req in ([x[:17], x[17:18], x[18:]], [F.to_planar(x[:3]), F.to_planar(x[3:])]):
            want = pipe.logits(np.concatenate(req))
            launches, in_place = counter.launches, pipe.coalesced_in_place
            got = pipe.logits(req)
            assert counter.launches == launches + 1
            assert pipe.coalesced_in_place == in_place + 1
            assert torch.equal(got, want)
        assert pipe.coalesced_concatenated == 0


def test_int24_program_launches_k1_once_a_request(cuda, tmp_path):
    """``wire_format: int24``: a request of 512 frames or more is decoded on
    the card and runs K1 once; logits within 1e-3 of the float32 program,
    at least 99 % identical argmax; a smaller request takes float32."""
    wire = _mlp_pipeline(cuda, tmp_path, 1024, wire_format="int24")
    f32 = _mlp_pipeline(cuda, tmp_path, 1024)
    assert wire._wire == "int24" and wire._kernel == "fused"
    x = _frames(600, 1024, seed=14, spread=1.0)
    for frames, eligible in ((x, True), (F.to_planar(x), True), (x[:511], False)):
        assert wire._wire_eligible(len(frames), 1024) == eligible
        launches = extract_features_fused.launches
        got = wire.logits(frames)
        assert extract_features_fused.launches == launches + 1
        want = f32.logits(frames)
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
        assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.99


def test_gen_planes_statistics_on_card(cuda):
    """The frames drawn on the card (Philox): noise power per SNR level
    within 5 standard errors of 10^(-snr/10) (the noise isolated by drawing
    the same stream at 200 dB), |x| at 200 dB on the constellation's
    magnitudes within 1e-5, WGN of unit power (``tests/test_torch_synth.py``
    holds the CPU's stream to the same bars)."""
    from amcpy_tpu_torch.data import synth

    snr = (-10, 0, 10, 20)
    for mod in ("BPSK", "16QAM", "64QAM"):
        def planes(levels):
            i, q = synth.gen_planes(synth.seeded_generator(3, cuda), synth.points_of(mod),
                                    levels, 64, 512, True, cuda)
            return i.double(), q.double()

        i, q = planes(snr)
        i0, q0 = planes((200,) * len(snr))
        p = ((i - i0) ** 2 + (q - q0) ** 2).reshape(len(snr), -1)
        want = torch.tensor([10.0 ** (-s / 10.0) for s in snr], dtype=torch.float64, device=cuda)
        se = p.std(dim=1) / p.shape[1] ** 0.5
        assert ((p.mean(dim=1) - want).abs() <= 5 * se).all(), mod
        mags = torch.tensor(np.unique(np.round(np.abs(synth.points_of(mod)), 12)), device=cuda)
        dist = (torch.hypot(i0, q0)[..., None] - mags).abs().min(dim=-1).values
        assert float(dist.max()) <= 1e-5, mod
    i, q = synth.gen_planes(synth.seeded_generator(4, cuda), None, snr, 64, 512, True, cuda)
    p = (i.double() ** 2 + q.double() ** 2).reshape(len(snr), -1)
    assert ((p.mean(dim=1) - 1).abs() <= 5 * p.std(dim=1) / p.shape[1] ** 0.5).all()


def test_entry_points_draw_the_same_frames_on_card(cuda, tmp_path):
    """``generate_dataset`` and ``gen_planes`` on the card give the same
    frames for a seed, and the card's stream is not the CPU's."""
    from amcpy_tpu_torch.data import synth

    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"num_frames": 5, "frame_size": 256, "snr_db": (0, 10)})
    data = synth.generate_dataset(cfg, seed=6, device=cuda)
    mi = cfg.signals.modulations_with_noise.index("QPSK")
    i, q = synth.gen_planes(synth.seeded_generator(6 * 1000 + mi, cuda), synth.points_of("QPSK"),
                            (0, 10), 5, 256, True, cuda)
    np.testing.assert_array_equal(data["signal_qpsk"].real.reshape(10, 256), i.cpu().numpy())
    np.testing.assert_array_equal(data["signal_qpsk"].imag.reshape(10, 256), q.cpu().numpy())
    again = synth.generate_dataset(cfg, seed=6, device=cuda)
    np.testing.assert_array_equal(again["signal_noise"], data["signal_noise"])
    on_cpu = synth.generate_dataset(cfg, seed=6, device="cpu")
    assert not np.array_equal(on_cpu["signal_qpsk"], data["signal_qpsk"])


def test_synthetic_extraction_launches_k1_once_a_chunk(cuda, tmp_path, monkeypatch):
    """``run_extraction_synthetic`` on the card: one K1 launch per chunk
    (30 rows a modulation in chunks of 8: 4 launches each, the last one
    ragged), the features within K1's tolerance of the plain extractor on
    the same frames, and equal to ``write_dataset`` + ``run_extraction``."""
    from amcpy_tpu_torch import extraction
    from amcpy_tpu_torch.data import synth

    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"num_frames": 6, "frame_size": 2048,
                                    "snr_db": (-10, 0, 5, 10, 20)})
    monkeypatch.setattr(extraction, "_default_chunk_size", lambda dev, n: 8)
    extract_features_fused.launches = 0
    got = extraction.run_extraction_synthetic(cfg, seed=4, device=cuda)
    assert extract_features_fused.launches == 6 * 4
    synth.write_dataset(cfg, seed=4, device=cuda)
    host = extraction.run_extraction(cfg, force=True, device=cuda)
    data = synth.generate_dataset(cfg, seed=4, device=cuda)
    for mod, feats in got.items():
        frames = data[cfg.signals.mat_info[mod]].reshape(-1, 2048)
        want = F.extract_features_planar(torch.from_numpy(F.to_planar(frames)).to(cuda))
        _assert_within(feats.reshape(-1, 18), want.cpu().double().numpy(), frames, 2e-4, 2e-5)
        _assert_within(feats.reshape(-1, 18), host[mod].reshape(-1, 18), frames, 2e-4, 2e-5)


@pytest.fixture
def nccl_world(cuda, tmp_path, monkeypatch):
    """A process group of one rank over NCCL on the card (a ``file://``
    store), torn down after the test: two ranks cannot share one card."""
    import torch.distributed as dist

    from amcpy_tpu_torch.parallel.mesh import init_distributed

    for key in ("AMCPY_COORDINATOR", "AMCPY_NUM_PROCESSES", "AMCPY_PROCESS_ID", "WORLD_SIZE",
                "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed(f"file://{tmp_path}/store", 1, 0, device="cuda")
    assert dist.get_backend() == "nccl"
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dp_step_in_a_nccl_world_matches_the_plain_step(nccl_world, cuda):
    """One RMSprop step of the default MLP (dropout 0.4, its mask drawn
    from one seeded card generator) through the data-parallel path of a
    world of one, against the plain step: the loss and every tensor within
    1e-5 of its largest value (the same operations plus a sum over one
    rank), through seven all-reduces (three BatchNorm sums forward, three
    backward, the gradients)."""
    import copy

    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.parallel.audit import audit_collectives
    from amcpy_tpu_torch.parallel.mesh import data_shard, make_mesh
    from amcpy_tpu_torch.train.training import make_optimizer, train_step
    from amcpy_tpu_torch.utils.device import no_tf32

    torch.manual_seed(4)
    model = AMCClassifier(6).to(cuda)
    x = (torch.randn(128, 6) * 1.5).to(cuda)
    y = torch.randint(0, 6, (128,)).to(cuda)
    shard = data_shard(make_mesh())
    runs = []
    for s in (None, shard):
        m = copy.deepcopy(model)
        gen = torch.Generator(device=cuda).manual_seed(5)
        with no_tf32(), audit_collectives() as audit:
            loss, _ = train_step(m, make_optimizer(Config(), m.parameters()), x, y, gen, s)
        runs.append((float(loss), {k: v.cpu() for k, v in m.state_dict().items()}, audit))
    assert runs[0][2] == {} and runs[1][2]["all-reduce"]["count"] == 7
    _assert_steps_agree(runs[1][:2], runs[0][:2], 1e-5, 1e-5)


def test_pipeline_in_a_nccl_world_keeps_to_its_card(nccl_world, cuda, monkeypatch):
    """With two cards visible (the count faked), a pipeline outside a group
    fans out over both, and one built by a rank of a group keeps to its
    own card."""
    import torch.distributed as dist

    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    scaler = Standardizer(np.zeros(6, np.float32), np.ones(6, np.float32))
    # undone before the fixture tears the group down
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 2)
        pipe = AMCPipeline(AMCClassifier(6, in_features=6), scaler, Config(), device=cuda)
        assert pipe.devices == [pipe.device] and pipe.fanout(4096) is None
        m.setattr(dist, "is_initialized", lambda: False)
        alone = AMCPipeline(pipe.model, scaler, Config(), device=cuda)
        assert alone.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("mode", ["matmul", "fft"])
def test_sp_in_a_nccl_world_matches_plain(nccl_world, cuda, mode):
    """``extract_features_sp`` on the (1, 1) mesh at 4096 x 2048 on the
    card against the plain extractor: ``2e-4 * term_scales + 2e-5 *
    |want|``."""
    from amcpy_tpu_torch.parallel.mesh import make_mesh
    from amcpy_tpu_torch.parallel.sp import extract_features_sp

    x = _frames(4096, 2048, seed=21)
    i, q = _planes(x, cuda)
    got = extract_features_sp(i, q, make_mesh(shape=(1, 1)), gmax_mode=mode)
    assert got.device == i.device
    want = F._extract_planar(i, q, normalize_scale=True, compute_gmax=True, gmax_mode=mode)
    _assert_within(got.cpu().numpy(), want.cpu().numpy(), x, 2e-4, 2e-5)
