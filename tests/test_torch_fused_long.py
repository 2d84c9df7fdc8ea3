"""K1 for frames past one block's shared memory: the route rule
(``ops/fused.py::fused_route``, the library's ``amc_fused_route``), the
port's ``extract_batch`` at long frames against the JAX package's and the
float64 oracle, and a numpy model of the cluster route's arithmetic.

On the CPU the wrapper takes its plain version, so the CUDA kernel itself
is held to that version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). The model here pins the index arithmetic the kernel
implements before a card runs it: the C-point DFT over the slices
exchanged by place (block r reads its share of the places of every slice
and stores output k1 at those places into block k1's slice), the W_N
twiddle and the length-M FFT behind gamma_max, and the slices' partial
sums combined in rank order, the tiny-sample key and the phase step across
each slice boundary behind the statistics; and the launch's shape
(``cluster_shape``, the plain mirror of the library's).

Tolerances: the port against JAX ``2e-4 * term_scales + 2e-5 * |want|``
(``tests/test_fused.py``); against the float64 oracle, and the model
against it, ``1e-4 * term_scales + 1e-5 * |want|``.
"""

import numpy as np
import pytest
import torch

from amcpy_tpu.extraction import extract_batch as jax_extract_batch
from amcpy_tpu_torch.extraction import extract_batch
from amcpy_tpu_torch.ops.fft import fft_twiddles
from amcpy_tpu_torch.ops.fused import (
    SLICE_MAX,
    SLICE_MIN,
    cluster_shape,
    extract_features_fused,
    extract_features_fused_any,
    fused_route,
    split_planes,
)

from .oracle import features_batch
from .test_torch_features import _assert_within, _frames, _with_negative_zeros

#: the largest N whose best factorization fits one block (37 x 512)
BLOCK_MAX = 18944


@pytest.mark.parametrize(
    "n,want",
    [(2048, ("block", 1)), (16384, ("block", 1)), (BLOCK_MAX, ("block", 1)),
     (19456, ("none", 0)), (20480, ("cluster", 5)), (24576, ("cluster", 3)),
     (32768, ("cluster", 2)), (65536, ("cluster", 4)), (98304, ("cluster", 6)),
     (114688, ("cluster", 7)), (131072, ("cluster", 8)), (36864, ("none", 0)),
     (1 << 19, ("none", 0)), (10, ("none", 0)), (20011, ("none", 0))],
)
def test_fused_route_rule(n, want, monkeypatch):
    """K1's route follows N alone: one block where the best N1 x N2 split
    fits its shared memory; else the smallest cluster of C <= 8 blocks with
    N / C a power of two in [2048, 16384]; else neither (36864 = 9 x 4096,
    2^19 = 32 x 16384, 19456 = 19 x 1024, the prime 20011 and 10, which has
    no split). ``fused_route`` builds nothing (the card tests hold it equal
    to the library's ``amc_fused_route``)."""
    from amcpy_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("fused_route must not build the library")

    monkeypatch.setattr(_build, "load", no_build)
    assert fused_route(n) == want


@pytest.mark.parametrize(
    "n,want",
    [(20480, (5, 4096, 1024)), (24576, (3, 8192, 1024)),
     (32768, (2, 16384, 1024)), (65536, (4, 16384, 1024)),
     (131072, (8, 16384, 1024)), (BLOCK_MAX, (0, 0, 0)),
     (36864, (0, 0, 0)), (1 << 19, (0, 0, 0))],
)
def test_cluster_shape_rule(n, want, monkeypatch):
    """The cluster route's launch: C and M of the route and 1024 threads a
    block; nothing off the route. Built from nothing (the card tests hold it
    equal to the library's ``amc_fused_cluster_shape``, which also gives a
    block's shared memory)."""
    from amcpy_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("cluster_shape must not build the library")

    monkeypatch.setattr(_build, "load", no_build)
    assert cluster_shape(n) == want


#: every N the cluster route holds (C = 2 ... 8 the smallest, M a power of
#: two in [2048, 16384], N past one block), as it did before its launch
#: took 1024 threads a block
CLUSTER_ROUTE_SIZES = [20480, 24576, 28672, 32768, 40960, 49152, 57344, 65536,
                       81920, 98304, 114688, 131072]


def test_the_cluster_route_holds_the_sizes_it_held():
    """No N leaves the cluster route or joins it: the multiples of 32 up to
    140,000 that take it are exactly ``CLUSTER_ROUTE_SIZES``."""
    got = [n for n in range(32, 140_000, 32) if fused_route(n)[0] == "cluster"]
    assert got == CLUSTER_ROUTE_SIZES


@pytest.mark.parametrize("n", CLUSTER_ROUTE_SIZES)
def test_every_cluster_route_size_has_a_launch_that_fits(n):
    """Each N of the route keeps a kernel launch: C and M of the route,
    1024 threads a block, M within [2048, 16384] (the library asserts that
    the longest slice fits one block's shared memory) and whole 16-byte
    groups a slice (the slice's asynchronous copy)."""
    c, m, threads = cluster_shape(n)
    assert (c, c * m) == (fused_route(n)[1], n) and threads == 1024
    assert SLICE_MIN <= m <= SLICE_MAX and m % 4 == 0


def test_block_route_ends_where_the_cluster_route_begins():
    """No N above BLOCK_MAX takes the block route, and the first cluster
    size is 20480 = 5 x 4096."""
    routes = {n: fused_route(n)[0] for n in range(16384, 20481)}
    assert max(n for n, r in routes.items() if r == "block") == BLOCK_MAX
    assert min(n for n, r in routes.items() if r == "cluster") == 20480


@pytest.mark.parametrize("n", [20480, 32768, 65536])
def test_extract_batch_at_long_frames_matches_jax_and_oracle(n):
    """The port's ``extract_batch`` on the fused route (the CPU wrapper's
    plain version, no reroute) and on ``auto`` against JAX's on ``auto``
    (its XLA extractor off a TPU) and the float64 oracle."""
    x = _with_negative_zeros(_frames(3, n, seed=n))
    reroutes = extract_features_fused_any.reroutes
    got = extract_batch(x, kernel="fused", device="cpu")
    assert extract_features_fused_any.reroutes == reroutes
    auto = extract_batch(x, kernel="auto", device="cpu")
    want = jax_extract_batch(x, kernel="auto")
    assert got.shape == auto.shape == want.shape == (3, 18)
    _assert_within(got, want, x, 2e-4, 2e-5)
    _assert_within(auto, want, x, 2e-4, 2e-5)
    _assert_within(got, features_batch(x), x, 1e-4, 1e-5)


def test_frames_of_neither_route_reroute_by_shape():
    """N = 36864 = 9 x 4096 fits neither route: the wrapper raises, and the
    fused route of ``extract_batch`` answers through the counted reroute
    to the plain extractor."""
    n = 36864
    x = _frames(2, n, seed=5)
    i, q = (torch.from_numpy(p) for p in split_planes(x))
    with pytest.raises(ValueError, match="neither route"):
        extract_features_fused(i, q)
    reroutes = extract_features_fused_any.reroutes
    got = extract_batch(x, kernel="fused", device="cpu")
    assert extract_features_fused_any.reroutes == reroutes + 1
    _assert_within(got, features_batch(x), x, 1e-4, 1e-5)


def test_plain_gmax_takes_the_fft_past_the_table_cap():
    """N = 32792 = 8 x 4099 (a prime) has only splits with N2 = 4099 >
    ``MATMUL_MAX_N2``: the plain four-step product takes the FFT there (at
    N = 2^19 = 8 x 65536, where the reroute lands, its N2 x N2 table would
    take 64 GiB), and agrees with JAX's four-step product, which builds the
    4099 x 4099 table."""
    from amcpy_tpu.ops.fft import gmax_matmul as jax_gmax_matmul
    from amcpy_tpu_torch.ops.fft import MATMUL_MAX_N2, best_factorization, gmax_fft, gmax_matmul

    n = 32792
    assert best_factorization(n)[1] > MATMUL_MAX_N2
    x = _frames(2, n, seed=7)
    i, q = split_planes(x)
    got = gmax_matmul(torch.from_numpy(i), torch.from_numpy(q))
    assert torch.equal(got, gmax_fft(torch.from_numpy(i), torch.from_numpy(q)))
    want = np.asarray(jax_gmax_matmul(i, q))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


# ---- a numpy model of the cluster route ------------------------------------

F32 = np.float32
PI, TWO_PI = F32(np.pi), F32(2 * np.pi)
#: the bits of 2^-50, less 1 (``kTinyKey``)
TINY_KEY = np.uint32(0x26800000 - 1)


def _wrapped_freq(d):
    """``wrapped_freq`` of the kernel, in float32."""
    t = (d + PI).astype(F32)
    t = np.where(t >= TWO_PI, t - TWO_PI, np.where(t < 0, t + TWO_PI, t)).astype(F32)
    w = (t - PI).astype(F32)
    w = np.where((w == -PI) & (d > 0), PI, w)
    return (w / TWO_PI).astype(F32)


def _tiny_keys(i, q):
    """``tiny_key``: the bits of the larger component, less 1 (0 wraps)."""
    return (np.maximum(np.abs(i), np.abs(q)).astype(F32).view(np.uint32)
            - np.uint32(1))


def cluster_places(m, c, r):
    """The places of every slice that block r of a cluster of c reads and
    writes in gamma_max's C-point DFT: [r m / c, (r + 1) m / c)."""
    return np.arange(r * m // c, (r + 1) * m // c)


def model_gmax(x, c, touched=None):
    """X[k1 + C k2] by the cluster route's decomposition, as a (C, M) array
    [k1, k2], in the kernel's data flow: the C slices in the blocks' shared
    memory; block r, in rank order, loads its places (``cluster_places``) of
    every slice, forms the C outputs there (output k1 = sum over q in order
    of x_q W_C^{q k1}, W_C^{j} = W_N^{j M}, times W_N^{p k1}, both from the
    N-entry table) and stores output k1 into slice k1 at the same places;
    then block k1 takes the length-M FFT of its slice. ``touched``, where
    given, (C, M) counts, receives the loads and the stores of each place of
    each slice by any block."""
    n = x.size
    m = n // c
    tw = fft_twiddles(n).astype(np.float64) @ np.array([1, 1j])
    shared = x.astype(np.complex128).reshape(c, m).copy()
    for r in range(c):
        p = cluster_places(m, c, r)
        loaded = shared[:, p].copy()
        if touched is not None:
            touched[:, p] += 1
        for k1 in range(c):
            wc = tw[((np.arange(c) * k1) % c) * m]
            y = np.zeros(len(p), np.complex128)
            for q in range(c):
                y += wc[q] * loaded[q]
            shared[k1, p] = y * tw[p * k1]
            if touched is not None:
                touched[k1, p] += 1
    return np.stack([np.fft.fft(shared[k1]) for k1 in range(c)])


def model_features(x, c, normalize=True):
    """The 18 features of frame ``x`` as the cluster route takes them: each
    slice's float32 partial sums in its three passes, combined over the
    slices in rank order at each pass boundary; the phase step after a
    slice's last sample reads the next slice's first phase. Also returns
    the combined tiny key and the wrapped frequencies."""
    n = x.size
    m = n // c
    i, q = (pl[0] for pl in split_planes(x[None]))
    a = np.abs(x.astype(np.complex128)).astype(F32)
    p = np.arctan2(q, i).astype(F32)
    sl = [slice(r * m, (r + 1) * m) for r in range(c)]
    key = min(_tiny_keys(i[s], q[s]).min() for s in sl)
    # pass 1: sum |x|, sum |phase|, sum phase, max |x|
    s1 = np.zeros(4, F32)
    for s in sl:
        part = np.array([a[s].sum(dtype=F32), np.abs(p[s]).sum(dtype=F32),
                         p[s].sum(dtype=F32), 0], F32)
        s1[:3] += part[:3]
        s1[3] = max(s1[3], a[s].max())
    fn, fn1 = F32(n), F32(n - 1)
    mean_a, mean_ap, mean_p = s1[0] / fn, s1[1] / fn, s1[2] / fn
    amax = s1[3]
    scale = amax if normalize and amax > 0 else F32(1)
    xu = (x / scale).astype(np.complex64)
    # the phase steps: inside a slice the next sample's phase; after its last
    # sample, the next slice's first (none after the frame's last)
    freq = []
    for r, s in enumerate(sl):
        nxt = np.append(p[s][1:], p[(r + 1) * m] if r + 1 < c else np.nan)
        d = (nxt - p[s]).astype(F32)
        freq.append(_wrapped_freq(d[: m if r + 1 < c else m - 1]))
    cn = (a / mean_a - F32(1)).astype(F32)
    # pass 2: centred phase sums, |cn|, cn, frequency and the moment sums
    t2 = np.zeros(6, F32)
    mom = np.zeros(9, np.complex64)
    for r, s in enumerate(sl):
        t2 += np.array([((np.abs(p[s]) - mean_ap) ** 2).sum(dtype=F32),
                        ((p[s] - mean_p) ** 2).sum(dtype=F32),
                        np.abs(cn[s]).sum(dtype=F32), cn[s].sum(dtype=F32),
                        freq[r].sum(dtype=F32), 0], F32)
        z = xu[s]
        a2 = (z * z.conj()).real.astype(F32)
        z2 = z * z
        mom += np.array([z2.sum(), a2.sum(), (z2 * z2).sum(), (z2 * a2).sum(),
                         (a2 * a2).sum(), (z2 * z2 * z2).sum(),
                         (z2 * z2 * a2).sum(), (z2 * a2 * a2).sum(),
                         (a2 * a2 * a2).sum()], np.complex64)
    mean_acn, mean_cn, f_mu = t2[2] / fn, t2[3] / fn, t2[4] / fn1
    # pass 3: centred second and fourth powers
    u = np.zeros(5, F32)
    for r, s in enumerate(sl):
        da = np.abs(cn[s]) - mean_acn
        cc = (cn[s] - mean_cn) ** 2
        fc = (freq[r] - f_mu) ** 2
        u += np.array([(da * da).sum(dtype=F32), cc.sum(dtype=F32),
                       (cc * cc).sum(dtype=F32), fc.sum(dtype=F32),
                       (fc * fc).sum(dtype=F32)], F32)
    out = np.empty(18)
    out[0] = (np.abs(model_gmax(x, c)) ** 2).max() / n
    f_m2 = u[3] / fn1
    cn_m2 = u[1] / fn
    out[1:9] = [np.sqrt(t2[0] / fn1), np.sqrt(t2[1] / fn1), np.sqrt(u[0] / fn1),
                np.sqrt(f_m2 * fn1 / (fn1 - 1)), mean_a, np.sqrt(s1[0]) / fn,
                (u[2] / fn) / cn_m2**2, (u[4] / fn1) / f_m2**2]
    m20, m21, m40, m41, m42, m60, m61, m62, m63 = (mom / n).astype(np.complex128)
    m21, m42, m62, m63 = m21.real, m42.real, m62.real, m63.real
    m22, m43 = np.conj(m20), np.conj(m41)
    s2 = float(scale) ** 2
    out[9:18] = [
        np.abs(m20) * s2, np.abs(m21) * s2,
        np.abs(m40 - 3 * m20**2) * s2**2,
        np.abs(m41 - 3 * m20 * m21) * s2**2,
        np.abs(m42 - np.abs(m20) ** 2 - 2 * m21**2) * s2**2,
        np.abs(m60 - 15 * m20 * m40 + 3 * m20**3) * s2**3,
        np.abs(m61 - 5 * m21 * m40 - 10 * m20 * m41 + 30 * m20**2 * m21) * s2**3,
        np.abs(m62 - 6 * m20 * m42 - 8 * m21 * m41 - m22 * m40 + 6 * m20**2 * m22
               + 24 * m21**2 * m20) * s2**3,
        np.abs(m63 - 9 * m21 * m42 + 12 * m21**3 - 3 * m20 * m43 - 3 * m22 * m41
               + 18 * m20 * m21 * m22) * s2**3,
    ]
    return out, key, np.concatenate(freq)


def _model_frames(c, m, seed):
    """Gaussian frames of C x M samples with a scale spread: frame 0 with
    (I < 0, Q = -0.0) samples, frame 1 with its peak and tiny (1e-30) and
    subnormal samples in the last slice, frame 2 with phase steps of
    exactly +-pi at every slice boundary."""
    n = c * m
    x = _with_negative_zeros(_frames(3, n, seed=seed), step=3)
    x[1] = _frames(1, n, seed=seed + 1, scale_spread=False)[0]
    x[1, n - 2] = np.complex64(30 + 40j)
    x[1, n - m + 3::7] *= np.float32(1e-30)
    x[1, n - 1] *= np.float32(1e-41)
    k = np.arange(n)
    x[2] = np.where((k // m) % 2 == 0, 1.0, -1.0) * (1 + 0.5 * (k % 3 == 0))
    x.imag[2] = 0.0
    return x


@pytest.mark.parametrize("c", [2, 3, 5, 8])
def test_model_gmax_decomposition_matches_numpy_fft(c):
    """X[k1 + C k2] from the C-point DFT over the slices exchanged by
    place, the W_N^{m k1} twiddle and the length-M FFT equals ``np.fft.fft``
    of the whole frame (within the float32 rounding of the twiddle table);
    every place of every slice is loaded once and stored once, by the one
    block whose share of the places holds it."""
    m = 256
    x = _frames(1, c * m, seed=c)[0]
    touched = np.zeros((c, m), int)
    got = model_gmax(x, c, touched)
    want = np.fft.fft(x.astype(np.complex128))
    natural = got.T.reshape(-1)  # [k2, k1] -> k = k1 + C k2
    assert np.abs(natural - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(touched, 2)
    owners = np.concatenate([cluster_places(m, c, r) for r in range(c)])
    np.testing.assert_array_equal(owners, np.arange(m))


@pytest.mark.parametrize("c,m", [(3, 8192), (5, 4096), (5, 8192), (7, 4096), (7, 8192)])
def test_cluster_places_split_slices_the_route_holds(c, m):
    """At the route's C that do not divide M (24576 = 3 x 8192, 20480 =
    5 x 4096, ...) the blocks' shares of the places still cover the slice
    once, in order, and differ by at most one place."""
    parts = [cluster_places(m, c, r) for r in range(c)]
    np.testing.assert_array_equal(np.concatenate(parts), np.arange(m))
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1 and fused_route(c * m) == ("cluster", c)


@pytest.mark.parametrize("c,m", [(2, 2048), (3, 1024), (5, 512), (8, 256)])
def test_model_of_the_cluster_route_matches_oracle(c, m):
    """The model's 18 features of slices combined in rank order against the
    float64 oracle; its phase steps across the slice boundaries equal the
    whole frame's bit for bit; its combined tiny key says "tiny" exactly
    for the frame with a sample below 2^-50 (in its last slice)."""
    x = _model_frames(c, m, seed=10 * c)
    want = features_batch(x)
    for f, frame in enumerate(x):
        got, key, freq = model_features(frame, c)
        _assert_within(got[None], want[f][None], frame[None], 1e-4, 1e-5)
        i, q = (p[0] for p in split_planes(frame[None]))
        p = np.arctan2(q, i).astype(F32)
        np.testing.assert_array_equal(freq, _wrapped_freq((p[1:] - p[:-1]).astype(F32)))
        tiny = np.maximum(np.abs(i), np.abs(q))
        assert (key < TINY_KEY) == bool(((tiny > 0) & (tiny < 2.0**-50)).any()) == (f == 1)
