"""The port's host IO library binding (``amcpy_tpu_torch/data/native_io.py``):
the native library built from ``native/amc_io.cc`` and the NumPy path give
the same arrays, and the same arrays as the JAX package's
``amcpy_tpu/data/native_io.py``. The cases are those of
``tests/test_native_io.py``; the NumPy path is taken by making the loader
find no library."""

import numpy as np
import pytest

import amcpy_tpu.data.native_io as jax_nio
from amcpy_tpu_torch.data import native_io as nio


@pytest.fixture(params=["native", "numpy"])
def path_kind(request, monkeypatch):
    if request.param == "native":
        if not nio.available():
            pytest.skip("no C++ compiler: the native library cannot be built here")
    else:
        monkeypatch.setattr(nio, "_load", lambda: None)
        assert not nio.available()
    return request.param


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_library_builds_beside_the_package_not_into_native():
    if not nio.available():
        pytest.skip("no C++ compiler here")
    lib = nio._lib_path()
    assert lib.exists() and lib.parent.name == "amcpy_tpu_torch"
    assert lib.parent.parent.name == "build" and lib.name.startswith("libamc_io-")


@pytest.mark.parametrize("shape", [(7, 333), (7, 1, 333), (1, 64)])
def test_planarize_matches_jax(path_kind, shape):
    frames = _frames(shape, 0)
    got = nio.planarize(frames)
    assert got.shape == shape[:-1] + (2, shape[-1]) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_nio.planarize(frames))
    np.testing.assert_array_equal(got[..., 0, :], frames.real)
    np.testing.assert_array_equal(nio.deplanarize(got), frames)
    np.testing.assert_array_equal(nio.deplanarize(got), jax_nio.deplanarize(got))


@pytest.mark.parametrize("max_frames", [None, 2])
def test_read_stream_frames_matches_jax(path_kind, tmp_path, max_frames):
    payload = _frames((4096,), 2)
    path = tmp_path / "capture.bin"
    np.concatenate([np.zeros(2400, np.complex64), payload]).tofile(path)
    got = nio.read_stream_frames(path, frame_size=1024, max_frames=max_frames)
    want = jax_nio.read_stream_frames(path, frame_size=1024, max_frames=max_frames)
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((max_frames or 4), 2, 1024)
    np.testing.assert_array_equal(got, nio.planarize(payload.reshape(4, 1024))[: len(got)])


def test_standardize_matches_numpy(path_kind):
    x = np.random.default_rng(3).standard_normal((100, 6)).astype(np.float32)
    mean, std = x.mean(0), x.std(0)
    np.testing.assert_allclose(nio.standardize(x, mean, std), (x - mean) / std, rtol=1e-6)


def test_chunked_stream_reads_are_bounded(path_kind, monkeypatch, tmp_path):
    """Chunked reads of a capture larger than a chunk tile it exactly as one
    read does, and the NumPy path reads only each requested window."""
    n_frames, size, chunk = 64, 256, 16
    payload = _frames((n_frames * size,), 7)
    path = tmp_path / "big_capture.bin"
    np.concatenate([np.zeros(100, np.complex64), payload]).tofile(path)
    calls = []
    real = np.fromfile

    def spy(f, dtype=float, count=-1, offset=0, **kw):
        calls.append(count)
        return real(f, dtype=dtype, count=count, offset=offset, **kw)

    monkeypatch.setattr(np, "fromfile", spy)
    got = np.concatenate([
        nio.read_stream_frames(path, size, skip=100 + start * size, max_frames=chunk)
        for start in range(0, n_frames, chunk)
    ])
    np.testing.assert_array_equal(got, nio.planarize(payload.reshape(n_frames, size)))
    if path_kind == "numpy":
        assert calls and all(c == chunk * size for c in calls)
