"""The port's ARM analysis (``amcpy_tpu_torch/arm/analysis.py``) and legacy
dataset tooling (``amcpy_tpu_torch/data/legacy.py``) against the JAX
package's modules on identical inputs: the same numbers and the same
frames. The cases are those of ``tests/test_arm_legacy.py``."""

import pickle

import numpy as np
import pytest
import scipy.io

import amcpy_tpu.arm.analysis as jax_arm
import amcpy_tpu.data.legacy as jax_legacy
from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu_torch.arm import analysis as arm
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import legacy


def _preds(seed):
    rng = np.random.default_rng(seed)
    return {m: rng.integers(0, 6, size=(16, 10)) for m in Config().signals.modulations_with_noise}


def test_per_modulation_accuracy_matches_jax():
    preds = {"BPSK": np.array([0, 0, 0, 1]), "QPSK": np.array([1, 1, 2, 2]),
             "WGN": np.array([5, 5, 5, 5])}
    got = arm.per_modulation_accuracy(preds)
    assert got == jax_arm.per_modulation_accuracy(preds)
    assert got == pytest.approx({"BPSK": 75.0, "QPSK": 50.0, "WGN": 100.0})
    flat = {m: p.ravel() for m, p in _preds(1).items()}
    assert arm.per_modulation_accuracy(flat, Config()) == jax_arm.per_modulation_accuracy(
        flat, JaxConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_per_snr_counts_matches_jax(seed):
    preds = _preds(seed)
    if seed == 0:
        preds = {"BPSK": preds["BPSK"]}
    got = arm.per_snr_counts(preds, Config())
    np.testing.assert_array_equal(got, jax_arm.per_snr_counts(preds, JaxConfig()))
    assert got.shape == (6, 16)


@pytest.mark.parametrize("n_bins,target", [(16, 0), (8, 3), (5, 1)])
def test_bin_predictions_matches_jax(n_bins, target):
    preds = np.zeros(160, dtype=int)
    preds[10:20] = 3
    preds[::7] = 1
    got = arm.bin_predictions(preds, n_bins=n_bins, target=target)
    np.testing.assert_array_equal(got, jax_arm.bin_predictions(preds, n_bins=n_bins,
                                                                target=target))


@pytest.mark.parametrize("plot", ["embedded_accuracy", "binned_predictions", "time_domain"])
def test_plots_write_files(tmp_path, plot):
    rng = np.random.default_rng(3)
    out = tmp_path / f"{plot}.png"
    if plot == "embedded_accuracy":
        got = arm.plot_embedded_accuracy(rng.uniform(0, 100, size=(6, 16)), out_path=out)
    elif plot == "binned_predictions":
        got = arm.plot_binned_predictions(np.zeros(160, dtype=int), out_path=out)
    else:
        frames = (rng.standard_normal((4, 256)) + 1j * rng.standard_normal((4, 256)))
        got = legacy.plot_time_domain(frames.astype(np.complex64), out, num_frames=2)
    assert got == out and out.stat().st_size > 0


def test_prediction_dump_matches_jax(tmp_path):
    cell = np.empty((5, 2, 1), dtype=object)
    for k in range(5):
        cell[k, 0, 0] = np.array([[k]])
        cell[k, 1, 0] = np.array([[k % 3]])
    scipy.io.savemat(str(tmp_path / "dump.mat"), {"Data": cell})
    got = arm.load_prediction_dump(tmp_path / "dump.mat")
    np.testing.assert_array_equal(got, jax_arm.load_prediction_dump(tmp_path / "dump.mat"))


@pytest.mark.parametrize("skip,limit,size,count", [
    (2400, None, 1024, None), (2400, None, 1024, 2), (100, 3000, 500, None), (0, 256, 64, 3),
])
def test_gnuradio_stream_matches_jax(tmp_path, skip, limit, size, count):
    rng = np.random.default_rng(2)
    payload = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    path = tmp_path / "binary_BPSK(10)"
    np.concatenate([np.zeros(skip, np.complex64), payload]).tofile(path)
    stream = legacy.read_gnuradio_stream(path, skip=skip, limit=limit)
    np.testing.assert_array_equal(stream, jax_legacy.read_gnuradio_stream(path, skip=skip,
                                                                          limit=limit))
    np.testing.assert_array_equal(stream, payload[:limit])
    frames = legacy.frame_stream(stream, size, count)
    np.testing.assert_array_equal(frames, jax_legacy.frame_stream(stream, size, count))


def test_pickle_to_mat_matches_jax(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    with open(tmp_path / "x.pkl", "wb") as f:
        pickle.dump(arr, f)
    got = legacy.pickle_to_mat(tmp_path / "x.pkl", tmp_path / "port.mat", "signal_bpsk")
    jax_legacy.pickle_to_mat(tmp_path / "x.pkl", tmp_path / "jax.mat", "signal_bpsk")
    a = scipy.io.loadmat(str(got))["signal_bpsk"]
    np.testing.assert_array_equal(a, scipy.io.loadmat(str(tmp_path / "jax.mat"))["signal_bpsk"])
    np.testing.assert_array_equal(a, arr)


def test_deepsig_tables_match_jax():
    assert legacy.DEEPSIG_CLASSES == jax_legacy.DEEPSIG_CLASSES
    assert legacy.DEEPSIG_FRAMES_PER_MOD == jax_legacy.DEEPSIG_FRAMES_PER_MOD
    assert legacy.GR_WARMUP_SAMPLES == jax_legacy.GR_WARMUP_SAMPLES


@pytest.mark.parametrize("mod,as_complex,max_frames", [
    ("BPSK", True, None), ("BPSK", False, None), ("16QAM", True, 3), ("OOK", False, 5),
])
def test_deepsig_loader_matches_jax(tmp_path, monkeypatch, mod, as_complex, max_frames):
    """An HDF5 file in the DeepSig layout, X (frames, 1024, 2), with eight
    frames a class."""
    h5py = pytest.importorskip("h5py")
    monkeypatch.setattr(legacy, "DEEPSIG_FRAMES_PER_MOD", 8)
    monkeypatch.setattr(jax_legacy, "DEEPSIG_FRAMES_PER_MOD", 8)
    x = np.random.default_rng(4).standard_normal((8 * 24, 1024, 2)).astype(np.float32)
    path = tmp_path / "deepsig.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=x)
    kw = dict(as_complex=as_complex, max_frames=max_frames)
    got = legacy.load_deepsig_modulation(path, mod, **kw)
    want = jax_legacy.load_deepsig_modulation(path, mod, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    start = legacy.DEEPSIG_CLASSES.index(mod) * 8
    first = x[start, :, 0] if not as_complex else x[start, :, 0].astype(np.complex64)
    np.testing.assert_array_equal(got[0] if as_complex else got[0, :, 0],
                                  first if not as_complex else got[0].real + 1j * x[start, :, 1])
