"""The port's synthetic dataset (``amcpy_tpu_torch/data/synth.py``) against
the JAX package's ``amcpy_tpu/data/synth.py`` on the CPU.

A torch generator and ``jax.random`` give different streams for one seed
(and a CUDA generator another), so the two packages' frames cannot be
compared bit for bit. They are held to each other on what the generator
promises, with bars set before measuring:

* layout: the same variable names, shapes and dtype as JAX's
  ``generate_dataset``, and a ``.mat`` the JAX package's ``run_extraction``
  reads (features within ``2e-4 * term_scales + 2e-5 * |want|`` of the
  port's ``run_extraction`` of the same file);
* statistics: the noise power at each SNR level is ``10^(-snr/10)`` within
  5 standard errors (the noise is isolated exactly by drawing the same
  stream again at 200 dB, where the symbols are left alone), at 200 dB
  every |x| lies on the constellation's magnitudes within 1e-5, and WGN
  has unit power within 5 standard errors at every level;
* features: per (modulation, SNR) block of 64 frames x 512 samples, the
  mean of each of the 18 features from the port's frames through the
  port's plain extractor lies within ``6 sqrt(s_port^2 / n + s_jax^2 / n)
  + 1e-4 * term_scales`` of the mean from JAX's frames through JAX's
  extractor (a 6-sigma bar on a difference of two means, plus the float32
  budget for blocks whose spread is ~0).
"""

import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.data import synth as jax_synth
from amcpy_tpu.extraction import extract_batch as jax_extract_batch
from amcpy_tpu.extraction import run_extraction as jax_run_extraction
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import synth
from amcpy_tpu_torch.extraction import extract_batch, run_extraction

from .oracle import term_scales

CPU = torch.device("cpu")


def _cfgs(tmp_path, **signals):
    return (Config().replace(paths={"root": str(tmp_path)}, signals=signals),
            JaxConfig().replace(paths={"root": str(tmp_path)}, signals=signals))


N_FRAMES, N = 64, 512


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    """JAX's dataset at 64 frames x 512 samples a block (drawn once: the
    JAX generator compiles for each constellation)."""
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path_factory.mktemp("jax_synth"))},
                               signals={"frame_size": N, "num_frames": N_FRAMES})
    return jax_synth.generate_dataset(jcfg, seed=2)


def test_dataset_layout_matches_jax(tmp_path, jax_data):
    cfg, _ = _cfgs(tmp_path, frame_size=N, num_frames=N_FRAMES)
    got = synth.generate_dataset(cfg, seed=3, device="cpu")
    assert list(got) == list(jax_data) == [
        "signal_bpsk", "signal_qpsk", "signal_8psk", "signal_qam16",
        "signal_qam64", "signal_noise",
    ]
    for name, arr in got.items():
        assert arr.shape == jax_data[name].shape == (16, N_FRAMES, N)
        assert arr.dtype == jax_data[name].dtype == np.complex64


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"])
def test_constellations_are_the_jax_packages(mod):
    np.testing.assert_array_equal(synth.points_of(mod), jax_synth._constellation(mod))
    assert synth.points_of("WGN") is None


def _planes(mod, snr_db, frames, n, seed):
    i, q = synth.gen_planes(synth.seeded_generator(seed, CPU), synth.points_of(mod),
                            snr_db, frames, n, True, CPU)
    return i.double().numpy(), q.double().numpy()


SNR = (-10, -4, 0, 6, 12, 20)


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"])
def test_noise_power_per_snr(mod):
    """Redrawing the same stream at 200 dB gives the same symbols, so the
    difference is the noise alone (its 1e-10 sigma is far below the bar)."""
    i, q = _planes(mod, SNR, 64, 512, seed=5)
    i0, q0 = _planes(mod, (200,) * len(SNR), 64, 512, seed=5)
    p = ((i - i0) ** 2 + (q - q0) ** 2).reshape(len(SNR), -1)
    want = 10.0 ** (-np.asarray(SNR) / 10.0)
    se = p.std(axis=1) / np.sqrt(p.shape[1])
    assert (np.abs(p.mean(axis=1) - want) <= 5 * se).all(), (p.mean(axis=1), want, se)


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"])
def test_magnitudes_at_200_db_lie_on_the_constellation(mod):
    i, q = _planes(mod, (200,), 64, 512, seed=6)
    mags = np.unique(np.round(np.abs(synth.points_of(mod)), 12))
    dist = np.abs(np.hypot(i, q)[..., None] - mags).min(axis=-1)
    assert dist.max() <= 1e-5


def test_wgn_has_unit_power_at_every_level():
    i, q = _planes("WGN", SNR, 64, 512, seed=7)
    p = (i**2 + q**2).reshape(len(SNR), -1)
    se = p.std(axis=1) / np.sqrt(p.shape[1])
    assert (np.abs(p.mean(axis=1) - 1.0) <= 5 * se).all(), p.mean(axis=1)


def test_feature_block_means_match_jax(tmp_path, jax_data):
    """The 18 features' means per (modulation, SNR) block, the port's frames
    through the port's extractor against JAX's through JAX's."""
    n_frames, n = N_FRAMES, N
    cfg, _ = _cfgs(tmp_path, frame_size=n, num_frames=n_frames)
    got = synth.generate_dataset(cfg, seed=1, device="cpu")
    want = jax_data
    for name in got:
        f_port = extract_batch(got[name].reshape(-1, n), device="cpu").reshape(16, n_frames, 18)
        jax_frames = want[name].reshape(-1, n)
        f_jax = jax_extract_batch(jax_frames).reshape(16, n_frames, 18)
        ts = np.stack([term_scales(f) for f in jax_frames]).reshape(16, n_frames, 18)
        bar = (6 * np.sqrt(f_port.var(axis=1, ddof=1) / n_frames
                           + f_jax.var(axis=1, ddof=1) / n_frames)
               + 1e-4 * ts.mean(axis=1))
        gap = np.abs(f_port.mean(axis=1) - f_jax.mean(axis=1))
        bad = np.argwhere(gap > bar)
        assert not len(bad), f"{name}: (snr, feature) blocks {bad.tolist()}"


def test_entry_points_draw_the_same_frames(tmp_path):
    cfg, _ = _cfgs(tmp_path, frame_size=64, num_frames=3, snr_db=(0, 10))
    mi = cfg.signals.modulations_with_noise.index("8PSK")
    data = synth.generate_dataset(cfg, seed=2, device="cpu")
    frames = synth.generate_modulation("8PSK", cfg, 2 * 1000 + mi, device="cpu")
    i, q = synth.gen_planes(synth.seeded_generator(2 * 1000 + mi, CPU),
                            synth.points_of("8PSK"), (0, 10), 3, 64, True, CPU)
    np.testing.assert_array_equal(data["signal_8psk"], frames)
    np.testing.assert_array_equal(frames.real.reshape(6, 64), i.numpy())
    np.testing.assert_array_equal(frames.imag.reshape(6, 64), q.numpy())
    again = synth.generate_dataset(cfg, seed=2, device="cpu")
    np.testing.assert_array_equal(again["signal_noise"], data["signal_noise"])
    other = synth.generate_dataset(cfg, seed=3, device="cpu")
    assert not np.array_equal(other["signal_noise"], data["signal_noise"])


def test_written_dataset_is_read_by_jax(tmp_path):
    cfg, jcfg = _cfgs(tmp_path, frame_size=256, num_frames=4, snr_db=(0, 10, 20))
    path = synth.write_dataset(cfg, seed=8, device="cpu")
    assert path.endswith("mat-data/all_modulations.mat")
    got = run_extraction(cfg, device="cpu")
    want = jax_run_extraction(jcfg, force=True)
    data = synth.generate_dataset(cfg, seed=8, device="cpu")
    for mod in cfg.signals.modulations_with_noise:
        frames = data[cfg.signals.mat_info[mod]].reshape(-1, 256)
        tol = (2e-4 * np.stack([term_scales(f) for f in frames])
               + 2e-5 * np.abs(want[mod].reshape(-1, 18)))
        assert (np.abs(got[mod].reshape(-1, 18) - want[mod].reshape(-1, 18)) <= tol).all(), mod
