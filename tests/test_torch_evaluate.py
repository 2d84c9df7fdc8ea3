"""The port's preprocessing (``amcpy_tpu_torch/preprocessing.py``) and
evaluation (``amcpy_tpu_torch/train/evaluate.py``) against the JAX
package's on a synthetic tiny configuration (6 modulations x 16 SNR
levels x 8 frames of 64 samples), on the CPU.

Split indices, held-out masks, labels and raw datasets must be identical
(``assert_array_equal``). Standardized features: rtol 1e-6 (the JAX
standardizer reduces in float32 with XLA's summation order, the port with
NumPy's). Accuracy and confusion matrices must be equal: the models are
float32, whose logits agree to ~1e-5 in the two packages, and the seeds
are picked so that no frame's top two logits lie within 1e-4 (checked)
and several classes are predicted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io

from amcpy_tpu import preprocessing as jprep
from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.train import evaluate as jeval
from amcpy_tpu.train.training import TrainState
from amcpy_tpu_torch import preprocessing as prep
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.train import evaluate as ev
from amcpy_tpu_torch.train.checkpoint import params_from_flax

from .test_torch_cnn import K1_F32, SMALL, _models
from .test_torch_serve import _flax_weights as _mlp_weights

FRAMES, N = 8, 64


def _cfgs(tmp_path=None, **training):
    kw = {"signals": {"num_frames": FRAMES, "frame_size": N}}
    if training:
        kw["training"] = training
    if tmp_path is not None:
        return (JaxConfig().replace(paths={"root": str(tmp_path / "jax")}, **kw),
                Config().replace(paths={"root": str(tmp_path / "torch")}, **kw))
    return JaxConfig().replace(**kw), Config().replace(**kw)


def _features(cfg, seed=0):
    """``{mod: (16, FRAMES, 18)}`` float32, shifted per modulation and SNR
    so that a random MLP predicts several classes."""
    rng = np.random.default_rng(seed)
    shape = (cfg.signals.num_snr, FRAMES, 18)
    return {
        m: (rng.standard_normal(shape) + 0.7 * k
            + 0.1 * np.arange(shape[0])[:, None, None]).astype(np.float32)
        for k, m in enumerate(cfg.signals.modulations_with_noise)
    }


def _raw(cfg, seed=0):
    """``{mod: (16, FRAMES, N)}`` complex64: unit-power PSK/QAM symbols per
    sample plus AWGN at each SNR level (noise only for WGN)."""
    rng = np.random.default_rng(seed)
    snr = np.asarray(cfg.signals.snr_db, np.float64)[:, None, None]
    shape = (cfg.signals.num_snr, FRAMES, N)
    side = np.arange(4) * 2.0 - 3
    qam = (side[:, None] + 1j * side[None, :]).reshape(-1) / np.sqrt(10)
    points = [np.array([-1, 1]), np.exp(1j * np.pi / 4 * (2 * np.arange(4) + 1)),
              np.exp(1j * np.pi / 4 * np.arange(8)), qam, qam * 1.3, None]
    out = {}
    for m, pts in zip(cfg.signals.modulations_with_noise, points):
        noise = rng.standard_normal((*shape, 2)) @ np.array([1, 1j]) * np.sqrt(0.5)
        if pts is None:
            out[m] = noise.astype(np.complex64)
            continue
        sym = pts[rng.integers(0, len(pts), shape)]
        out[m] = (sym + np.sqrt(10 ** (-snr / 10)) * noise).astype(np.complex64)
    return out


@pytest.mark.parametrize("seed,test_size", [(42, 0.2), (0, 0.25), (7, 0.5)])
def test_split_indices_identical(seed, test_size):
    y = np.repeat(np.arange(6, dtype=np.int32), 37)
    np.random.default_rng(seed).shuffle(y)
    want = jprep.stratified_split_indices(y, test_size, seed)
    got = prep.stratified_split_indices(y, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    x = np.arange(len(y) * 2).reshape(len(y), 2)
    for g, w in zip(prep.stratified_split(x, y, test_size, seed),
                    jprep.stratified_split(x, y, test_size, seed)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["training", "test"])
def test_datasets_and_mask_identical(mode):
    jcfg, cfg = _cfgs()
    feats, raw = _features(cfg), _raw(cfg)
    for got, want in (
        (prep.build_dataset(feats, cfg, mode), jprep.build_dataset(feats, jcfg, mode)),
        (prep.build_raw_dataset(raw, cfg, mode),
         jprep.build_raw_dataset(raw, jcfg, mode)),
    ):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    y = prep.build_dataset(feats, cfg, mode)[1]
    tr, _ = prep.stratified_split_indices(y, 0.2, 3)
    np.testing.assert_array_equal(
        prep.train_frame_mask(cfg, tr, mode), jprep.train_frame_mask(jcfg, tr, mode)
    )


def test_preprocess_matches_jax():
    jcfg, cfg = _cfgs(seed=5, test_size=0.3)
    feats = _features(cfg, seed=1)
    got = prep.preprocess(feats, cfg, return_indices=True)
    want = jprep.preprocess(feats, jcfg, return_indices=True)
    for g, w in zip(got[5], want[5]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[4].mean, want[4].mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[4].std, want[4].std, rtol=1e-6)


def test_preprocess_raw_matches_jax():
    jcfg, cfg = _cfgs(seed=9)
    raw = _raw(cfg, seed=2)
    got = prep.preprocess_raw(raw, cfg, "test", return_indices=True)
    want = jprep.preprocess_raw(raw, jcfg, "test", return_indices=True)
    for g, w in zip(got[:4] + tuple(got[4]), want[:4] + tuple(want[4])):
        np.testing.assert_array_equal(g, w)


def _assert_no_near_ties(logits, gap=1e-4):
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > gap).all()


def _mlp(seed=0):
    jmodel, params, stats = _mlp_weights("relu", seed)
    model = AMCClassifier(6)
    model.load_state_dict(params_from_flax(params, stats))
    return jmodel, TrainState(params, stats, None, np.zeros((), np.int32)), model


@pytest.mark.parametrize("masked", [False, True])
def test_evaluate_by_snr_matches_jax(masked):
    jcfg, cfg = _cfgs()
    feats = _features(cfg, seed=3)
    jmodel, state, model = _mlp(seed=1)
    x, _ = jprep.build_dataset(feats, jcfg, "test")
    scaler = prep.Standardizer.fit(x)
    jscaler = jprep.Standardizer(scaler.mean, scaler.std)
    _assert_no_near_ties(jmodel.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jscaler.transform(x), train=False,
    ))
    mask = None
    if masked:
        y = prep.build_dataset(feats, cfg)[1]
        mask = prep.train_frame_mask(cfg, prep.stratified_split_indices(y, 0.2, 1)[0])
    want = jeval.evaluate_by_snr(jmodel, state, jscaler, feats, jcfg, mask)
    got = ev.evaluate_by_snr(model, scaler, feats, cfg, mask, device="cpu")
    assert got.shape == (6, 16)
    assert len(np.unique(got)) > 2  # the inputs exercise several classes
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "arch,seed,masked,chunk",
    [(K1_F32, 2, False, 48), (K1_F32, 2, True, 2048), (SMALL, 5, True, 40)],
)
def test_evaluate_by_snr_raw_matches_jax(arch, seed, masked, chunk):
    """16 x 8 = 128 frames per modulation: a chunk of 48 or 40 leaves a
    ragged last chunk (the JAX package pads it with zero frames, the port
    runs it as it is); 2048 takes every frame in one call."""
    jcfg, cfg = _cfgs()
    raw = _raw(cfg, seed=5)
    jmodel, variables, model = _models(N, seed=seed, dtype="float32", **arch)
    x, y = prep.build_raw_dataset(raw, cfg, "test")
    _assert_no_near_ties(jmodel.apply(variables, jnp.asarray(x), train=False))
    mask = None
    if masked:
        mask = prep.train_frame_mask(
            cfg, prep.stratified_split_indices(prep.build_raw_dataset(raw, cfg)[1],
                                               0.2, 2)[0]
        )
    state = TrainState(variables["params"], variables["batch_stats"], None,
                       np.zeros((), np.int32))
    want = jeval.evaluate_by_snr_raw(jmodel, state, raw, jcfg, chunk, mask)
    got = ev.evaluate_by_snr_raw(model, raw, cfg, chunk, mask, device="cpu")
    assert got.shape == (6, 16)
    np.testing.assert_array_equal(got, want)
    cm = ev.confusion_counts(model, x, y, 6, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(
        cm, jeval.confusion_counts(jmodel, state, x, y, 6, chunk=chunk)
    )
    assert (cm > 0).sum() > 6  # several predicted classes


def test_confusion_counts_mlp_matches_jax():
    jcfg, cfg = _cfgs()
    feats = _features(cfg, seed=3)
    jmodel, state, model = _mlp(seed=7)
    x, y = prep.build_dataset(feats, cfg, "test")
    xs = prep.Standardizer.fit(x).transform(x).astype(np.float32)
    np.testing.assert_array_equal(
        ev.confusion_counts(model, xs, y, 6, device="cpu"),
        jeval.confusion_counts(jmodel, state, xs, y, 6),
    )


def test_save_figure_data_writes_the_same_acc(tmp_path):
    jcfg, cfg = _cfgs(tmp_path)
    acc = np.random.default_rng(9).uniform(size=(6, 16))
    ev.save_figure_data(cfg, "m", acc)
    jeval.save_figure_data(jcfg, "m", acc)
    got = scipy.io.loadmat(str(cfg.paths.figures / "m_figure_data.mat"))["acc"]
    want = scipy.io.loadmat(str(jcfg.paths.figures / "m_figure_data.mat"))["acc"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, acc)


def test_masked_block_accuracy_ignores_excluded_frames():
    correct = np.random.default_rng(10).uniform(size=(6, 16, 8)) > 0.5
    mask = np.zeros_like(correct)
    mask[:, :, :3] = True
    mask[0, 0] = True  # a block with no frame left counts as 0
    np.testing.assert_array_equal(
        ev._masked_block_accuracy(correct, mask),
        jeval._masked_block_accuracy(correct, mask),
    )
    np.testing.assert_array_equal(
        ev._masked_block_accuracy(correct, None), correct.mean(-1)
    )
