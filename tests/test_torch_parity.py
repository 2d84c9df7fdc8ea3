"""The port's parity harness (``amcpy_tpu_torch/parity.py``) and ``parity``
subcommand on the CPU, against the JAX package's ``parity.py``, and the
paired-seed accuracy gate between the two packages.

The original amcpy checkout that ``parity`` runs against is absent from
this repository. The tests write a stand-in for it: a temporary
``src/amcpy/features.py`` whose ``calculate_features(ids, signal)``
returns ``tests/oracle.py::features_frame``. It stands in for the absent
checkout so that the harness's machinery (the import from a checkout, the
worker subprocesses, the budget, the report) runs; it is not the
reference.

The accuracy gate (``parity.py``'s budget: mean |delta| <= 1 pp, max
|delta| <= 5 pp over the (modulation, SNR) cells): the same frames go
through each package's extraction, each package's ``preprocess`` gives the
same split, and for each of two paired seeds both packages' MLPs start
from JAX's initialization for that seed and see JAX's row order for it
(dropout 0, so nothing else is drawn), then each package's
``evaluate_by_snr`` scores its own model.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.extraction import run_extraction as jax_run_extraction
from amcpy_tpu.parity import _term_scales_batch as jax_term_scales_batch
from amcpy_tpu.parity import paired_accuracy_stats as jax_paired_accuracy_stats
from amcpy_tpu.preprocessing import preprocess as jax_preprocess
from amcpy_tpu.train import training as jtr
from amcpy_tpu.train.evaluate import evaluate_by_snr as jax_evaluate_by_snr
from amcpy_tpu_torch import parity
from amcpy_tpu_torch.cli import main
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat, synth
from amcpy_tpu_torch.extraction import run_extraction
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import preprocess
from amcpy_tpu_torch.train.checkpoint import params_from_flax
from amcpy_tpu_torch.train.evaluate import evaluate_by_snr
from amcpy_tpu_torch.train.training import make_optimizer, run_epoch

from .oracle import features_batch, term_scales
from .test_torch_training import _jax_orders, _np, _one_device_mesh

TESTS = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """A checkout-shaped directory whose extractor is the float64 oracle."""
    root = tmp_path_factory.mktemp("stand_in_reference")
    (root / "src" / "amcpy").mkdir(parents=True)
    (root / "src" / "amcpy" / "features.py").write_text(
        "# stands in for the original amcpy checkout's extractor (absent here):\n"
        "# the tests' float64 oracle, not the reference\n"
        "import sys\n"
        f"sys.path.insert(0, {str(TESTS)!r})\n"
        "from oracle import features_frame\n\n\n"
        "def calculate_features(ids, signal):\n"
        "    return features_frame(signal)[[i - 1 for i in ids]]\n"
    )
    return root


def _frames(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (x * np.exp(rng.uniform(-3, 3, (b, 1)))).astype(np.complex64)


@pytest.mark.parametrize("processes", [1, 2])
def test_reference_features_batch_runs_the_checkout(stand_in, processes):
    frames = _frames(6, 256, 0)
    got = parity.reference_features_batch(frames, stand_in, processes=processes)
    np.testing.assert_array_equal(got, features_batch(frames))


def test_missing_checkout_is_named(tmp_path):
    with pytest.raises(FileNotFoundError, match="reference checkout not found"):
        parity.reference_features_batch(_frames(2, 64, 1), tmp_path / "nowhere", processes=1)


def test_term_scales_batch_is_jaxs_and_the_oracles():
    frames = _frames(9, 200, 2)
    got = parity._term_scales_batch(frames)
    np.testing.assert_array_equal(got, jax_term_scales_batch(frames))
    np.testing.assert_allclose(got, np.stack([term_scales(f) for f in frames]), rtol=1e-12)


@pytest.mark.parametrize("case", ["matched", "systematic", "one_cell", "one_seed"])
def test_paired_accuracy_stats_is_jaxs(case):
    """The cases of ``tests/test_parity_harness.py``: matched curves pass,
    a systematic +3 pp fails the mean budget and the noise bound, one
    pathological cell fails the max budget."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.9, size=(5, 6, 16))
    noise = rng.normal(0.0, 0.004, size=base.shape)
    ours = {"matched": base + noise, "systematic": base + 0.03 + noise,
            "one_cell": base + noise, "one_seed": base[:1] + noise[:1]}[case]
    ref = base[:1] if case == "one_seed" else base
    if case == "one_cell":
        ours[:, 2, 5] += 0.20
    got = parity.paired_accuracy_stats(ours, ref)
    assert got == jax_paired_accuracy_stats(ours, ref)
    assert got["budget"]["pass"] == (case in ("matched", "one_seed"))
    if case == "systematic":
        assert not got["delta_within_seed_noise"]
        assert got["cells_exceeding_noise"] > got["n_cells"] // 2
    assert (parity.ACC_BUDGET_MEAN_PP, parity.ACC_BUDGET_MAX_PP) == (1.0, 5.0)


def test_run_parity_smoke(tmp_path, stand_in):
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"frame_size": 128, "num_frames": 3})
    synth.write_dataset(cfg, seed=4, device="cpu")
    report = parity.run_parity(cfg, ref_root=stand_in, train_models=False, processes=1,
                               device="cpu")
    assert report["frames_total"] == 6 * 16 * 3
    assert report["frames_outside_tolerance"] == 0
    assert report["worst_error_fraction_of_tolerance"] < 1.0
    assert report["pipeline_frames_per_s"] > 0 and report["device"] == "cpu"
    assert "BPSK" in report["wall_s"]["per_modulation"]
    assert json.loads((tmp_path / "metrics" / "parity.json").read_text()) == report
    assert "Reference parity report" in (tmp_path / "metrics" / "parity_report.md").read_text()


def test_parity_command_end_to_end(tmp_path, stand_in, capsys):
    """``generate`` -> ``parity`` with the training arm, through the CLI."""
    (tmp_path / "cfg.yaml").write_text(
        '{"signals": {"num_frames": 6, "frame_size": 256}, '
        '"training": {"epochs": 2, "batch_size": 64}}')
    base = ["--root", str(tmp_path), "--config", str(tmp_path / "cfg.yaml"), "--device", "cpu"]
    main(base + ["generate", "--seed", "3"])
    main(base + ["parity", "--ref", str(stand_in), "--processes", "1",
                 "--frames-per-snr", "4", "--seeds", "2"])
    report = json.loads((tmp_path / "metrics" / "parity.json").read_text())
    assert report["frames_total"] == 6 * 16 * 4
    assert report["frames_outside_tolerance"] == 0
    a = report["accuracy"]
    assert a["n_seeds"] == 2 and "paired_cell_sd_max" in a
    assert np.asarray(a["per_seed"]["ours"]).shape == (2, 6, 16)
    assert "Accuracy parity (paired seeds)" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the checkout has no default
        main(base + ["parity"])


def _numpy_dataset(cfg, seed):
    """Unit-power constellations plus AWGN per SNR level (WGN: noise)."""
    rng = np.random.default_rng(seed)
    s = cfg.signals
    shape = (s.num_snr, s.num_frames, s.frame_size)
    sigma = np.sqrt(10.0 ** (-np.asarray(s.snr_db) / 10.0))[:, None, None]
    out = {}
    for mod in s.modulations_with_noise:
        noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * np.sqrt(0.5)
        pts = synth.points_of(mod)
        out[mod] = (noise if pts is None else
                    pts[rng.integers(0, len(pts), shape)] + sigma * noise).astype(np.complex64)
    return out


def test_paired_seed_accuracy_gate(tmp_path):
    signals = {"num_frames": 24, "frame_size": 128}
    training = {"epochs": 6, "dropout": 0.0}
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals=signals, training=training)
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path / "jax")}, signals=signals,
                               training=training)
    data = _numpy_dataset(cfg, seed=5)
    io_mat.save_dataset(cfg, data)
    jcfg.paths.ensure_dirs()
    (jcfg.paths.mat_data / jcfg.paths.mat_filename).write_bytes(
        (cfg.paths.mat_data / cfg.paths.mat_filename).read_bytes())
    feats = run_extraction(cfg, device="cpu")
    jfeats = jax_run_extraction(jcfg)

    x_tr, x_te, y_tr, y_te, scaler = preprocess(feats, cfg)
    jx_tr, jx_te, jy_tr, jy_te, jscaler = jax_preprocess(jfeats, jcfg)
    np.testing.assert_array_equal(y_tr, jy_tr)
    n, batch = len(x_tr), min(cfg.training.batch_size, len(x_tr))
    take = max(n // batch, 1) * batch
    ours, theirs = [], []
    for seed in (0, 1):
        jmodel, jstate, _, _ = jtr.train(jcfg, jx_tr, jy_tr, jx_te, jy_te,
                                         mesh=_one_device_mesh(), seed=seed)
        theirs.append(jax_evaluate_by_snr(jmodel, jstate, jscaler, jfeats, jcfg))
        init = jmodel.init(jax.random.split(jax.random.key(seed))[0],
                           jnp.zeros((1, x_tr.shape[1])), train=False)
        model = AMCClassifier(6, tuple(cfg.training.hidden_sizes), dropout=0.0,
                              in_features=x_tr.shape[1])
        model.load_state_dict(params_from_flax(_np(init["params"]), _np(init["batch_stats"])))
        opt = make_optimizer(cfg, model.parameters())
        tensors = [torch.from_numpy(np.asarray(a)) for a in (x_tr, y_tr, x_te, y_te)]
        for order in _jax_orders(seed, n, take, cfg.training.epochs):
            run_epoch(model, opt, tensors[0], tensors[1].long(), tensors[2],
                      tensors[3].long(), torch.from_numpy(order[0]), batch)
        ours.append(evaluate_by_snr(model, scaler, feats, cfg, device="cpu"))
    stats = parity.paired_accuracy_stats(np.stack(ours), np.stack(theirs))
    assert stats == jax_paired_accuracy_stats(np.stack(ours), np.stack(theirs))
    assert stats["budget"]["pass"], stats
    assert stats["mean_reference"] > 0.4  # both learned well above chance (1/6)
