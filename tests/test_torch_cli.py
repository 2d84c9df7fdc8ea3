"""The port's command line (``python -m amcpy_tpu_torch``) end to end on a
tiny numpy-made dataset, on the CPU (``--device cpu``): extract -> train ->
eval -> quantize --emit-c -> classify, resume, the CNN family, and the
refusals. Mirrors ``tests/test_cli.py``; the figures the JAX commands draw
are written as numbers (``figures/{id}_figure_data.mat``,
``figures/cm-{id}.json``) and, where matplotlib imports, drawn too. Drawing
at the JAX package's 300 dpi takes seconds a command, so the commands run
without matplotlib unless a test checks the figures.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from amcpy_tpu_torch.cli import _eval_cm_dataset, main
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat

FRAMES, SIZE = 24, 128


def _qam(m):
    levels = np.arange(int(m**0.5)) * 2.0 - (m**0.5 - 1)
    return (levels[:, None] + 1j * levels[None, :]).ravel()


def _dataset(cfg, seed=7):
    """Unit-power constellation symbols plus AWGN at each SNR level (WGN:
    noise only), ``{mod: (num_snr, FRAMES, SIZE) complex64}``."""
    rng = np.random.default_rng(seed)
    points = {"BPSK": np.array([-1, 1]), "QPSK": np.exp(1j * np.pi / 4 * np.arange(1, 8, 2)),
              "8PSK": np.exp(1j * np.pi / 4 * np.arange(8)), "16QAM": _qam(16),
              "64QAM": _qam(64)}
    shape = (cfg.signals.num_snr, FRAMES, SIZE)
    sigma = np.sqrt(10 ** (-np.asarray(cfg.signals.snr_db) / 10))[:, None, None]
    out = {}
    for mod in cfg.signals.modulations_with_noise:
        noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * np.sqrt(0.5)
        if mod == "WGN":
            out[mod] = noise.astype(np.complex64)
            continue
        pts = points[mod] / np.sqrt(np.mean(np.abs(points[mod]) ** 2))
        out[mod] = (pts[rng.integers(0, len(pts), shape)] + sigma * noise).astype(np.complex64)
    return out


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("amc_torch_project")
    cfg_yaml = root / "cfg.yaml"
    cfg_yaml.write_text(
        f"signals:\n  num_frames: {FRAMES}\n  frame_size: {SIZE}\n"
        "training:\n  epochs: 6\n  batch_size: 64\n"
    )
    cfg = Config.from_yaml(cfg_yaml).replace(paths={"root": str(root)})
    io_mat.save_dataset(cfg, _dataset(cfg))
    return root, cfg_yaml, cfg


def _run(project, *argv, figures=False):
    root, cfg_yaml, _ = project
    argv = ["--root", str(root), "--config", str(cfg_yaml), "--device", "cpu", *argv]
    if figures:
        main(argv)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)  # the figures' numbers only
        main(argv)


def _newest_meta(root):
    newest = max((root / "ann").glob("model-*.json"), key=lambda p: p.stat().st_mtime)
    return newest.stem.replace("model-", ""), json.loads(newest.read_text())


def test_full_pipeline(project, capsys):
    root, _, _ = project
    _run(project, "extract")
    for mod in ("BPSK", "QPSK", "8PSK", "16QAM", "64QAM", "WGN"):
        feats = scipy.io.loadmat(str(root / "calculated-features" / f"{mod}_features.mat"))
        assert feats[Config().signals.mat_info[mod]].shape == (16, FRAMES, 18)

    _run(project, "train", "--epochs", "5", "--seed", "0", figures=True)
    ckpts = list((root / "ann").glob("model-*.pt"))
    assert len(ckpts) == 1
    model_id = ckpts[0].stem.replace("model-", "")
    for name in ("cm", "accuracy", "history"):
        assert (root / "figures" / f"{name}-{model_id}.png").exists(), name
    meta = json.loads((root / "ann" / f"model-{model_id}.json").read_text())
    assert len(meta["history"]["loss"]) == 5 and meta["epoch"] == 5  # --epochs reached training
    acc = scipy.io.loadmat(str(root / "figures" / f"{model_id}_figure_data.mat"))["acc"]
    assert acc.shape == (6, 16)
    assert acc[:, -4:].mean() > 1.0 / 6.0  # beats chance at high SNR
    cm = json.loads((root / "figures" / f"cm-{model_id}.json").read_text())
    assert cm["classes"] == list(Config().signals.modulations_with_noise)
    assert np.asarray(cm["cm"]).shape == (6, 6)
    assert "Mean accuracy across SNR" in capsys.readouterr().out

    _run(project, "eval", model_id)
    _run(project, "quantize", model_id, "--emit-c")
    assert (root / "arm-data" / "w_and_b.mat").exists()
    text = (root / "arm-data" / "amc_weights.h").read_text()
    assert "amc_classify" in text and "AMC_NUM_CLASSES 6" in text
    assert "amc_scaler_mean" in text  # the standardizer ships with the model

    capsys.readouterr()
    _run(project, "classify", "BPSK")
    assert "SNR +20 dB" in capsys.readouterr().out


def test_classify_capture_file(project):
    """A raw GNU Radio capture through ``classify --out``."""
    root, _, cfg = project
    raw = io_mat.load_modulation(cfg, "QPSK")
    np.concatenate([np.zeros(2400, np.complex64), raw[-1].reshape(-1)]).tofile(
        root / "capture.bin")
    _run(project, "classify", str(root / "capture.bin"), "--frame-size", str(SIZE),
         "--out", str(root / "preds.npy"))
    assert np.load(root / "preds.npy").shape == (FRAMES,)


def test_eval_reports_the_held_out_matrix_train_reports(project):
    """``eval`` reproduces the checkpoint's held-out split from its sidecar,
    so it writes the confusion matrix ``train`` wrote; ``--full-data``
    takes every row of the ``--mode`` set."""
    root, _, cfg = project
    _run(project, "train", "--epochs", "2", "--seed", "1")
    model_id, meta = _newest_meta(root)
    cm_path = root / "figures" / f"cm-{model_id}.json"
    from_train = json.loads(cm_path.read_text())
    cm_path.unlink()
    _run(project, "eval", model_id)
    assert json.loads(cm_path.read_text()) == from_train
    feats = {m: io_mat.load_features(cfg, m) for m in cfg.signals.modulations_with_noise}
    from amcpy_tpu_torch.preprocessing import build_dataset

    def build(mode):
        return build_dataset(feats, cfg, mode)

    held_out = _eval_cm_dataset(cfg, argparse.Namespace(mode="test", full_data=False),
                                meta, build)
    full = _eval_cm_dataset(cfg, argparse.Namespace(mode="test", full_data=True),
                            meta, build)
    assert full[0].shape[0] > held_out[0].shape[0]


def test_eval_refuses_on_config_drift(project):
    root, _, cfg = project
    _, meta = _newest_meta(root)
    drifted = cfg.replace(training={"training_snr": (8, 9, 10, 11, 12, 13)})
    with pytest.raises(SystemExit, match="cannot reproduce"):
        _eval_cm_dataset(drifted, argparse.Namespace(mode="test", full_data=False), meta,
                         lambda mode: (None, None))
    # --full-data stays available whatever drifted
    assert _eval_cm_dataset(drifted, argparse.Namespace(mode="test", full_data=True), meta,
                            lambda mode: ("x", "y")) == ("x", "y")


def test_train_resume_command(project):
    """A resumed run's checkpoint carries the whole run's history and epoch
    counter, and its optimizer state, and evaluates."""
    root, _, _ = project
    _run(project, "train", "--epochs", "3", "--seed", "2")
    first, _ = _newest_meta(root)
    _run(project, "train", "--epochs", "5", "--resume", first)
    resumed, meta = _newest_meta(root)
    assert resumed != first and meta["epoch"] == 5
    for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
        assert len(meta["history"][k]) == 5
    from amcpy_tpu_torch.train.checkpoint import load_checkpoint

    _, state, _, _ = load_checkpoint(Config().replace(paths={"root": str(root)}), resumed)
    assert state.opt_state is not None and state.step > 0
    _run(project, "eval", resumed)


def test_resume_adopts_checkpoint_optimizer(project):
    """Resuming without ``--optimizer``/``--lr`` restores the checkpoint's
    optimizer, learning rate and split seed around its saved state."""
    root, _, _ = project
    _run(project, "train", "--epochs", "2", "--optimizer", "adam", "--lr", "1e-3",
         "--seed", "3")
    adam_id, meta = _newest_meta(root)
    assert meta["config"]["training"]["optimizer"] == "adam"
    _run(project, "train", "--epochs", "3", "--resume", adam_id)
    _, meta2 = _newest_meta(root)
    t = meta2["config"]["training"]
    assert (t["optimizer"], t["learning_rate"], t["seed"]) == ("adam", 1e-3, 3)
    assert len(meta2["history"]["loss"]) == 3


def test_cnn_train_and_quantize_refusal(project, capsys):
    """``train --model cnn`` trains the raw-IQ CNN on the ``.mat`` frames
    (Adam 3e-4 by default), ``classify`` serves it, ``eval`` evaluates it,
    and ``quantize`` refuses it."""
    root, _, _ = project
    _run(project, "train", "--model", "cnn", "--epochs", "1")
    cnn_id, meta = _newest_meta(root)
    assert meta["config"]["model"]["family"] == "cnn"
    t = meta["config"]["training"]
    assert (t["optimizer"], t["learning_rate"]) == ("adam", 3e-4)
    assert (root / "figures" / f"cm-{cnn_id}.json").exists()
    capsys.readouterr()
    _run(project, "classify", "8PSK", "--model-id", cnn_id)
    assert "SNR -10 dB" in capsys.readouterr().out
    _run(project, "eval", cnn_id)
    with pytest.raises(SystemExit, match="raw-IQ CNN"):
        _run(project, "quantize", cnn_id)


def test_quantize_compare(project, capsys):
    root, _, _ = project
    _run(project, "train", "--epochs", "2", "--seed", "4")
    model_id, _ = _newest_meta(root)
    capsys.readouterr()
    _run(project, "quantize", model_id, "--compare", "--no-fold-bn", "--range-mode",
         "reference", figures=True)
    assert "Max per-SNR accuracy delta" in capsys.readouterr().out
    for name in (f"quant-accuracy-{model_id}.mat", f"quant-cm-float-{model_id}.json",
                 f"quant-cm-int16-{model_id}.json", f"quant-accuracy-{model_id}.png",
                 f"quant-cm-float-{model_id}.png", f"quant-cm-int16-{model_id}.png"):
        assert (root / "figures" / name).exists()


def test_cli_requires_command(tmp_path):
    with pytest.raises(SystemExit):
        main(["--root", str(tmp_path)])


def test_extract_without_dataset_friendly_error(tmp_path):
    with pytest.raises(SystemExit, match="all_modulations.mat"):
        main(["--root", str(tmp_path), "--device", "cpu", "extract"])


def test_default_device_is_cuda_and_raises_without_it(project, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, cfg_yaml, _ = project
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--root", str(root), "--config", str(cfg_yaml), "train", "--epochs", "1"])


def test_module_entry_point_info(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "amcpy_tpu_torch", "--root", str(tmp_path), "--device", "cpu",
         "info"],
        capture_output=True, text=True, timeout=120, cwd=Path(__file__).resolve().parent.parent,
    )
    assert out.returncode == 0, out.stderr
    assert "amcpy_tpu_torch" in out.stdout and "extraction kernel: auto" in out.stdout


def test_config_reads_the_json_form_without_pyyaml(tmp_path, monkeypatch):
    """The card's machine has no PyYAML: a config written in YAML's JSON
    form still reads."""
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps({"signals": {"num_frames": 50}, "training": {"epochs": 2}}))
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = Config.from_yaml(path)
    assert (cfg.signals.num_frames, cfg.training.epochs) == (50, 2)


@pytest.mark.parametrize("command", ["eval", "quantize"])
def test_eval_and_quantize_refuse_a_resnet_checkpoint(project, tmp_path, command):
    """The port serves the RadioML 2018 ResNet only: ``eval`` and
    ``quantize`` refuse its checkpoint up front, before any data is read."""
    from amcpy_tpu_torch.models.resnet import RadioResNet
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint

    _, cfg_yaml, cfg = project
    cfg = cfg.replace(paths={"root": str(tmp_path)})
    save_checkpoint(cfg, "rn", RadioResNet(n_classes=6, frame_size=SIZE),
                    Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32)))
    with pytest.raises(SystemExit, match="serves this family only"):
        main(["--root", str(tmp_path), "--config", str(cfg_yaml), "--device", "cpu",
              command, "rn"])


@pytest.mark.parametrize("command", [["eval", "mc"], ["quantize", "mc"],
                                     ["train", "--resume", "mc"],
                                     ["train", "--model", "cnn", "--resume", "mc"]],
                         ids=["eval", "quantize", "train", "train-cnn"])
def test_eval_quantize_and_train_refuse_an_mcldnn_checkpoint(project, tmp_path, command):
    """The port serves MCLDNN only: ``eval``, ``quantize`` and a resumed
    ``train`` refuse its checkpoint up front, by the family check, before
    any data is read (``tmp_path`` holds none)."""
    from amcpy_tpu_torch.models.mcldnn import RadioMCLDNN
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint

    _, cfg_yaml, cfg = project
    cfg = cfg.replace(paths={"root": str(tmp_path)})
    save_checkpoint(cfg, "mc", RadioMCLDNN(n_classes=6, frame_size=SIZE),
                    Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32)))
    with pytest.raises(SystemExit, match="it does not evaluate, quantize or train it"):
        main(["--root", str(tmp_path), "--config", str(cfg_yaml), "--device", "cpu",
              *command])
