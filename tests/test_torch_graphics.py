"""The port's figures (``amcpy_tpu_torch/graphics.py``) and the ``plot`` and
``full`` subcommands on the CPU, against the JAX package's
``amcpy_tpu/graphics.py``: the same statistics from the same features,
the same files where matplotlib is present, and the numbers alone where it
is absent (the card's machine has no matplotlib)."""

import sys

import numpy as np
import pytest
import scipy.io

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.graphics import feature_stats as jax_feature_stats
from amcpy_tpu.graphics import run_plots as jax_run_plots
from amcpy_tpu_torch import graphics
from amcpy_tpu_torch.cli import main
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat, synth

#: two used features keep the drawn files few
FEATURES = {"used": (2, 14)}


def _features(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {m: rng.standard_normal((cfg.signals.num_snr, 5, 18)).astype(np.float32)
            for m in cfg.signals.modulations_with_noise}


@pytest.mark.parametrize("used", [(2, 4, 6, 8, 12, 14), (1, 18)])
@pytest.mark.parametrize("parity_columns", [False, True])
def test_feature_stats_matches_jax(used, parity_columns):
    feats = _features(Config(), seed=len(used))
    over = {"used": used, "reference_parity_columns": parity_columns}
    if parity_columns and 18 in used:
        over["used"] = (1, 17)
    got = graphics.feature_stats(feats, Config().replace(features=over))
    want = jax_feature_stats(feats, JaxConfig().replace(features=over))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _files(root):
    return sorted(p.name for p in (root / "figures" / "features").iterdir())


def test_run_plots_draws_the_jax_packages_files(tmp_path):
    feats = _features(Config())
    cfg = Config().replace(paths={"root": str(tmp_path / "port")}, features=FEATURES)
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path / "jax")}, features=FEATURES)
    path = graphics.run_plots(cfg, feats)
    jax_run_plots(jcfg, feats)
    assert _files(tmp_path / "port") == sorted(_files(tmp_path / "jax") + [path.name])
    stats = scipy.io.loadmat(str(path))
    data = np.stack([feats[m] for m in cfg.signals.modulations_with_noise])
    np.testing.assert_allclose(stats["mean"], data.mean(axis=2), rtol=1e-6)
    np.testing.assert_allclose(stats["std"], data.std(axis=2), rtol=1e-6)
    assert stats["mean"].shape == (6, 16, 18)
    np.testing.assert_array_equal(stats["used_columns"].ravel(), [1, 13])


def test_run_plots_writes_numbers_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not graphics.have_matplotlib()
    cfg = Config().replace(paths={"root": str(tmp_path)}, features=FEATURES)
    graphics.run_plots(cfg, _features(cfg))
    assert _files(tmp_path) == ["feature_stats.mat"]
    assert "matplotlib is absent" in capsys.readouterr().out


def test_plot_and_full_commands(tmp_path, monkeypatch, capsys):
    """``generate`` -> ``full`` (extract -> plot -> train) -> ``plot``
    without matplotlib."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text('{"signals": {"num_frames": 6, "frame_size": 128}, '
                   '"training": {"epochs": 2, "batch_size": 32}, '
                   '"features": {"used": [2, 14]}}')
    base = ["--root", str(tmp_path), "--config", str(cfg), "--device", "cpu"]
    main(base + ["generate", "--seed", "4"])
    main(base + ["full"])
    out = capsys.readouterr().out
    assert "All feature calculations complete!" in out and "Mean accuracy" in out
    model_id = next((tmp_path / "ann").glob("model-*.pt")).stem[len("model-"):]
    for name in (f"cm-{model_id}.png", f"accuracy-{model_id}.png",
                 f"history-{model_id}.png", f"cm-{model_id}.json"):
        assert (tmp_path / "figures" / name).exists(), name
    assert "feature_stats.mat" in _files(tmp_path)
    assert "ft2_mean.png" in _files(tmp_path) and "all_plots.html" in _files(tmp_path)
    for p in (tmp_path / "figures" / "features").iterdir():
        p.unlink()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    main(base + ["plot"])
    assert _files(tmp_path) == ["feature_stats.mat"]
    assert "matplotlib is absent" in capsys.readouterr().out


def test_generate_command_writes_the_seeds_frames(tmp_path):
    main(["--root", str(tmp_path), "--device", "cpu", "generate", "--seed", "5",
          "--frames", "3", "--frame-size", "64"])
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"num_frames": 3, "frame_size": 64})
    want = synth.generate_dataset(cfg, seed=5, device="cpu")
    got = io_mat.load_dataset(cfg)
    for mod, arr in got.items():
        np.testing.assert_array_equal(arr, want[cfg.signals.mat_info[mod]])
