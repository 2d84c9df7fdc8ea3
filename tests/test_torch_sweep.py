"""The port's sweep (``amcpy_tpu_torch/train/sweep.py``) and ``sweep``
subcommand on the CPU, against the JAX package's ``train/sweep.py``.

The proposals are NumPy on ``np.random.default_rng(seed)`` in both
packages, so for one seed and one history of trial metrics the port must
propose the identical parameters, value for value. Trials train with each
package's own ``train``, so their metrics are the port's; a ``random``
sweep gives the identical trials at ``parallel`` 1 and 2 (each trial trains
from its own seed). The cases are those of ``tests/test_sweep.py``.
"""

import json
import sys

import numpy as np
import pytest

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.train import sweep as jax_sweep
from amcpy_tpu_torch.cli import main
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat
from amcpy_tpu_torch.train import sweep

LOG_SPEC = {
    "dropout": {"values": [0.1, 0.2]},
    "lr": {"distribution": "log_uniform", "min": 1e-4, "max": 1e-2},
    "width": {"distribution": "int_uniform", "min": 6, "max": 12},
    "gain": {"min": 0.5, "max": 2.0},
}


def _toy_objective(p):
    """A smooth objective over the reference space, best at lr 0.00125,
    hl1 24, hl2 12, dropout 0.3, epochs 25 (``tests/test_sweep.py``)."""
    if "layer_size_hl1" not in p:
        return -np.log(p["lr"] / 1e-3) ** 2 - (p["width"] - 9) ** 2 / 9 - (p["gain"] - 1) ** 2
    return (
        -np.log(p["learning_rate"] / 0.00125) ** 2
        - ((p["layer_size_hl1"] - 24) / 24.0) ** 2
        - ((p["layer_size_hl2"] - 12) / 24.0) ** 2
        - 0.2 * (p["dropout"] - 0.3) ** 2
        - ((p["epochs"] - 25) / 25.0) ** 2
    )


def _proposals(mod, method, spec, seed, n):
    rng = np.random.default_rng(seed)
    hist = []
    for _ in range(n):
        if method == "bayes":
            p = mod.suggest_tpe(spec, hist, rng)
        else:
            p = mod.sample_params(spec, rng)
        hist.append({"params": p, "metric": _toy_objective(p)})
    return hist


@pytest.mark.parametrize("method", ["bayes", "random"])
@pytest.mark.parametrize("spec_name,seed", [("default", 11), ("default", 3), ("log", 5)])
def test_proposals_are_jaxs(method, spec_name, seed):
    spec = sweep.DEFAULT_SPEC if spec_name == "default" else LOG_SPEC
    assert sweep.DEFAULT_SPEC == jax_sweep.DEFAULT_SPEC
    got = _proposals(sweep, method, spec, seed, 30)
    want = _proposals(jax_sweep, method, spec, seed, 30)
    for g, w in zip(got, want):
        assert g["params"] == w["params"]
        assert [type(v) for v in g["params"].values()] == [type(v) for v in w["params"].values()]
    if spec_name == "default" and method == "bayes":  # tests/test_sweep.py's domain case
        for t in got:
            p = t["params"]
            assert p["batch_size"] in (32, 64, 96, 128, 160, 196)
            assert 5 <= p["epochs"] <= 30 and isinstance(p["epochs"], int)
            assert 0.0005 <= p["learning_rate"] <= 0.002


@pytest.mark.parametrize("x", [0.3, 0.9, 1.7])
def test_parzen_logpdf_is_jaxs(x):
    obs = np.array([0.5, 0.7, 1.1, 1.9])
    assert sweep._parzen_logpdf(x, obs, 0.5, 2.0) == jax_sweep._parzen_logpdf(x, obs, 0.5, 2.0)


def test_tpe_beats_random_search():
    """The JAX package's bar for its TPE (mean best-so-far over 8 seeds,
    at 20 trials and at 40), held by the port's."""
    def curves(method):
        return np.stack([
            np.maximum.accumulate([t["metric"] for t in _proposals(sweep, method,
                                                                   sweep.DEFAULT_SPEC, s, 40)])
            for s in range(8)
        ])
    bayes, rand = curves("bayes"), curves("random")
    assert bayes[:, 19].mean() > rand[:, 19].mean()
    assert bayes[:, -1].mean() > rand[:, -1].mean()


WANDB_YAML = (
    "method: bayes\nmetric:\n  goal: maximize\n  name: accuracy\n"
    "parameters:\n"
    "  dropout:\n    values: [0.1, 0.2]\n"
    "  lr:\n    distribution: log_uniform\n    min: 0.0001\n    max: 0.01\n"
)


@pytest.mark.parametrize("form", ["yaml", "json_without_pyyaml"])
def test_load_sweep_spec(tmp_path, monkeypatch, form):
    path = tmp_path / "sweep.yaml"
    path.write_text(WANDB_YAML)
    want = jax_sweep.load_sweep_spec(path)
    if form == "json_without_pyyaml":
        import yaml

        path.write_text(json.dumps(yaml.safe_load(WANDB_YAML)))
        monkeypatch.setitem(sys.modules, "yaml", None)
    assert sweep.load_sweep_spec(path) == want == {
        "dropout": {"values": [0.1, 0.2]},
        "lr": {"distribution": "log_uniform", "min": 0.0001, "max": 0.01},
    }


def test_apply_params_is_jaxs():
    p = {"layer_size_hl1": 7, "layer_size_hl3": 9, "dropout": 0.2, "epochs": 3,
         "learning_rate": 1e-3, "optimizer": "adam", "batch_size": 64, "ignored": 1}
    got = sweep._apply_params(Config(), p).training
    want = jax_sweep._apply_params(JaxConfig(), p).training
    for key in ("hidden_sizes", "dropout", "epochs", "learning_rate", "optimizer",
                "batch_size", "activation"):
        assert getattr(got, key) == getattr(want, key), key


def _data(seed):
    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(6), 40).astype(np.int32)
    x = (rng.standard_normal((240, 6)) + 2.0 * y[:, None]).astype(np.float32)
    order = rng.permutation(240)
    x, y = x[order], y[order]
    return x[:180], y[:180], x[180:], y[180:]


SPEC = {
    "epochs": {"values": [2]},
    "batch_size": {"values": [32]},
    "dropout": {"values": [0.2, 0.4]},
    "learning_rate": {"distribution": "uniform", "min": 1e-3, "max": 2e-3},
    "optimizer": {"values": ["adam"]},
    "layer_size_hl1": {"distribution": "int_uniform", "min": 6, "max": 12},
    "layer_size_hl2": {"values": [8]},
    "layer_size_hl3": {"values": [8]},
}


def test_run_sweep_two_trials(tmp_path):
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           training={"epochs": 2, "batch_size": 32})
    best, trials = sweep.run_sweep(cfg, *_data(2), spec=SPEC, n_trials=2, seed=3,
                                   device="cpu")
    assert len(trials) == 2
    assert best["metric"] == max(t["metric"] for t in trials)
    want = _proposals(jax_sweep, "bayes", SPEC, 3, 2)  # TPE: random for 5 trials
    assert [t["params"] for t in trials] == [w["params"] for w in want]
    log = (tmp_path / "metrics" / "sweep.jsonl").read_text().strip().split("\n")
    assert [json.loads(line)["trial"] for line in log] == [0, 1]


def test_random_sweep_parallel_matches_sequential(tmp_path):
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           training={"epochs": 2, "batch_size": 32})
    kw = dict(spec=SPEC, n_trials=4, seed=7, method="random", device="cpu")
    best_seq, seq = sweep.run_sweep(cfg, *_data(4), log_path=tmp_path / "seq.jsonl",
                                    parallel=1, **kw)
    best_par, par = sweep.run_sweep(cfg, *_data(4), log_path=tmp_path / "par.jsonl",
                                    parallel=2, **kw)
    assert [t["params"] for t in par] == [t["params"] for t in seq]
    assert [t["metric"] for t in par] == [t["metric"] for t in seq]
    assert best_par["trial"] == best_seq["trial"]


@pytest.mark.parametrize("pyyaml", [True, False])
def test_sweep_command_best_config_reads_back(tmp_path, monkeypatch, pyyaml):
    """``sweep`` writes ``metrics/sweep_best.yaml`` (YAML, or YAML's JSON
    form without PyYAML) and ``--config`` of it trains with the best
    trial's settings."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text('{"signals": {"num_frames": 6, "frame_size": 128}}')
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"parameters": SPEC}))
    base = ["--root", str(tmp_path), "--device", "cpu"]
    cfg = Config.from_yaml(cfg_path).replace(paths={"root": str(tmp_path)})
    rng = np.random.default_rng(0)
    for mod in cfg.signals.modulations_with_noise:
        io_mat.save_features(cfg, mod, rng.standard_normal((16, 6, 18)).astype(np.float32))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # no figures: numbers only
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    main(base + ["--config", str(cfg_path), "sweep", "--trials", "2", "--seed", "1",
                 "--method", "random", "--spec", str(spec)])
    best_path = tmp_path / "metrics" / "sweep_best.yaml"
    text = best_path.read_text()
    assert text.lstrip().startswith("{") != pyyaml
    trials = [json.loads(line) for line in
              (tmp_path / "metrics" / "sweep.jsonl").read_text().splitlines()]
    best = max(trials, key=lambda t: t["metric"])
    t = Config.from_yaml(best_path).training
    assert t.hidden_sizes == (best["params"]["layer_size_hl1"], 8, 8)
    assert (t.epochs, t.dropout, t.optimizer) == (2, best["params"]["dropout"], "adam")
    main(base + ["--config", str(best_path), "train", "--seed", "0"])
    meta = json.loads(next((tmp_path / "ann").glob("model-*.json")).read_text())
    assert tuple(meta["config"]["training"]["hidden_sizes"]) == t.hidden_sizes
