"""Hyperparameter sweeps: the port's counterpart of ``amcpy_tpu/train/sweep.py``.

The reference shipped a W&B Bayesian sweep spec (``sweep.yaml``:
``method: bayes``; batch {32..196}, dropout {0.2, 0.3, 0.4}, epochs 5-30,
hidden sizes 6-30, lr 5e-4..2e-3, rmsprop). Here sweeps need no service:

* :func:`load_sweep_spec` parses the W&B sweep schema (``values`` lists,
  ``int_uniform``/``uniform``/``log_uniform`` ranges), from YAML where
  PyYAML is installed and from YAML's JSON form where it is not (the
  card's machine);
* :func:`run_sweep` searches the spec with ``method="bayes"`` (a
  Tree-structured Parzen Estimator) or ``method="random"``. Proposals are
  NumPy on ``np.random.default_rng(seed)``, so for the same seed and the
  same trial metrics they are the JAX package's proposals, value for
  value. Trial ``k`` trains with the port's ``train(seed=seed + k)`` on
  the one device, and each finished trial is appended to
  ``metrics/sweep.jsonl``;
* if wandb happens to be installed, trials are mirrored to it (optional,
  never required).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from amcpy_tpu_torch.config import Config

__all__ = [
    "load_sweep_spec",
    "sample_params",
    "suggest_tpe",
    "run_sweep",
    "DEFAULT_SPEC",
]

#: The reference sweep space (sweep.yaml:5-44) in parsed form.
DEFAULT_SPEC: dict[str, dict[str, Any]] = {
    "activation": {"values": ["relu"]},
    "batch_size": {"values": [32, 64, 96, 128, 160, 196]},
    "dropout": {"values": [0.2, 0.3, 0.4]},
    "epochs": {"distribution": "int_uniform", "min": 5, "max": 30},
    "layer_size_hl1": {"distribution": "int_uniform", "min": 6, "max": 30},
    "layer_size_hl2": {"distribution": "int_uniform", "min": 6, "max": 30},
    "layer_size_hl3": {"distribution": "int_uniform", "min": 6, "max": 30},
    "learning_rate": {"distribution": "uniform", "min": 0.0005, "max": 0.002},
    "optimizer": {"values": ["rmsprop"]},
}


def load_sweep_spec(path: str | Path) -> dict[str, dict[str, Any]]:
    """Parse a W&B-format sweep YAML into a parameter spec dict. Without
    PyYAML the file must be written in YAML's JSON form, which ``json``
    reads."""
    text = Path(path).read_text()
    try:
        import yaml
    except ImportError:
        raw = json.loads(text)
    else:
        raw = yaml.safe_load(text)
    return dict(raw.get("parameters", raw))


def sample_params(
    spec: Mapping[str, Mapping[str, Any]], rng: np.random.Generator
) -> dict[str, Any]:
    """Draw one configuration from the spec."""
    out: dict[str, Any] = {}
    for name, p in spec.items():
        if "values" in p:
            vals = list(p["values"])
            out[name] = vals[int(rng.integers(0, len(vals)))]
        elif p.get("distribution") == "int_uniform":
            out[name] = int(rng.integers(int(p["min"]), int(p["max"]) + 1))
        elif p.get("distribution") in ("uniform", None):
            out[name] = float(rng.uniform(float(p["min"]), float(p["max"])))
        elif p.get("distribution") in ("log_uniform", "log_uniform_values"):
            lo, hi = np.log(float(p["min"])), np.log(float(p["max"]))
            out[name] = float(np.exp(rng.uniform(lo, hi)))
        else:
            raise ValueError(f"unsupported distribution for {name}: {p}")
    return out


# ---------------------------------------------------------------------------
# Tree-structured Parzen Estimator (the "bayes" method)
# ---------------------------------------------------------------------------


def _dim_domain(p: Mapping[str, Any]) -> tuple[str, Any]:
    """Classify a spec dimension: ("cat", values) | ("num", (lo, hi, kind))
    with kind in {"int", "float", "log"}."""
    if "values" in p:
        return "cat", list(p["values"])
    dist = p.get("distribution")
    lo, hi = float(p["min"]), float(p["max"])
    if dist == "int_uniform":
        return "num", (lo, hi, "int")
    if dist in ("log_uniform", "log_uniform_values"):
        return "num", (np.log(lo), np.log(hi), "log")
    return "num", (lo, hi, "float")


def _parzen_logpdf(x: float, obs: np.ndarray, lo: float, hi: float) -> float:
    """Log density of a 1-D Parzen mixture: Gaussians at each observation
    (bandwidth ~ range-scaled Scott's rule) + one uniform prior component
    so unexplored regions never get zero mass."""
    width = max(hi - lo, 1e-12)
    bw = max(width / max(np.sqrt(len(obs)), 1.0), 1e-3 * width)
    z = (x - obs) / bw
    comps = np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi))
    # mixture: observations and the uniform prior in equal parts
    pdf = (np.sum(comps) + 1.0 / width) / (len(obs) + 1)
    return float(np.log(max(pdf, 1e-300)))


def suggest_tpe(
    spec: Mapping[str, Mapping[str, Any]],
    history: list[dict[str, Any]],
    rng: np.random.Generator,
    *,
    gamma: float = 0.25,
    n_candidates: int = 32,
    n_startup: int = 5,
) -> dict[str, Any]:
    """Propose the next configuration with a Tree-structured Parzen
    Estimator (Bergstra et al. 2011, the algorithm behind W&B/hyperopt
    ``method: bayes`` for mixed spaces).

    Split observed trials into good (top ``gamma`` by metric) and bad;
    model each parameter's density separately under both (categorical:
    Laplace-smoothed counts, numeric: Parzen windows); sample candidates
    from the good density and keep the one maximizing l(x)/g(x).
    Falls back to random search during the first ``n_startup`` trials.
    """
    if len(history) < n_startup:
        return sample_params(spec, rng)
    scores = np.asarray([t["metric"] for t in history], dtype=np.float64)
    n_good = max(1, int(np.ceil(gamma * len(history))))
    good_set = set(np.argsort(scores)[::-1][:n_good].tolist())
    good = [history[i]["params"] for i in sorted(good_set)]
    bad = [
        history[i]["params"]
        for i in range(len(history))
        if i not in good_set
    ] or good  # degenerate: everything is "good"

    best_cand: dict[str, Any] | None = None
    best_score = -np.inf
    for _ in range(n_candidates):
        cand: dict[str, Any] = {}
        acq = 0.0  # log l(x) - log g(x)
        for name, p in spec.items():
            kind, dom = _dim_domain(p)
            if kind == "cat":
                values = dom
                k = len(values)
                cg = np.array(
                    [sum(g[name] == v for g in good) for v in values],
                    dtype=np.float64,
                )
                cb = np.array(
                    [sum(b[name] == v for b in bad) for v in values],
                    dtype=np.float64,
                )
                pg = (cg + 1.0) / (cg.sum() + k)
                pb = (cb + 1.0) / (cb.sum() + k)
                vi = int(rng.choice(k, p=pg))
                cand[name] = values[vi]
                acq += float(np.log(pg[vi]) - np.log(pb[vi]))
            else:
                lo, hi, num_kind = dom

                def to_internal(v):
                    return np.log(v) if num_kind == "log" else float(v)

                og = np.asarray([to_internal(g[name]) for g in good])
                ob = np.asarray([to_internal(b[name]) for b in bad])
                width = max(hi - lo, 1e-12)
                bw = max(
                    width / max(np.sqrt(len(og)), 1.0), 1e-3 * width
                )
                # draw from the good mixture (uniform prior component incl.)
                if rng.uniform() < 1.0 / (len(og) + 1):
                    x = rng.uniform(lo, hi)
                else:
                    x = float(
                        np.clip(rng.choice(og) + bw * rng.normal(), lo, hi)
                    )
                if num_kind == "int":
                    x = float(np.clip(round(x), lo, hi))
                acq += _parzen_logpdf(x, og, lo, hi) - _parzen_logpdf(
                    x, ob, lo, hi
                )
                if num_kind == "int":
                    cand[name] = int(x)
                elif num_kind == "log":
                    cand[name] = float(np.exp(x))
                else:
                    cand[name] = float(x)
        if acq > best_score:
            best_cand, best_score = cand, acq
    assert best_cand is not None
    return best_cand


def _apply_params(cfg: Config, params: Mapping[str, Any]) -> Config:
    """Map sweep-parameter names (reference naming) onto the config tree."""
    t: dict[str, Any] = {}
    hidden = list(cfg.training.hidden_sizes)
    for k, v in params.items():
        if k == "layer_size_hl1":
            hidden[0] = int(v)
        elif k == "layer_size_hl2":
            hidden[1] = int(v)
        elif k == "layer_size_hl3":
            hidden[2] = int(v)
        elif k in (
            "activation", "batch_size", "dropout", "epochs",
            "learning_rate", "optimizer",
        ):
            t[k] = v
    t["hidden_sizes"] = tuple(hidden)
    return cfg.replace(training=t)


def _run_one_trial(
    cfg, params, trial_idx, seed, metric,
    x_train, y_train, x_test, y_test, device,
):
    from amcpy_tpu_torch.train.training import train

    trial_cfg = _apply_params(cfg, params)
    t0 = time.perf_counter()
    _, _, history, model_id = train(
        trial_cfg, x_train, y_train, x_test, y_test,
        seed=seed + trial_idx, device=device,
    )
    return {
        "trial": trial_idx,
        "model_id": model_id,
        "params": params,
        "metric": float(history[metric][-1]),
        "history_last": {k: float(v[-1]) for k, v in history.items()},
        "wall_s": time.perf_counter() - t0,
    }


def run_sweep(
    cfg: Config,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    *,
    spec: Mapping[str, Mapping[str, Any]] | None = None,
    n_trials: int = 20,
    seed: int = 0,
    metric: str = "val_accuracy",
    log_path: str | Path | None = None,
    method: str = "bayes",
    parallel: int = 1,
    device: "str | torch.device | None" = None,
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Hyperparameter sweep: ``method="bayes"`` (TPE, the default, as the
    reference spec's ``method: bayes``) or ``"random"``. Returns
    ``(best_trial, all_trials)``.

    ``parallel=P`` runs trials in rounds of P, each round's trials in a
    thread pool on the one device (the ~2.6k-parameter model leaves most
    of a card idle, and each trial's host dispatch overlaps the others').
    Trial ``k`` always trains with ``seed + k`` from its own generator, so
    ``method="random"`` proposes the identical parameters at any
    ``parallel``; for ``method="bayes"`` the TPE proposes each round's P
    configurations from the history at the round's start (batched TPE;
    equal to sequential when P = 1).

    Each trial record: ``{"trial", "model_id", "params", "metric",
    "history_last", "wall_s"}``, appended as JSONL as it completes, so an
    interrupted sweep keeps its finished work.
    """
    from concurrent.futures import ThreadPoolExecutor

    from amcpy_tpu_torch.utils.device import resolve_device

    if method not in ("bayes", "random"):
        raise ValueError(f"unknown sweep method {method!r}")
    dev = resolve_device(device)
    spec = dict(spec or DEFAULT_SPEC)
    rng = np.random.default_rng(seed)
    log_file = Path(log_path) if log_path else cfg.paths.metrics / "sweep.jsonl"
    log_file.parent.mkdir(parents=True, exist_ok=True)

    try:
        import wandb  # noqa: F401 (optional mirror only)

        have_wandb = True
    except ImportError:
        have_wandb = False

    parallel = max(1, min(parallel, n_trials))
    trials: list[dict[str, Any]] = []
    best: dict[str, Any] | None = None

    def finish(record):
        nonlocal best
        with open(log_file, "a") as f:
            f.write(json.dumps(record) + "\n")
        if have_wandb:
            try:
                import wandb

                run = wandb.init(
                    project="amcpy-tpu-sweep", config=record["params"],
                    reinit=True,
                )
                run.log({metric: record["metric"]})
                run.finish()
            except Exception:
                pass
        trials.append(record)
        if best is None or record["metric"] > best["metric"]:
            best = record
        print(
            f"[sweep {record['trial'] + 1}/{n_trials}] {metric}="
            f"{record['metric']:.4f} best={best['metric']:.4f} "
            f"{record['params']}"
        )

    trial_idx = 0
    while trial_idx < n_trials:
        round_n = min(parallel, n_trials - trial_idx)
        # the whole round is proposed up front (deterministic given the
        # seed and the history at the round's start)
        round_params = []
        for _ in range(round_n):
            if method == "bayes":
                round_params.append(suggest_tpe(spec, trials, rng))
            else:
                round_params.append(sample_params(spec, rng))
        args = (seed, metric, x_train, y_train, x_test, y_test, dev)
        if round_n == 1:
            finish(_run_one_trial(cfg, round_params[0], trial_idx, *args))
        else:
            with ThreadPoolExecutor(max_workers=round_n) as pool:
                futs = [
                    pool.submit(_run_one_trial, cfg, p, trial_idx + j, *args)
                    for j, p in enumerate(round_params)
                ]
                for fut in futs:  # keep trial order in the log
                    finish(fut.result())
        trial_idx += round_n
    if best is None:
        raise ValueError("run_sweep needs n_trials >= 1")
    return best, trials
