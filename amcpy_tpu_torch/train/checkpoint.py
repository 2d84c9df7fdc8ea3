"""Model checkpoints for inference, and the weight carry-across from flax.

Counterpart of the inference part of ``amcpy_tpu/train/checkpoint.py``. A
checkpoint is ``ann/model-{id}.pt`` (the model's ``state_dict``, read back
with ``weights_only=True``) plus ``ann/model-{id}.json``, a sidecar with
the same keys as the JAX package's: scaler, used columns, training
hyperparameters, split provenance and model family.

:func:`params_from_flax` maps the JAX package's flax parameter and
batch-statistics pytrees (as NumPy arrays) onto :class:`AMCClassifier`, so
one set of weights runs in both packages. Optimizer state, training resume
and the flax-msgpack reader wait for later slices.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from collections import OrderedDict
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import Standardizer

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "resolve_model_id",
    "params_from_flax",
]


def _write_atomic(path: Path, data, mode: str) -> None:
    """Never expose a half-written file to a reader."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name)
    try:
        with os.fdopen(fd, mode) as f:
            f.write(data)
        os.replace(tmp, str(path))
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def save_checkpoint(
    cfg: Config,
    model_id: str,
    model: AMCClassifier,
    scaler: Standardizer,
    history: dict[str, list[float]] | None = None,
    epoch: int | None = None,
    model_meta: dict[str, Any] | None = None,
) -> Path:
    """Write ``model-{id}.pt`` and its JSON sidecar; return the ``.pt`` path."""
    cfg.paths.ensure_dirs()
    path = cfg.paths.trained_ann / f"model-{model_id}.pt"
    buf = io.BytesIO()
    torch.save(
        OrderedDict((k, v.detach().cpu()) for k, v in model.state_dict().items()),
        buf,
    )
    meta = {
        "model_id": model_id,
        "epoch": epoch,
        "history": history or {},
        "scaler": scaler.to_dict(),
        "config": {
            "features": {
                "used": list(cfg.features.used),
                "used_columns": list(cfg.features.used_columns),
            },
            "training": {
                "hidden_sizes": list(cfg.training.hidden_sizes),
                "dropout": cfg.training.dropout,
                "activation": cfg.training.activation,
                "optimizer": cfg.training.optimizer,
                "learning_rate": cfg.training.learning_rate,
                "seed": cfg.training.seed,
                "test_size": cfg.training.test_size,
                "training_snr": list(cfg.training.training_snr),
            },
            "signals": {
                "num_frames": cfg.signals.num_frames,
                "num_snr": cfg.signals.num_snr,
                "modulations": list(cfg.signals.modulations_with_noise),
            },
            "n_classes": len(cfg.signals.modulations_with_noise),
            "model": model_meta or {"family": "mlp"},
        },
    }
    _write_atomic(path, buf.getvalue(), "wb")
    _write_atomic(
        cfg.paths.trained_ann / f"model-{model_id}.json",
        json.dumps(meta, indent=2), "w",
    )
    return path


def load_checkpoint(
    cfg: Config, model_id: str
) -> tuple[AMCClassifier, Standardizer, dict[str, Any]]:
    """Rebuild the model (on the CPU, in eval mode), its scaler and the
    sidecar metadata."""
    meta = json.loads(
        (cfg.paths.trained_ann / f"model-{model_id}.json").read_text()
    )
    mcfg = meta["config"].get("model") or {"family": "mlp"}
    if mcfg.get("family", "mlp") != "mlp":
        raise NotImplementedError(
            f"model family {mcfg.get('family')!r} is not ported yet "
            "(ROADMAP Queue A, item 15)"
        )
    tcfg = meta["config"]["training"]
    model = AMCClassifier(
        n_classes=meta["config"]["n_classes"],
        hidden_sizes=tuple(tcfg["hidden_sizes"]),
        dropout=tcfg["dropout"],
        activation=tcfg["activation"],
        in_features=len(meta["config"]["features"]["used_columns"]),
    )
    state = torch.load(
        cfg.paths.trained_ann / f"model-{model_id}.pt",
        map_location="cpu", weights_only=True,
    )
    model.load_state_dict(state)
    model.eval()
    return model, Standardizer.from_dict(meta["scaler"]), meta


def resolve_model_id(cfg: Config, model_id: str | None = None) -> str:
    """Use the given id or fall back to the newest ``.pt`` checkpoint by
    mtime."""
    if model_id:
        return model_id
    ckpts = sorted(
        cfg.paths.trained_ann.glob("model-*.pt"),
        key=lambda p: p.stat().st_mtime,
    )
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {cfg.paths.trained_ann}")
    newest = ckpts[-1].stem.replace("model-", "")
    print(f"No model ID given — using newest: {newest}")
    return newest


def params_from_flax(
    params: Mapping[str, Mapping[str, Any]],
    batch_stats: Mapping[str, Mapping[str, Any]],
) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`AMCClassifier` from the flax pytrees.

    * ``Dense_k.kernel`` (in, out) -> ``dense.k.weight`` (out, in),
      transposed; ``Dense_k.bias`` -> ``dense.k.bias``;
    * ``BatchNorm_k.scale``/``bias`` -> ``norm.k.weight``/``bias``;
    * batch stats ``BatchNorm_k.mean``/``var`` -> ``norm.k.running_mean``/
      ``running_var``;
    * the last ``Dense_{len(hidden)}`` -> ``out``.
    """
    def arr(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    n_hidden = sum(1 for k in params if k.startswith("BatchNorm_"))
    state: OrderedDict[str, torch.Tensor] = OrderedDict()
    for k in range(n_hidden):
        dense = params[f"Dense_{k}"]
        state[f"dense.{k}.weight"] = arr(dense["kernel"]).T.contiguous()
        state[f"dense.{k}.bias"] = arr(dense["bias"])
    for k in range(n_hidden):
        bn, st = params[f"BatchNorm_{k}"], batch_stats[f"BatchNorm_{k}"]
        state[f"norm.{k}.weight"] = arr(bn["scale"])
        state[f"norm.{k}.bias"] = arr(bn["bias"])
        state[f"norm.{k}.running_mean"] = arr(st["mean"])
        state[f"norm.{k}.running_var"] = arr(st["var"])
        state[f"norm.{k}.num_batches_tracked"] = torch.tensor(0)
    last = params[f"Dense_{n_hidden}"]
    state["out.weight"] = arr(last["kernel"]).T.contiguous()
    state["out.bias"] = arr(last["bias"])
    return state
