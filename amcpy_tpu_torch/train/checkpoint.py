"""Checkpoints, resume, and the carry-across from the JAX package.

Counterpart of ``amcpy_tpu/train/checkpoint.py``. A checkpoint is
``ann/model-{id}.pt`` plus ``ann/model-{id}.json``, a sidecar with the same
keys as the JAX package's: scaler, used columns, training hyperparameters,
split provenance, history, epoch and model family. ``model.family`` is
``"mlp"`` (the feature MLP), ``"cnn"`` (the raw-IQ :class:`IQConvNet`),
``"resnet"`` (the RadioML 2018 :class:`RadioResNet`) or ``"mcldnn"`` (the
conv + LSTM :class:`RadioMCLDNN`); each class writes its
own ``model`` block (``sidecar``) and is rebuilt from it (``from_sidecar``),
found by its ``family`` in :data:`_FAMILIES`. The ``.pt`` file (read back with
``weights_only=True``) holds ``{"model": state_dict, "optimizer":
optimizer state_dict or None, "step": int}``, a complete snapshot to
resume from; a file holding a bare model ``state_dict`` (the port's first
format) still loads, with no optimizer state. Both files are written
atomically.

:func:`params_from_flax` and :func:`cnn_params_from_flax` map the JAX
package's flax parameter and batch-statistics pytrees (as NumPy arrays)
onto :class:`AMCClassifier` and :class:`IQConvNet`, and
:func:`opt_state_from_optax` its optax RMSprop/Adam/NAdam states onto the
port's optimizers, so a run of either package goes on in the other.

:func:`load_checkpoint` also reads the JAX package's checkpoint,
``ann/model-{id}.msgpack`` (``{params, batch_stats, opt_state, step}``
written by flax, decoded in plain Python by
:mod:`~amcpy_tpu_torch.train.flax_msgpack`) with the same sidecar, when no
``.pt`` of that id exists: such a model serves, evaluates, quantizes and
resumes in the port. The port writes ``.pt`` only. A family the JAX
package does not have (the ResNet, MCLDNN) has no such file.

With a process group up, rank 0 writes a checkpoint first; after a barrier
every other rank writes its own copy where the file is not there (as the
JAX package does, ``checkpoint.py:50-55``), so checkpoints work on a
filesystem the ranks share and on one each.
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
from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.models.mcldnn import RadioMCLDNN
from amcpy_tpu_torch.models.resnet import RadioResNet
from amcpy_tpu_torch.parallel.audit import barrier
from amcpy_tpu_torch.parallel.mesh import group_up, is_primary
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.train.training import TrainState, _optimizer

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "resolve_model_id",
    "params_from_flax",
    "cnn_params_from_flax",
    "opt_state_from_optax",
]


#: the model class of each sidecar ``model.family``
_FAMILIES = {cls.family: cls for cls in (AMCClassifier, IQConvNet, RadioResNet, RadioMCLDNN)}


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
    model: "AMCClassifier | IQConvNet | RadioResNet | RadioMCLDNN",
    scaler: Standardizer,
    history: dict[str, list[float]] | None = None,
    epoch: int | None = None,
    model_meta: dict[str, Any] | None = None,
    state: TrainState | None = None,
) -> Path:
    """Write ``model-{id}.pt`` and its JSON sidecar; return the ``.pt`` path.

    ``state`` (from :func:`~amcpy_tpu_torch.train.training.train`) adds the
    optimizer's state and the step counter, so that the run can resume.
    ``model_meta`` defaults to the model's own block, ``model.sidecar(cfg)``.
    """
    cfg.paths.ensure_dirs()
    path = cfg.paths.trained_ann / f"model-{model_id}.pt"
    buf = io.BytesIO()
    torch.save(
        {
            "model": OrderedDict(
                (k, v.detach().cpu()) for k, v in model.state_dict().items()
            ),
            "optimizer": None if state is None else state.opt_state,
            "step": 0 if state is None else int(state.step),
        },
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
            "model": model_meta or model.sidecar(cfg),
        },
    }

    def write() -> None:
        _write_atomic(path, buf.getvalue(), "wb")
        _write_atomic(
            cfg.paths.trained_ann / f"model-{model_id}.json",
            json.dumps(meta, indent=2), "w",
        )

    if is_primary():
        write()
    if group_up():
        barrier()
        if not path.exists():  # a filesystem of this rank's own
            write()
    return path


def load_checkpoint(
    cfg: Config, model_id: str
) -> tuple["AMCClassifier | IQConvNet | RadioResNet | RadioMCLDNN", TrainState,
           Standardizer, dict[str, Any]]:
    """Rebuild ``(model, state, scaler, meta)``: the model (on the CPU, in
    eval mode), its training state (the optimizer's ``state_dict``, None
    when the file has none, and the step counter), the scaler and the
    sidecar metadata. The sidecar's ``model.family`` selects the model; an
    unknown family raises ``NotImplementedError``. ``model-{id}.pt`` is
    read when it exists, else the JAX package's ``model-{id}.msgpack``."""
    meta = json.loads(
        (cfg.paths.trained_ann / f"model-{model_id}.json").read_text()
    )
    family = (meta["config"].get("model") or {}).get("family", "mlp")
    if family not in _FAMILIES:
        raise NotImplementedError(f"unknown model family {family!r}")
    model = _FAMILIES[family].from_sidecar(meta)
    pt = cfg.paths.trained_ann / f"model-{model_id}.pt"
    if pt.exists():
        blob = torch.load(pt, map_location="cpu", weights_only=True)
        if not isinstance(blob.get("model"), dict):  # a bare state_dict
            blob = {"model": blob, "optimizer": None, "step": 0}
    else:
        blob = _read_flax(
            cfg.paths.trained_ann / f"model-{model_id}.msgpack", model,
            meta["config"]["training"]["optimizer"],
        )
    model.load_state_dict(blob["model"])
    model.eval()
    state = TrainState(blob["optimizer"], int(blob["step"]))
    return model, state, Standardizer.from_dict(meta["scaler"]), meta


def _read_flax(path: Path, model, optimizer: str) -> dict:
    """``{"model", "optimizer", "step"}`` of the JAX package's checkpoint
    for ``model``, whose optax state is that of ``optimizer``."""
    from amcpy_tpu_torch.train.flax_msgpack import msgpack_restore

    to_state = _from_flax(model)
    payload = msgpack_restore(path.read_bytes())
    step = int(np.asarray(payload["step"]))
    return {
        "model": to_state(payload["params"], payload["batch_stats"]),
        "optimizer": opt_state_from_optax(optimizer, payload["opt_state"], model, step),
        "step": step,
    }


def resolve_model_id(cfg: Config, model_id: str | None = None) -> str:
    """Use the given id or fall back to the newest checkpoint by mtime, the
    port's ``.pt`` and the JAX package's ``.msgpack`` alike."""
    if model_id:
        return model_id
    ckpts = sorted(
        [*cfg.paths.trained_ann.glob("model-*.pt"),
         *cfg.paths.trained_ann.glob("model-*.msgpack")],
        key=lambda p: p.stat().st_mtime,
    )
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {cfg.paths.trained_ann}")
    newest = ckpts[-1].stem.replace("model-", "")
    print(f"No model ID given — using newest: {newest}")
    return newest


def _arr(x) -> torch.Tensor:
    """A float32 CPU tensor of a NumPy leaf or a (bfloat16) tensor leaf."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _norm_state(state, params, batch_stats, count: int) -> None:
    """``norm.k.*`` of ``state`` from flax's ``BatchNorm_k`` (k < count):
    ``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var``
    -> ``running_mean``/``running_var`` (left out when ``batch_stats`` is
    None)."""
    for k in range(count):
        bn = params[f"BatchNorm_{k}"]
        state[f"norm.{k}.weight"] = _arr(bn["scale"])
        state[f"norm.{k}.bias"] = _arr(bn["bias"])
        if batch_stats is not None:
            st = batch_stats[f"BatchNorm_{k}"]
            state[f"norm.{k}.running_mean"] = _arr(st["mean"])
            state[f"norm.{k}.running_var"] = _arr(st["var"])
            state[f"norm.{k}.num_batches_tracked"] = torch.tensor(0)


def params_from_flax(
    params: Mapping[str, Mapping[str, Any]],
    batch_stats: Mapping[str, Mapping[str, Any]] | None,
) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`AMCClassifier` from the flax pytrees.

    * ``Dense_k.kernel`` (in, out) -> ``dense.k.weight`` (out, in),
      transposed; ``Dense_k.bias`` -> ``dense.k.bias``;
    * ``BatchNorm_k`` -> ``norm.k`` (:func:`_norm_state`);
    * the last ``Dense_{len(hidden)}`` -> ``out``.
    """
    n_hidden = sum(1 for k in params if k.startswith("BatchNorm_"))
    state: OrderedDict[str, torch.Tensor] = OrderedDict()
    for k in range(n_hidden):
        dense = params[f"Dense_{k}"]
        state[f"dense.{k}.weight"] = _arr(dense["kernel"]).T.contiguous()
        state[f"dense.{k}.bias"] = _arr(dense["bias"])
    _norm_state(state, params, batch_stats, n_hidden)
    last = params[f"Dense_{n_hidden}"]
    state["out.weight"] = _arr(last["kernel"]).T.contiguous()
    state["out.bias"] = _arr(last["bias"])
    return state


def cnn_params_from_flax(
    params: Mapping[str, Mapping[str, Any]],
    batch_stats: Mapping[str, Mapping[str, Any]] | None,
) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`IQConvNet` from the flax pytrees.

    * ``Conv_k.kernel`` (k, C_in, C_out) -> ``conv.k.weight``
      (C_out, C_in, k); ``Conv_k.bias`` -> ``conv.k.bias``;
    * ``BatchNorm_k`` -> ``norm.k`` (:func:`_norm_state`);
    * ``Dense_0`` -> ``dense`` and ``Dense_1`` -> ``out``, transposed.
    """
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    state: OrderedDict[str, torch.Tensor] = OrderedDict()
    for k in range(n_conv):
        conv = params[f"Conv_{k}"]
        state[f"conv.{k}.weight"] = _arr(conv["kernel"]).permute(2, 1, 0).contiguous()
        state[f"conv.{k}.bias"] = _arr(conv["bias"])
    _norm_state(state, params, batch_stats, n_conv)
    for name, layer in (("dense", "Dense_0"), ("out", "Dense_1")):
        state[f"{name}.weight"] = _arr(params[layer]["kernel"]).T.contiguous()
        state[f"{name}.bias"] = _arr(params[layer]["bias"])
    return state


#: the map from the flax pytrees to the ``state_dict`` of each family the
#: JAX package has
_FLAX_STATE = {"mlp": params_from_flax, "cnn": cnn_params_from_flax}


def _from_flax(model):
    """The map of ``model``'s family from the flax pytrees to its
    ``state_dict``; ``NotImplementedError`` for a family the JAX package
    does not have."""
    if model.family not in _FLAX_STATE:
        raise NotImplementedError(f"the {model.family!r} family has no flax form: the JAX "
                                  "package has no such model, and the port writes .pt")
    return _FLAX_STATE[model.family]


def opt_state_from_optax(
    name: str,
    opt_state: Any,
    model: "AMCClassifier | IQConvNet",
    step: int = 0,
) -> dict[str, Any]:
    """The port's optimizer ``state_dict`` for ``model`` from the JAX
    package's optax state of optimizer ``name``: its pytree with NumPy
    leaves, as ``jax.tree.map(np.asarray, state.opt_state)`` gives it, or
    the state dict a flax msgpack file holds (the chain's states keyed
    ``"0"``, ``"1"``, …, each a dict of its fields).

    * ``rmsprop``: ``ScaleByRmsState.nu`` -> ``square_avg``; optax keeps no
      step count (RMSprop's update does not use it), so ``step`` is given;
    * ``adam``, ``nadam``: ``ScaleByAdamState`` ``mu``/``nu``/``count`` ->
      ``exp_avg``/``exp_avg_sq``/``step``.

    The moments are laid out as the parameters are
    (:func:`params_from_flax`, :func:`cnn_params_from_flax`). The state's
    ``param_groups`` hold the optimizer's defaults;
    :func:`~amcpy_tpu_torch.train.training.make_optimizer` sets the
    learning rate from the config when it loads the state.
    """
    if isinstance(opt_state, Mapping):
        opt_state = [opt_state[k] for k in sorted(opt_state, key=int)]
    inner = next(
        s if isinstance(s, Mapping) else s._asdict()
        for s in opt_state
        if (isinstance(s, Mapping) and "nu" in s) or hasattr(s, "nu")
    )
    to_state = _from_flax(model)
    names = [n for n, _ in model.named_parameters()]

    def per_param(tree) -> list[torch.Tensor]:
        flat = to_state(tree, None)
        return [flat[n] for n in names]

    if name == "rmsprop":
        moments = {"square_avg": per_param(inner["nu"])}
        count = float(step)
    elif name in ("adam", "nadam"):
        moments = {"exp_avg": per_param(inner["mu"]), "exp_avg_sq": per_param(inner["nu"])}
        count = float(np.asarray(inner["count"]))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    state = {
        i: {"step": torch.tensor(count), **{k: v[i] for k, v in moments.items()}}
        for i in range(len(names))
    }
    groups = _optimizer(name, 1e-3, model.parameters()).state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}
