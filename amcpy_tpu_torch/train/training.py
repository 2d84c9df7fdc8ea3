"""Classifier training on one device.

Counterpart of ``amcpy_tpu/train/training.py``, for both model families
(the feature MLP built from ``cfg.training``, or any module passed as
``model``, such as the raw-IQ :class:`~amcpy_tpu_torch.models.cnn.IQConvNet`).
The JAX package runs an epoch as one device program; here an epoch is a
loop of eager steps that never waits for the device:

* the training and test sets are resident on the device, and each batch is
  gathered there by index from the epoch's row order, a permutation drawn
  on the device from the run's generator;
* loss and accuracy are summed on the device; the epoch's metrics are read
  once, after the full-test-set evaluation in eval mode;
* float32 products run without TF32 (``utils/device.no_tf32``).

The batching keeps the JAX geometry: ``batch_size = min(batch_size, n)``,
``n_batches = max(n // batch_size, 1)``, the permutation wrapped to
``n_batches * batch_size`` rows (``training.py:156-158``), softmax
cross-entropy on the logits. :func:`run_epoch` takes the row order as a
tensor, so a test can give it the order a JAX epoch draws.

Optimizers compute what the JAX package's optax transformations compute:
``rmsprop`` is ``torch.optim.RMSprop(alpha=0.99, eps=1e-8)`` (optax's
``eps_in_sqrt=False``), ``adam`` is ``torch.optim.Adam``, and ``nadam`` is
:class:`OptaxNAdam`, the port's own: ``torch.optim.NAdam`` is another
algorithm (a momentum-decay schedule).

Random draws come from explicit generators: a CPU generator seeded with
``seed`` initializes the model (flax's defaults in distribution) and seeds
the run's device generator, which draws each epoch's row order, the
dropout masks and the CNN's augmentation.

Not ported: the jit cache of epoch programs (eager PyTorch compiles
nothing) and ``predict_logits_global`` (multi-process, ROADMAP A17).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.models.layers import init_flax_defaults
from amcpy_tpu_torch.utils.device import no_tf32, resolve_device
from amcpy_tpu_torch.utils.metrics import MetricsLogger, stage_timer

__all__ = [
    "HISTORY_KEYS",
    "OptaxNAdam",
    "TrainState",
    "accuracy",
    "epoch_order",
    "make_optimizer",
    "predict_logits",
    "run_epoch",
    "train",
    "train_step",
]

#: the history's keys, in the order an epoch's metrics are read
HISTORY_KEYS = ("loss", "accuracy", "val_loss", "val_accuracy")
#: rows per forward when evaluating (bounds the CNN's activations)
EVAL_CHUNK = 4096


@dataclass
class TrainState:
    """What a training run carries besides the model's own state:
    the optimizer's ``state_dict`` (None before any step) and the number
    of optimizer steps taken."""

    opt_state: dict[str, Any] | None
    step: int


class OptaxNAdam(torch.optim.Optimizer):
    """``optax.nadam``: Adam with Nesterov momentum as optax computes it.

    Per parameter, with gradient g at step t (counted from 1)::

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
        nu_hat = nu / (1 - b2^t)
        p -= lr mu_hat / (sqrt(nu_hat) + eps)

    The state keys are ``torch.optim.Adam``'s (``step``, ``exp_avg``,
    ``exp_avg_sq``), ``step`` a float32 tensor on the CPU, so reading it
    never waits for the device.
    """

    def __init__(
        self,
        params: Iterable,
        lr: float = 1e-3,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
    ):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = int(state["step"].item())
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = b1 * (mu / (1 - b1 ** (t + 1))) + (1 - b1) * (g / (1 - b1**t))
                nu_hat = nu / (1 - b2**t)
                p.sub_(group["lr"] * (mu_hat / (nu_hat.sqrt() + group["eps"])))
        return loss


def _optimizer(name: str, lr: float, params: Iterable) -> torch.optim.Optimizer:
    if name == "rmsprop":
        # torch's RMSprop is optax.rmsprop(decay=0.99, eps_in_sqrt=False)
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "nadam":
        return OptaxNAdam(params, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


def make_optimizer(
    cfg: Config, params: Iterable, state: dict[str, Any] | None = None
) -> torch.optim.Optimizer:
    """``cfg.training``'s optimizer over ``params``; with ``state`` (an
    optimizer ``state_dict``) its moments and step counts are restored and
    the learning rate stays ``cfg``'s, as a resumed JAX run rebuilds its
    optax transformation from the config."""
    t = cfg.training
    opt = _optimizer(t.optimizer, t.learning_rate, params)
    if state is not None:
        opt.load_state_dict(state)
        for group in opt.param_groups:
            group["lr"] = t.learning_rate
    return opt


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    xb: torch.Tensor,
    yb: torch.Tensor,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch, the model in training mode: softmax
    cross-entropy on the logits (the batch mean), its gradient, the
    optimizer's update. Returns the batch's loss and accuracy as device
    scalars (nothing is read to the host)."""
    logits = model(xb, generator=generator)
    loss = F.cross_entropy(logits, yb)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    acc = (logits.detach().argmax(-1) == yb).float().mean()
    return loss.detach(), acc


def epoch_order(
    n: int, take: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """One epoch's row order on ``device``: a permutation of ``n`` rows
    drawn from ``generator``, wrapped to ``take`` rows."""
    perm = torch.randperm(n, generator=generator, device=device)
    return perm[torch.arange(take, device=device) % n]


@torch.no_grad()
def predict_logits(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits of the rows of ``x`` (a tensor on the model's
    device), ``EVAL_CHUNK`` rows a forward. The model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        return torch.cat([model(x[i : i + EVAL_CHUNK])
                          for i in range(0, x.shape[0], EVAL_CHUNK)])
    finally:
        model.train(was_training)


def accuracy(model: torch.nn.Module, x, y, device=None) -> float:
    """Eval-mode accuracy of ``model`` (on ``device``, CUDA when None) on
    rows ``x`` with labels ``y`` (numpy arrays or tensors)."""
    dev = resolve_device(device)
    model.to(dev)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    y = torch.as_tensor(np.asarray(y, np.int64)).to(dev)
    with no_tf32():
        return float((predict_logits(model, x).argmax(-1) == y).float().mean())


def run_epoch(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    order: torch.Tensor,
    batch_size: int,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """One epoch: a step on each ``batch_size`` rows of ``order`` (row
    indices into the resident training set, ``n_batches * batch_size`` of
    them), then the full test set in eval mode. Returns the mean step loss
    and accuracy and the test loss and accuracy (``HISTORY_KEYS``) as
    device scalars; the model is left in training mode."""
    model.train()
    n_batches = order.numel() // batch_size
    loss_sum = torch.zeros((), device=x_train.device)
    acc_sum = torch.zeros((), device=x_train.device)
    for b in range(n_batches):
        idx = order[b * batch_size : (b + 1) * batch_size]
        loss, acc = train_step(
            model, optimizer, x_train.index_select(0, idx),
            y_train.index_select(0, idx), generator,
        )
        loss_sum += loss
        acc_sum += acc
    logits = predict_logits(model, x_test)
    return {
        "loss": loss_sum / n_batches,
        "accuracy": acc_sum / n_batches,
        "val_loss": F.cross_entropy(logits, y_test),
        "val_accuracy": (logits.argmax(-1) == y_test).float().mean(),
    }


def train(
    cfg: Config,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    *,
    seed: int | None = None,
    logger: MetricsLogger | None = None,
    initial: tuple[dict, dict | None, int] | None = None,
    model: torch.nn.Module | None = None,
    device: "str | torch.device | None" = None,
) -> tuple[torch.nn.Module, TrainState, dict[str, list[float]], str]:
    """Train a classifier; returns ``(model, state, history, model_id)``.

    ``model`` selects the family: None builds the feature MLP from
    ``cfg.training``; any module whose forward takes ``generator=`` (e.g.
    an ``IQConvNet`` over raw planar frames) trains the same way. Its
    parameters are reset to flax's defaults from ``seed`` (``cfg``'s when
    None) unless ``initial = (model_state, opt_state, start_epoch)``
    resumes a run: the model's and optimizer's ``state_dict`` (``opt_state``
    may be None) and the epoch to go on from. The model is moved to
    ``device`` (CUDA when None) and trained there.
    """
    dev = resolve_device(device)
    t = cfg.training
    seed = t.seed if seed is None else seed
    model_id = str(uuid.uuid4()).split("-")[0]
    if model is None:
        model = AMCClassifier(
            n_classes=len(cfg.signals.modulations_with_noise),
            hidden_sizes=tuple(t.hidden_sizes),
            dropout=t.dropout,
            activation=t.activation,
            in_features=int(x_train.shape[1]),
        )
    init_gen = torch.Generator().manual_seed(seed)
    run_seed = int(torch.randint(0, 2**62, (), generator=init_gen))
    start_epoch, opt_state = 0, None
    if initial is None:
        init_flax_defaults(model, init_gen)
    else:
        model_state, opt_state, start_epoch = initial
        model.load_state_dict(model_state)
    model.to(dev)
    optimizer = make_optimizer(cfg, model.parameters(), opt_state)
    run_gen = torch.Generator(device=dev).manual_seed(run_seed)

    n = int(x_train.shape[0])
    batch_size = min(t.batch_size, n)
    n_batches = max(n // batch_size, 1)
    x_tr = torch.as_tensor(np.asarray(x_train, np.float32)).to(dev)
    y_tr = torch.as_tensor(np.asarray(y_train, np.int64)).to(dev)
    x_te = torch.as_tensor(np.asarray(x_test, np.float32)).to(dev)
    y_te = torch.as_tensor(np.asarray(y_test, np.int64)).to(dev)

    history: dict[str, list[float]] = {k: [] for k in HISTORY_KEYS}
    steps = 0
    with no_tf32():
        for ep in range(start_epoch, t.epochs):
            with stage_timer(logger, "train_epoch", epoch=ep) as rec:
                order = epoch_order(n, n_batches * batch_size, run_gen, dev)
                metrics = run_epoch(
                    model, optimizer, x_tr, y_tr, x_te, y_te, order,
                    batch_size, run_gen,
                )
                # the epoch's one host read
                values = torch.stack([metrics[k] for k in HISTORY_KEYS]).tolist()
                rec.update(zip(HISTORY_KEYS, values))
            steps += n_batches
            for k, v in zip(HISTORY_KEYS, values):
                history[k].append(v)
            print(
                f"Epoch {ep + 1:3d}/{t.epochs} | "
                f"loss: {history['loss'][-1]:.4f} | "
                f"acc: {history['accuracy'][-1]:.4f} | "
                f"val_loss: {history['val_loss'][-1]:.4f} | "
                f"val_acc: {history['val_accuracy'][-1]:.4f}"
            )
    model.eval()
    return model, TrainState(optimizer.state_dict(), steps), history, model_id
