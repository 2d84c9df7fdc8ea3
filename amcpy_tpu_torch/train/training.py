"""Classifier training, on one device or data-parallel over ranks.

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

**Data parallelism.** Whenever a process group is up (at any world size,
one included), :func:`train` runs over the data axis of the mesh, as the
JAX package's SPMD epoch does (``training.py:85-195``, ``:197-340``):

* sizes round as there: the batch, ``n`` and ``m`` to multiples of the W
  ranks; each rank keeps its contiguous shard of the training and test
  sets on its device;
* each epoch every rank draws all W shard permutations from the run's
  generator (seeded alike on every rank, so the ranks stay in lockstep),
  takes its own, wrapped to ``n_batches * batch_size / W`` rows; global
  batch b is rank 0's rows of step b, then rank 1's, and so on (the JAX
  transpose, ``training.py:161-170``);
* dropout, the CNN's augmentation and BatchNorm act on the global batch
  (``models/layers.py``), so W ranks compute what one process computes on
  the same global batches;
* a rank's loss is its rows' mean over W (its sum over the global batch
  size), the gradients are summed over the ranks by one all-reduce of one
  flat bucket a step, and every rank steps its own optimizer with them;
* the epoch's metrics and the test set's loss and accuracy (the test set
  sharded too) are summed over the ranks once an epoch;
* ``model_id`` is rank 0's draw, broadcast.

Not ported: the jit cache of epoch programs (eager PyTorch compiles
nothing).
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
from amcpy_tpu_torch.parallel.audit import all_gather, all_reduce, broadcast
from amcpy_tpu_torch.parallel.mesh import (
    DataShard,
    data_shard,
    group_up,
    make_mesh,
    pad_to_multiple,
)
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
    "predict_logits_global",
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
    shard: DataShard | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch, the model in training mode: softmax
    cross-entropy on the logits (the batch mean), its gradient, the
    optimizer's update. Returns the batch's loss and accuracy as device
    scalars (nothing is read to the host).

    With a ``shard``, ``xb`` is this rank's block of the global batch: the
    loss and accuracy are the rank's share (its mean over ``shard.size``),
    and the gradient is summed over the shard's group before the update."""
    if shard is None:
        logits = model(xb, generator=generator)
        loss = F.cross_entropy(logits, yb)
    else:
        logits = model(xb, generator=generator, shard=shard)
        loss = F.cross_entropy(logits, yb) / shard.size
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if shard is not None:
        _sum_gradients(model, shard)
    optimizer.step()
    acc = (logits.detach().argmax(-1) == yb).to(loss.dtype).mean()
    if shard is not None:
        acc = acc / shard.size
    return loss.detach(), acc


def _sum_gradients(model: torch.nn.Module, shard: DataShard) -> None:
    """Every parameter's gradient summed over the shard's ranks: one
    all-reduce of one flat bucket."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), "sum", shard.group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def epoch_order(
    n: int,
    take: int,
    generator: torch.Generator,
    device: torch.device,
    shard: DataShard | None = None,
) -> torch.Tensor:
    """One epoch's row order on ``device``: a permutation of ``n`` rows
    drawn from ``generator``, wrapped to ``take`` rows. With a ``shard``,
    ``n`` and ``take`` count one rank's rows: a permutation is drawn for
    every rank of the data axis, in rank order, and this rank's is kept
    (so every rank's generator draws alike)."""
    perms = [torch.randperm(n, generator=generator, device=device)
             for _ in range(1 if shard is None else shard.size)]
    perm = perms[0 if shard is None else shard.index]
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


def predict_logits_global(
    model: torch.nn.Module,
    x,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Eval-mode logits of the rows of ``x`` (a host array every rank holds
    alike) computed over the ranks of the data axis of the default mesh
    (``make_mesh()``): the rows are padded to a multiple of the axis
    (repeating the last), each rank computes its block on ``device`` (CUDA
    when None), and the blocks are all-gathered; every rank returns all
    rows' logits, on ``device``. Counterpart of the JAX package's
    ``predict_logits_global``; numerically :func:`predict_logits`."""
    dev = resolve_device(device)
    shard = data_shard(make_mesh())
    xp, orig = pad_to_multiple(np.asarray(x, np.float32), shard.size)
    block = torch.from_numpy(np.ascontiguousarray(shard.local(xp))).to(dev)
    model.to(dev)
    with no_tf32():
        logits = predict_logits(model, block)
    return all_gather(logits, shard.group)[:orig]


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
    shard: DataShard | None = None,
) -> dict[str, torch.Tensor]:
    """One epoch: a step on each ``batch_size`` rows of ``order`` (row
    indices into the resident training set, ``n_batches * batch_size`` of
    them), then the full test set in eval mode. Returns the mean step loss
    and accuracy and the test loss and accuracy (``HISTORY_KEYS``) as
    device scalars; the model is left in training mode.

    With a ``shard`` the sets, ``order`` and ``batch_size`` are this rank's
    (step b's global batch is every rank's b-th block, in rank order) and
    the returned metrics are the global ones, summed over the ranks by one
    all-reduce."""
    model.train()
    n_batches = order.numel() // batch_size
    # the sums in the model's float dtype (float64 when a test casts)
    loss_sum = torch.zeros((), dtype=x_train.dtype, device=x_train.device)
    acc_sum = torch.zeros((), dtype=x_train.dtype, device=x_train.device)
    for b in range(n_batches):
        idx = order[b * batch_size : (b + 1) * batch_size]
        loss, acc = train_step(
            model, optimizer, x_train.index_select(0, idx),
            y_train.index_select(0, idx), generator, shard,
        )
        loss_sum += loss
        acc_sum += acc
    logits = predict_logits(model, x_test)
    metrics = [
        loss_sum / n_batches,
        acc_sum / n_batches,
        F.cross_entropy(logits, y_test),
        (logits.argmax(-1) == y_test).to(logits.dtype).mean(),
    ]
    if shard is not None:
        share = torch.stack(metrics[:2] + [v / shard.size for v in metrics[2:]])
        metrics = all_reduce(share, "sum", shard.group).unbind()
    return dict(zip(HISTORY_KEYS, metrics))


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
    ``cfg.training``; any module whose forward takes ``generator=`` (and,
    data-parallel, ``shard=``; e.g. an ``IQConvNet`` over raw planar
    frames) trains the same way. Its parameters are reset to flax's
    defaults from ``seed`` (``cfg``'s when None) unless ``initial =
    (model_state, opt_state, start_epoch)`` resumes a run: the model's and
    optimizer's ``state_dict`` (``opt_state`` may be None) and the epoch to
    go on from. The model is moved to ``device`` (CUDA when None) and
    trained there.

    With a process group up, every rank calls this with the same arguments
    and the run is data-parallel over the data axis of ``make_mesh(cfg)``
    (see the module docstring); every rank
    returns the same model, history and id.
    """
    dev = resolve_device(device)
    t = cfg.training
    seed = t.seed if seed is None else seed
    model_id = str(uuid.uuid4()).split("-")[0]
    shard = None
    if group_up():
        shard = data_shard(make_mesh(cfg))
        # every rank names the checkpoint alike: rank 0's draw wins
        raw = torch.tensor(list(model_id.encode("ascii")), dtype=torch.uint8)
        model_id = bytes(broadcast(raw, 0).tolist()).decode("ascii")
    w = 1 if shard is None else shard.size
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

    # the batch and the set sizes rounded to multiples of the ranks (JAX
    # training.py:277-280); each rank keeps its block of each set
    batch_size = max(min(t.batch_size, int(x_train.shape[0])) // w, 1) * w
    n = int(x_train.shape[0]) // w * w
    m = int(x_test.shape[0]) // w * w
    n_batches = max(n // batch_size, 1)

    def rows(a, count, dtype):
        a = np.asarray(a[:count], dtype)
        return torch.as_tensor(a if shard is None else shard.local(a)).to(dev)

    x_tr, y_tr = rows(x_train, n, np.float32), rows(y_train, n, np.int64)
    x_te, y_te = rows(x_test, m, np.float32), rows(y_test, m, np.int64)

    history: dict[str, list[float]] = {k: [] for k in HISTORY_KEYS}
    steps = 0
    with no_tf32():
        for ep in range(start_epoch, t.epochs):
            with stage_timer(logger, "train_epoch", epoch=ep) as rec:
                order = epoch_order(n // w, n_batches * batch_size // w, run_gen, dev,
                                    shard)
                metrics = run_epoch(
                    model, optimizer, x_tr, y_tr, x_te, y_te, order,
                    batch_size // w, run_gen, shard,
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
