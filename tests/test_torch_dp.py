"""Data-parallel training and evaluation (``amcpy_tpu_torch/train/training.py``
under a process group, ``models/layers.py``'s global BatchNorm and
dropout) on a gloo world of two CPU ranks, against the JAX package's
``train`` on a (2, 1) sub-mesh of the conftest's CPU devices and against
the port's own one-process loop on the same global batches.

One world runs every case (``test_torch_parallel._case_dp``); each test
reads its case. Tolerances, each with its reason:

* against JAX (dropout 0, JAX's initial weights and its two shards' row
  orders, 3 epochs of 7 steps): ``test_torch_training``'s whole-run bars
  (history atol 1e-5, 1e-5, 1e-3, 3e-3; the weights the data determine
  rtol 1e-5, atol 1e-6; eval logits with JAX's data-free biases atol
  1e-4): two ranks compute JAX's SPMD step, whose float32 roundoff differs
  from the port's as on one device;
* against one process on the interleaved global batches, in float64
  (dropout 0.4, and one CNN epoch with augmentation): 1e-9, as the sums
  over two ranks are the one process's sums in another order, ~1e-16;
* ``train`` itself over two ranks (float32, dropout 0.4, 1001 and 501 rows
  that round to 1000 and 500, batch 127 to 126) against one process
  drawing the same stream: the history to the whole-run bars, for the same
  reason (the split sums round otherwise in float32, and in eval mode the
  data-free biases carry that apart; measured val_loss 1.2e-4), and the
  weights the data determine to the step-parity bar, rtol 1e-5 and atol
  2e-5 (RMSprop moves a weight whose gradient is a cancelled sum near 1e-7
  by an amount roundoff sets: measured 9.1e-6 on one weight of 754);
* one step's collectives: more than 0 and fewer than ``8 n_params 4``
  bytes (``tests/test_scaling_audit.py:125-174``);
* ``predict_logits_global`` at 37 rows: within 1e-6 of one forward.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.train import training as jtr
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.models.layers import init_flax_defaults
from amcpy_tpu_torch.train.checkpoint import params_from_flax
from amcpy_tpu_torch.train.training import HISTORY_KEYS, make_optimizer, run_epoch

from .test_torch_parallel import run_world
from .test_torch_training import (
    HIDDEN,
    _assert_runs_agree,
    _data_free,
    _features_dataset,
    _jax_orders,
    _np,
)

W = 2


def _interleave(local_orders: np.ndarray, bs_local: int, local_n: int) -> np.ndarray:
    """The global row order of W ranks' local orders ``(W, take)``: step
    b's batch is rank 0's b-th block, then rank 1's, each rank's rows
    offset by its shard's start."""
    w, take = local_orders.shape
    blocks = local_orders.reshape(w, take // bs_local, bs_local)
    blocks = blocks + (np.arange(w) * local_n)[:, None, None]
    return blocks.transpose(1, 0, 2).reshape(-1)


def _local_orders(rng, epochs, local_n, take):
    return np.stack([[rng.permutation(local_n)[np.arange(take) % local_n] for _ in range(W)]
                     for _ in range(epochs)])


def _state(model) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _cnn():
    return IQConvNet(6, channels=(4, 8), kernel_sizes=(1, 3), strides=(1, 2), dense=8,
                     dropout=0.5, dtype="float32", aug_phase=True,
                     aug_noise_snr_db=(-5.0, 20.0)).double()


def _cnn_data():
    rng = np.random.default_rng(4)
    y = rng.integers(0, 6, 96)
    x = rng.standard_normal((96, 2, 32)) * (1.0 + y[:, None, None])
    return x[:64], y[:64], x[64:], y[64:]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's directory after the two ranks ran every case."""
    root = tmp_path_factory.mktemp("dp")
    data = _features_dataset()
    for k, a in zip(("x_tr", "y_tr", "x_te", "y_te"), data):
        np.save(root / f"dp_{k}.npy", a)
    jmodel = jtr.AMCClassifier(n_classes=6, hidden_sizes=HIDDEN, dropout=0.0)
    init = jmodel.init(jax.random.split(jax.random.key(5))[0], jnp.zeros((1, 6)), train=False)
    state = params_from_flax(_np(init["params"]), _np(init["batch_stats"]))
    np.savez(root / "dp_init.npz", **{k: v.numpy() for k, v in state.items()})
    np.save(root / "dp_orders.npy", np.stack(_jax_orders(5, 500, 448, 3, n_shards=W)))
    model = AMCClassifier(6, HIDDEN, dropout=0.4).double()
    init_flax_defaults(model, torch.Generator().manual_seed(1))
    np.savez(root / "dp_init64.npz", **_state(model))
    np.save(root / "dp_orders64.npy", _local_orders(np.random.default_rng(2), 2, 500, 448))
    cnn = _cnn()
    init_flax_defaults(cnn, torch.Generator().manual_seed(2))
    np.savez(root / "cnn_init.npz", **_state(cnn))
    for k, a in zip(("x_tr", "y_tr", "x_te", "y_te"), _cnn_data()):
        np.save(root / f"cnn_{k}.npy", a)
    np.save(root / "cnn_orders.npy", _local_orders(np.random.default_rng(3), 1, 32, 32))
    rng = np.random.default_rng(9)
    y = rng.integers(0, 6, 1502)
    x = (2.0 * rng.standard_normal((6, 6))[y] + rng.standard_normal((1502, 6))).astype(np.float32)
    np.savez(root / "dp_extra.npz", x_tr=x[:1001], y_tr=y[:1001], x_te=x[1001:], y_te=y[1001:])
    run_world("dp", W, root)
    return root


def _result(root, name):
    z = np.load(root / f"dp_{name}.npz")
    state = {k[6:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("state/")}
    history = {k: z[f"history/{k}"].tolist() for k in HISTORY_KEYS}
    return state, history


def _one_process(model, opt, data, orders, bs_local, local_n, gen=None):
    """The port's own loop in this process on the interleaved global
    batches of the ranks' orders."""
    x_tr, y_tr, x_te, y_te = (torch.from_numpy(np.asarray(a)) for a in data)
    history = {k: [] for k in HISTORY_KEYS}
    for order in orders:
        m = run_epoch(model, opt, x_tr, y_tr.long(), x_te, y_te.long(),
                      torch.from_numpy(_interleave(order, bs_local, local_n)), bs_local * W,
                      gen)
        for k in HISTORY_KEYS:
            history[k].append(float(m[k]))
    return history


def _assert_close(got_state, got_hist, model, hist, tol, skip_data_free=False):
    for k in HISTORY_KEYS:
        np.testing.assert_allclose(got_hist[k], hist[k], rtol=0, atol=tol, err_msg=k)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") or (skip_data_free and _data_free(k)):
            continue
        np.testing.assert_allclose(got_state[k].numpy(), v.double().numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_dp_mlp_matches_jax_two_shards(world):
    """Two ranks from JAX's initial weights on its two shards' orders,
    against JAX's ``train`` on a (2, 1) mesh."""
    data = _features_dataset()
    mesh = jax.make_mesh((2, 1), ("data", "seq"), devices=jax.devices()[:2])
    jcfg = JaxConfig().replace(training={"epochs": 3, "dropout": 0.0})
    jmodel, jstate, jhistory, _ = jtr.train(jcfg, *data, mesh=mesh, seed=5)
    state, history = _result(world, "jax")
    model = AMCClassifier(6, HIDDEN, dropout=0.0)
    model.load_state_dict({k: v.float() for k, v in state.items()})
    _assert_runs_agree(model, jmodel, jstate, history, jhistory, data[2])


def test_dp_dropout_equals_one_process_float64(world):
    data = [a.astype(np.float64) if a.dtype == np.float32 else a for a in _features_dataset()]
    model = AMCClassifier(6, HIDDEN, dropout=0.4).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(world / "dp_init64.npz").items()})
    opt = make_optimizer(Config(), model.parameters())
    hist = _one_process(model, opt, data, np.load(world / "dp_orders64.npy"), 64, 500,
                        torch.Generator().manual_seed(7))
    _assert_close(*_result(world, "dropout64"), model, hist, 1e-9)


def test_dp_cnn_epoch_equals_one_process_float64(world):
    cnn = _cnn()
    cnn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         np.load(world / "cnn_init.npz").items()})
    opt = make_optimizer(Config().replace(training={"optimizer": "adam",
                                                    "learning_rate": 3e-3}), cnn.parameters())
    hist = _one_process(cnn, opt, _cnn_data(), np.load(world / "cnn_orders.npy"), 8, 32,
                        torch.Generator().manual_seed(3))
    _assert_close(*_result(world, "cnn64"), cnn, hist, 1e-9)


def test_dp_train_equals_one_process(world):
    """``train`` over two ranks: the sizes round to multiples of 2, each
    rank draws both shards' permutations and the global batches' dropout,
    and the ranks agree on the model id."""
    z = np.load(world / "dp_extra.npz")
    cfg = Config().replace(training={"epochs": 2, "dropout": 0.4, "batch_size": 127})
    model = AMCClassifier(6, HIDDEN, dropout=0.4)
    init_gen = torch.Generator().manual_seed(11)
    run_seed = int(torch.randint(0, 2**62, (), generator=init_gen))
    init_flax_defaults(model, init_gen)
    opt = make_optimizer(cfg, model.parameters())
    gen = torch.Generator().manual_seed(run_seed)
    x_tr, y_tr = torch.from_numpy(z["x_tr"][:1000]), torch.from_numpy(z["y_tr"][:1000])
    x_te, y_te = torch.from_numpy(z["x_te"][:500]), torch.from_numpy(z["y_te"][:500])
    hist = {k: [] for k in HISTORY_KEYS}
    for _ in range(2):
        perms = [torch.randperm(500, generator=gen) for _ in range(W)]
        local = np.stack([p[np.arange(7 * 63) % 500].numpy() for p in perms])
        m = run_epoch(model, opt, x_tr, y_tr, x_te, y_te,
                      torch.from_numpy(_interleave(local, 63, 500)), 126, gen)
        for k in HISTORY_KEYS:
            hist[k].append(float(m[k]))
    state, history = _result(world, "train")
    for k, atol in zip(HISTORY_KEYS, (1e-5, 1e-5, 1e-3, 3e-3)):
        np.testing.assert_allclose(history[k], hist[k], rtol=0, atol=atol, err_msg=k)
    for k, v in model.state_dict().items():
        if not (_data_free(k) or k.endswith("num_batches_tracked")):
            np.testing.assert_allclose(state[k].numpy(), v.double().numpy(), rtol=1e-5,
                                       atol=2e-5, err_msg=k)
    step = json.loads((world / "dp_step.json").read_text())
    other = json.loads((world / "dp_rank1.json").read_text())
    assert step["model_id"] == other["model_id"] and len(step["model_id"]) == 8


def test_dp_step_moves_only_gradient_bytes(world):
    step = json.loads((world / "dp_step.json").read_text())
    assert set(step["audit"]) == {"all-reduce"}, step["audit"]
    # three BatchNorm sums forward and three backward, then the gradients
    assert step["audit"]["all-reduce"]["count"] == 7
    assert 0 < step["bytes"] < 8 * step["n_params"] * 4, step


def test_predict_logits_global_equals_one_forward(world):
    step = json.loads((world / "dp_step.json").read_text())
    assert step["global_rows"] == 37
    assert step["global_minus_local"] <= 1e-6
