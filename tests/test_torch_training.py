"""The port's MLP training (``amcpy_tpu_torch/train/training.py``, the
training behaviour of ``models/classifier.py``, resume through
``train/checkpoint.py``) against the JAX package's on the CPU.

Weights are carried across with ``params_from_flax`` and optimizer states
with ``opt_state_from_optax``; inputs are numpy-made from a seed. JAX's
``train`` runs on a one-device mesh, so its shuffle is the one-shard
permutation this file reproduces from its key chain. Tolerances, each with
its reason and the gap measured on this CPU:

* step parity (1 and 5 steps, dropout 0, lr 1e-2): loss rtol 1e-5 (measured
  2e-6); parameters, batch statistics and optimizer moments rtol 1e-5 with
  atol 2e-5 in float32 (worst measured 1.2e-5, one weight of 870: RMSprop's
  first step moves a weight by lr g / (0.1 |g| + 1e-8), so a weight whose
  gradient is a cancelled sum near 1e-7, known to float32 only to ~1e-3 of
  itself, moves by an amount that roundoff sets; all others within 4e-6).
  The biases of the Dense layers that feed a BatchNorm have a gradient
  that is zero in exact arithmetic (the BatchNorm removes the batch mean):
  both packages see float32 roundoff there (|g| < 1e-7, checked) and their
  adaptive optimizers scale it up, so those biases, their moments and the
  running means that absorb them are not determined by the data in float32
  and are left out of the float32 comparison; the same steps in float64,
  where that roundoff is ~1e-17 and moves nothing, hold every leaf to rtol
  1e-5 (atol 1e-9; measured 6e-8 relative);
* whole-run parity (3 epochs, 1,000 training and 1,000 test rows, rmsprop
  at the default lr, batch 128): training loss and accuracy atol 1e-5
  (measured 1.2e-7); the weights determined by the data rtol 1e-5, atol
  1e-6 (measured 2.4e-7); val_loss atol 1e-3 (measured 4.7e-4) and
  val_accuracy atol 3e-3, above the 1e-3 the other keys keep (measured
  2e-3: two of 1,000 test rows, each a near tie, predicted otherwise). In
  eval mode the data-free biases act, less their running means, and those
  drift apart between the packages by roundoff-driven updates of up to
  ~0.1 lr a step (eval logits up to 1e-2 apart). With JAX's data-free
  biases and running means put into the port's model the eval logits agree
  to atol 1e-4, and as trained a prediction differs only where JAX's top
  two logits are within 0.05;
* resume parity (JAX 2 epochs carried into the port's 3rd, against JAX's 3
  epochs): the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.classifier import AMCClassifier as JaxClassifier
from amcpy_tpu.train import training as jtr
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.models.layers import FlaxBatchNorm1d
from amcpy_tpu_torch.preprocessing import preprocess
from amcpy_tpu_torch.train.checkpoint import (
    load_checkpoint,
    opt_state_from_optax,
    params_from_flax,
    resolve_model_id,
    save_checkpoint,
)
from amcpy_tpu_torch.train.evaluate import confusion_counts, evaluate_by_snr
from amcpy_tpu_torch.train.training import (
    HISTORY_KEYS,
    OptaxNAdam,
    accuracy,
    make_optimizer,
    predict_logits,
    run_epoch,
    train,
    train_step,
)

HIDDEN = (26, 29, 30)
OPTIMIZERS = ["rmsprop", "adam", "nadam"]
#: moment names of the port's optimizers
MOMENTS = {"rmsprop": ("square_avg",), "adam": ("exp_avg", "exp_avg_sq"),
           "nadam": ("exp_avg", "exp_avg_sq")}


def _np(tree, dtype=None):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "seq"), devices=jax.devices()[:1])


def _data_free(key: str) -> bool:
    """The biases of Dense layers that feed a BatchNorm, and the running
    means that absorb them (see the module docstring)."""
    return (key.startswith("dense.") and key.endswith(".bias")) or key.endswith("running_mean")


def _moments(opt_state, model):
    """{name: (moment name, tensor)} of the port's optimizer state."""
    names = [n for n, _ in model.named_parameters()]
    return {
        (names[i], m): v for i, s in opt_state["state"].items() for m, v in s.items()
        if m != "step"
    }


def _assert_state_close(model, params, batch_stats, rtol, atol, skip_data_free):
    want = params_from_flax(_np(params, np.float64), _np(batch_stats, np.float64))
    got = model.state_dict()
    for key, w in want.items():
        if key.endswith("num_batches_tracked") or (skip_data_free and _data_free(key)):
            continue
        np.testing.assert_allclose(got[key].double().numpy(), w.double().numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


def _batch(n=64, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 6)) * 1.5 + 0.3).astype(dtype)
    return x, rng.integers(0, 6, n).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_steps_match_optax(name, steps, dtype):
    """One and five steps on one batch, dropout 0: loss, parameters, batch
    statistics and optimizer state against flax + optax."""
    f64 = dtype == "float64"
    npdt = np.float64 if f64 else np.float32
    rtol, atol = (1e-5, 1e-9) if f64 else (1e-5, 2e-5)
    lr = 1e-2
    cfg = Config().replace(training={"optimizer": name, "learning_rate": lr})
    x, y = _batch(dtype=npdt)
    with jax.enable_x64(f64):
        jm = JaxClassifier(6, HIDDEN, dropout=0.0)
        variables = jm.init(jax.random.key(3), jnp.zeros((1, 6), npdt), train=False)
        params = jax.tree.map(lambda a: jnp.asarray(a, npdt), variables["params"])
        bs = jax.tree.map(lambda a: jnp.asarray(a, npdt), variables["batch_stats"])
        tx = jtr._make_optimizer(name, lr)
        opt_state = tx.init(params)

        model = AMCClassifier(6, HIDDEN, dropout=0.0)
        model.load_state_dict(params_from_flax(_np(params), _np(bs)))
        model = model.to(torch.float64 if f64 else torch.float32)
        opt = make_optimizer(cfg, model.parameters(),
                             opt_state_from_optax(name, _np(opt_state), model))

        def loss_fn(p, stats):
            logits, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
            loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y))
            return loss, upd["batch_stats"]

        @jax.jit
        def step(params, stats, opt_state):
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), stats, opt_state, loss, grads

        xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
        for _ in range(steps):
            params, bs, opt_state, loss, grads = step(params, bs, opt_state)
            got_loss, _ = train_step(model, opt, xt, yt)
        # the data-free biases see only roundoff
        for k in range(len(HIDDEN)):
            assert float(jnp.abs(grads[f"Dense_{k}"]["bias"]).max()) < (1e-16 if f64 else 1e-7)
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
        _assert_state_close(model, params, bs, rtol, atol, skip_data_free=not f64)
        want_opt = opt_state_from_optax(name, _np(opt_state), model, step=steps)
    got_m, want_m = _moments(opt.state_dict(), model), _moments(want_opt, model)
    assert set(got_m) == set(want_m) and {m for _, m in got_m} == set(MOMENTS[name])
    for (pname, m), w in want_m.items():
        if not f64 and _data_free(pname):
            continue
        np.testing.assert_allclose(got_m[pname, m].double().numpy(), w.double().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{pname} {m}")
    for s in opt.state_dict()["state"].values():
        assert float(s["step"]) == steps


def test_optax_nadam_is_not_torch_nadam():
    """``OptaxNAdam`` is optax's algorithm; ``torch.optim.NAdam`` (with its
    momentum-decay schedule) lands elsewhere after three steps."""
    torch.manual_seed(0)
    w0 = torch.randn(8)
    grads = [torch.randn(8) for _ in range(3)]

    def run(cls, **kw):
        w = torch.nn.Parameter(w0.clone())
        opt = cls([w], lr=1e-2, **kw)
        for g in grads:
            w.grad = g.clone()
            opt.step()
        return w.detach()

    tx = optax.nadam(1e-2)
    p = jnp.asarray(w0.numpy())
    state = tx.init(p)
    for g in grads:
        u, state = tx.update(jnp.asarray(g.numpy()), state, p)
        p = optax.apply_updates(p, u)
    want = np.asarray(p)
    np.testing.assert_allclose(run(OptaxNAdam).numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.abs(run(torch.optim.NAdam).numpy() - want).max() > 1e-3


def _features_dataset(seed=0):
    """1,000 standardized 6-feature training rows and 1,000 test rows of 6
    classes, separable in part."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 6, 2000).astype(np.int32)
    x = 2.0 * rng.standard_normal((6, 6))[y] + rng.standard_normal((2000, 6))
    x = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    return x[:1000], y[:1000], x[1000:], y[1000:]


def _jax_orders(seed, n, take, epochs, n_shards=1):
    """Each epoch's row orders as JAX's ``train`` draws them over
    ``n_shards`` data shards of ``n`` rows, ``(n_shards, take)`` local row
    indices (key chain of ``training.py:245-246``, ``:320``, ``:138-158``)."""
    _, run_key = jax.random.split(jax.random.key(seed))
    orders = []
    for _ in range(epochs):
        run_key, ep_key = jax.random.split(run_key)
        perm_key, _ = jax.random.split(ep_key)
        perms = jax.vmap(lambda k: jax.random.permutation(k, n))(
            jax.random.split(perm_key, n_shards))
        orders.append(np.asarray(perms)[:, np.arange(take) % n])
    return orders


def _jax_train(epochs, data, seed=5):
    jcfg = JaxConfig().replace(training={"epochs": epochs, "dropout": 0.0})
    return jtr.train(jcfg, *data, mesh=_one_device_mesh(), seed=seed)


def _port_epochs(model, opt, data, orders):
    x_tr, y_tr, x_te, y_te = (torch.from_numpy(np.asarray(a)) for a in data)
    history = {k: [] for k in HISTORY_KEYS}
    for order in orders:
        m = run_epoch(model, opt, x_tr, y_tr.long(), x_te, y_te.long(),
                      torch.from_numpy(order), 128)
        for k in HISTORY_KEYS:
            history[k].append(float(m[k]))
    return history


def _assert_runs_agree(model, jmodel, jstate, history, jhistory, x_test):
    """History, weights and eval logits of a port run against a JAX run
    (bars in the module docstring)."""
    for k, atol in zip(HISTORY_KEYS, (1e-5, 1e-5, 1e-3, 3e-3)):
        np.testing.assert_allclose(history[k], jhistory[k], rtol=0, atol=atol, err_msg=k)
    want_state = params_from_flax(_np(jstate.params), _np(jstate.batch_stats))
    got_state = model.state_dict()
    for key, w in want_state.items():
        if not (_data_free(key) or key.endswith("num_batches_tracked")):
            np.testing.assert_allclose(got_state[key].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    # with JAX's data-free biases and running means, the eval logits agree
    # to float32 roundoff
    aligned = AMCClassifier(6, HIDDEN, dropout=0.0)
    aligned.load_state_dict({k: want_state[k] if _data_free(k) else v
                             for k, v in got_state.items()})
    want = np.asarray(jtr.predict_logits(jmodel, jstate.params, jstate.batch_stats,
                                         jnp.asarray(x_test)))
    got = predict_logits(aligned, torch.from_numpy(x_test)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # as trained, a prediction differs only where JAX's top two are a near tie
    own = predict_logits(model, torch.from_numpy(x_test)).numpy()
    top2 = np.sort(want, axis=-1)[:, -2:]
    differs = own.argmax(-1) != want.argmax(-1)
    assert (top2[differs, 1] - top2[differs, 0] < 0.05).all()


def test_whole_run_matches_jax():
    """Three epochs from the same initial weights, each epoch on the row
    order JAX draws: history, eval logits and weights agree."""
    data = _features_dataset()
    jmodel, jstate, jhistory, _ = _jax_train(3, data)
    init = jmodel.init(jax.random.split(jax.random.key(5))[0], jnp.zeros((1, 6)),
                       train=False)
    model = AMCClassifier(6, HIDDEN, dropout=0.0)
    model.load_state_dict(params_from_flax(_np(init["params"]), _np(init["batch_stats"])))
    opt = make_optimizer(Config(), model.parameters())
    history = _port_epochs(model, opt, data, [o[0] for o in _jax_orders(5, 1000, 896, 3)])
    _assert_runs_agree(model, jmodel, jstate, history, jhistory, data[2])


def test_resume_from_jax_matches_jax():
    """JAX's first two epochs carried into the port (weights, batch
    statistics, optax state) and the port's third epoch, against JAX's
    three epochs."""
    data = _features_dataset(seed=1)
    jmodel, jstate2, jhistory2, _ = _jax_train(2, data)
    _, jstate3, jhistory3, _ = _jax_train(3, data)
    np.testing.assert_array_equal(jhistory2["loss"], jhistory3["loss"][:2])
    model = AMCClassifier(6, HIDDEN, dropout=0.0)
    model.load_state_dict(params_from_flax(_np(jstate2.params), _np(jstate2.batch_stats)))
    opt = make_optimizer(Config(), model.parameters(),
                         opt_state_from_optax("rmsprop", _np(jstate2.opt_state), model))
    history = _port_epochs(model, opt, data, [o[0] for o in _jax_orders(5, 1000, 896, 3)[2:]])
    _assert_runs_agree(model, jmodel, jstate3, history,
                       {k: v[2:] for k, v in jhistory3.items()}, data[2])


# ---- mirrors of tests/test_training.py ------------------------------------


def _fake_features(cfg, rng):
    """Synthetic feature artifacts with class-separable structure."""
    s = cfg.signals
    return {
        mod: rng.standard_normal((s.num_snr, s.num_frames, 18)).astype(np.float32) + 3.0 * li
        for li, mod in enumerate(s.modulations_with_noise)
    }


@pytest.fixture()
def cfg(tmp_path):
    return Config().replace(
        paths={"root": str(tmp_path)},
        signals={"num_frames": 40, "frame_size": 64},
        training={"epochs": 8, "batch_size": 32},
    )


def test_train_learns_and_checkpoints(cfg):
    rng = np.random.default_rng(3)
    feats = _fake_features(cfg, rng)
    x_train, x_test, y_train, y_test, scaler = preprocess(feats, cfg)
    model, state, history, model_id = train(
        cfg, x_train, y_train, x_test, y_test, device="cpu"
    )
    assert len(history["loss"]) == cfg.training.epochs
    assert len(model_id) == 8 and state.step == cfg.training.epochs * (len(x_train) // 32)
    assert history["val_accuracy"][-1] > 0.95
    acc = accuracy(model, x_test, y_test, device="cpu")
    assert acc > 0.95

    # the checkpoint round trip keeps the model's behaviour exactly
    save_checkpoint(cfg, model_id, model, scaler, history, cfg.training.epochs, state=state)
    model2, state2, scaler2, meta = load_checkpoint(cfg, model_id)
    assert meta["model_id"] == model_id and meta["history"] == history
    assert state2.step == state.step and state2.opt_state is not None
    np.testing.assert_allclose(scaler2.mean, scaler.mean, rtol=1e-6)
    assert accuracy(model2, x_test, y_test, device="cpu") == acc
    assert resolve_model_id(cfg, None) == model_id

    snr_acc = evaluate_by_snr(model2, scaler2, feats, cfg, device="cpu")
    assert snr_acc.shape == (6, 16) and snr_acc.mean() > 0.95
    cm = confusion_counts(model2, x_test, y_test, 6, device="cpu")
    assert cm.shape == (6, 6) and np.diag(cm).mean() > 0.95


def test_resume_midtraining(cfg):
    """2 epochs, checkpoint, resume for the rest with the restored weights,
    optimizer state and epoch counter."""
    rng = np.random.default_rng(4)
    x_train, x_test, y_train, y_test, scaler = preprocess(_fake_features(cfg, rng), cfg)
    short = cfg.replace(training={"epochs": 2})
    model, state, history, mid = train(short, x_train, y_train, x_test, y_test, device="cpu")
    save_checkpoint(short, mid, model, scaler, history, 2, state=state)
    model2, state2, _, meta = load_checkpoint(cfg, mid)
    for a, b in zip(state.opt_state["state"].values(), state2.opt_state["state"].values()):
        torch.testing.assert_close(a["square_avg"], b["square_avg"], rtol=0, atol=0)
    _, _, history3, _ = train(
        cfg, x_train, y_train, x_test, y_test, device="cpu",
        initial=(model2.state_dict(), state2.opt_state, meta["epoch"]),
    )
    assert len(history3["loss"]) == cfg.training.epochs - 2
    assert history3["val_accuracy"][-1] >= history["val_accuracy"][-1] - 0.05


@pytest.mark.parametrize("opt", ["adam", "nadam"])
def test_other_optimizers(cfg, opt):
    rng = np.random.default_rng(5)
    x_train, x_test, y_train, y_test, _ = preprocess(_fake_features(cfg, rng), cfg)
    c = cfg.replace(training={"optimizer": opt, "epochs": 6})
    _, state, history, _ = train(c, x_train, y_train, x_test, y_test, device="cpu")
    assert history["val_accuracy"][-1] > 0.9
    assert set(state.opt_state["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}


def test_train_is_deterministic_for_a_seed(cfg):
    """Initialization, row order and dropout come from the run's seeded
    generators: the same seed gives the same history, another seed another."""
    rng = np.random.default_rng(6)
    data = preprocess(_fake_features(cfg, rng), cfg)[:4]
    c = cfg.replace(training={"epochs": 2})
    h1 = train(c, data[0], data[2], data[1], data[3], seed=1, device="cpu")[2]
    h2 = train(c, data[0], data[2], data[1], data[3], seed=1, device="cpu")[2]
    h3 = train(c, data[0], data[2], data[1], data[3], seed=2, device="cpu")[2]
    assert h1 == h2 and h1 != h3


def test_initialization_follows_flax():
    """lecun-normal kernels (a normal truncated at 2 standard deviations,
    scaled by 1/sqrt(fan-in)): the std of a wide layer's weights within 10 %
    of flax's on the same shape; biases zero; BatchNorm scale 1, bias 0."""
    model = AMCClassifier(6, (512, 512), in_features=512)
    w = model.dense[1].weight.detach().numpy()
    kernel = JaxClassifier(6, (512, 512)).init(
        jax.random.key(0), jnp.zeros((1, 512)), train=False)["params"]["Dense_1"]["kernel"]
    assert abs(w.std() / float(jnp.std(kernel)) - 1) < 0.1
    assert abs(w).max() <= 2 * 512**-0.5 / 0.87962566103423978 + 1e-6
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().any(), name
    assert all(bool((n.weight == 1).all()) for n in model.norm)


def test_batchnorm_running_variance_follows_flax():
    """At batch 8 the running variance moves towards the biased batch
    variance, as flax's does (``torch.nn.BatchNorm1d`` takes the unbiased
    one, n/(n-1) larger)."""
    x = np.random.default_rng(7).standard_normal((8, 4)).astype(np.float32) * 1.2
    bn = FlaxBatchNorm1d(4).train()
    y = bn(torch.from_numpy(x))
    jbn = jax.numpy.asarray(x)
    import flax.linen as nn

    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = flax_bn.init(jax.random.key(0), jbn)
    jy, upd = flax_bn.apply(v, jbn, mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    torch_bn = torch.nn.BatchNorm1d(4).train()
    torch_bn(torch.from_numpy(x))
    np.testing.assert_allclose(torch_bn.running_var.numpy() - 0.9, (want - 0.9) * 8 / 7,
                               rtol=1e-4)
