"""Whole training runs of the port's raw-IQ CNN against the JAX package's
on the CPU: the flax ``IQConvNet`` trained by JAX's ``train``
(``amcpy_tpu/train/training.py``) and the port's ``IQConvNet`` stepped by
``run_epoch`` (``amcpy_tpu_torch/train/training.py``), from the same
weights, on the same row orders and, for the augmented stack, the same
draws at every step (recorded from JAX's jitted epoch by an ordered debug
callback and fed to the port in order).

The arms are the CNN record's three stacks (``metrics/cnn_vs_mlp.json``)
at narrow widths (16, 32, 64; dense 32): k=1, the k=8 stride-2 control,
and k=1 with phase rotation and SNR mixing from -12 to 25 dB; dropout 0;
under RMSprop at the config's lr 1.418e-3 (the records' optimizer) and
under Adam at the same lr; in float32 and in bfloat16. The data: 192
training and 64 test frames of N = 128 of six classes (BPSK, QPSK, 8PSK,
16QAM, 64QAM, noise) made with numpy from a seed; batch 32, 3 epochs (18
steps).

**The bars.** A CNN run at this learning rate is chaotic in JAX itself:
RMSprop's first step moves every weight by ten learning rates, and a
weight whose gradient is a cancelled sum moves by what roundoff sets, so
runs that differ by roundoff part within a few steps; and the conv biases
that feed a BatchNorm take values that roundoff sets (ROADMAP C-watch 10),
which move a float32 run by ~1e-4 in loss within 3 epochs. The MLP's bars
(``tests/test_torch_training.py``: history 1e-5 / 1e-5 / 1e-3 / 3e-3,
weights rtol 1e-5 with atol 1e-6) and bf16's one-step bars
(``tests/test_torch_cnn_train.py``) therefore do not hold for JAX against
itself. Each case measures that spread: JAX's ``train`` again from the
initial weights and the frames each moved by 2^-20 of themselves, the
data-free conv biases at +-lr (two such runs, seeds 1 and 2), and the
port again with the rows of each batch (and their draws) permuted, the
same steps summed in another order. At each epoch the port is held to JAX
within ``max(SPREAD x the largest of those three gaps at any epoch up to
this one, the floor)``, ``SPREAD = 4``: each history key, and each weight
tensor's root-mean-square gap (the data-free conv biases and the running
means left out, as C-watch 10 does; RMSprop's first step moves a weight by
ten learning rates either way, so the largest element's gap is 20 lr for
a roundoff sign and for a fault alike, the mean square is not). The
history floors are the MLP's bars in float32 and, in bfloat16, the
one-step bars (loss atol 5e-3; accuracy two rows a step's share, 2/32/6;
val_loss 5e-2; val_accuracy two of the 64 test rows); a weight's floor is
``rtol x rms(w)`` plus the one-step atol once for each step taken (rtol,
atol: 1e-5, 1e-6 in float32; 1e-3, 6e-4 in bf16). The packages round their
bf16 products apart (``test_wide_strided_stack_bf16_gradients_match_flax``:
0.6-4 % of a gradient), more than a moved start or another summing order
moves either one: with the one-step atol unscaled, the augmented Adam bf16
case's ``norm.0.bias`` leaves at epoch 1 by 1.2 (port against JAX 0.6 lr
rms, JAX against itself 0.1 lr). ``python -m tests.test_torch_cnn_trajectory``
prints each case's gaps and bars by epoch: on an 8-core CPU every gap was
within 0.68 of its bar.

**The conv biases** (a proposed cause of the k=8 and augmented arms' gaps to the
JAX record: a bias many times its product's spread rounds the product
away in bf16): at each epoch each layer's ``max|bias|`` in the port lies
within ``BIAS_FACTOR = 4`` of JAX's runs' span (``[min / 4 - lr, max x 4
+ lr]``), and no channel's bias reaches its product's std in the port
(largest ratio measured 0.41; JAX's, recorded in ``run_case``'s output and
not asserted, 0.65).

The bars have teeth: on a copy of the port with BatchNorm's momentum at
0.99 every case leaves them (by 6.4-25,000 times); with RMSprop's decay at
0.9 every RMSprop case (1.08-33,500); with the augmentation's noise scaled
by the variance instead of its root every augmented case (2.1-2,600); with
the k=8 kernels flipped in time three of the four k=8 cases (1.9-11,500).
The fourth, bf16 under RMSprop, stays inside (0.71): JAX's own runs part
by 0.07 in the first epoch's mean loss there, so a whole run cannot tell a
flipped kernel from roundoff; the one-step gradient tests of
``tests/test_torch_cnn_train.py`` catch it (the bf16 one by 11-16 times
its bar).
"""

import math

import jax
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.cnn import IQConvNet as JaxIQConvNet
from amcpy_tpu.train import training as jtr
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models import cnn as cnn_mod
from amcpy_tpu_torch.models.cnn import IQConvNet, conv_bias_report
from amcpy_tpu_torch.train.checkpoint import cnn_params_from_flax
from amcpy_tpu_torch.train.training import HISTORY_KEYS, make_optimizer, run_epoch
from scripts.torch_training_card_vs_cpu import frames, nudged

N, N_TRAIN, N_TEST, BATCH, EPOCHS, SEED = 128, 192, 64, 32, 3, 5
LR = Config().training.learning_rate
#: the record's three stacks, at narrow widths
WIDTHS = {"channels": (16, 32, 64), "dense": 32}
ARMS = {
    "k1": WIDTHS,
    "k8": {**WIDTHS, "kernel_sizes": (8, 8, 8), "strides": (2, 2, 2)},
    "aug": {**WIDTHS, "aug_phase": True, "aug_noise_snr_db": (-12.0, 25.0)},
}
#: how far the port may lie from JAX, in units of the measured spread
SPREAD = 4.0
#: how far the port's conv biases may lie from JAX's, as a factor
BIAS_FACTOR = 4.0
#: the bars where JAX's own gap is smaller: history (loss, accuracy,
#: val_loss, val_accuracy) atol; weights (rtol, atol)
FLOOR = {
    "float32": ((1e-5, 1e-5, 1e-3, 3e-3), (1e-5, 1e-6)),
    "bfloat16": ((5e-3, 2 / BATCH / (N_TRAIN // BATCH), 5e-2, 2 / N_TEST), (1e-3, 6e-4)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's steps on one thread: these shapes gain nothing from more,
    and the sums keep one order whatever the machine's core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data_free(key: str) -> bool:
    return (key.startswith("conv.") and key.endswith(".bias")) or key.endswith("running_mean")


def _frames():
    """``N_TRAIN`` training and ``N_TEST`` test frames of six classes
    (``scripts/torch_training_card_vs_cpu.py::frames``), labels int32."""
    x, y = frames(N_TRAIN + N_TEST, N, seed=0)
    y = y.astype(np.int32)
    return x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]


def _jax_orders(seed, n, take, epochs):
    """Each epoch's row order as JAX's ``train`` draws it on one shard
    (``tests/test_torch_training.py::_jax_orders``)."""
    _, run_key = jax.random.split(jax.random.key(seed))
    orders = []
    for _ in range(epochs):
        run_key, ep_key = jax.random.split(run_key)
        perm_key, _ = jax.random.split(ep_key)
        orders.append(np.asarray(jax.random.permutation(
            jax.random.split(perm_key, 1)[0], n))[np.arange(take) % n])
    return orders


class _Tape:
    """Records the augmentation's draws of a jitted JAX epoch, in program
    order: ``jax.random.uniform``/``normal`` wrapped with an ordered debug
    callback while the epoch is traced (``install``, through a monkeypatch
    that undoes it)."""

    def __init__(self):
        self.values: list[np.ndarray] = []

    def _wrap(self, fn):
        def drawn(*args, **kwargs):
            out = fn(*args, **kwargs)
            jax.debug.callback(lambda v: self.values.append(np.array(v)), out,
                               ordered=True)
            return out
        return drawn

    def install(self, mp):
        for name in ("uniform", "normal"):
            mp.setattr(jax.random, name, self._wrap(getattr(jax.random, name)))

    def steps(self, prob, count):
        """The first ``count`` steps' draws in the port's form ``(theta,
        snr_db, keep, noise)``: flax draws theta, the SNR, the keep
        uniform, then the noise (``amcpy_tpu/models/cnn.py:110-134``)."""
        for theta, snr, u_keep, noise in zip(*[iter(self.values[:4 * count])] * 4):
            assert theta.shape == (BATCH, 1) and noise.shape == (BATCH, 2, N)
            yield (torch.from_numpy(theta), torch.from_numpy(snr),
                   torch.from_numpy(u_keep) < prob, torch.from_numpy(noise))


def _jax_runs(jm, opt, data, tape, monkeypatch):
    """JAX's ``train`` on ``data``, then twice from a start moved by
    roundoff (weights and frames nudged, seeds 1 and 2), one compiled epoch
    program for all three: the initial (params, batch_stats) and, for each
    run, its history and per-epoch (params, batch_stats). The epoch program
    is JAX's own (``_epoch_fn``), put in ``train``'s cache under the key
    ``train`` looks up (through ``monkeypatch``), wrapped to keep each
    epoch's state."""
    cfg = JaxConfig().replace(training={"epochs": EPOCHS, "dropout": 0.0,
                                        "optimizer": opt, "batch_size": BATCH})
    mesh = jax.make_mesh((1, 1), ("data", "seq"), devices=jax.devices()[:1])
    tx = jtr.make_optimizer(cfg)
    n_batches = N_TRAIN // BATCH
    inner = jax.jit(jtr._epoch_fn(jm, tx, n_batches, BATCH, 1, "data", mesh))
    key = (jm, tx, n_batches, BATCH, 1, "data", mesh)
    states, init = [], []

    def epoch(state, *args):
        if not init:  # the first call traces the program: record its draws
            init.append(_np((state.params, state.batch_stats)))
            with monkeypatch.context() as mp:
                tape.install(mp)
                out = inner(state, *args)
        else:
            out = inner(state, *args)
        states[-1].append(_np((out[0].params, out[0].batch_stats)))
        return out

    runs = []
    monkeypatch.setitem(jtr._EPOCH_CACHE, key, epoch)
    for nudge in (None, 1, 2):
        states.append([])
        x_train, initial = data[0], None
        if nudge:  # the initial weights and the frames moved by roundoff,
            # the data-free conv biases set to +-lr
            params = jax.tree.map(lambda a: nudged(np.asarray(a), nudge), init[0][0])
            signs = np.random.default_rng(10 + nudge)
            params = {k: {**v, "bias": (LR * signs.choice([-1, 1], v["bias"].shape))
                          .astype(np.float32)} if k.startswith("Conv_") else v
                      for k, v in params.items()}
            initial = (params, init[0][1], tx.init(params), 0)
            x_train = nudged(x_train, nudge)
        _, _, hist, _ = jtr.train(cfg, x_train, data[1], *data[2:], mesh=mesh,
                                  seed=SEED, model=jm, initial=initial)
        runs.append((hist, states[-1]))
    assert all(len(s) == EPOCHS for s in states)
    return init[0], runs


def _port_run(arch, opt, data, init, draws, monkeypatch, shuffle=None):
    """The port's epochs from JAX's initial weights on JAX's row orders,
    fed JAX's draws step by step: (history, per-epoch state_dict). With a
    ``shuffle`` generator the rows of each batch (and their draws) are
    permuted: the same steps, summed in another order."""
    model = IQConvNet(6, **arch)
    model.load_state_dict(cnn_params_from_flax(*init))
    o = make_optimizer(Config().replace(training={"optimizer": opt}), model.parameters())
    per_epoch = N_TRAIN // BATCH
    perms = [np.arange(BATCH) if shuffle is None else shuffle.permutation(BATCH)
             for _ in range(EPOCHS * per_epoch)]
    if draws is not None:
        feed = iter([tuple(d[p] for d in step) for step, p in zip(draws, perms)])
        monkeypatch.setattr(cnn_mod, "augmentation_draws", lambda *a, **k: next(feed))
    x_tr, y_tr, x_te, y_te = (torch.from_numpy(a) for a in data)
    history, states = {k: [] for k in HISTORY_KEYS}, []
    orders = _jax_orders(SEED, N_TRAIN, per_epoch * BATCH, EPOCHS)
    for e, order in enumerate(orders):
        within = np.concatenate([b * BATCH + perms[e * per_epoch + b]
                                 for b in range(per_epoch)])
        m = run_epoch(model, o, x_tr, y_tr.long(), x_te, y_te.long(),
                      torch.from_numpy(order[within]), BATCH)
        for k in HISTORY_KEYS:
            history[k].append(float(m[k]))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    if draws is not None:
        assert next(feed, None) is None  # every step took one batch of draws
    return history, states


def _rms(t) -> float:
    return float(t.double().square().mean().sqrt())


def _envelope(gaps) -> np.ndarray:
    """Per epoch, the largest gap up to that epoch."""
    return np.maximum.accumulate(np.asarray(gaps, np.float64))


def _bias_report(arch, state, probe):
    model = IQConvNet(6, **arch)
    model.load_state_dict(state)
    return conv_bias_report(model, probe)


def run_case(arm, opt, dtype, monkeypatch):
    """One case: the port's and JAX's two runs, with every gap the bars
    read. Returns a dict of the measured gaps and bars."""
    arch = dict(ARMS[arm], dropout=0.0, dtype=dtype)
    jm = JaxIQConvNet(n_classes=6, **arch)
    data = _frames()
    tape = _Tape()
    init, ((jhist, jstates), *others) = _jax_runs(jm, opt, data, tape, monkeypatch)
    steps = EPOCHS * (N_TRAIN // BATCH)
    draws = None
    if arm == "aug":
        # four draws a step, the same in every JAX run
        assert len(tape.values) == (1 + len(others)) * 4 * steps
        assert all(np.array_equal(a, tape.values[i % (4 * steps)])
                   for i, a in enumerate(tape.values))
        draws = list(tape.steps(jm.aug_noise_prob, steps))
    else:
        assert not tape.values
    history, states = _port_run(arch, opt, data, init, draws, monkeypatch)
    phist, pstates = _port_run(arch, opt, data, init, draws, monkeypatch,
                               shuffle=np.random.default_rng(2))
    out = {"history": {}, "weights": {}, "bias": []}
    hist_floor, (rtol, atol) = FLOOR[dtype]
    # per epoch: the gap, and the bar from the spread up to that epoch
    for k, floor in zip(HISTORY_KEYS, hist_floor):
        gap = np.abs(np.subtract(history[k], jhist[k]))
        own = np.max([np.abs(np.subtract(h[k], jhist[k])) for h, _ in others]
                     + [np.abs(np.subtract(phist[k], history[k]))], axis=0)
        out["history"][k] = (gap, np.maximum(SPREAD * _envelope(own), floor))
    want = [cnn_params_from_flax(*s) for s in jstates]
    alts = [[cnn_params_from_flax(*s) for s in o] for _, o in others]
    for key in want[0]:
        if _data_free(key) or key.endswith("num_batches_tracked"):
            continue
        gap = np.array([_rms(states[e][key] - want[e][key]) for e in range(EPOCHS)])
        own = np.max([[_rms(alt[e][key] - want[e][key]) for e in range(EPOCHS)]
                      for alt in alts]
                     + [[_rms(pstates[e][key] - states[e][key]) for e in range(EPOCHS)]],
                     axis=0)
        # the one-step bar once for each step taken
        floor = np.array([rtol * _rms(want[e][key]) + atol * (e + 1) * (N_TRAIN // BATCH)
                          for e in range(EPOCHS)])
        out["weights"][key] = (gap, np.maximum(SPREAD * _envelope(own), floor))
    probe = torch.from_numpy(data[2])
    for e in range(EPOCHS):
        mine = _bias_report(arch, states[e], probe)
        theirs = [_bias_report(arch, cnn_params_from_flax(*s[e]), probe)
                  for s in [jstates] + [o[1] for o in others]]
        for layer, m in enumerate(mine):
            js = [t[layer]["max_abs_bias"] for t in theirs]
            out["bias"].append({
                "epoch": e, "layer": layer, "port": m["max_abs_bias"], "jax": js,
                "range": (min(js) / BIAS_FACTOR - LR, max(js) * BIAS_FACTOR + LR),
                "port_ratio": m["ratio"],
                "jax_ratio": max(t[layer]["ratio"] for t in theirs)})
    return out


CASES = [(arm, opt, dtype) for arm in ARMS for opt in ("rmsprop", "adam")
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("arm,opt,dtype", CASES)
def test_whole_run_matches_jax(arm, opt, dtype, monkeypatch):
    """Three epochs of the port from flax's initial weights, on JAX's row
    orders (and draws): history, weights and conv biases against JAX's
    ``train`` (bars in the module docstring)."""
    out = run_case(arm, opt, dtype, monkeypatch)
    for key, (gap, bar) in {**out["history"], **out["weights"]}.items():
        for e in range(EPOCHS):
            assert gap[e] <= bar[e], f"{key}, epoch {e + 1}: {gap[e]:.3g} > {bar[e]:.3g}"
    for b in out["bias"]:
        lo, hi = b["range"]
        assert lo <= b["port"] <= hi, b
        assert b["port_ratio"] < 1.0, b
    assert math.isfinite(out["history"]["loss"][0][0])


if __name__ == "__main__":  # print each case's gaps against its bars
    torch.set_num_threads(1)
    for case in CASES:
        with pytest.MonkeyPatch.context() as mp:
            result = run_case(*case, mp)
        rows = {k: np.divide(*v) for k, v in {**result["history"],
                                               **result["weights"]}.items()}
        worst = max(rows, key=lambda k: rows[k].max())
        print(case, "worst", worst, "gap/bar by epoch",
              " ".join("%.3g" % r for r in rows[worst]),
              {k: " ".join("%.3g/%.3g" % gb for gb in zip(*result["history"][k]))
               for k in HISTORY_KEYS},
              "bias/std port %.3g jax %.3g" % tuple(
                  max(b[k] for b in result["bias"]) for k in ("port_ratio", "jax_ratio")),
              flush=True)
