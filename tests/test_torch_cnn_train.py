"""Training of the port's raw-IQ CNN (``amcpy_tpu_torch/models/cnn.py``'s
train mode and augmentation, stepped by ``train/training.py``) against the
JAX package's flax ``IQConvNet`` on the CPU.

Tolerances, each with its reason and the gap measured on this CPU:

* one Adam step of the float32 stack (8, 16): loss rtol 1e-5, parameters
  and batch statistics rtol 1e-5 with atol 1e-6, Adam's moments within
  1e-5 of each tensor's largest (measured 8.6e-6).
  As in the MLP (``tests/test_torch_training.py``), the conv biases that
  feed a BatchNorm have a gradient that is zero in exact arithmetic; Adam
  scales their roundoff up to a full step, so they, their moments and the
  running means are left out (in float32 their |g| < 1e-6 is checked; in
  bf16 the gradient of the rounded conv output is itself bf16, and its sum
  over 4,096 values reaches 0.04);
* the same step in bf16 (flax's step jitted, as the JAX package trains):
  loss rtol 5e-3 (measured 1.4e-3); parameters rtol 1e-3 with atol 6e-4,
  two learning rates (Adam's first step moves each weight by lr sign(g),
  and where bf16 rounding flips a small gradient's sign the packages land
  2 lr apart: measured on one weight of 128); Adam's moments within 0.2 of
  each tensor's largest (measured 0.13): both packages round activations
  and their gradients to bf16 (8 bits) from float32 values whose last bits
  differ, in another order;
* the train-mode forward with augmentation, given the same draws, against
  flax's (its draws replaced by the same arrays): atol 1e-4 in float32
  (measured 2e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amcpy_tpu.models.cnn import IQConvNet as JaxIQConvNet
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models import cnn as cnn_mod
from amcpy_tpu_torch.models.cnn import IQConvNet, augment, augmentation_draws
from amcpy_tpu_torch.train.checkpoint import cnn_params_from_flax, opt_state_from_optax
from amcpy_tpu_torch.train.training import make_optimizer, train, train_step

from .test_torch_cnn import K1_F32, _flax_weights, _frames


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data_free(key: str) -> bool:
    return (key.startswith("conv.") and key.endswith(".bias")) or key.endswith("running_mean")


def _one_step(dtype):
    """After one Adam step of the (8, 16) stack on the same batch, dropout
    0: (port model, its optimizer, flax params, batch stats, optax state,
    flax loss, port loss, flax grads)."""
    arch = dict(K1_F32, dropout=0.0, dtype=dtype)
    jm = JaxIQConvNet(n_classes=6, **arch)
    params0, stats0 = _flax_weights(jm, 128, seed=3)
    tx = optax.adam(3e-4)
    x = _frames(32, 128, seed=4)
    y = np.random.default_rng(5).integers(0, 6, 32).astype(np.int32)

    def loss_fn(p, st):
        logits, upd = jm.apply({"params": p, "batch_stats": st}, x, train=True,
                               mutable=["batch_stats"])
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y))
        return loss, upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params0, stats0)
    updates, opt_state = tx.update(grads, tx.init(params0), params0)
    params = optax.apply_updates(params0, updates)

    model = IQConvNet(6, **arch)
    model.load_state_dict(cnn_params_from_flax(params0, stats0))
    cfg = Config().replace(training={"optimizer": "adam", "learning_rate": 3e-4})
    opt = make_optimizer(cfg, model.parameters(),
                         opt_state_from_optax("adam", _np(tx.init(params0)), model))
    got_loss, _ = train_step(model, opt, torch.from_numpy(x),
                             torch.from_numpy(y.astype(np.int64)))
    return model, opt, params, stats, opt_state, float(loss), float(got_loss), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_flax(dtype):
    """One Adam step: loss, parameters, batch statistics and Adam's moments
    against flax + optax (bars in the module docstring)."""
    model, opt, params, stats, opt_state, loss, got_loss, grads = _one_step(dtype)
    f32 = dtype == "float32"
    rtol, atol = (1e-5, 1e-6) if f32 else (1e-3, 2 * 3e-4)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5 if f32 else 5e-3)
    if f32:  # in bf16 the gradient of the rounded conv output is bf16 too
        for k in range(2):
            assert float(jnp.abs(grads[f"Conv_{k}"]["bias"]).max()) < 1e-6
    want = cnn_params_from_flax(_np(params), _np(stats))
    got = model.state_dict()
    for key, w in want.items():
        if _data_free(key) or key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)
    want_opt = opt_state_from_optax("adam", _np(opt_state), model)
    names = [n for n, _ in model.named_parameters()]
    for i, s in opt.state_dict()["state"].items():
        assert float(s["step"]) == 1.0
        if _data_free(names[i]):
            continue
        for m in ("exp_avg", "exp_avg_sq"):
            w = want_opt["state"][i][m].numpy()
            np.testing.assert_allclose(s[m].numpy(), w, rtol=rtol,
                                       atol=(rtol if f32 else 0.2) * float(np.abs(w).max()),
                                       err_msg=f"{names[i]} {m}")


#: the k=8 control arm of the CNN record (``scripts/torch_cnn_wide_control.py``)
WIDE = dict(channels=(32, 64, 128), kernel_sizes=(8, 8, 8), strides=(2, 2, 2), dense=128)


def _wide_stack_gradients(n, dtype):
    """The k=8, stride-2 stack's gradients in flax and in the port from the
    same weights and batch (dropout 0): (flax's, the port's) pairs of every
    conv kernel, the first dense kernel and every BatchNorm scale."""
    arch = dict(WIDE, dropout=0.0, dtype=dtype)
    jm = JaxIQConvNet(n_classes=6, **arch)
    params, stats = _flax_weights(jm, n, seed=3)
    x = _frames(64, n, seed=4)
    y = np.random.default_rng(5).integers(0, 6, 64).astype(np.int32)

    def loss_fn(p):
        logits, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                             mutable=["batch_stats"])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y))

    grads = _np(jax.grad(loss_fn)(params))
    model = IQConvNet(6, **arch)
    model.load_state_dict(cnn_params_from_flax(params, stats))
    logits = model.train()(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y.astype(np.int64))).backward()
    pairs = [(grads[f"Conv_{k}"]["kernel"], model.conv[k].weight.grad.numpy().transpose(2, 1, 0))
             for k in range(3)]
    pairs.append((grads["Dense_0"]["kernel"], model.dense.weight.grad.numpy().T))
    return pairs + [(grads[f"BatchNorm_{k}"]["scale"], model.norm[k].weight.grad.numpy())
                    for k in range(3)]


@pytest.mark.parametrize("n", [256, 250])
def test_wide_strided_stack_gradients_match_flax(n):
    """The k=8, stride-2 stack of the control arm (SAME padding, odd at
    N = 250) in float32, dropout 0: every layer's kernel gradient against
    flax's within 2e-5 of its largest."""
    for want, got in _wide_stack_gradients(n, "float32")[:4]:
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [256, 250])
def test_wide_strided_stack_bf16_gradients_match_flax(n):
    """The same step in bfloat16, the records' dtype: every conv kernel's,
    the first dense kernel's and every BatchNorm scale's gradient within
    0.1 of its rms, as an rms gap (measured: 0.006-0.044 at N = 256 and
    250 from two seeds of weights; the two packages round their bf16
    products apart). With the k=8 kernels flipped in time the conv kernels'
    gradients leave by 1.07-1.6 of their rms: a wrong strided convolution
    shows here at the first step, before whole runs part by chaos
    (``tests/test_torch_cnn_trajectory.py``)."""
    for want, got in _wide_stack_gradients(n, "bfloat16"):
        gap = np.sqrt(np.mean((got - want) ** 2))
        assert gap <= 0.1 * np.sqrt(np.mean(want**2)), (want.shape, gap)


def _draws(b, n, seed, lo=-12.0, hi=25.0):
    """Fixed augmentation draws: theta, snr_db, the keep uniforms, noise."""
    rng = np.random.default_rng(seed)
    theta = (rng.uniform(0, 2 * np.pi, (b, 1))).astype(np.float32)
    snr = rng.uniform(lo, hi, (b, 1, 1)).astype(np.float32)
    u_keep = rng.uniform(0, 1, (b, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((b, 2, n)).astype(np.float32)
    return theta, snr, u_keep, noise


def test_augmented_train_forward_matches_flax(monkeypatch):
    """The train-mode forward of an augmenting model (phase rotation and
    SNR-mixing noise), both packages given the same draws: the port's
    ``augment`` is the JAX formula of ``cnn.py:110-134``."""
    arch = dict(K1_F32, dropout=0.0, dtype="float32", aug_phase=True,
                aug_noise_snr_db=(-12.0, 25.0), aug_noise_prob=0.5)
    jm = JaxIQConvNet(n_classes=6, **arch)
    params, stats = _flax_weights(jm, 128, seed=6)
    x = _frames(16, 128, seed=7)
    theta, snr, u_keep, noise = _draws(16, 128, seed=8)
    uniforms = iter([theta, snr, u_keep])

    def fake_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = next(uniforms)
        assert out.shape == tuple(shape)
        return jnp.asarray(out)

    def fake_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jax.random, "normal", fake_normal)
    want, _ = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                       mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
    monkeypatch.undo()
    assert next(uniforms, None) is None

    model = IQConvNet(6, **arch)
    model.load_state_dict(cnn_params_from_flax(_np(params), _np(stats)))
    keep = torch.from_numpy(u_keep) < 0.5
    given = (torch.from_numpy(theta), torch.from_numpy(snr), keep, torch.from_numpy(noise))
    monkeypatch.setattr(cnn_mod, "augmentation_draws", lambda *a, **k: given)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_augment_formula():
    """``augment`` rotates by theta and adds noise of per-component
    variance mean(x^2) 10^(-snr/10) where kept, the mean over both planes."""
    x = torch.from_numpy(_frames(4, 64, seed=9))
    theta, snr, u_keep, noise = (torch.from_numpy(a) for a in _draws(4, 64, seed=10))
    keep = torch.tensor([True, False, True, False]).view(4, 1, 1)
    got = augment(x, theta, snr, keep, noise).double().numpy()
    xd, th = x.double().numpy(), theta.double().numpy()
    rot = np.stack([xd[:, 0] * np.cos(th) - xd[:, 1] * np.sin(th),
                    xd[:, 0] * np.sin(th) + xd[:, 1] * np.cos(th)], axis=1)
    v = (rot**2).mean(axis=(1, 2), keepdims=True) * 10 ** (-snr.double().numpy() / 10)
    want = rot + np.where(keep.numpy(), np.sqrt(v), 0.0) * noise.double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # phase only, and noise only
    assert torch.equal(augment(x, None, None, None, None), x)
    only_noise = augment(x, None, snr, keep, noise)
    torch.testing.assert_close(only_noise[1], x[1])


def test_augmentation_draws_follow_their_distributions():
    """Over 10^4 frames: theta in [0, 2 pi) with mean pi, the added-noise
    SNR in [lo, hi) with mean (lo + hi) / 2, the keep share near
    ``aug_noise_prob`` (binomial sd 0.005), the noise standard normal."""
    g = torch.Generator().manual_seed(0)
    theta, snr, keep, noise = augmentation_draws(
        10_000, 16, phase=True, noise_snr_db=(-12.0, 25.0), noise_prob=0.75, generator=g
    )
    assert theta.shape == (10_000, 1) and snr.shape == keep.shape == (10_000, 1, 1)
    assert float(theta.min()) >= 0 and float(theta.max()) < 2 * math.pi
    assert abs(float(theta.mean()) - math.pi) < 0.05
    assert float(snr.min()) >= -12.0 and float(snr.max()) < 25.0
    assert abs(float(snr.mean()) - 6.5) < 0.3
    assert keep.dtype == torch.bool and abs(float(keep.float().mean()) - 0.75) < 0.02
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1) < 0.01
    none = augmentation_draws(3, 8, phase=False, noise_snr_db=None, noise_prob=0.5)
    assert none == (None, None, None, None)


def test_augmentation_acts_in_training_only():
    """Eval logits of an augmenting model equal the plain model's on the
    same weights; in training the augmented forward differs from the plain
    one and depends on the generator (as ``tests/test_cnn.py:254-292``)."""
    kw = dict(K1_F32, dtype="float32")
    plain = IQConvNet(6, **kw)
    aug = IQConvNet(6, **kw, aug_phase=True, aug_noise_snr_db=(-12.0, 25.0))
    aug.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_frames(4, 64, seed=11))
    with torch.no_grad():
        torch.testing.assert_close(aug.eval()(x), plain.eval()(x), rtol=0, atol=0)

        def run(model, seed):
            return model.train()(x, generator=torch.Generator().manual_seed(seed))

        a1, p1, a2 = run(aug, 1), run(plain, 1), run(aug, 2)
    assert not torch.allclose(a1, p1) and not torch.allclose(a1, a2)
    assert torch.equal(run(aug, 1), a1)


def test_cnn_trains_on_raw_frames():
    """``train`` with an ``IQConvNet`` on planar frames of two classes told
    apart by their phase spread: the loss falls and the accuracy rises."""
    rng = np.random.default_rng(12)
    n, size = 512, 64
    y = np.repeat([0, 1], n // 2).astype(np.int32)
    phase = np.where(y[:, None] == 0, rng.choice([0, np.pi], (n, size)),
                     rng.choice([0, np.pi / 2, np.pi, 3 * np.pi / 2], (n, size)))
    frames = np.exp(1j * phase) + 0.1 * (rng.standard_normal((n, size))
                                         + 1j * rng.standard_normal((n, size)))
    x = np.stack([frames.real, frames.imag], axis=1).astype(np.float32)
    cfg = Config().replace(signals={"modulations_with_noise": ("BPSK", "QPSK")},
                           training={"epochs": 4, "batch_size": 32, "optimizer": "adam",
                                     "learning_rate": 3e-3})
    model = IQConvNet(2, **K1_F32, dtype="float32")
    model, state, history, _ = train(cfg, x[::2], y[::2], x[1::2], y[1::2], model=model,
                                     device="cpu")
    assert history["loss"][-1] < history["loss"][0]
    assert history["val_accuracy"][-1] > 0.9 and state.step == 4 * 8
