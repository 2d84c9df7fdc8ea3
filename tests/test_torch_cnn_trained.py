"""A trained CNN through the fused route: the port against the JAX
package's Pallas trunk, and each package's gap to its own module forward.

On the card a trained default ``IQConvNet`` served through K3 read 0.1007
from the module forward at a largest logit of 6.13, over the 0.08 that the
JAX package's kernel-versus-apply test holds with random weights. The
cause given: the module forward rounds the normalized frame to bf16 before
layer 0, while the trunk keeps layer 0 in float32, as the JAX kernel does
(``amcpy_tpu/ops/cnn_infer.py:136-139``). This file trains a default-width
bf16 ``IQConvNet`` in JAX on the CPU until its logits reach several units,
carries it over with ``cnn_params_from_flax`` and holds:

* the port's fused route (``kernel="fused"`` on the CPU: the trunk's plain
  version plus the head) against JAX's ``cnn_logits_fused(interpret=True)``
  within ``0.02 * (1 + |want|)`` (measured 0.038 of it, 1.4e-3 absolute);
* the port's gap between its fused route and its module forward against
  JAX's gap between its kernel and ``model.apply``: the port's is no larger
  than JAX's plus that tolerance (measured: both 0.0752 at a largest logit
  of 7.45). The gap belongs to the design both packages share, not to the
  port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.cnn import IQConvNet as JaxIQConvNet
from amcpy_tpu.ops.cnn_infer import cnn_logits_fused as jax_cnn_logits_fused
from amcpy_tpu.train import training as jtr
from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.ops.cnn_infer import cnn_logits_fused
from amcpy_tpu_torch.train.checkpoint import cnn_params_from_flax

N = 256
TOL = 0.02


def _qam(side):
    lv = np.arange(side) * 2.0 - (side - 1)
    pts = (lv[:, None] + 1j * lv[None, :]).ravel()
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def _dataset(per_class, seed):
    """Planar float32 frames of BPSK, QPSK, 8PSK, 16QAM, 64QAM at 5-15 dB
    and noise, each frame scaled by U(0.5, 2); labels 0 ... 5."""
    rng = np.random.default_rng(seed)
    points = [np.array([-1.0, 1.0]), np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))),
              np.exp(1j * np.pi / 4 * np.arange(8)), _qam(4), _qam(8)]
    xs, ys = [], []
    for c in range(6):
        noise = (rng.standard_normal((per_class, N))
                 + 1j * rng.standard_normal((per_class, N))) * np.sqrt(0.5)
        if c < 5:
            sym = points[c][rng.integers(0, len(points[c]), (per_class, N))]
            noise = sym + noise * 10 ** (-rng.uniform(5, 15, (per_class, 1)) / 20)
        x = noise * rng.uniform(0.5, 2.0, (per_class, 1))
        xs.append(np.stack([x.real, x.imag], axis=1).astype(np.float32))
        ys.append(np.full(per_class, c, np.int32))
    return np.concatenate(xs), np.concatenate(ys)


@pytest.fixture(scope="module")
def trained():
    """(flax model, host variables, the port's model) after 6 epochs of
    Adam at 3e-3 on 768 frames, and 192 held-out frames."""
    x_tr, y_tr = _dataset(128, seed=0)
    x_te, y_te = _dataset(32, seed=1)
    cfg = JaxConfig().replace(training={"optimizer": "adam", "learning_rate": 3e-3,
                                        "epochs": 6, "batch_size": 64})
    mesh = jax.make_mesh((1, 1), ("data", "seq"), devices=jax.devices()[:1])
    jmodel, state, history, _ = jtr.train(cfg, x_tr, y_tr, x_te, y_te,
                                          model=JaxIQConvNet(n_classes=6), mesh=mesh, seed=0)
    assert history["val_accuracy"][-1] > 0.5
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model = IQConvNet(6)
    model.load_state_dict(cnn_params_from_flax(variables["params"],
                                               variables["batch_stats"]))
    return jmodel, variables, model.eval(), x_te


def test_trained_cnn_fused_route_matches_jax_kernel_and_gap(trained):
    jmodel, variables, model, x = trained
    jax_apply = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    jax_fused = np.asarray(jax_cnn_logits_fused(jmodel, variables, jnp.asarray(x),
                                                interpret=True))
    with torch.no_grad():
        fused = cnn_logits_fused(model, torch.from_numpy(x[:, 0].copy()),
                                 torch.from_numpy(x[:, 1].copy())).numpy()
        module = model(torch.from_numpy(x)).numpy()
    peak = float(np.abs(jax_apply).max())
    assert peak > 4.0, f"the logits reach {peak}: not trained far enough to pin"
    np.testing.assert_array_less(np.abs(fused - jax_fused), TOL * (1 + np.abs(jax_fused)))
    port_gap = float(np.abs(fused - module).max())
    jax_gap = float(np.abs(jax_fused - jax_apply).max())
    assert port_gap <= jax_gap + TOL * (1 + peak), (port_gap, jax_gap)
