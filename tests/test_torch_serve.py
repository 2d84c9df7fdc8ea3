"""The port's serving chain (``amcpy_tpu_torch/serve.py``) against the JAX
package's ``AMCPipeline`` on the CPU: one set of flax weights, carried
across with ``params_from_flax``, one scaler, the same frames.

Logit tolerance: atol 2e-4, rtol 2e-4. The two extractors agree to about
1e-5 relative (float32 sums in another order); the standardizer divides
each feature by its spread over the batch, which magnifies that difference
where a feature varies little between frames, and the MLP (random weights
of scale 0.5, three hidden layers) carries it to the logits. Measured
worst case on these inputs: below 1e-5 absolute, logits up to ~5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.classifier import AMCClassifier as JaxClassifier
from amcpy_tpu.ops.features import extract_features_planar as jax_extract
from amcpy_tpu.ops.features import to_planar
from amcpy_tpu.preprocessing import Standardizer as JaxStandardizer
from amcpy_tpu.serve import AMCPipeline as JaxPipeline
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.train.checkpoint import (
    load_checkpoint,
    params_from_flax,
    resolve_model_id,
    save_checkpoint,
)

N = 256
ATOL = RTOL = 2e-4


def _frames(b, seed):
    """Gaussian frames with a per-frame scale spread of exp(U(-1, 1)), so
    the scale-dependent used features (X, C40, C42) vary over the batch."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N)) + 1j * rng.standard_normal((b, N))
    return (x * np.exp(rng.uniform(-1, 1, (b, 1)))).astype(np.complex64)


def _flax_weights(activation, seed):
    """Seeded numpy values in the flax pytree layout: Dense kernels (in,
    out), BatchNorm scale/bias, and positive running variances."""
    model = JaxClassifier(n_classes=6, activation=activation)
    shapes = jax.tree.map(
        np.shape, model.init(jax.random.key(0), jnp.zeros((1, 6)), train=False)
    )
    rng = np.random.default_rng(seed)
    params = {
        layer: {k: rng.normal(0.0, 0.5, s).astype(np.float32) for k, s in leaves.items()}
        for layer, leaves in shapes["params"].items()
    }
    stats = {
        layer: {
            "mean": rng.normal(0.0, 0.3, leaves["mean"]).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, leaves["var"]).astype(np.float32),
        }
        for layer, leaves in shapes["batch_stats"].items()
    }
    return model, params, stats


def _pipelines(tmp_path, activation, kernel="auto", seed=0):
    """(JAX pipeline, port pipeline) on the same weights and scaler."""
    jcfg = JaxConfig().replace(
        paths={"root": str(tmp_path / "jax")},
        signals={"frame_size": N},
        training={"activation": activation},
        compute={"kernel": kernel},
    )
    cfg = Config().replace(
        paths={"root": str(tmp_path / "torch")},
        signals={"frame_size": N},
        training={"activation": activation},
        compute={"kernel": kernel},
    )
    fit = _frames(64, seed=100 + seed)
    cols = list(cfg.features.used_columns)
    jscaler = JaxStandardizer.fit(np.asarray(jax_extract(to_planar(fit)))[:, cols])
    jmodel, params, stats = _flax_weights(activation, seed)
    jpipe = JaxPipeline(jmodel, params, stats, jscaler, jcfg)
    jpipe.multi_device = False

    model = AMCClassifier(6, activation=activation)
    model.load_state_dict(params_from_flax(params, stats))
    scaler = Standardizer.from_dict(jscaler.to_dict())
    return jpipe, AMCPipeline(model, scaler, cfg, device="cpu")


def _assert_logits_agree(jpipe, pipe, frames):
    want = np.asarray(jpipe.logits(frames))
    got = pipe.logits(frames).numpy()
    assert got.shape == want.shape == (len(frames), 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid", "gelu"])
def test_pipeline_matches_jax_pipeline(tmp_path, activation):
    jpipe, pipe = _pipelines(tmp_path, activation)
    assert pipe._kernel == "xla"  # "auto" on the CPU
    _assert_logits_agree(jpipe, pipe, _frames(37, seed=1))


def test_fused_route_matches_jax_fused_kernel(tmp_path):
    """kernel="fused" on both sides: the JAX Pallas kernel in interpret
    mode, the port's wrapper on its plain version (a CPU tensor)."""
    jpipe, pipe = _pipelines(tmp_path, "relu", kernel="fused", seed=2)
    assert pipe._kernel == "fused"
    _assert_logits_agree(jpipe, pipe, _frames(20, seed=3))


def test_planar_and_complex_inputs_agree(tmp_path):
    _, pipe = _pipelines(tmp_path, "relu")
    x = _frames(9, seed=4)
    np.testing.assert_array_equal(
        pipe.logits(x).numpy(), pipe.logits(to_planar(x)).numpy()
    )
    np.testing.assert_array_equal(pipe.predict(x), pipe.predict(to_planar(x)))
    probs = pipe.predict_proba(x)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)
    names = pipe.predict_names(x)
    assert names == [Config().signals.modulations_with_noise[k] for k in pipe.predict(x)]
    with pytest.raises(ValueError, match="complex"):
        pipe.logits(np.zeros((2, 3, N), np.float32))


def test_pipeline_leaves_the_tf32_flag_as_it_was(tmp_path, monkeypatch):
    """The MLP runs without TF32, but the process-wide flag is restored
    after each call, and building a pipeline does not touch it."""
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_tf32", True)
    seen = []
    _, pipe = _pipelines(tmp_path, "relu")
    assert flags.allow_tf32 is True
    pipe.model.register_forward_hook(lambda *_: seen.append(flags.allow_tf32))
    pipe.logits(_frames(3, seed=5))
    assert seen == [False] and flags.allow_tf32 is True


def test_gelu_is_the_tanh_approximation():
    """flax's nn.gelu defaults to approximate=True; PyTorch's nn.GELU()
    does not, so the port must ask for the tanh form."""
    model = AMCClassifier(6, activation="gelu")
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        model.act(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(x)),
        atol=1e-6,
    )


def test_checkpoint_round_trip(tmp_path):
    """``model-{id}.pt`` plus a JSON sidecar with the JAX package's keys;
    loaded back it serves the same logits."""
    from amcpy_tpu.train.checkpoint import save_checkpoint as jax_save
    from amcpy_tpu.train.training import TrainState, make_optimizer

    jpipe, pipe = _pipelines(tmp_path, "tanh", seed=5)
    cfg = pipe.cfg
    history = {"loss": [1.5, 1.0]}
    path = save_checkpoint(cfg, "rt", pipe.model, pipe.scaler, history, epoch=2)
    assert path.name == "model-rt.pt"
    assert (cfg.paths.trained_ann / "model-rt.json").exists()

    model, scaler, meta = load_checkpoint(cfg, "rt")
    for key, value in pipe.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)
    np.testing.assert_array_equal(scaler.mean, pipe.scaler.mean)
    np.testing.assert_array_equal(scaler.std, pipe.scaler.std)
    assert meta["history"] == history and meta["epoch"] == 2

    # the sidecar carries the same keys and config values as the JAX one
    jcfg = jpipe.cfg
    state = TrainState(
        params=jpipe.params,
        batch_stats=jpipe.batch_stats,
        opt_state=make_optimizer(jcfg).init(jpipe.params),
        step=np.zeros((), np.int32),
    )
    jax_save(jcfg, "rt", state, jpipe.scaler, history, 2)
    jmeta = json.loads((jcfg.paths.trained_ann / "model-rt.json").read_text())

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(meta) == keys(jmeta)
    assert meta["config"] == jmeta["config"]
    np.testing.assert_allclose(meta["scaler"]["mean"], jmeta["scaler"]["mean"])

    assert resolve_model_id(cfg) == "rt"
    served = AMCPipeline.from_checkpoint(cfg, device="cpu")
    x = _frames(11, seed=6)
    np.testing.assert_array_equal(served.logits(x).numpy(), pipe.logits(x).numpy())


def test_checkpoint_refuses_unported_family(tmp_path):
    _, pipe = _pipelines(tmp_path, "relu")
    save_checkpoint(pipe.cfg, "cnn", pipe.model, pipe.scaler,
                    model_meta={"family": "cnn"})
    with pytest.raises(NotImplementedError, match="family"):
        load_checkpoint(pipe.cfg, "cnn")


def test_classify_stream_matches_predict(tmp_path):
    _, pipe = _pipelines(tmp_path, "relu")
    x = _frames(21, seed=7)
    path = tmp_path / "capture.bin"
    np.concatenate([np.zeros(2400, np.complex64), x.reshape(-1)]).tofile(path)
    preds = pipe.classify_stream(path, batch_size=8)
    np.testing.assert_array_equal(preds, pipe.predict(x))


def test_standardizer_matches_jax():
    """Biased statistics, a constant column passes through with std 1."""
    x = np.random.default_rng(8).standard_normal((50, 6)).astype(np.float32) * 3 + 1
    x[:, 2] = 4.0
    mine, theirs = Standardizer.fit(x), JaxStandardizer.fit(x)
    np.testing.assert_allclose(mine.mean, theirs.mean, rtol=1e-6)
    np.testing.assert_allclose(mine.std, theirs.std, rtol=1e-6)
    assert mine.std[2] == 1.0
    want = np.asarray(theirs.transform(x))
    np.testing.assert_allclose(mine.transform(x), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        mine.transform(torch.from_numpy(x)).numpy(), want, rtol=1e-5, atol=1e-6
    )
    again = Standardizer.from_dict(mine.to_dict())
    np.testing.assert_allclose(again.mean, mine.mean, rtol=1e-7)
    assert Standardizer.fit(torch.from_numpy(x)).std.dtype == np.float32
