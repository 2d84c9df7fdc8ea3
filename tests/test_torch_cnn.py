"""The port's raw-IQ CNN (``amcpy_tpu_torch/models/cnn.py``,
``ops/cnn_infer.py``, the CNN branch of ``serve.py`` and of
``train/checkpoint.py``) against the JAX package's flax ``IQConvNet`` on the
CPU. Inputs are numpy-made from a seed; the flax weights are numpy-made in
the flax pytree layout and carried across with ``cnn_params_from_flax``.

Tolerances, each with its reason:

* default bf16 stack, module forward against ``model.apply``, and the fused
  route against ``model.apply``: logits atol 0.08 (the JAX package's own
  kernel-versus-apply tolerance, ``tests/test_cnn.py:223``) and identical
  argmax wherever flax's top-two margin exceeds 0.16. The module forward
  rounds to bf16 where flax does (measured worst case 7e-7 on these
  inputs); the fused route rounds elsewhere (layer 0 stays float32), as
  the JAX kernel does (measured 0.021);
* float32 stacks: atol 1e-4 (only float32 summation order differs;
  measured 7e-7);
* the fused route (plain trunk + head) against the JAX Pallas trunk in
  interpret mode: atol 1e-4 and identical argmax (the same cast points;
  measured 1.2e-6 over five seeds);
* the folded BatchNorm: 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.cnn import IQConvNet as JaxIQConvNet
from amcpy_tpu.ops.cnn_infer import cnn_logits_fused as jax_cnn_logits_fused
from amcpy_tpu.ops.cnn_infer import fold_bn_params as jax_fold
from amcpy_tpu.ops.cnn_infer import supports_fused as jax_supports_fused
from amcpy_tpu.preprocessing import Standardizer as JaxStandardizer
from amcpy_tpu.serve import AMCPipeline as JaxPipeline
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.cnn import IQConvNet, same_padding
from amcpy_tpu_torch.ops.cnn_infer import (
    cnn_logits_fused,
    cnn_trunk,
    cnn_trunk_plain,
    fold_bn_params,
    supports_fused,
    trunk_path,
)
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.train.checkpoint import (
    cnn_params_from_flax,
    load_checkpoint,
    save_checkpoint,
)

SMALL = dict(channels=(16, 32), kernel_sizes=(5, 3), strides=(2, 2), dense=32)
K1_F32 = dict(channels=(8, 16), kernel_sizes=(1, 1), strides=(1, 1), dense=16)


def _frames(b, n, seed, scale=4.0):
    """Planar float32 ``(b, 2, n)`` Gaussian frames times a per-frame scale
    of ``scale * exp(U(-1, 1))``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)) * np.exp(rng.uniform(-1, 1, (b, 1, 1)))
    return (x * scale).astype(np.float32)


def _flax_weights(jmodel, n, seed):
    """Seeded numpy values in the flax pytree layout: kernels scaled by
    1/sqrt(fan-in), BatchNorm scale near 1, positive running variances."""
    shapes = jax.tree.map(
        lambda a: a.shape,
        jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 2, n)),
                                           train=False)),
    )
    rng = np.random.default_rng(seed)

    def leaf(key, s):
        if key == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s[:-1])), s)
        if key == "scale":
            return rng.uniform(0.5, 1.5, s)
        return rng.normal(0.0, 0.1, s)

    params = {
        layer: {k: leaf(k, s).astype(np.float32) for k, s in leaves.items()}
        for layer, leaves in shapes["params"].items()
    }
    stats = {
        layer: {
            "mean": rng.normal(0.0, 0.1, leaves["mean"]).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, leaves["var"]).astype(np.float32),
        }
        for layer, leaves in shapes["batch_stats"].items()
    }
    return params, stats


def _models(n, seed=0, **arch):
    """(flax model, its variables, the port's model) on the same weights."""
    jmodel = JaxIQConvNet(n_classes=6, **arch)
    params, stats = _flax_weights(jmodel, n, seed)
    model = IQConvNet(6, **arch)
    model.load_state_dict(cnn_params_from_flax(params, stats))
    return jmodel, {"params": params, "batch_stats": stats}, model.eval()


def _apply(jmodel, variables, x):
    return np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _assert_bf16_agree(got, want):
    """atol 0.08; argmax identical where the reference's top-two margin
    exceeds 0.16 (a bf16 rounding flip cannot move a logit that far)."""
    np.testing.assert_allclose(got, want, atol=0.08, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.16
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_default_bf16_forward_matches_flax():
    jmodel, variables, model = _models(256, seed=1)
    x = _frames(32, 256, seed=2)
    want, got = _apply(jmodel, variables, x), _logits(model, x)
    assert got.shape == want.shape == (32, 6) and got.dtype == np.float32
    _assert_bf16_agree(got, want)


@pytest.mark.parametrize("n", [128, 101])
def test_strided_f32_forward_matches_flax(n):
    """k=(5, 3), s=(2, 2) as ``tests/test_cnn.py::_small_cnn``: pins flax's
    SAME padding, odd lengths included (101 -> 51 -> 26 samples)."""
    jmodel, variables, model = _models(n, seed=3, dtype="float32", **SMALL)
    x = _frames(6, n, seed=4)
    np.testing.assert_allclose(
        _logits(model, x), _apply(jmodel, variables, x), atol=1e-4, rtol=0
    )


def test_k1_f32_forward_matches_flax():
    jmodel, variables, model = _models(64, seed=5, dtype="float32", **K1_F32)
    x = _frames(9, 64, seed=6)
    np.testing.assert_allclose(
        _logits(model, x), _apply(jmodel, variables, x), atol=1e-4, rtol=0
    )


def test_same_padding_matches_lax():
    for n, k, s in [(128, 5, 2), (64, 3, 2), (101, 5, 2), (7, 8, 3), (10, 1, 1)]:
        want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
        assert same_padding(n, k, s) == tuple(want)


def test_fused_route_matches_jax_kernel_interpret():
    """13 ragged frames of 256 samples, as ``tests/test_cnn.py:195-223``:
    the JAX Pallas trunk (interpret mode, padded to its tile of 8) against
    the port's wrapper on a CPU tensor (its plain version) plus the head."""
    jmodel, variables, model = _models(256, seed=7)
    x = _frames(13, 256, seed=5)
    want = np.asarray(
        jax_cnn_logits_fused(jmodel, variables, jnp.asarray(x), interpret=True)
    )
    launches = cnn_trunk.launches
    got = cnn_logits_fused(
        model, torch.from_numpy(x[:, 0].copy()), torch.from_numpy(x[:, 1].copy())
    ).numpy()
    assert cnn_trunk.launches == launches  # a CPU tensor launches nothing
    assert got.shape == want.shape == (13, 6)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # and the fused route against the module forward, as the JAX test does
    _assert_bf16_agree(got, _apply(jmodel, variables, x))


def test_fold_bn_params_matches_jax():
    jmodel, variables, model = _models(64, seed=8)
    want, got = jax_fold(jmodel, variables), fold_bn_params(model)
    assert len(got["convs"]) == len(want["convs"]) == 3
    for (w, b), (jw, jb) in zip(got["convs"], want["convs"]):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-6, rtol=1e-6)
    for (w, b), (jw, jb) in zip(got["dense"], want["dense"]):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize(
    "arch",
    [{}, {"kernel_sizes": (8, 1, 1)}, {"strides": (1, 2, 1)},
     {"dtype": "float32"}, {**K1_F32, "dtype": "bfloat16"}],
)
def test_supports_fused_agrees_with_jax(arch):
    assert supports_fused(IQConvNet(6, **arch)) == jax_supports_fused(
        JaxIQConvNet(n_classes=6, **arch)
    )


def test_plain_trunk_pools_mean_then_max():
    """One layer (L = 1): the pooled features are the float32 mean and max
    over time of ReLU(w0 . (I, Q) / rms + b0), computed here in float64."""
    rng = np.random.default_rng(9)
    x = _frames(3, 50, seed=10)
    w0 = rng.normal(size=(4, 2)).astype(np.float32)
    b0 = rng.normal(size=(4, 1)).astype(np.float32)
    got = cnn_trunk_plain(
        torch.from_numpy(x[:, 0].copy()), torch.from_numpy(x[:, 1].copy()),
        [(torch.from_numpy(w0), torch.from_numpy(b0))],
    ).numpy()
    xd = x.astype(np.float64)
    xn = xd / np.sqrt((xd**2).sum(axis=(1, 2), keepdims=True) / 100 + 1e-12)
    h = np.maximum(np.einsum("co,bot->bct", w0, xn) + b0, 0)
    np.testing.assert_allclose(got, np.concatenate([h.mean(-1), h.max(-1)], -1),
                               rtol=1e-5, atol=1e-6)


def test_trunk_path_of_the_default_stack_is_wgmma():
    """The default IQConvNet's folded widths take the wgmma kernel."""
    model = IQConvNet(6)
    widths = [2] + [int(w.shape[0]) for w, _ in fold_bn_params(model)["convs"]]
    assert widths == [2, 32, 64, 128]
    assert trunk_path(widths) == trunk_path((2, 32, 64, 128)) == "wgmma"


@pytest.mark.parametrize(
    "widths", [(2, 32), (2, 20), (2, 32, 64), (2, 16, 48, 32, 16), (2, 32, 64, 128, 16),
               (2, 32, 64, 112), (2, 16, 1024), (2,) + (16,) * 8]
)
def test_trunk_path_of_other_stacks_is_mma_sync(widths):
    assert trunk_path(widths) == "mma_sync"


@pytest.mark.parametrize(
    "shapes,match",
    [([(32, 3), (64, 32), (128, 64)], "do not follow"),  # C_in other than 2
     ([(32, 2), (64, 16)], "do not follow"),  # a layer that skips a width
     ([], "at least one layer")],
)
def test_cnn_trunk_refuses_malformed_stacks_before_any_launch(monkeypatch, shapes, match):
    """A stack whose layers do not chain from C_in = 2 raises ``ValueError``
    on any device before the library is loaded; the widths only the library
    refuses (not multiples of 16, more than eight layers, more than 227 KB
    of shared memory) are the card tests'."""
    from amcpy_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("a malformed stack must not reach the library")

    monkeypatch.setattr(_build, "load", no_build)
    x = _frames(2, 40, seed=3)
    i, q = torch.from_numpy(x[:, 0].copy()), torch.from_numpy(x[:, 1].copy())
    convs = [(torch.ones((o, a)), torch.zeros((o, 1))) for o, a in shapes]
    launches = cnn_trunk.launches
    with pytest.raises(ValueError, match=match):
        cnn_trunk(i, q, convs)
    assert cnn_trunk.launches == launches


def test_trunk_path_is_plain_and_cpu_route_is_unchanged(monkeypatch):
    """``trunk_path`` builds nothing, and a CPU tensor still takes the
    plain version for any widths, counting no launch."""
    from amcpy_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("trunk_path must not build the library")

    monkeypatch.setattr(_build, "load", no_build)
    assert trunk_path((2, 32, 64, 128)) == "wgmma"
    x = _frames(2, 40, seed=3)
    i, q = torch.from_numpy(x[:, 0].copy()), torch.from_numpy(x[:, 1].copy())
    rng = np.random.default_rng(4)
    convs = [(torch.from_numpy(rng.normal(size=(o, a)).astype(np.float32)),
              torch.zeros((o, 1))) for a, o in ((2, 24), (24, 40))]
    launches, by_path = cnn_trunk.launches, dict(cnn_trunk.launches_by_path)
    assert cnn_trunk(i, q, convs).shape == (2, 80)
    assert cnn_trunk.launches == launches and cnn_trunk.launches_by_path == by_path


def _cfg(root, **compute):
    return Config().replace(
        paths={"root": str(root)}, signals={"frame_size": 256},
        compute=compute or {"kernel": "auto"},
    )


@pytest.mark.parametrize("kernel", ["xla", "fused"])
def test_pipeline_matches_jax_pipeline(tmp_path, kernel):
    """One CNN checkpoint's weights in both pipelines on the CPU. The JAX
    pipeline runs ``model.apply`` there; the port runs the module forward
    (``kernel="xla"``) or the plain trunk and head (``kernel="fused"``)."""
    jmodel, variables, model = _models(256, seed=11)
    jcfg = JaxConfig().replace(
        paths={"root": str(tmp_path / "jax")}, signals={"frame_size": 256},
        compute={"kernel": kernel},
    )
    identity = JaxStandardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    jpipe = JaxPipeline(
        jmodel, variables["params"], variables["batch_stats"], identity, jcfg
    )
    jpipe.multi_device = False
    pipe = AMCPipeline(
        model, Standardizer.from_dict(identity.to_dict()),
        _cfg(tmp_path, kernel=kernel), device="cpu",
    )
    assert pipe.route == {"xla": "module", "fused": "k3"}[kernel]
    rng = np.random.default_rng(12)
    frames = (rng.standard_normal((20, 256)) + 1j * rng.standard_normal((20, 256)))
    frames = frames.astype(np.complex64)
    want = np.asarray(jpipe.logits(frames))
    got = pipe.logits(frames).numpy()
    _assert_bf16_agree(got, want)
    np.testing.assert_array_equal(pipe.predict(frames), got.argmax(-1))
    planar = np.stack([frames.real, frames.imag], axis=1)
    np.testing.assert_array_equal(pipe.logits(planar).numpy(), got)
    np.testing.assert_allclose(pipe.predict_proba(frames).sum(-1), 1.0, rtol=1e-6)
    mods = Config().signals.modulations_with_noise
    assert pipe.predict_names(frames) == [mods[k] for k in got.argmax(-1)]


@pytest.mark.parametrize(
    "arch,kernel,fused",
    [({}, "auto", False), ({}, "pallas", False), ({}, "fused", True),
     ({"kernel_sizes": (3, 1, 1)}, "fused", False),
     ({"dtype": "float32"}, "fused", False)],
)
def test_pipeline_routes(tmp_path, arch, kernel, fused):
    """The trunk route only for a k=1/stride-1 bf16 stack under "fused"
    ("auto" is "fused" on CUDA, "xla" on the CPU); else the module
    forward."""
    pipe = AMCPipeline(IQConvNet(6, **arch), Standardizer(np.zeros(1), np.ones(1)),
                       _cfg(tmp_path, kernel=kernel), device="cpu")
    assert pipe.model.family == "cnn" and pipe.route == ("k3" if fused else "module")
    assert pipe._wants_planes == fused
    assert pipe.logits(_frames(3, 256, seed=13)).shape == (3, 6)


def test_checkpoint_round_trip(tmp_path):
    """``save_checkpoint`` writes the JAX CLI's ``model`` sidecar entry for a
    CNN; ``load_checkpoint`` rebuilds it and serves identical logits."""
    jmodel, _, model = _models(256, seed=14, dropout=0.25)
    cfg = _cfg(tmp_path)
    scaler = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    save_checkpoint(cfg, "cnn", model, scaler, {"loss": [1.0]}, epoch=1)
    meta = json.loads((cfg.paths.trained_ann / "model-cnn.json").read_text())
    assert meta["config"]["model"] == {
        "family": "cnn",
        "input_shape": [2, 256],
        "arch": {
            "channels": list(jmodel.channels),
            "kernel_sizes": list(jmodel.kernel_sizes),
            "strides": list(jmodel.strides),
            "dense": jmodel.dense,
            "dropout": 0.25,
            "dtype": jmodel.dtype,
        },
    }
    loaded, _, _, _ = load_checkpoint(cfg, "cnn")
    assert isinstance(loaded, IQConvNet) and loaded.dropout == 0.25
    x = _frames(7, 256, seed=15)
    np.testing.assert_array_equal(_logits(loaded, x), _logits(model, x))
    served = AMCPipeline.from_checkpoint(cfg, "cnn", device="cpu")
    np.testing.assert_array_equal(served.logits(x).numpy(), _logits(model, x))


def test_checkpoint_keeps_augmentation_fields(tmp_path):
    """A sidecar whose ``arch`` carries the ``aug_*`` fields loads, and the
    fields are kept (they act only in training, which now runs them)."""
    cfg = _cfg(tmp_path)
    model = IQConvNet(6, **K1_F32, dtype="float32")
    meta = {"family": "cnn", "input_shape": [2, 256],
            "arch": {**model.arch(), "aug_phase": True,
                     "aug_noise_snr_db": [-12.0, 25.0], "aug_noise_prob": 0.5}}
    save_checkpoint(cfg, "aug", model, Standardizer(np.zeros(1), np.ones(1)),
                    model_meta=meta)
    loaded, _, _, _ = load_checkpoint(cfg, "aug")
    assert loaded.aug_phase and loaded.aug_noise_snr_db == (-12.0, 25.0)
    assert loaded.aug_noise_prob == 0.5
    x = torch.from_numpy(_frames(2, 256, seed=16))
    assert loaded.eval()(x).shape == (2, 6)  # eval ignores augmentation
    # training augments, drawing from the generator it is given
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(loaded.train()(x, generator=g)).all()


def test_scale_invariance():
    """Per-frame RMS normalization: the logits do not see the frame's scale
    (as ``tests/test_cnn.py:61-65``)."""
    _, _, model = _models(128, seed=17, dtype="float32", **SMALL)
    x = _frames(4, 128, seed=18)
    np.testing.assert_allclose(
        _logits(model, x), _logits(model, x * np.float32(37.5)),
        rtol=1e-4, atol=1e-5,
    )
