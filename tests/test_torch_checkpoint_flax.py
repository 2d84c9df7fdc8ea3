"""The JAX package's checkpoints (``model-{id}.msgpack``, written by flax)
in the port: the plain-Python msgpack reader
(``amcpy_tpu_torch/train/flax_msgpack.py``) and ``load_checkpoint``,
``resolve_model_id`` and the CLI on such files, on the CPU.

Every load runs with ``sys.modules["msgpack"] = None``, as on the card's
machine, which has no msgpack. Tolerances, each with its reason:

* eval logits of a loaded model against the JAX model's on the same
  checkpoint: atol and rtol 2e-4, the serving tolerance of
  ``tests/test_torch_serve.py`` (float32 sums in another order; the CNN's
  bf16 casts sit where flax's do);
* the weights and the optimizer's moments are the file's float32 values,
  exactly;
* a run resumed from a msgpack's optax state against JAX's own longer run:
  the bars of ``tests/test_torch_training.py::test_resume_from_jax_matches_jax``;
* evaluation, quantization and serving against the JAX package's on the
  same checkpoint: equal accuracy matrices, equal int16 tables, logits
  within the serving tolerance (the CNN's pipeline within the bf16 bar of
  ``tests/test_torch_cnn.py``, see its test).
"""

import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import scipy.io
import torch
from flax import serialization

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.ops import quantize as jq
from amcpy_tpu.preprocessing import Standardizer as JaxStandardizer
from amcpy_tpu.serve import AMCPipeline as JaxPipeline
from amcpy_tpu.train import evaluate as jev
from amcpy_tpu.train import training as jtr
from amcpy_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from amcpy_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from amcpy_tpu_torch.cli import main
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.ops import quantize as q
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.train.checkpoint import (
    load_checkpoint,
    opt_state_from_optax,
    resolve_model_id,
)
from amcpy_tpu_torch.train.evaluate import evaluate_by_snr
from amcpy_tpu_torch.train.flax_msgpack import msgpack_restore, unpackb
from amcpy_tpu_torch.train.training import make_optimizer

from .test_torch_cnn import _assert_bf16_agree
from .test_torch_training import (
    _assert_runs_agree,
    _features_dataset,
    _jax_orders,
    _one_device_mesh,
    _port_epochs,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "flax_ckpt"
IDS = {"mlp": "jax-mlp", "cnn": "jax-cnn"}
ATOL = RTOL = 2e-4
#: the fixtures' dataset: 8 frames a block at N = 2048
SIGNALS = {"num_frames": 8}


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_flax_fixtures", ROOT / "scripts" / "make_flax_fixtures.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_msgpack(monkeypatch):
    """The card's machine: ``import msgpack`` fails."""
    monkeypatch.setitem(sys.modules, "msgpack", None)


@pytest.fixture
def project(tmp_path):
    """(port config, JAX config) of one root whose ``ann/`` holds the
    committed fixtures."""
    (tmp_path / "ann").mkdir()
    for p in FIXTURES.iterdir():
        shutil.copy(p, tmp_path / "ann" / p.name)
    return (Config().replace(paths={"root": str(tmp_path)}, signals=SIGNALS),
            JaxConfig().replace(paths={"root": str(tmp_path)}, signals=SIGNALS))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_fixtures_match_a_regeneration(tmp_path):
    """``scripts/make_flax_fixtures.py`` writes the committed files again:
    the same sidecars and the same arrays, so the fixtures cannot go stale
    unseen."""
    paths = _fixture_script().make_fixtures(tmp_path)
    assert sorted(p.name for p in paths) == sorted(p.name for p in FIXTURES.iterdir())
    for p in paths:
        committed = FIXTURES / p.name
        if p.suffix == ".json":
            assert json.loads(p.read_text()) == json.loads(committed.read_text())
            continue
        got, want = (_leaves(msgpack_restore(f.read_bytes())) for f in (p, committed))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20


def _jax_logits(jmodel, jstate, x):
    return np.asarray(jmodel.apply({"params": jstate.params,
                                    "batch_stats": jstate.batch_stats},
                                   jnp.asarray(x), train=False))


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_jax_checkpoint_loads_without_msgpack(project, family, monkeypatch):
    """Weights, batch statistics, optimizer moments and step are the file's;
    eval logits are the JAX model's."""
    cfg, jcfg = project
    jmodel, jstate, _, jmeta = jax_load_checkpoint(jcfg, IDS[family])
    monkeypatch.setitem(sys.modules, "msgpack", None)
    model, state, scaler, meta = load_checkpoint(cfg, IDS[family])
    assert meta == jmeta and model.training is False
    assert state.step == int(jstate.step) > 0
    opt = jmeta["config"]["training"]["optimizer"]
    assert opt == {"mlp": "rmsprop", "cnn": "adam"}[family]
    want = opt_state_from_optax(opt, jax.tree.map(np.asarray, jstate.opt_state), model,
                                int(jstate.step))
    assert state.opt_state["state"].keys() == want["state"].keys()
    for i, s in want["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(state.opt_state["state"][i][k], v, rtol=0, atol=0)
    rng = np.random.default_rng(0)
    if family == "mlp":
        x = scaler.transform(rng.standard_normal((64, 6)) * 3 + 1).astype(np.float32)
    else:
        x = (rng.standard_normal((16, 2, 2048)) * 2).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jmodel, jstate, x), atol=ATOL, rtol=RTOL)


def test_msgpack_checkpoint_evaluates_and_quantizes_as_jax(project, no_msgpack):
    """The MLP fixture's per-SNR accuracy and its int16 tables, in the port
    and in the JAX package."""
    cfg, jcfg = project
    rng = np.random.default_rng(1)
    feats = {m: (rng.standard_normal((16, 8, 18)) * (1 + k)).astype(np.float32)
             for k, m in enumerate(cfg.signals.modulations_with_noise)}
    model, _, scaler, _ = load_checkpoint(cfg, IDS["mlp"])
    sys.modules.pop("msgpack")  # JAX's loader needs it
    jmodel, jstate, jscaler, _ = jax_load_checkpoint(jcfg, IDS["mlp"])
    np.testing.assert_array_equal(
        evaluate_by_snr(model, scaler, feats, cfg, device="cpu"),
        np.asarray(jev.evaluate_by_snr(jmodel, jstate, jscaler, feats, jcfg)),
    )
    sample = scaler.transform(rng.standard_normal((256, 6)) * 3).astype(np.float32)
    save, info = q.quantize_model(model.state_dict(), sample, cfg, save=False)
    jsave, jinfo = jq.quantize_model(jax.tree.map(np.asarray, jstate.params),
                                     jax.tree.map(np.asarray, jstate.batch_stats),
                                     sample, jcfg, save=False)
    assert info == jinfo
    for key in ("weights", "biases"):
        np.testing.assert_array_equal(save[key], jsave[key])


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_msgpack_checkpoint_serves_as_jax(project, family, monkeypatch):
    """``AMCPipeline.from_checkpoint`` of a msgpack id against the JAX
    package's pipeline on the same file (both on the CPU: the plain
    extractor, the CNN's module forward). The JAX pipeline pads the batch
    to a bucket of 64 frames, and XLA's bf16 convolutions round otherwise
    at another batch size (up to 7e-3 here), so the CNN is held to the bf16
    bar of ``tests/test_torch_cnn.py``: atol 0.08 and the same argmax where
    the top two are more than 0.16 apart."""
    cfg, jcfg = project
    jpipe = JaxPipeline.from_checkpoint(jcfg, IDS[family])
    jpipe.multi_device = False
    rng = np.random.default_rng(2)
    frames = (rng.standard_normal((12, 2048)) + 1j * rng.standard_normal((12, 2048)))
    frames = (frames * np.exp(rng.uniform(-1, 1, (12, 1)))).astype(np.complex64)
    want = np.asarray(jpipe.logits(frames))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got = AMCPipeline.from_checkpoint(cfg, IDS[family], device="cpu").logits(frames)
    if family == "mlp":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        _assert_bf16_agree(got.numpy(), want)


def test_resume_from_msgpack_matches_jax(tmp_path, no_msgpack):
    """JAX's two epochs saved by its ``save_checkpoint``, loaded by the port
    without msgpack, and the port's third epoch, against JAX's three."""
    sys.modules.pop("msgpack")  # JAX's writer needs it
    data = _features_dataset(seed=1)
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path)},
                               training={"epochs": 2, "dropout": 0.0})
    jmodel, jstate2, jhistory2, _ = jtr.train(jcfg, *data, mesh=_one_device_mesh(), seed=5)
    _, jstate3, jhistory3, _ = jtr.train(jcfg.replace(training={"epochs": 3}), *data,
                                         mesh=_one_device_mesh(), seed=5)
    identity = JaxStandardizer(np.zeros(6, np.float32), np.ones(6, np.float32))
    jax_save_checkpoint(jcfg, "r2", jstate2, identity, jhistory2, 2)
    sys.modules["msgpack"] = None
    model, state, _, meta = load_checkpoint(Config().replace(paths={"root": str(tmp_path)}),
                                            "r2")
    assert meta["epoch"] == 2 and state.step == int(jstate2.step)
    model.train()
    opt = make_optimizer(Config(), model.parameters(), state.opt_state)
    history = _port_epochs(model, opt, data, [o[0] for o in _jax_orders(5, 1000, 896, 3)[2:]])
    _assert_runs_agree(model, jmodel, jstate3, history,
                       {k: v[2:] for k, v in jhistory3.items()}, data[2])


def _tiny_mat(cfg):
    """Numpy-made complex64 frames, 8 a block, under each modulation's
    variable name."""
    rng = np.random.default_rng(3)
    s = cfg.signals
    shape = (s.num_snr, s.num_frames, s.frame_size)
    data = {m: ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                * (1 + k)).astype(np.complex64)
            for k, m in enumerate(s.modulations_with_noise)}
    cfg.paths.ensure_dirs()
    scipy.io.savemat(str(cfg.paths.mat_data / cfg.paths.mat_filename),
                     {s.mat_info[m]: a for m, a in data.items()})


def test_cli_takes_msgpack_ids(project, no_msgpack, capsys):
    """``eval`` (no id: the newest checkpoint), ``quantize``, ``classify``
    and ``train --resume`` on the JAX package's checkpoints."""
    cfg, _ = project
    root = str(cfg.paths.root)
    ann = cfg.paths.trained_ann
    os.utime(ann / "model-jax-mlp.msgpack", (2e9, 2e9))  # the newest
    config = Path(root) / "small.json"
    config.write_text(json.dumps({"signals": SIGNALS}))
    _tiny_mat(cfg)

    def run(*argv):
        main(["--root", root, "--config", str(config), "--device", "cpu", *argv])
        return capsys.readouterr().out

    run("extract")
    assert "using newest: jax-mlp" in run("eval")
    run("quantize", "jax-mlp", "--emit-c")
    assert (cfg.paths.arm_data / "w_and_b.mat").exists()
    assert (cfg.paths.arm_data / "amc_weights.h").exists()
    assert "SNR" in run("classify", "BPSK", "--model-id", "jax-cnn")
    out = run("train", "--resume", "jax-mlp", "--epochs", "4")
    assert "Resuming from jax-mlp at epoch 3" in out
    assert len(list(ann.glob("model-*.pt"))) == 1 and not list(ann.glob("model-*.pt.*"))


# ---- the decoder ------------------------------------------------------------

VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, float("inf"), 1e300,
    "", "ä" * 15, "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65536,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    [], list(range(15)), list(range(16)), list(range(65536)),
    {}, {str(k): k for k in range(15)}, {str(k): k for k in range(16)},
    {str(k): [k, {"x": None}] for k in range(65536)},
]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
def test_decoder_reads_each_msgpack_type(value):
    blob = msgpack.packb(value, use_bin_type=True)
    assert unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_decoder_reads_float32_and_every_extension_size():
    assert unpackb(msgpack.packb(0.1, use_single_float=True)) == np.float32(0.1)
    for n in (1, 2, 4, 8, 16, 3, 17, 256, 65536):
        blob = msgpack.packb(msgpack.ExtType(5, b"\x07" * n))
        assert unpackb(blob, lambda code, data: (code, data)) == (5, b"\x07" * n)


def test_decoder_reads_what_flax_writes():
    """Every array dtype flax writes (bfloat16 as a torch.bfloat16 tensor),
    Python complex and NumPy scalars."""
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5,
        "f64": np.linspace(-1, 1, 5), "i8": np.arange(-4, 4, dtype=np.int8),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3, 1),
        "u16": np.arange(7, dtype=np.uint16), "b": np.array([True, False]),
        "c64": (np.arange(3) + 1j).astype(np.complex64), "empty": np.zeros((0, 4)),
        "scalar0d": np.asarray(7, np.int32), "f32s": np.float32(2.5), "i64s": np.int64(-3),
        "bf16": jnp.asarray([1.5, -2.0, 3.140625], jnp.bfloat16),
        "complex": 1.5 - 2j, "nested": {"0": {}, "1": {"nu": np.ones(2, np.float32)}},
    }
    blob = serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(blob), serialization.msgpack_restore(blob)
    assert got.keys() == want.keys()
    bf = got.pop("bf16")
    assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), np.asarray(want.pop("bf16"), np.float32))
    for k, v in want.items():
        if isinstance(v, dict):
            assert _leaves(got[k]).keys() == _leaves(v).keys()
            continue
        assert type(got[k]) is type(v), k
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_decoder_refuses_chunked_arrays_and_malformed_data(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize({"w": np.zeros(100, np.float32)})
    with pytest.raises(ValueError, match="chunk"):
        msgpack_restore(blob)
    good = msgpack.packb({"a": [1, 2]})
    with pytest.raises(ValueError, match="ends inside"):
        unpackb(good[:-1])
    with pytest.raises(ValueError, match="after the msgpack value"):
        unpackb(good + b"\x00")
    with pytest.raises(ValueError, match="0xc1"):
        unpackb(b"\xc1")
    with pytest.raises(ValueError, match="extension type 9"):
        msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"")))
    with pytest.raises(ValueError, match="extension type"):
        unpackb(msgpack.packb(msgpack.ExtType(1, b"")))


def test_resolve_model_id_takes_the_newest_across_pt_and_msgpack(tmp_path, capsys):
    cfg = Config().replace(paths={"root": str(tmp_path)})
    ann = cfg.paths.trained_ann
    ann.mkdir(parents=True)
    for name, t in (("model-a.pt", 100), ("model-b.msgpack", 300), ("model-c.pt", 200)):
        (ann / name).write_bytes(b"")
        os.utime(ann / name, (t, t))
    assert resolve_model_id(cfg) == "b"
    os.utime(ann / "model-c.pt", (400, 400))
    assert resolve_model_id(cfg) == "c"
    assert resolve_model_id(cfg, "a") == "a"
    (ann / "model-b.msgpack").unlink()
    (ann / "model-a.pt").unlink()
    (ann / "model-c.pt").unlink()
    with pytest.raises(FileNotFoundError):
        resolve_model_id(cfg)
