"""The benchmark's isolation and its reference, on the CPU.

Nothing under ``port_bench/`` imports JAX, flax or the JAX package, and
the reference imports nothing of the program (top-level module names
compared whole: ``amcpy_tpu_torch`` starts with ``amcpy_tpu``). The
reference agrees with the program's plain path at a small size.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import common, signals
from port_bench.reference import features as ref_features
from port_bench.reference import models as ref_models

HOME = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "amcpy_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HOME.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HOME / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "amcpy_tpu_torch" not in _imports(path)


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom amcpy_tpu.ops import fused\n"
                   "import amcpy_tpu_torch\n")
    assert _imports(bad) == {"jax", "amcpy_tpu", "amcpy_tpu_torch"}
    assert _imports(bad) & FORBIDDEN == {"jax", "amcpy_tpu"}


MODS = ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM", "WGN"]


def test_reference_features_match_the_programs_plain_extractor():
    from amcpy_tpu_torch.ops.features import extract_features_planar

    x, _ = signals.make_pool(3, 48, 256, MODS, [-10, 0, 20])
    x[:4] *= np.float32(np.exp(5))
    want = extract_features_planar(torch.from_numpy(np.stack([x.real, x.imag], 1)),
                                   gmax_mode="matmul")
    got = ref_features.features_of_frames(x, "cpu")
    scale = ref_features.term_scales(torch.from_numpy(x))
    err = ((got.double() - want.double()).abs() / scale).max()
    assert float(err) < 1e-5
    # the control, in bfloat16, is far off
    ctrl = ref_features.features_of_frames(x, "cpu", torch.bfloat16)
    assert float(((ctrl.double() - want.double()).abs() / scale).max()) > 1e-3


def _cfg(family: str) -> dict:
    cfg = {"family": family,
           "signals": {"modulations": MODS, "snr_db": [0, 10], "frame_size": 128,
                       "num_frames": 4},
           "features": {"used": [2, 4, 6, 8, 12, 14]},
           "training": {"hidden_sizes": [26, 29, 30], "activation": "relu", "dropout": 0.4,
                        "optimizer": "rmsprop", "learning_rate": 0.001418378071933655,
                        "batch_size": 32, "training_snr": [0, 1], "test_size": 0.2},
           "compute": {"kernel": "auto", "wire_format": "f32"}}
    if family == "cnn":
        cfg["model"] = {"channels": [32, 64, 128], "kernel_sizes": [1, 1, 1],
                        "strides": [1, 1, 1], "dense": 128, "dropout": 0.5,
                        "dtype": "bfloat16"}
    return cfg


def test_reference_mlp_matches_the_programs_module():
    cfg = _cfg("mlp")
    p = ref_models.mlp_params(cfg, 11, "cpu")
    model = common.port_model(cfg, p).eval()
    x = torch.randn(64, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
    assert torch.allclose(ref_models.mlp_logits(p, x), want, rtol=1e-6, atol=1e-6)


def test_reference_cnn_matches_the_programs_served_route():
    """The served route's plain version (folded trunk and head), which K3
    and the head run on the card."""
    from amcpy_tpu_torch.ops.cnn_infer import cnn_logits_fused

    cfg = _cfg("cnn")
    p = ref_models.cnn_params(cfg, 12, "cpu")
    model = common.port_model(cfg, p).eval()
    x, _ = signals.make_pool(4, 32, 128, MODS, [0, 10])
    i, q = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    with torch.no_grad():
        want = cnn_logits_fused(model, i, q)
        module = model(torch.stack([i, q], 1))
    got = ref_models.cnn_logits(p, i, q)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    # the module forward rounds elsewhere (the normalized frame, each
    # product): near, not equal
    assert (got - module).abs().max() < 0.05 * (1 + module.abs().max())
    ctrl = ref_models.cnn_logits(p, i, q, ref_models.fp8)
    assert (ctrl - want).abs().max() > 1e-2


def test_reference_training_steps_match_the_programs_run_epoch():
    from amcpy_tpu_torch.train.training import make_optimizer, run_epoch

    cfg = _cfg("mlp")
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(96, 6, generator=g), torch.randint(0, 6, (96,), generator=g)
    p0 = ref_models.mlp_params(cfg, 13, "cpu", trained=False)
    model = common.port_model(cfg, p0)
    opt = make_optimizer(common.port_config(cfg, "/nonexistent"), model.parameters())
    gen = torch.Generator().manual_seed(99)
    rows = [torch.arange(k * 32, (k + 1) * 32) for k in range(3)]
    losses = [float(run_epoch(model, opt, x, y, x[:8], y[:8], r, 32, gen)["loss"])
              for r in rows]
    ref_losses, ref_first, ref_after = ref_models.mlp_train_steps(
        p0, [(x[r], y[r]) for r in rows], dropout=0.4, lr=cfg["training"]["learning_rate"],
        dropout_seed=99)
    assert np.allclose(losses, ref_losses, rtol=1e-6)
    # a bias that feeds a BatchNorm has a gradient of rounding alone, which
    # RMSprop scales to +-10 lr: the harness's rule leaves it out
    med = float(np.median([float(g.norm()) for g in ref_first.values()]))
    rounding = {n for n, g in ref_first.items() if float(g.norm()) < 1e-3 * med}
    assert rounding == {f"dense.{k}.bias" for k in range(3)}
    for n, v in model.named_parameters():
        if n not in rounding:
            assert torch.allclose(v.detach(), ref_after[n], atol=1e-6), n
