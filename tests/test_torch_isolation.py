"""The port stands alone: ``amcpy_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX, flax or msgpack (the card's machine has none of them) or of
the ``amcpy_tpu`` package, and every entry point that
defaults to the CUDA card raises when there is none instead of carrying on
on the CPU.
"""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amcpy_tpu_torch
from amcpy_tpu_torch.config import Config

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "amcpy_tpu_torch"


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(amcpy_tpu_torch.__path__, "amcpy_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "amcpy_tpu_torch.ops.fused" in mods and "amcpy_tpu_torch.serve" in mods
    assert "amcpy_tpu_torch.ops.cnn_infer" in mods
    assert "amcpy_tpu_torch.train.evaluate" in mods
    for new in ("train.training", "ops.quantize", "models.layers", "cli", "__main__",
                "server", "ops.wire", "train.flax_msgpack", "data.synth", "graphics",
                "data.native_io", "data.legacy", "arm.analysis", "train.sweep", "parity"):
        assert f"amcpy_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'msgpack')\n"
        "             or m.startswith(('jax.', 'flax.', 'msgpack.'))\n"
        "             or m == 'amcpy_tpu' or m.startswith('amcpy_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_names_jax_or_the_jax_package():
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack)\b|amcpy_tpu\.", re.M)
    bad = [str(p.relative_to(ROOT)) for p in sources if pattern.search(p.read_text())]
    assert not bad, bad
    assert len(sources) > 15


#: scripts that hold the port against the JAX package and so import both:
#: they run where JAX does (the CPU), never on the card's machine
PARITY_TOOLS = ("torch_cnn_arms_cpu.py",)


def test_port_scripts_name_no_jax_or_the_jax_package():
    """The port's scripts run on the card's machine too: the record scripts
    (``scripts/torch_*.py``) and the kernel ablations import nothing of JAX,
    flax, msgpack or ``amcpy_tpu``, by name or once imported. The parity
    tools (``PARITY_TOOLS``) import both packages by design; no other
    script, module of the port or ``chip_smoke.py`` names them."""
    scripts = sorted(p for p in (ROOT / "scripts").glob("torch_*.py")
                     if p.name not in PARITY_TOOLS) + [
        ROOT / "scripts" / "k1_ablation.py", ROOT / "scripts" / "k3_ablation.py"]
    assert len(scripts) >= 6
    users = scripts + sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for tool in PARITY_TOOLS:
        assert "amcpy_tpu." in (ROOT / "scripts" / tool).read_text()
        stem = tool.removesuffix(".py")
        assert not [p.name for p in users if stem in p.read_text()], tool
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack)\b|amcpy_tpu\.", re.M)
    bad = [str(p.relative_to(ROOT)) for p in scripts if pattern.search(p.read_text())]
    assert not bad, bad
    names = [f"scripts.{p.stem}" for p in scripts]
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'msgpack')\n"
        "             or m.startswith(('jax.', 'flax.', 'msgpack.'))\n"
        "             or m == 'amcpy_tpu' or m.startswith('amcpy_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _frames():
    return np.ones((2, 256), np.complex64)


def _entry_points(tmp_path):
    from amcpy_tpu_torch.extraction import extract_batch, prepare_frames, run_extraction
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.ops.features import extract_features
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.server import AMCServer
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.train.evaluate import (
        confusion_counts,
        evaluate_by_snr,
        evaluate_by_snr_raw,
    )
    from amcpy_tpu_torch.cli import main
    from amcpy_tpu_torch.data import io_mat, synth
    from amcpy_tpu_torch.extraction import run_extraction_synthetic
    from amcpy_tpu_torch.parity import run_parity
    from amcpy_tpu_torch.train.sweep import run_sweep
    from amcpy_tpu_torch.train.training import accuracy, train
    from amcpy_tpu_torch.utils.device import resolve_device

    cfg = Config().replace(paths={"root": str(tmp_path)})
    scaler = Standardizer(np.zeros(6, np.float32), np.ones(6, np.float32))
    model = AMCClassifier(6)
    save_checkpoint(cfg, "m", model, scaler)
    cnn = IQConvNet(6)
    save_checkpoint(cfg, "cnn", cnn, Standardizer(np.zeros(1), np.ones(1)))
    mods = cfg.signals.modulations_with_noise
    raw = {m: np.ones((1, 1, 256), np.complex64) for m in mods}
    feats = {m: np.ones((1, 1, 18), np.float32) for m in mods}
    io_mat.save_dataset(cfg, raw)
    for m in mods:
        io_mat.save_features(cfg, m, np.ones((16, 2, 18), np.float32))
    tiny = ["--root", str(tmp_path)]
    return {
        "gen_planes": lambda: synth.gen_planes(None, None, (0,), 1, 8, True),
        "generate_modulation": lambda: synth.generate_modulation("BPSK", cfg, 0),
        "generate_dataset": lambda: synth.generate_dataset(cfg),
        "write_dataset": lambda: synth.write_dataset(cfg),
        "run_extraction_synthetic": lambda: run_extraction_synthetic(cfg),
        "run_sweep": lambda: run_sweep(cfg, np.ones((4, 6)), np.zeros(4), np.ones((2, 6)),
                                       np.zeros(2), n_trials=1),
        "run_parity": lambda: run_parity(cfg, ref_root=tmp_path),
        "cli generate": lambda: main(tiny + ["generate"]),
        "cli extract --from-synthetic": lambda: main(tiny + ["extract", "--from-synthetic",
                                                              "1"]),
        "cli extract --profile": lambda: main(tiny + ["extract", "--force", "--profile",
                                                      str(tmp_path / "prof")]),
        "cli full": lambda: main(tiny + ["full"]),
        "cli sweep": lambda: main(tiny + ["sweep", "--trials", "1"]),
        "cli parity": lambda: main(tiny + ["parity", "--ref", str(tmp_path)]),
        "resolve_device": lambda: resolve_device(),
        "extract_features": lambda: extract_features(_frames()),
        "prepare_frames": lambda: prepare_frames(_frames()),
        "extract_batch": lambda: extract_batch(_frames()),
        "run_extraction": lambda: run_extraction(cfg),
        "AMCPipeline": lambda: AMCPipeline(model, scaler, cfg),
        "AMCPipeline.from_checkpoint": lambda: AMCPipeline.from_checkpoint(cfg, "m"),
        "AMCPipeline(cnn)": lambda: AMCPipeline(cnn, scaler, cfg),
        "AMCPipeline.from_checkpoint(cnn)": lambda: AMCPipeline.from_checkpoint(
            cfg, "cnn"
        ),
        "evaluate_by_snr": lambda: evaluate_by_snr(model, scaler, feats, cfg),
        "evaluate_by_snr_raw": lambda: evaluate_by_snr_raw(cnn, raw, cfg),
        "confusion_counts": lambda: confusion_counts(
            cnn, np.ones((2, 2, 256), np.float32), np.zeros(2, int), 6
        ),
        "train": lambda: train(cfg, np.ones((4, 6)), np.zeros(4), np.ones((2, 6)),
                               np.zeros(2)),
        "accuracy": lambda: accuracy(model, np.ones((2, 6)), np.zeros(2)),
        "cli classify": lambda: main(["--root", str(tmp_path), "classify", "BPSK",
                                      "--model-id", "m"]),
        "AMCServer": lambda: AMCServer(cfg, "m", port=0),
        "cli serve": lambda: main(["--root", str(tmp_path), "serve", "--model-id", "m",
                                   "--port", "0"]),
    }


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, no_cuda):
    for name, call in _entry_points(tmp_path).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
            pytest.fail(f"{name} ran without a CUDA device")


def test_explicit_cpu_device_runs(tmp_path, no_cuda):
    from amcpy_tpu_torch.extraction import extract_batch

    assert extract_batch(_frames(), device="cpu").shape == (2, 18)


def test_new_commands_need_no_yaml_matplotlib_or_jax(tmp_path):
    """The card's machine has none of PyYAML, matplotlib, h5py or JAX: with
    each of them made unimportable, every module imports and ``generate``,
    ``extract --from-synthetic``, ``plot``, ``sweep`` (its best config
    written in YAML's JSON form and read back by ``--config``) and
    ``full`` run on the CPU."""
    code = f"""
import importlib, json, sys
for m in ("yaml", "matplotlib", "h5py", "jax", "flax", "msgpack", "amcpy_tpu"):
    sys.modules[m] = None
mods = {_modules()!r}
for m in mods:
    importlib.import_module(m)
from amcpy_tpu_torch.cli import main
root = {str(tmp_path)!r}
cfg = root + "/cfg.yaml"
open(cfg, "w").write(json.dumps({{"signals": {{"num_frames": 3, "frame_size": 64}},
                                 "training": {{"epochs": 1}}}}))
base = ["--root", root, "--config", cfg, "--device", "cpu"]
main(base + ["generate", "--seed", "1"])
main(base + ["extract", "--from-synthetic", "1"])
main(base + ["plot"])
spec = root + "/spec.yaml"
open(spec, "w").write(json.dumps({{"parameters": {{"epochs": {{"values": [1]}}}}}}))
main(base + ["sweep", "--trials", "1", "--method", "random", "--spec", spec])
main(["--root", root, "--config", root + "/metrics/sweep_best.yaml", "--device", "cpu",
      "full"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "matplotlib is absent" in out.stdout
    assert (tmp_path / "figures" / "features" / "feature_stats.mat").exists()
    assert json.loads((tmp_path / "metrics" / "sweep_best.yaml").read_text())["training"]
