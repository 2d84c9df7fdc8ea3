"""The port stands alone: ``amcpy_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the ``amcpy_tpu`` package, and every entry point that
defaults to the CUDA card raises when there is none instead of carrying on
on the CPU.
"""

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
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax')\n"
        "             or m.startswith(('jax.', 'flax.'))\n"
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
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b|amcpy_tpu\.", re.M)
    bad = [str(p.relative_to(ROOT)) for p in sources if pattern.search(p.read_text())]
    assert not bad, bad
    assert len(sources) > 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _frames():
    return np.ones((2, 256), np.complex64)


def _entry_points(tmp_path):
    from amcpy_tpu_torch.extraction import extract_batch, prepare_frames, run_extraction
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.ops.features import extract_features
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.utils.device import resolve_device

    cfg = Config().replace(paths={"root": str(tmp_path)})
    scaler = Standardizer(np.zeros(6, np.float32), np.ones(6, np.float32))
    model = AMCClassifier(6)
    save_checkpoint(cfg, "m", model, scaler)
    return {
        "resolve_device": lambda: resolve_device(),
        "extract_features": lambda: extract_features(_frames()),
        "prepare_frames": lambda: prepare_frames(_frames()),
        "extract_batch": lambda: extract_batch(_frames()),
        "run_extraction": lambda: run_extraction(cfg),
        "AMCPipeline": lambda: AMCPipeline(model, scaler, cfg),
        "AMCPipeline.from_checkpoint": lambda: AMCPipeline.from_checkpoint(cfg, "m"),
    }


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, no_cuda):
    for name, call in _entry_points(tmp_path).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
            pytest.fail(f"{name} ran without a CUDA device")


def test_explicit_cpu_device_runs(tmp_path, no_cuda):
    from amcpy_tpu_torch.extraction import extract_batch

    assert extract_batch(_frames(), device="cpu").shape == (2, 18)
