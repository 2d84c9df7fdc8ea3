"""How the port builds its CUDA kernels (``amcpy_tpu_torch/ops/_build.py``),
checked without a compiler: a missing or failing ``nvcc`` raises and leaves
no library behind, and the library's name follows its sources, so an
edited kernel is rebuilt.
"""

import stat

import pytest

from amcpy_tpu_torch.ops import _build


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_libs", {})
    return out


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_missing_nvcc_raises(build_dir, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("features")
    assert "features" not in _build._libs


def test_failed_compile_raises_and_leaves_no_library(build_dir, monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path / "nvcc", "echo 'features.cu(1): error: boom'; exit 1")
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*boom"):
        _build.build("features")
    assert not list(build_dir.glob("*.so")) and not list(build_dir.glob("*.tmp"))


def test_nvcc_path_prefers_cuda_home(monkeypatch, tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = _fake_nvcc(tmp_path / "bin" / "nvcc", "exit 0")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc_path() == nvcc


def test_library_name_follows_the_sources(build_dir, monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "features.cu"
    src.write_bytes((_build.CSRC / "features.cu").read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._lib_path("features")
    assert first.parent == build_dir and first.name.startswith("libfeatures-")
    assert _build._lib_path("features") == first
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build._lib_path("features")
    assert edited != first
    (csrc / "common.cuh").write_text("#pragma once\n")
    assert _build._lib_path("features") != edited


def test_every_source_has_its_entry_points():
    """Each ``csrc/*.cu`` is a library with ctypes signatures, and each
    library exports ``amc_error_string`` for ``_build.check``."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.SIGNATURES) == ["cnn_trunk", "features", "resnet_trunk"]
    for name, fns in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "amc_error_string" in fns
        for fn in fns:
            assert f" {fn}(" in text, (name, fn)
