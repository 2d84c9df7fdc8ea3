"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, ``build/amcpy_tpu_torch/lib<name>-<hash>.so``
beside the package, and loaded with ``ctypes``. The hash covers the
sources, the headers beside them and the compiler flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A build that
cannot run or fails raises: there is no fallback to the plain PyTorch
version for a CUDA tensor.

``torch.utils.cpp_extension.load`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["SIGNATURES", "build", "check", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "amcpy_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: ctypes signatures of every C entry point, per source
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES: dict[str, dict[str, tuple[list, object]]] = {
    "features": {
        "amc_fused_features": ([_P] * 11 + [_I] * 5 + [_P], _I),
        "amc_fused_route": ([_I, ctypes.POINTER(_I)], _I),
        "amc_fused_cluster_occupancy": ([_I, ctypes.POINTER(_I)], _I),
        "amc_fused_cluster_shape": ([_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
        "amc_stats_features": ([_P, _P, _I, _I, _I, _P], _I),
        "amc_fused_gmax_path": ([_I], _I),
        "amc_stats_fits": ([_I], _I),
        "amc_stats_path": ([_I], _I),
        "amc_error_string": ([_I], ctypes.c_char_p),
    },
    "cnn_trunk": {
        "amc_cnn_trunk": ([_P] * 5 + [_I, _P, _I, _I, _P], _I),
        "amc_cnn_trunk_smem": ([_P, _I], _I),
        "amc_cnn_trunk_path": ([_P, _I], _I),
        "amc_error_string": ([_I], ctypes.c_char_p),
    },
    "resnet_trunk": {
        "amc_resnet_stack": ([_P, _P, _P, _I, _I, _I, _P], _I),
        "amc_resnet_stack_fits": ([_I, _I], _I),
        "amc_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of amcpy_tpu_torch cannot be built"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is built already, and
    return the library's path. nvcc's output, ptxas's report of registers,
    shared memory and spills included, is kept beside it as ``.log``."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.name, suffix=".tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.amc_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
