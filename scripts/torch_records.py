"""What the port's record scripts share (``scripts/torch_wire_gate.py``,
``scripts/torch_cnn_vs_mlp.py``, ``scripts/torch_cnn_wide_control.py``):
the device a run asks for, the full-scale dataset they read, and the
machine a record was taken on.

Imports ``torch``, ``numpy`` and ``amcpy_tpu_torch`` only.
"""

from __future__ import annotations

import os
import platform
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: where the records' dataset lives unless ``--root`` says otherwise: a
#: directory of the checkout that ``.gitignore`` lists
DEFAULT_ROOT = ROOT / "build" / "amc_records"


def add_device_flags(ap, out: str) -> None:
    """``--device`` (the card unless the caller asks for ``cpu``) and
    ``--out`` (the record's path, ``out`` by default)."""
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card only cpu runs")
    ap.add_argument("--out", default=out, help="where the record is written")


def require_device(device: str | None):
    """The torch device a record runs on: the card unless ``device`` names
    another; raises ``RuntimeError`` naming ``--device cpu`` where a card is
    asked for and there is none."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card on this machine: pass --device cpu to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def ensure_dataset(cfg, dev) -> Path:
    """``ROOT/mat-data/all_modulations.mat``, written by the port's
    ``synth.write_dataset(cfg, seed=0)`` on ``dev`` where it is absent."""
    from amcpy_tpu_torch.data import synth

    cfg.paths.ensure_dirs()
    mat = cfg.paths.mat_data / cfg.paths.mat_filename
    if not mat.exists():
        print(f"[records] writing the dataset {mat} on {dev} ...", flush=True)
        synth.write_dataset(cfg, seed=0, device=dev)
    return mat


def environment(dev) -> dict:
    """The card (``torch``'s name; nvidia-smi's name and power limit) and
    the host (CPU model, cores) a record was taken on."""
    import torch

    device = {"type": dev.type}
    if dev.type == "cuda":
        device["name"] = torch.cuda.get_device_name(dev)
        device["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    cpu = platform.machine()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.lower().startswith(("model name", "cpu model")):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return {"device": device,
            "host": {"cpu": cpu, "cores": os.cpu_count(), "torch": torch.__version__}}
