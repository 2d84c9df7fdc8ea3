"""What the drivers share: the program's configuration and models built from
a configuration file of the benchmark, the model family a configuration
names, a metrics logger that keeps its records, a pause gate for
closed-loop clients, and small statistics."""

from __future__ import annotations

import importlib.util
import threading
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

__all__ = ["Gate", "KeepLogger", "family", "holding", "port_config", "port_model", "quantiles"]

#: the folder of the family files
FAMILIES = Path(__file__).resolve().parent / "families"


def port_config(cfg: dict, root, **signals):
    """The program's ``Config`` for the benchmark's configuration ``cfg``,
    its files under ``root``; ``signals`` override signal fields. Without
    ``features`` or ``training`` the program's defaults hold."""
    from amcpy_tpu_torch.config import Config

    s = cfg["signals"]
    return Config.from_dict({
        "paths": {"root": str(root)},
        "signals": {"modulations": s["modulations"][:-1] if s["modulations"][-1] == "WGN"
                    else s["modulations"],
                    "modulations_with_noise": s["modulations"],
                    "labels": list(range(len(s["modulations"]))),
                    "snr_db": s["snr_db"], "frame_size": s["frame_size"],
                    "num_frames": s["num_frames"], **signals},
        **({"features": {"used": cfg["features"]["used"]}} if "features" in cfg else {}),
        "training": cfg.get("training", {}),
        "compute": cfg["compute"],
    })


def family(cfg: dict) -> ModuleType:
    """The module of the model family ``cfg["family"]`` names,
    ``families/<family>.py``. It offers

    * ``params(cfg, seed, device)``: the seeded weights, by the names the
      program's module loads;
    * ``scaler(cfg, pool, params, device)``: the program's ``Standardizer``
      for the checkpoint, and the state the reference needs beside the
      weights (or None);
    * ``program_model(cfg, params)``: the program's module holding
      ``params``;
    * ``reference_logits(cfg, params, state, frames, device, control)``:
      the reference's float32 logits of host frames, or with ``control``
      the control's, one precision below the configuration's;
    * ``frame_work(cfg)``: the model work of serving one frame, by unit of
      ``work.PEAKS``."""
    name = cfg["family"]
    path = FAMILIES / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no family file {path} for family {name!r}")
    spec = importlib.util.spec_from_file_location(f"port_bench_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def holding(model: torch.nn.Module, params: dict[str, torch.Tensor]) -> torch.nn.Module:
    """``model`` with every leaf of its state set from ``params``."""
    state = model.state_dict()
    for name in state:
        if name.endswith("num_batches_tracked"):
            continue
        state[name] = params[name].detach().cpu()
    model.load_state_dict(state)
    return model


def port_model(cfg: dict, params: dict[str, torch.Tensor]):
    """The program's module of ``cfg``'s family holding ``params``."""
    return family(cfg).program_model(cfg, params)


class KeepLogger:
    """A ``MetricsLogger`` of the program that keeps its records in memory
    and writes none."""

    def __init__(self):
        from amcpy_tpu_torch.utils.metrics import MetricsLogger

        self._inner = MetricsLogger(None)
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def log(self, event: str, **fields):
        rec = self._inner.log(event, **fields)
        with self._lock:
            self.records.append(rec)
        return rec


class Gate:
    """Lets the window hold its closed-loop clients between requests: after
    :meth:`hold` returns no request is in flight, until :meth:`release`."""

    def __init__(self):
        self._cond = threading.Condition()
        self._held = False
        self._waiting = 0
        self.phase = 0

    def wait(self) -> int:
        """Called by a client before each request: blocks while held;
        returns the phase the request belongs to."""
        with self._cond:
            if self._held:
                self._waiting += 1
                self._cond.notify_all()
                while self._held:
                    self._cond.wait()
                self._waiting -= 1
            return self.phase

    def hold(self, alive) -> None:
        """Hold every client that is still running (``alive()`` counts them)
        once its request is answered."""
        with self._cond:
            self._held = True
            while self._waiting < alive():
                self._cond.wait(0.01)

    def release(self) -> None:
        with self._cond:
            self.phase += 1
            self._held = False
            self._cond.notify_all()


def quantiles(values) -> dict[str, float]:
    """Median, 95th and 99th percentile (numpy's linear rule) and count."""
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)), "p95": float(np.percentile(v, 95)),
            "p99": float(np.percentile(v, 99)), "n": int(len(v))}
