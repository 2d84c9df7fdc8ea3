"""The benchmark's harness: one run of one cell, driven by data.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Everything else is found by name under
the benchmark's folder:

* ``configs/<config>.json``, the configuration (the file the entry of
  ``configs`` names);
* ``traffic/<traffic>.json``, the traffic's parameters, whose ``kind``
  names its driver, ``drivers/<kind>.py``;
* ``limits/<cell>.json``, the limit of each number the cell's comparison
  reads;
* ``families/<family>.py``, the model family the configuration's
  ``family`` names, for the drivers that build a model (``common.family``);
* ``layer_metrics/<metric>.py``, the reader of each per-layer metric.

A driver module holds ``Driver(ctx)``, whose constructor is the set-up
and which offers ``window(seconds, tracer)``, ``release()`` and
``compare(control)``, and fills ``attempted``, ``failed`` and ``e2e``. A
reader holds ``read(r)``: a number from the traced slice, or None when the
slice holds nothing it reads.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

from port_bench import faults as faults_mod

__all__ = ["Cell", "Ctx", "Readings", "load_cell", "run_cell", "held_forbidden", "FORBIDDEN"]

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "amcpy_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    driver: Path
    end_to_end: list[dict]
    per_layer: list[tuple[dict, Path]]


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""

    cfg: dict
    traffic: dict
    seed: int
    device: object
    workdir: Path
    log: Callable[[str], None]


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(root: Path, workload: str, overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files;
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) are merged into
    the configuration and the traffic (the tests' small sizes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    home = root / bench["paths"][0]
    cfg = _merge(json.loads((root / conf["file"]).read_text()), (overrides or {}).get("config"))
    traffic = _merge(json.loads((home / "traffic" / f"{entry['traffic']}.json").read_text()),
                     (overrides or {}).get("traffic"))
    limits = json.loads((home / "limits" / f"{workload}.json").read_text())
    driver = home / "drivers" / f"{traffic['kind']}.py"
    if not driver.is_file():
        raise FileNotFoundError(f"no driver {driver} for traffic kind {traffic['kind']!r}")

    def applies(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reports = {m["name"] for m in e2e}
    layer = [(m, home / "layer_metrics" / f"{m['name']}.py") for m in bench["per_layer"]
             if (applies(m) if "workloads" in m else m["moves"] in reports)]
    return Cell(workload, entry, cfg, traffic, limits, driver, e2e, layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def held_forbidden() -> list[str]:
    """The forbidden top-level modules this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _device_info(device) -> dict:
    import subprocess

    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        info["power_limit"] = f"not read: {exc!r}"
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             *, t_start: float | None = None, overrides: dict | None = None,
             fault: str | None = None, control: bool = False, numbers: bool = False,
             log: Callable[[str], None] = print) -> dict:
    """One run of ``workload``: set-up, the window (a traced slice in it
    with ``trace``), then the comparison with the reference. Returns the
    result line's object; with ``control`` its ``control`` key holds the
    control's numbers, read on the same inputs, and with ``numbers`` its
    ``numbers`` key every number the comparison read, limited or not."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, workload, overrides)
    kind = cell.traffic["kind"]
    drivers = _module(cell.driver, f"port_bench_driver_{kind}")
    workdir = Path(tempfile.mkdtemp(prefix="port_bench-"))
    try:
        ctx = Ctx(cell.cfg, cell.traffic, seed, device, workdir, log)
        if device.type == "cuda":
            torch.empty(0, device=device)  # the context, before its counters are reset
            torch.cuda.reset_peak_memory_stats(device)
        with faults_mod.planted(kind, fault):
            drv = drivers.Driver(ctx)
            setup_s = time.perf_counter() - t_start
            tracer = None
            if trace:
                from port_bench.trace import Tracer

                tracer = Tracer(workdir)
            drv.window(seconds, tracer)
        dev = _device_info(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        drv.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        read = drv.compare(False)
        result_control = drv.compare(True) if control else None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    checks = {k: {"value": read[k], "limit": cell.limits[k]} for k in cell.limits}
    correct = drv.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics: dict[str, dict] = {}
    out = {"correct": correct, "attempted": drv.attempted, "failed": drv.failed}
    if trace:
        s = tracer.summary or {}
        top = sorted(s.get("kernels", {}).items(), key=lambda kv: -kv[1][1])[:12]
        log(f"traced slice: {tracer.counts}; kernels (launches, s): {top}; "
            f"h2d {s.get('h2d_bytes')} B in {s.get('h2d_s')} s")
        r = Readings(s, tracer.counts, cell.cfg)
        for m, path in cell.per_layer:
            value = _module(path, f"port_bench_metric_{m['name']}").read(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = s.get("busy_s", 0.0)
        dev["window_s"] = s.get("window_s", 0.0)
        out.update(metrics=metrics, device=dev,
                   breakdown={"device_ops": s.get("device_ops", []),
                              "idle_gaps": s.get("idle_gaps", [])})
    else:
        values = dict(drv.e2e, setup_s=setup_s)
        for m in cell.end_to_end:  # a value the run could not measure (no card) is left out
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        out.update(metrics=metrics, device=dev)
    out["checks"] = checks
    if control:
        out["control"] = result_control
    if numbers:
        out["numbers"] = read
    return out


@dataclasses.dataclass
class Readings:
    """What a per-layer reader is given: the trace's summary
    (:func:`port_bench.trace.summarize`), the slice's counts from the
    driver and the configuration."""

    summary: dict
    counts: dict
    cfg: dict
