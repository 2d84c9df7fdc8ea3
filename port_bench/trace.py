"""Reading a ``torch.profiler`` Chrome trace into what the per-layer
metrics need.

An extended copy of ``chip_smoke.py::trace_summary``: the device's busy
time (the union of its kernels, copies and memsets) over the traced
window (first event to last), each kernel name's launches and device
seconds, the host-to-device copies' bytes and device seconds, and the
``breakdown`` of a result line: the device operations that took the most
time, and the idle gaps summed by what the host was doing (the innermost
host span, an operator or one of the benchmark's own ``record_function``
spans, that covers a gap's middle).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np

__all__ = ["Tracer", "kernel_seconds", "span", "summarize"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
#: entries of each ``breakdown`` list
TOP = 10
#: the longest idle gaps that are labelled by the host span covering them
LABELLED_GAPS = 400


def _merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(path: Path) -> dict:
    """Everything the readers take from one trace (times in seconds)."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not events:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "h2d_bytes": 0.0,
                "h2d_s": 0.0, "device_ops": [], "idle_gaps": []}
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    merged = _merged([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    busy = sum(b - a for a, b in merged)

    kernels: dict[str, list[float]] = {}
    ops: dict[str, float] = {}
    h2d_bytes = h2d_us = 0.0
    for e in device:
        name, dur = e.get("name", "?"), float(e["dur"])
        ops[name] = ops.get(name, 0.0) + dur
        if e["cat"] == "kernel":
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += dur / 1e6
        elif e["cat"] == "gpu_memcpy" and "HtoD" in name:
            nbytes = (e.get("args") or {}).get("bytes")
            if nbytes is not None:
                h2d_bytes += float(nbytes)
                h2d_us += dur

    # idle gaps, the longest labelled by the innermost host span over them
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(b - a, (a + b) / 2) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS
            and not e.get("name", "").startswith("PyTorch Profiler")]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    idle: dict[str, float] = {}
    for length, mid in gaps[:LABELLED_GAPS]:
        label = "no host span"
        if len(host):
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(cover):
                label = host[int(cover[np.argmax(starts[cover])])]["name"]
        idle[label] = idle.get(label, 0.0) + length / 1e6
    rest = sum(length for length, _ in gaps[LABELLED_GAPS:]) / 1e6
    if rest > 0:
        idle["shorter gaps"] = rest

    def top(d: dict[str, float], scale: float) -> list[list]:
        return [[k, v * scale] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": {k: (int(c), s) for k, (c, s) in kernels.items()},
        "h2d_bytes": h2d_bytes,
        "h2d_s": h2d_us / 1e6,
        "device_ops": top(ops, 1e-6),
        "idle_gaps": top(idle, 1.0),
    }


class Tracer:
    """One traced slice of a window: ``torch.profiler`` over host and
    device activity between :meth:`start` and :meth:`stop`, exported to
    ``trace.json`` in ``workdir`` and summarized. A driver calls
    :meth:`start` and :meth:`stop` at the edges of whole units of work (a
    pass, an epoch, or a moment with no request in flight) and records
    what the slice held in :attr:`counts`.

    With ``host=False`` it records the device's activity alone (CUPTI's
    kernels, copies and memsets, no host operators or spans): the device
    clock of an untraced window, whose ``busy_s`` an end-to-end metric
    reads."""

    def __init__(self, workdir: Path, host: bool = True):
        self.path = Path(workdir) / "trace.json"
        self.host = host
        self.counts: dict[str, float] = {}
        self.summary: dict | None = None
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        extra = {}
        try:  # the host spans of every thread (clients, the batcher), not this one's alone
            from torch._C._profiler import _ExperimentalConfig

            if self.host:
                extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            pass
        self._prof = profile(activities=acts, **extra)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.counts["slice_host_s"] = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        self.summary = summarize(self.path)
        self.path.unlink(missing_ok=True)

    @contextlib.contextmanager
    def slice(self):
        self.start()
        try:
            yield self.counts
        finally:
            self.stop()


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, named ``port_bench.<name>``."""
    import torch

    with torch.profiler.record_function(f"port_bench.{name}"):
        yield


def kernel_seconds(summary: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name matches the regular
    expression ``pattern``."""
    import re

    rx = re.compile(pattern)
    return sum(s for k, (_, s) in summary.get("kernels", {}).items() if rx.search(k))
