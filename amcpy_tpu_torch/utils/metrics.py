"""Structured metrics logging, stage timing and host spans.

Counterpart of ``amcpy_tpu/utils/metrics.py``: every pipeline stage emits a
JSONL record (wall time, throughput, shapes) to ``metrics/run.jsonl``.
PyTorch launches CUDA work asynchronously, so :func:`stage_timer`
synchronizes the device at both edges when given one; otherwise the wall
time would measure the enqueue, not the work.

**Spans.** :func:`span` names a stretch of host work (``amc.concat``,
``amc.io.load_modulation``, ...). Tracing is on exactly while a
``torch.profiler`` session records in the process
(``torch.autograd.profiler._is_profiler_enabled``, read once when a span
opens); there is no other switch. Off, a span is that one read and a
shared no-op context. On, it appends a :class:`Span` record (name, id,
parent, request ids, thread, ``perf_counter_ns`` edges, counts) to a
bounded process-wide recorder that :func:`spans` reads and
:func:`clear_spans` empties, and a span of work also opens a
``record_function`` of the same name, so that it lands in the profiler's
trace on the profiler's clock beside the kernels and copies. A span that
only waits for another thread (``wait=True``) stays out of that trace, so
it never takes a gap's label from the thread doing the work.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Any, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

from amcpy_tpu_torch.utils.device import sync

__all__ = [
    "MetricsLogger",
    "Span",
    "clear_spans",
    "record_span",
    "span",
    "spans",
    "spans_dropped",
    "stage_timer",
]


class MetricsLogger:
    """Append-only JSONL metrics sink. Safe to construct cheaply anywhere."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields: Any) -> dict[str, Any]:
        rec = {"ts": time.time(), "event": event, **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


@contextlib.contextmanager
def stage_timer(
    logger: MetricsLogger | None,
    event: str,
    *,
    device: torch.device | None = None,
    **fields: Any,
) -> Iterator[dict[str, Any]]:
    """Time a pipeline stage in wall-clock seconds and log it. With a CUDA
    ``device`` the clock starts and stops on a synchronized device. The
    dict yielded can be extended with result fields before the block
    exits."""
    rec: dict[str, Any] = dict(fields)
    with span(f"amc.{event}") as sp:
        if device is not None:
            sync(device)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            if device is not None:
                sync(device)
            rec["wall_s"] = time.perf_counter() - t0
            if "frames" in rec:
                sp.set(frames=rec["frames"])
            if logger:
                logger.log(event, **rec)


#: records the recorder keeps; later ones are counted in :func:`spans_dropped`
SPAN_CAP = 1 << 16


class Span:
    """One span's record. ``request`` is a request id, or a tuple of them
    for a span of many requests; ``counts`` holds ``frames``, ``bytes``,
    ``requests`` and the like."""

    __slots__ = ("name", "id", "parent", "request", "thread", "t0_ns", "t1_ns", "counts")

    def __init__(self, name: str, parent: int | None, request, counts: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.request = request
        self.thread = threading.current_thread().name
        self.counts = counts
        self.t0_ns = self.t1_ns = 0

    def set(self, **counts: Any) -> None:
        """Add counts before the span closes."""
        self.counts.update(counts)


class _OpenSpan:
    """The context of a span while tracing is on; ``rf`` is the
    ``record_function`` of a span of work, None for a waiting one."""

    __slots__ = ("rec", "rf")

    def __init__(self, rec: Span, trace: bool):
        self.rec = rec
        self.rf = torch.profiler.record_function(rec.name) if trace else None

    def __enter__(self) -> Span:
        _stack().append(self.rec.id)
        if self.rf is not None:
            self.rf.__enter__()
        self.rec.t0_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.t1_ns = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        _RECORDER.add(self.rec)


class _Off:
    """The shared context and record of every span while tracing is off:
    falsy, with no id, and it records nothing."""

    __slots__ = ()
    id = request = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **counts: Any) -> None:
        return None


class _Recorder:
    def __init__(self):
        self.records: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, rec: Span) -> None:
        with self._lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


_OFF = _Off()
_RECORDER = _Recorder()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list[int]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, *, parent: int | None = None, request=None, wait: bool = False,
         **counts: Any):
    """A context manager over a stretch of host work named ``name``, which
    yields its record (falsy, and ignoring :meth:`Span.set`, while tracing
    is off). ``parent`` defaults to the innermost span open on this thread;
    pass it to nest a span under one on another thread. ``wait=True`` marks
    a span that only waits for another thread: recorded, kept out of the
    profiler's trace."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    return _OpenSpan(Span(name, parent, request, counts), not wait)


def record_span(name: str, t0_ns: int, t1_ns: int, *, parent: int | None = None,
                request=None, **counts: Any) -> None:
    """Record, while tracing is on, a span whose edges were stamped
    (``time.perf_counter_ns()``) on two threads, such as a request's wait
    in a queue. It is kept out of the profiler's trace."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    rec = Span(name, parent, request, counts)
    rec.t0_ns, rec.t1_ns = t0_ns, t1_ns
    _RECORDER.add(rec)


def spans() -> list[Span]:
    """A snapshot of the recorded spans, in the order they closed."""
    with _RECORDER._lock:
        return list(_RECORDER.records)


def spans_dropped() -> int:
    """Spans not recorded since the recorder held :data:`SPAN_CAP`."""
    return _RECORDER.dropped


def clear_spans() -> None:
    """Empty the recorder and zero its count of dropped spans."""
    with _RECORDER._lock:
        _RECORDER.records.clear()
        _RECORDER.dropped = 0
