"""The program's recorded host spans, for the readers in ``layer_metrics/``
that read them (``amcpy_tpu_torch.utils.metrics.spans()``).

The recorder is process-wide and records only while a ``torch.profiler``
session does. A benchmark run is one process with one traced slice, so the
recorder holds that slice's spans. A reader finds nothing where the
program has no recorder, or where the recorder dropped spans past its cap:
a truncated set would skew every share and rate read from it.
"""


def named(name: str) -> list:
    """The recorded spans called ``name``, in the order they closed."""
    try:
        from amcpy_tpu_torch.utils.metrics import spans, spans_dropped
    except ImportError:  # a program without the span recorder
        return []
    if spans_dropped():
        return []
    return [s for s in spans() if s.name == name]


def ns(records: list) -> int:
    """The summed nanoseconds of ``records``."""
    return sum(s.t1_ns - s.t0_ns for s in records)
