"""The reader of ``inplace_share.serve`` on hand-made span records: the
share of coalesced dispatches that opened no ``amc.concat``, and nothing
where no dispatch was coalesced or the recorder dropped spans.

    python -m pytest port_bench/tests/test_port_bench_inplace.py -q
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench.harness import Readings, _module

HOME = Path(__file__).resolve().parent.parent
read = _module(HOME / "layer_metrics" / "inplace_share.serve.py", "reader_inplace_share").read
SLICE = Readings({}, {"frames": 64}, {})


@pytest.fixture
def recorder(monkeypatch):
    """Hand-made records served as the program's ``spans()``."""
    from amcpy_tpu_torch.utils import metrics

    records: list = []
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 0)
    return records


def _rec(name: str, **counts):
    return SimpleNamespace(name=name, t0_ns=0, t1_ns=1_000_000, counts=counts)


def _dispatches(requests: list[int]) -> list:
    return [_rec("amc.dispatch", requests=k, frames=16 * k) for k in requests]


def test_a_concatenate_in_every_coalesced_dispatch_reads_0(recorder):
    recorder += _dispatches([1, 3, 2, 1]) + [_rec("amc.concat", bytes=8)] * 2
    assert read(SLICE) == 0.0


def test_no_concatenate_reads_100(recorder):
    recorder += _dispatches([1, 3, 2, 4])
    assert read(SLICE) == 100.0


def test_a_share_of_the_coalesced_dispatches(recorder):
    """Lone requests never concatenate and do not count."""
    recorder += _dispatches([2, 2, 2, 2, 1, 1]) + [_rec("amc.concat", bytes=8)]
    assert read(SLICE) == pytest.approx(75.0)


@pytest.mark.parametrize("records", [
    [],
    _dispatches([1, 1, 1]),
    [_rec("amc.concat", bytes=8)],
], ids=["no_spans", "lone_requests", "no_dispatch"])
def test_nothing_coalesced_reads_nothing(recorder, records):
    recorder += records
    assert read(SLICE) is None


def test_nothing_is_read_where_the_recorder_dropped_spans(recorder, monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    recorder += _dispatches([3, 2])
    assert read(SLICE) == 100.0
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 1)
    assert read(SLICE) is None


def test_a_slice_with_no_frames_reads_nothing(recorder):
    recorder += _dispatches([3, 2])
    assert read(Readings({}, {"frames": 0}, {})) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "spans")
    assert read(SLICE) is None
