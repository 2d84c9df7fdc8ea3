"""The per-layer metrics read from the program's spans
(``amcpy_tpu_torch.utils.metrics.spans()``), on the CPU: a traced run of a
bulk and of the extract cell at a small size prints each of them, a
positive number (a share at most 100 %; ``inplace_share.serve`` reads 0
here, since the CPU route concatenates a coalesced group by design), and
each reader's arithmetic on hand-made records.

    python -m pytest port_bench/tests/test_port_bench_spans.py -q
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from port_bench import harness
from port_bench.harness import Readings, _module

ROOT = Path(__file__).resolve().parent.parent.parent
HOME = ROOT / "port_bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"
                and m["name"] != "extract_stage_share.extract"}
#: the small sizes of ``test_port_bench_faults.py``; four clients, so that
#: requests queue behind a dispatch and are coalesced
FUSED = {"kernel": "fused", "wire_format": "f32"}
SMALL = {
    "mlp-2048.bulk": {"config": {"signals": {"frame_size": 256}, "compute": FUSED},
                      "traffic": {"pool_frames": 768, "k_min": 8, "k_max": 64, "k_step": 8,
                                  "clients": 4}},
    "mlp-2048.extract": {"config": {"signals": {"frame_size": 256}, "compute": FUSED},
                         "traffic": {"frames_per": 4}},
}
#: window seconds: a serve cell traces a fixed 2 s slice, the extract cell
#: its second pass, which a loaded host may not reach in 0.5 s
SECONDS = {"mlp-2048.bulk": 0.5, "mlp-2048.extract": 3.0}
SEED = 2**31 + 91


def reader(metric: str):
    return _module(HOME / "layer_metrics" / f"{metric}.py", f"reader_{metric}").read


@pytest.fixture
def recorder(monkeypatch):
    """Hand-made records served as the program's ``spans()``."""
    from amcpy_tpu_torch.utils import metrics

    records: list = []
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    return records


def _rec(name: str, ms: float, **counts):
    return SimpleNamespace(name=name, t0_ns=1_000_000, t1_ns=1_000_000 + int(ms * 1e6),
                           counts=counts)


def _one_of_each() -> list:
    """One span of each name a span reader reads; the dispatch coalesces two
    requests."""
    return [_rec(n, 1.0, frames=4, bytes=4, requests=2) for n in (
        "amc.queue", "amc.concat", "amc.reply", "amc.stage.write", "amc.fetch",
        "amc.dispatch", "amc.extract.pass", "amc.extract.load_wait", "amc.io.save_features")]


def test_seven_span_metrics_are_listed():
    assert set(SPAN_METRICS) == {
        "queue_wait_ms.serve", "reply_us_per_frame.serve", "staging_gbps.serve",
        "device_wait_ms.serve", "load_wait_share.extract", "save_share.extract",
        "inplace_share.serve"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_prints_each_span_metric(cell):
    from amcpy_tpu_torch.utils.metrics import clear_spans

    clear_spans()
    try:
        out = harness.run_cell(ROOT, cell, SEED, SECONDS[cell], True, torch.device("cpu"),
                               overrides=SMALL[cell], log=lambda _: None)
    finally:
        clear_spans()
    assert out["correct"], out["checks"]
    mine = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    assert mine and mine <= set(out["metrics"])
    for name in mine:
        value = out["metrics"][name]["value"]
        if name == "inplace_share.serve":  # the CPU concatenates every coalesced group
            assert value == 0.0
            continue
        assert value > 0, name
        if out["metrics"][name]["unit"] == "%":
            assert value <= 100, name


def test_serve_readers_arithmetic(recorder):
    r = Readings({}, {"frames": 64}, {})
    recorder += [_rec("amc.queue", 2.0, frames=8), _rec("amc.queue", 6.0, frames=8),
                 _rec("amc.concat", 4.0, bytes=8_000_000), _rec("amc.concat", 1.0, bytes=2_000_000),
                 _rec("amc.reply", 3.0, frames=1000), _rec("amc.reply", 1.0, frames=3000),
                 _rec("amc.stage.write", 2.0, bytes=10_000_000),
                 _rec("amc.fetch", 3.0, frames=16), _rec("amc.fetch", 5.0, frames=16),
                 _rec("amc.dispatch", 50.0, frames=16)]
    assert reader("queue_wait_ms.serve")(r) == pytest.approx(4.0)
    assert reader("reply_us_per_frame.serve")(r) == pytest.approx(4e-3 / 4000 * 1e6)
    assert reader("staging_gbps.serve")(r) == pytest.approx(5.0)
    assert reader("device_wait_ms.serve")(r) == pytest.approx(4.0)
    assert reader("load_wait_share.extract")(r) is None  # no pass in a serve slice


def test_extract_readers_arithmetic(recorder):
    r = Readings({}, {"frames": 96}, {})
    recorder += [_rec("amc.extract.pass", 1000.0, frames=96),
                 _rec("amc.extract.load_wait", 300.0), _rec("amc.extract.load_wait", 450.0),
                 _rec("amc.io.save_features", 20.0, bytes=1000),
                 _rec("amc.io.save_features", 30.0, bytes=1000)]
    assert reader("load_wait_share.extract")(r) == pytest.approx(75.0)
    assert reader("save_share.extract")(r) == pytest.approx(5.0)
    assert reader("queue_wait_ms.serve")(r) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_reader_is_silent_without_frames_or_its_spans(recorder, metric):
    recorder += _one_of_each()
    assert reader(metric)(Readings({}, {"frames": 0}, {})) is None
    assert reader(metric)(Readings({}, {"frames": 4}, {})) is not None
    recorder.clear()
    assert reader(metric)(Readings({}, {"frames": 4}, {})) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_reader_is_silent_where_the_recorder_dropped_spans(recorder, monkeypatch, metric):
    """Spans dropped past the recorder's cap leave a truncated set: no
    reader computes a share or a rate from it."""
    from amcpy_tpu_torch.utils import metrics

    recorder += _one_of_each()
    assert reader(metric)(Readings({}, {"frames": 4}, {})) is not None
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 1)
    assert reader(metric)(Readings({}, {"frames": 4}, {})) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent of this benchmark's readers has no ``spans()``: each
    reader returns None and does not raise."""
    from amcpy_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "spans")
    for metric in SPAN_METRICS:
        assert reader(metric)(Readings({}, {"frames": 4}, {})) is None, metric
