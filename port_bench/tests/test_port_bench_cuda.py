"""The benchmark's command on the card (``cuda`` marker; skips without one):

    python -m pytest --noconftest -m cuda port_bench/tests/test_port_bench_cuda.py

Each cell runs once with a short window and must print a correct result
line naming the card, and its traced run the per-layer metrics it lists.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_correct_on_the_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell,
                           "--seed", str(2**31 + 1234), "--seconds", "3",
                           "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["kind"] == card and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    if trace:
        listed = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
        assert set(out["metrics"]) == listed
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
        for name, m in out["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name
    else:
        names = {m["name"] for m in BENCH["end_to_end"]
                 if "workloads" not in m or cell in m["workloads"]}
        assert set(out["metrics"]) == names
