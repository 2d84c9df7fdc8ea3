"""Every cell's run on the CPU at a small size, past the harness's look for
a card: a sound run is correct, the control (the reference in the
precision below the configuration's) fails one of the cell's limits, and
so does each fault the cell can have, planted underneath the timed path.

The sizes are cut so that a run takes seconds here; on the card the same
comparisons run at the cells' own sizes.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import faults, harness

ROOT = Path(__file__).resolve().parent.parent.parent
#: the served route of the card (K1 or K3 and its head) takes its plain
#: version on the CPU under ``kernel="fused"``; ``"auto"`` would take the
#: module forward there
FUSED = {"kernel": "fused", "wire_format": "f32"}
SMALL = {
    "serve": {"config": {"signals": {"frame_size": 256}, "compute": FUSED},
              "traffic": {"pool_frames": 768, "k_min": 8, "k_max": 64, "k_step": 8,
                          "clients": 2}},
    "extract": {"config": {"signals": {"frame_size": 256}, "compute": FUSED},
                "traffic": {"frames_per": 4}},
    "train": {"config": {"signals": {"frame_size": 256}, "training": {"batch_size": 32}},
              "traffic": {"frames_per": 40}},
}
#: the train cell's entries, out of ``BENCHMARK.json`` until its rate holds
#: a bound (``PERF.md``); its driver, traffic, limits and readers are kept
LATER = {
    "workloads": [{"name": "mlp-2048.train", "config": "mlp-2048", "traffic": "train",
                   "chips": 1, "why": "whole run_epoch calls"}],
    "end_to_end": [{"name": "train_samples_per_s", "unit": "samples/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": ["mlp-2048.train"]}],
    "per_layer": [{"name": m, "unit": u, "better": b, "source": "device_trace", "layer": layer,
                   "moves": "train_samples_per_s", "workloads": ["mlp-2048.train"]}
                  for m, u, b, layer in (("launches_per_step.train", "launches", "lower", "train"),
                                         ("train_mfu", "%", "higher", "model"),
                                         ("idle_share.train", "%", "lower", "device"))],
}
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A checkout whose ``BENCHMARK.json`` also holds the train cell."""
    out = tmp_path_factory.mktemp("checkout")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        bench[key] += entries
    (out / "BENCHMARK.json").write_text(json.dumps(bench))
    (out / "port_bench").symlink_to(ROOT / "port_bench")
    return out


CELLS = {w["name"]: json.loads((ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json")
                               .read_text())["kind"]
         for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         + LATER["workloads"]}


def _run(root: Path, cell: str, **kw) -> dict:
    return harness.run_cell(root, cell, SEED, 0.5, False, torch.device("cpu"),
                            overrides=SMALL[CELLS[cell]], log=lambda _: None, **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct_and_its_control_is_not(root, cell):
    out = _run(root, cell, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(out["control"][k] > limits[k] for k in limits), (out["control"], limits)


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(CELLS)
                                         for f in faults.FAULTS[CELLS[c]]])
def test_a_planted_fault_makes_the_run_incorrect(root, cell, fault):
    out = _run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]
