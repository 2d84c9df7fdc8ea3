"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
lookup by name, on the CPU."""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_lines_use_only_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(f.relative_to(ROOT))), f


def test_setup_s_is_an_end_to_end_metric_of_every_cell():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for cell in CELLS:
        c = harness.load_cell(ROOT, cell)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.driver.is_file() and c.traffic["kind"] == c.driver.stem
    # a limit is positive, or 0 for an exact comparison (a count)
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for _, reader in c.per_layer:
        assert reader.is_file()
        assert callable(harness._module(reader, "m").read)
    conf = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert conf["file"].startswith(BENCH["paths"][0] + "/")


def test_every_config_is_used_and_each_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in CELLS:
        c = harness.load_cell(ROOT, cell)
        reported = {m["name"] for m in c.end_to_end}
        assert all(m["moves"] in reported for m, _ in c.per_layer)


def test_a_new_cell_is_new_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a cell (a new traffic file, its limits
    and an entry): the harness finds it without a change to any file it
    had."""
    shutil.copytree(HOME, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    traffic = json.loads((HOME / "traffic" / "bulk.json").read_text())
    traffic.update(clients=16, k_min=1, k_max=32, k_step=1)
    (tmp_path / "port_bench" / "traffic" / "small.json").write_text(json.dumps(traffic))
    (tmp_path / "port_bench" / "limits" / "mlp-2048.small.json").write_text(
        (HOME / "limits" / "mlp-2048.bulk.json").read_text())
    bench["workloads"].append({"name": "mlp-2048.small", "config": "mlp-2048",
                               "traffic": "small", "chips": 1, "why": "small requests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mlp-2048.bulk" in m.get("workloads", []):
            m["workloads"].append("mlp-2048.small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(tmp_path, "mlp-2048.small")
    assert c.traffic["clients"] == 16 and c.driver.name == "serve.py"
    assert {m["name"] for m, _ in c.per_layer} == {
        m["name"] for m, _ in harness.load_cell(ROOT, "mlp-2048.bulk").per_layer}
    after = {p: p.read_bytes() for p in before}
    assert after == before


#: a run in a checkout, at the fault tests' ``SMALL["serve"]`` sizes on the
#: CPU, sound and with the ``answer`` fault; prints each run's ``correct``
#: and the folder its family was found in
RUN_SMALL = """
import json, sys
from pathlib import Path
import torch
from port_bench import common, harness
small = {"config": {"signals": {"frame_size": 256},
                    "compute": {"kernel": "fused", "wire_format": "f32"}},
         "traffic": {"pool_frames": 768, "k_min": 8, "k_max": 64, "k_step": 8, "clients": 2}}
out = {"families": str(common.FAMILIES)}
for fault in (None, "answer"):
    r = harness.run_cell(Path.cwd(), sys.argv[1], 2**31 + 41, 0.5, False, torch.device("cpu"),
                         overrides=small, fault=fault, log=lambda _: None)
    out[str(fault)] = {"correct": r["correct"], "attempted": r["attempted"],
                       "checks": r["checks"]}
print(json.dumps(out))
"""


def test_a_new_family_is_new_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a model family (a family file, here
    re-exporting the CNN's), a configuration of it whose classes the traffic
    generator does not know and whose pool it names apart, its limits and
    entries: the harness finds the cell, runs it correct on the CPU and
    sees the ``answer`` fault, without a change to any file it had."""
    home = tmp_path / "port_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}
    (home / "families" / "iqnet.py").write_text(
        '"""The CNN under another family name."""\n\n'
        "from port_bench.families.cnn import (  # noqa: F401\n"
        "    frame_work, params, program_model, reference_logits, scaler)\n")
    cfg = json.loads((HOME / "configs" / "cnn-2048.json").read_text())
    cfg.update(name="iqnet-2048", family="iqnet")
    cfg["signals"]["pool_modulations"] = cfg["signals"]["modulations"]
    cfg["signals"]["modulations"] = ["OOK", "4ASK", "FM", "GMSK", "AM-SSB-WC", "OQPSK"]
    (home / "configs" / "iqnet-2048.json").write_text(json.dumps(cfg))
    (home / "limits" / "iqnet-2048.bulk.json").write_text(
        (HOME / "limits" / "cnn-2048.bulk.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "iqnet-2048", "source": "a test", "reduced": [],
                             "file": "port_bench/configs/iqnet-2048.json", "why": "a test"})
    bench["workloads"].append({"name": "iqnet-2048.bulk", "config": "iqnet-2048",
                               "traffic": "bulk", "chips": 1, "why": "a new family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cnn-2048.bulk" in m.get("workloads", []):
            m["workloads"].append("iqnet-2048.bulk")
    assert "iqnet-2048.bulk" in next(m for m in bench["end_to_end"]
                                     if m["name"] == "serve_card_us_per_frame")["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = harness.load_cell(tmp_path, "iqnet-2048.bulk")
    assert c.cfg["family"] == "iqnet" and c.driver.name == "serve.py"
    assert {m["name"] for m, _ in c.per_layer} == {
        m["name"] for m, _ in harness.load_cell(ROOT, "cnn-2048.bulk").per_layer}

    # the copy's own package, as a run from its checkout imports it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", RUN_SMALL, "iqnet-2048.bulk"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert Path(out["families"]) == home / "families"
    assert out["None"]["correct"] and out["None"]["attempted"] > 0, out["None"]
    assert not out["answer"]["correct"], out["answer"]

    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_spread_is_the_distance_of_the_quartiles_over_the_median():
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    """This machine has no CUDA device: the run refuses before any work and
    never falls back to the CPU."""
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA device" in proc.stderr
