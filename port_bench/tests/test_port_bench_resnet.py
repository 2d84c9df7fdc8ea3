"""The RadioML 2018 ResNet's family, reference, limits, cell and readers
(``families/resnet.py``, ``reference/resnet.py``,
``limits/resnet-rml2018.bulk.json``, ``resnet-rml2018.bulk``,
``layer_metrics/resnet_*.serve.py``), on the CPU, and its traced cell on
the card (``cuda`` marker; skips without one):

    python -m pytest port_bench/tests/test_port_bench_resnet.py -q
    python -m pytest --noconftest -m cuda port_bench/tests/test_port_bench_resnet.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import common, harness, signals
from port_bench.harness import Readings, _module
from port_bench.reference import resnet as ref_resnet

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
CELL = "resnet-rml2018.bulk"
CFG = json.loads((HOME / "configs" / "resnet-rml2018.json").read_text())
LIMITS = json.loads((HOME / "limits" / f"{CELL}.json").read_text())
#: the fault tests' serve sizes (``test_port_bench_faults.py``)
SMALL = {"config": {"signals": {"frame_size": 256},
                    "compute": {"kernel": "fused", "wire_format": "f32"}},
         "traffic": {"pool_frames": 768, "k_min": 8, "k_max": 64, "k_step": 8, "clients": 2}}
SEED = 2**31 + 2020


def _cfg(frame_size: int) -> dict:
    cfg = json.loads(json.dumps(CFG))
    cfg["signals"]["frame_size"] = frame_size
    return cfg


def _pool(cfg: dict, frames: int, seed: int = 4) -> np.ndarray:
    s = cfg["signals"]
    return signals.make_pool(seed, frames, s["frame_size"], s["pool_modulations"],
                             s["snr_db"])[0]


def reader(metric: str):
    return _module(HOME / "layer_metrics" / f"{metric}.py", f"reader_{metric}").read


def test_the_configuration_holds_the_published_widths():
    from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES

    assert CFG["family"] == "resnet" and CFG["model"] == {
        "stacks": 6, "filters": 32, "kernel_size": 3, "dense": [128, 128]}
    s = CFG["signals"]
    assert s["modulations"] == list(DEEPSIG_CLASSES) and s["frame_size"] == 1024
    assert s["snr_db"] == list(range(-20, 31, 2))
    assert s["pool_modulations"] == ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"]
    assert set(CFG["assumed"]) >= {"kernel_size", "activation", "padding", "weights", "pool"}
    entry = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == "resnet-rml2018")
    assert entry["reduced"] == [] and entry["source"] == CFG["source"]


def test_frame_work_is_the_count_of_the_published_shapes():
    """24,772,608 in the units' convs (2016 positions), 1,081,344 in the
    stacks' 1x1 convs, 84,992 in the head."""
    fam = common.family(CFG)
    assert fam.frame_work(CFG) == {"fp32_lane_ops": 25_938_944}
    assert 2016 * 4 * 32 * 32 * 3 + 1024 * 2 * 32 + 992 * 32 * 32 + 84_992 == 25_938_944
    # half the frame: every stack's length halves, the flatten too
    half = fam.frame_work(_cfg(512))["fp32_lane_ops"]
    assert half == (25_938_944 - 84_992) / 2 + 256 * 128 + 128 * 128 + 128 * 24


@pytest.mark.parametrize("frames", [40, 600], ids=["one_block", "two_blocks"])
def test_the_family_is_the_reference(frames):
    cfg = _cfg(128)
    fam = common.family(cfg)
    pool = _pool(cfg, frames)
    p = fam.params(cfg, 23, "cpu")
    want = ref_resnet.resnet_params(cfg, 23, "cpu")
    assert p.keys() == want.keys() and all(torch.equal(p[k], want[k]) for k in p)

    std, state = fam.scaler(cfg, pool, p, "cpu")
    assert state is None and std.mean.shape == (1,)

    x = torch.view_as_real(torch.from_numpy(pool)).transpose(1, 2)
    got = {}
    for control, rnd in ((False, None), (True, ref_resnet.tf32)):
        got[control] = fam.reference_logits(cfg, p, state, pool, "cpu", control)
        assert got[control].dtype == torch.float32 and got[control].shape == (frames, 24)
        assert torch.equal(got[control], ref_resnet.resnet_logits(p, x, rnd))
    assert (got[True] - got[False]).abs().max() > 1e-3

    model = fam.program_model(cfg, p)
    assert model.frame_size == 128
    assert all(torch.equal(v, p[k]) for k, v in model.state_dict().items())


def _readings(served: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The serve driver's two numbers for served logits against the
    reference's: the widest gap of the served class's logit below the
    best, and the largest error of a probability."""
    served, ref = served.double(), ref.double()
    ids = served.argmax(-1)
    gap = (ref.max(-1).values - ref.gather(1, ids[:, None])[:, 0]).max()
    err = (torch.softmax(served, -1) - torch.softmax(ref, -1)).abs().max()
    return {"max_logit_gap": float(gap), "max_prob_err": float(err)}


def test_the_module_reads_under_the_limits_and_its_tf32_control_above():
    """At the published widths on a small batch: the program's module under
    every limit, the control over at least one."""
    fam = common.family(CFG)
    pool = _pool(CFG, 48)
    p = fam.params(CFG, SEED, "cpu")
    ref = fam.reference_logits(CFG, p, None, pool, "cpu", False)
    with torch.inference_mode():
        served = fam.program_model(CFG, p).eval()(
            torch.view_as_real(torch.from_numpy(pool)).transpose(1, 2).contiguous())
    sound = _readings(served, ref)
    control = _readings(fam.reference_logits(CFG, p, None, pool, "cpu", True), ref)
    assert all(sound[k] <= LIMITS[k] for k in LIMITS), sound
    assert any(control[k] > LIMITS[k] for k in LIMITS), control


def test_the_cell_runs_correct_on_the_cpu_and_sees_the_answer_fault():
    for fault in (None, "answer"):
        out = harness.run_cell(ROOT, CELL, SEED, 0.5, False, torch.device("cpu"),
                               overrides=SMALL, fault=fault, log=lambda _: None)
        assert out["attempted"] > 0 and out["failed"] == 0
        assert out["correct"] == (fault is None), out["checks"]


def _span(name: str, us: float, **counts):
    return SimpleNamespace(name=name, t0_ns=0, t1_ns=int(us * 1e3), counts=counts)


def test_the_enqueue_reader(monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    records: list = []
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    read = reader("resnet_enqueue_us_per_frame.serve")
    r = Readings({}, {"frames": 3000}, CFG)
    assert read(r) is None  # no ResNet span in the slice
    # two forwards, of 1000 and 2000 frames: 6 stacks and a head each
    for frames in (1000, 2000):
        records += [_span("amc.resnet.stack", 10.0, stack=s, frames=frames) for s in range(6)]
        records.append(_span("amc.resnet.head", 30.0, frames=frames))
    records.append(_span("amc.model", 500.0, frames=3000))
    assert read(r) == pytest.approx((2 * 6 * 10.0 + 2 * 30.0) / 3000)
    assert read(Readings({}, {"frames": 0}, CFG)) is None
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 1)
    assert read(r) is None


def test_the_roofline_reader():
    read = reader("resnet_roofline.serve")
    kernels = {"conv": (40, 0.02), "pool": (6, 0.004), "packing": (1, 0.001)}
    r = Readings({"kernels": kernels}, {"frames": 10_000}, CFG)
    least = 10_000 * 25_938_944 / (132 * 128 * 1.98e9)
    assert read(r) == pytest.approx(100 * least / 0.025)
    assert read(Readings({"kernels": {}}, {"frames": 10_000}, CFG)) is None
    assert read(Readings({"kernels": kernels}, {"frames": 0}, CFG)) is None


@pytest.mark.cuda
def test_the_traced_cell_prints_both_new_metrics_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL,
                           "--seed", str(SEED), "--seconds", "4", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    m = out["metrics"]
    assert 0 < m["resnet_roofline.serve"]["value"] <= 100
    assert 0 < m["resnet_enqueue_us_per_frame.serve"]["value"]
