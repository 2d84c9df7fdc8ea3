"""MCLDNN's family, reference, limits, cell and readers
(``families/mcldnn.py``, ``reference/mcldnn.py``,
``limits/mcldnn-rml2018.bulk.json``, ``mcldnn-rml2018.bulk``,
``layer_metrics/mcldnn_*.serve.py``), on the CPU, and on the card
(``cuda`` marker; skips without one) the module against the reference at
the published frame size and the traced cell:

    python -m pytest port_bench/tests/test_port_bench_mcldnn.py -q
    python -m pytest --noconftest -m cuda port_bench/tests/test_port_bench_mcldnn.py
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
from port_bench.reference import mcldnn as ref_mcldnn

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
CELL = "mcldnn-rml2018.bulk"
CFG = json.loads((HOME / "configs" / "mcldnn-rml2018.json").read_text())
LIMITS = json.loads((HOME / "limits" / f"{CELL}.json").read_text())
#: the fault tests' serve sizes (``test_port_bench_faults.py``)
SMALL = {"config": {"signals": {"frame_size": 256},
                    "compute": {"kernel": "fused", "wire_format": "f32"}},
         "traffic": {"pool_frames": 768, "k_min": 8, "k_max": 64, "k_step": 8, "clients": 2}}
SEED = 2**31 + 2024
NEW = ("mcldnn_roofline.serve", "mcldnn_enqueue_us_per_frame.serve",
       "mcldnn_chunk_frames.serve")


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

    assert CFG["family"] == "mcldnn" and CFG["model"] == {
        "filters": [50, 50, 50, 100], "lstm_units": 128, "lstm_layers": 2, "dense": [128, 128]}
    s = CFG["signals"]
    assert s["modulations"] == list(DEEPSIG_CLASSES) and s["frame_size"] == 1024
    assert s["snr_db"] == list(range(-20, 31, 2))
    assert s["pool_modulations"] == ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM"]
    assert set(CFG["assumed"]) >= {"frame_size", "padding", "lstm_biases", "dropout",
                                   "weights", "pool"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "mcldnn-rml2018")
    assert entry["reduced"] == [] and entry["source"] == CFG["source"]


def test_the_harness_finds_the_cell_and_its_metrics():
    c = harness.load_cell(ROOT, CELL)
    assert c.cfg["family"] == "mcldnn" and c.traffic["kind"] == "serve"
    assert c.traffic == harness.load_cell(ROOT, "resnet-rml2018.bulk").traffic
    assert c.limits.keys() == {"max_logit_gap", "max_prob_err"}
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "serve_card_us_per_frame"}
    got = {m["name"] for m, _ in c.per_layer}
    resnet = {m["name"] for m, _ in harness.load_cell(ROOT, "resnet-rml2018.bulk").per_layer}
    assert got == {n for n in resnet if not n.startswith("resnet_")} | set(NEW)


def test_frame_work_is_the_count_of_the_published_shapes():
    """398,217,600 multiply-accumulates a frame at N = 1024: part A's convs
    145,417,600, the LSTMs 252,764,160 (133,693,440 of them the recurrent
    products), the head 35,840."""
    fam = common.family(CFG)
    convs = 2 * 1024 * 50 * 16 + 2 * 1024 * 50 * 8 + 2 * 1024 * 50 * 50 * 8 + 1020 * 100 * 100 * 10
    lstm = 1020 * 512 * (100 + 128) + 1020 * 512 * (128 + 128)
    assert (convs, lstm) == (145_417_600, 252_764_160)
    assert 2 * 1020 * 512 * 128 == 133_693_440
    assert fam.frame_work(CFG) == {"fp32_lane_ops": float(convs + lstm + 35_840)}
    assert fam.frame_work(CFG)["fp32_lane_ops"] == 398_217_600
    half = fam.frame_work(_cfg(512))["fp32_lane_ops"]
    assert half == (2 * 512 * 50 * (16 + 8 + 400) + 508 * (100 * 100 * 10 + 512 * 228 + 512 * 256)
                    + 35_840)


@pytest.mark.parametrize("frames", [40, 2100], ids=["one_block", "two_blocks"])
def test_the_family_is_the_reference(frames):
    cfg = _cfg(16)
    fam = common.family(cfg)
    pool = _pool(cfg, frames)
    p = fam.params(cfg, 23, "cpu")
    want = ref_mcldnn.mcldnn_params(cfg, 23, "cpu")
    assert p.keys() == want.keys() and all(torch.equal(p[k], want[k]) for k in p)

    std, state = fam.scaler(cfg, pool, p, "cpu")
    assert state is None and std.mean.shape == (1,)

    x = torch.view_as_real(torch.from_numpy(pool)).transpose(1, 2)
    got = {}
    for control, rnd in ((False, None), (True, ref_mcldnn.tf32)):
        got[control] = fam.reference_logits(cfg, p, state, pool, "cpu", control)
        assert got[control].dtype == torch.float32 and got[control].shape == (frames, 24)
        whole = ref_mcldnn.mcldnn_logits(p, x, rnd)
        assert float((got[control] - whole).abs().max()) <= 1e-6 * float(whole.abs().max())
    assert (got[True] - got[False]).abs().max() > 1e-4

    model = fam.program_model(cfg, p)
    assert model.frame_size == 16
    assert all(torch.equal(v, p[k]) for k, v in model.state_dict().items())


def test_the_seeded_weights_follow_the_keras_initialisers():
    p = ref_mcldnn.mcldnn_params(CFG, SEED, "cpu")
    for k in range(2):
        w_hh = p[f"lstm.weight_hh_l{k}"].double()
        assert torch.allclose(w_hh.T @ w_hh, torch.eye(128, dtype=torch.float64), atol=1e-5)
        assert not p[f"lstm.bias_ih_l{k}"].any()
        assert torch.equal(p[f"lstm.bias_hh_l{k}"],
                           torch.cat([torch.zeros(128), torch.ones(128), torch.zeros(256)]))
    # glorot-uniform: within sqrt(6 / (fan-in + fan-out)), and reaching near it
    for name, fans in (("conv_pair.weight", 50 * 8 + 50 * 8), ("lstm.weight_ih_l0", 100 + 512),
                       ("dense.0.weight", 256), ("conv_merge.weight", 1000 + 1000)):
        limit = (6 / fans) ** 0.5
        assert 0.95 * limit < float(p[name].abs().max()) <= limit
    assert not any(p[k].any() for k in p if k.endswith(".bias"))


def _readings(served: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The serve driver's two numbers for served logits against the
    reference's: the widest gap of the served class's logit below the
    best, and the largest error of a probability."""
    served, ref = served.double(), ref.double()
    ids = served.argmax(-1)
    gap = (ref.max(-1).values - ref.gather(1, ids[:, None])[:, 0]).max()
    err = (torch.softmax(served, -1) - torch.softmax(ref, -1)).abs().max()
    return {"max_logit_gap": float(gap), "max_prob_err": float(err)}


def _module_and_control(device) -> tuple[dict, dict]:
    """At the published widths and frame size on a batch of pool frames:
    the program's module's readings and the TF32 control's."""
    fam = common.family(CFG)
    pool = _pool(CFG, 48)
    p = fam.params(CFG, SEED, device)
    ref = fam.reference_logits(CFG, p, None, pool, device, False)
    model = fam.program_model(CFG, p).to(device).eval()
    with torch.inference_mode():
        served = model(torch.view_as_real(torch.from_numpy(pool)).transpose(1, 2)
                       .contiguous().to(device))
    return (_readings(served, ref),
            _readings(fam.reference_logits(CFG, p, None, pool, device, True), ref))


def test_the_module_reads_under_the_limits_and_its_tf32_control_above():
    sound, control = _module_and_control("cpu")
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


@pytest.fixture
def recorder(monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    records: list = []
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    return records


def test_the_enqueue_reader(recorder, monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    read = reader("mcldnn_enqueue_us_per_frame.serve")
    r = Readings({}, {"frames": 3000}, CFG)
    assert read(r) is None  # no MCLDNN span in the slice
    # a whole forward of 1000 frames and one of two chunks, 1200 and 800
    for frames in (1000, 1200, 800):
        recorder += [_span("amc.mcldnn.convs", 20.0, frames=frames),
                     _span("amc.mcldnn.lstm", 50.0, frames=frames, steps=1020),
                     _span("amc.mcldnn.head", 10.0, frames=frames)]
    recorder += [_span("amc.model", 900.0, frames=3000), _span("amc.chunk", 90.0, frames=1200)]
    assert read(r) == pytest.approx(3 * 80.0 / 3000)
    assert read(Readings({}, {"frames": 0}, CFG)) is None
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 1)
    assert read(r) is None


def test_the_chunk_reader(recorder, monkeypatch):
    from amcpy_tpu_torch.utils import metrics

    read = reader("mcldnn_chunk_frames.serve")
    r = Readings({}, {"frames": 30_000}, CFG)
    recorder.append(_span("amc.mcldnn.lstm", 50.0, frames=4000, steps=1020))
    assert read(r) is None  # every forward ran whole
    recorder += [_span("amc.chunk", 9.0, frames=f, index=i)
                 for i, f in enumerate((9000, 9000, 6000))]
    recorder += [_span("amc.chunk", 9.0, frames=f, index=i) for i, f in enumerate((9000, 100))]
    assert read(r) == pytest.approx(33_100 / 5)
    assert read(Readings({}, {"frames": 0}, CFG)) is None
    monkeypatch.setattr(metrics, "spans_dropped", lambda: 1)
    assert read(r) is None


def test_the_roofline_reader():
    read = reader("mcldnn_roofline.serve")
    kernels = {"conv": (40, 0.2), "lstm": (6, 0.5), "packing": (1, 0.001)}
    r = Readings({"kernels": kernels}, {"frames": 10_000}, CFG)
    least = 10_000 * 398_217_600 / (132 * 128 * 1.98e9)
    assert read(r) == pytest.approx(100 * least / 0.701)
    assert read(Readings({"kernels": {}}, {"frames": 10_000}, CFG)) is None
    assert read(Readings({"kernels": kernels}, {"frames": 0}, CFG)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_module_on_the_card_reads_under_the_limits_and_its_tf32_control_above(card):
    sound, control = _module_and_control(card)
    assert all(sound[k] <= LIMITS[k] for k in LIMITS), sound
    assert any(control[k] > LIMITS[k] for k in LIMITS), control


@pytest.mark.cuda
def test_the_traced_cell_prints_the_three_new_metrics_on_the_card(card):
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL,
                           "--seed", str(SEED), "--seconds", "6", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    m = out["metrics"]
    assert 0 < m["mcldnn_roofline.serve"]["value"] <= 100
    assert 0 < m["mcldnn_enqueue_us_per_frame.serve"]["value"]
    assert 0 < m["mcldnn_chunk_frames.serve"]["value"] <= 16_384
