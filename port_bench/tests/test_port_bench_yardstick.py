"""The benchmark's frozen yardstick on the CPU: the kernel bounds of
``PERF.md``, the traffic generator's seeding, and shares read from
synthetic traces.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import signals, trace, work
from port_bench.harness import Readings, _module

HOME = Path(__file__).resolve().parent.parent


def reader(metric: str):
    """The ``read`` of ``layer_metrics/<metric>.py``."""
    return _module(HOME / "layer_metrics" / f"{metric}.py", f"reader_{metric}").read

MLP = {"family": "mlp", "signals": {"frame_size": 2048, "modulations": ["a"] * 6},
       "features": {"used": [2, 4, 6, 8, 12, 14]}, "training": {"hidden_sizes": [26, 29, 30]}}
CNN = {"family": "cnn", "signals": {"frame_size": 2048, "modulations": ["a"] * 6},
       "model": {"channels": [32, 64, 128], "dense": 128}}


@pytest.mark.parametrize("b, n, want", [(4096, 2048, 0.0231), (128, 65536, 0.0268),
                                        (64, 131072, 0.0276), (256, 32768, 0.0261)])
def test_k1_bound_is_perf_md_s(b, n, want):
    ms, by = work.bound(*work.k1_work(b, n))
    assert round(ms, 4) == want and by == "operations"


def test_k3_bound_is_perf_md_s():
    ms, by, parts = work.k3_bound(4096, 2048)
    assert round(ms, 4) == 0.1737 and by == "operations"
    assert ms == parts["bf16_tensor_ops"]


def test_k2_bound_is_perf_md_s():
    assert round(work.bound(*work.k2_work(4096, 2048))[0], 4) == 0.0201


def test_mfu_work_of_a_4096_frame_request():
    """The worked example of ``PERF.md``: 4096 frames of 2048 samples."""
    mlp = work.scaled(work.serve_frame_work(MLP), 4096)
    assert mlp["fp32_lane_ops"] == pytest.approx(4096 * (188420 + 1960))
    assert work.least_seconds(mlp) == pytest.approx(7.7979e8 / work.FP32_LANE_OPS_PER_S, rel=1e-4)
    cnn = work.scaled(work.serve_frame_work(CNN), 4096)
    assert work.least_seconds(cnn) == pytest.approx(work.k3_bound_s(4096, 2048), rel=1e-12)
    train = work.mlp_train_sample_work(MLP)["fp32_lane_ops"]
    assert train == 1960 + 2 * 1960 - 6 * 26


def test_generator_repeats_for_a_seed_and_differs_between_seeds():
    mods = ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM", "WGN"]
    a, cls = signals.make_pool(2**31 + 11, 200, 64, mods, [-10, 0, 20])
    b, _ = signals.make_pool(2**31 + 11, 200, 64, mods, [-10, 0, 20])
    c, _ = signals.make_pool(2**31 + 12, 200, 64, mods, [-10, 0, 20])
    assert a.dtype == np.complex64 and a.shape == (200, 64)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(cls, np.arange(200) % 6)
    # a chunk is drawn alike whatever follows it
    d, _ = signals.make_pool(2**31 + 11, signals.CHUNK + 5, 64, mods, [-10, 0, 20])
    e, _ = signals.make_pool(2**31 + 11, signals.CHUNK + 9, 64, mods, [-10, 0, 20])
    assert np.array_equal(d[: signals.CHUNK], e[: signals.CHUNK])
    ds = signals.make_dataset(5, 7, 32, mods, [0, 10])
    assert ds["QPSK"].shape == (2, 7, 32)
    assert np.array_equal(ds["QPSK"], signals.make_dataset(5, 7, 32, mods, [0, 10])["QPSK"])
    # unit-power symbols: at 20 dB a PSK frame's power is about 1 + 0.01
    hi = a[(cls == 1) & (np.arange(200) // 6 % 3 == 2)]
    assert abs(np.mean(np.abs(hi) ** 2) - 1.01) < 0.05


def _trace(tmp_path, kernels, window_us, h2d=()):
    """A Chrome trace: kernel events ``(name, ts, dur)`` in microseconds, a
    host span over the window, and host-to-device copies ``(ts, dur,
    bytes)``."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "port_bench.classify",
           "ts": 0.0, "dur": window_us}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in kernels]
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
            "ts": ts, "dur": d, "args": {"bytes": nb}} for ts, d, nb in h2d]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.summarize(path)


@pytest.mark.parametrize("factor", [1.0, 1.5, 7.0])
def test_shares_from_a_synthetic_trace_stay_within_100(tmp_path, factor):
    """K1 takes ``factor`` times its bound for the slice's frames, the rest
    of the window idle: its roofline reads 100 / factor, the whole request's
    share less, and neither passes 100."""
    frames = 4096 * 3
    k1_us = work.k1_bound_s(frames, 2048) * 1e6 * factor
    per = k1_us / 3
    kernels = [("void fused_kernel<8, true>(float const*)", 100.0 + k * 1000, per)
               for k in range(3)]
    s = _trace(tmp_path, kernels, window_us=3000.0 + 100.0,
               h2d=[(50.0, 40.0, 4e6)])
    r = Readings(s, {"frames": frames, "dispatches": 3}, MLP)
    roof = reader("k1_roofline.serve")(r)
    assert roof == pytest.approx(100.0 / factor, rel=1e-9)
    assert reader("k1_roofline.extract")(r) == roof
    mfu = reader("serve_mfu")(r)
    assert 0 < mfu < roof <= 100.0
    assert reader("k3_roofline.serve")(r) is None  # no K3 in the slice: nothing read
    assert reader("h2d_gbps.serve")(r) == pytest.approx(4e6 / 40e-6 / 1e9)
    idle = reader("idle_share.serve")(r)
    assert idle == pytest.approx(100 * (1 - (k1_us + 40.0) / 3100.0))
    assert s["idle_gaps"][0][0] == "port_bench.classify"
    assert reader("frames_per_dispatch.serve")(r) == 4096


def test_a_share_never_reads_0_when_nothing_was_traced(tmp_path):
    s = _trace(tmp_path, [], window_us=100.0)
    r = Readings(s, {"frames": 0}, MLP)
    for path in sorted((HOME / "layer_metrics").glob("*.py")):
        assert reader(path.stem)(r) is None, path.name


def test_busy_time_is_the_union_of_device_intervals(tmp_path):
    s = _trace(tmp_path, [("k", 0.0, 10.0), ("k", 5.0, 10.0), ("k", 30.0, 5.0)], 50.0)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["window_s"] == pytest.approx(50e-6)
    assert s["kernels"]["k"][0] == 3
