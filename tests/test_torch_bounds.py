"""The yardsticks ``chip_smoke.py`` holds the kernels against, checked on
the CPU: the arithmetic of each kernel's bound (bytes over the memory rate,
bf16 products over the tensor-core rate, FP32 work in lane operations over
132 SMs x 128 lanes x 1.98 GHz), and the reading of ptxas's report.
``chip_smoke.py`` imports only numpy and the benchmark's yardstick
(``port_bench/work.py``, whose functions it uses) at module level, so it
imports here without a card.
"""

import numpy as np
import pytest

import chip_smoke as cs

B, N = 4096, 2048
SAMPLES = B * N


def test_fp32_lane_rate():
    """One issue slot per lane and cycle: half the data sheet's 67 TFLOP/s,
    which counts an FMA as two operations."""
    assert cs.FP32_LANE_OPS_PER_S == pytest.approx(33.45408e12, rel=1e-9)


def test_k3_bound_parts_and_which_binds():
    """At 4096 x 2048 on the default stack (2, 32, 64, 128): 67 MB of
    planes, 20,480 tensor-core operations a sample, and 500 FP32 lane
    operations a sample (RMS 4, layer 0 two FMAs on each of 32 channels,
    ReLU-with-rounding of 32 + 64 values two at a time, the last layer's
    ReLU, sum and max on 128 channels). The tensor cores bind."""
    ms, by, parts = cs.k3_bound(B, N)
    weights = 4 * (32 * 3 + 64 * 33 + 128 * 65)
    want_bytes = (8 * SAMPLES + 8 * B * 128 + weights) / 3.35e12 * 1e3
    want_tensor = SAMPLES * 2 * (32 * 64 + 64 * 128) / 989e12 * 1e3
    want_fp32 = SAMPLES * (4 + 64 + 48 + 384) / (132 * 128 * 1.98e9) * 1e3
    assert parts == pytest.approx(
        {"bytes": want_bytes, "bf16_tensor_ops": want_tensor, "fp32_lane_ops": want_fp32},
        rel=1e-12,
    )
    assert parts["bytes"] == pytest.approx(0.0213, abs=1e-4)
    assert parts["bf16_tensor_ops"] == pytest.approx(0.1737, abs=1e-4)
    assert parts["fp32_lane_ops"] == pytest.approx(0.1254, abs=1e-4)
    assert (ms, by) == (parts["bf16_tensor_ops"], "operations")


def test_k1_and_k2_bounds():
    """K1: the statistics' 59 lane operations a sample, the split-radix
    FFT's real additions, 3 N log2 N - 3 N + 4 (30 a sample and 4 a frame at
    N = 2048, below the 38 of all its real operations and the 44 of radix-2
    butterflies with every twiddle product counted), and |X|^2 with its
    maximum 3: 92 a sample, which binds over the bytes. K2: the statistics
    alone, below its bytes."""
    k1_ms, k1_by = cs.bound(*cs.k1_work(B, N))
    assert k1_by == "operations"
    want_ops = SAMPLES * (59 + 30 + 3) + 4 * B
    assert k1_ms == pytest.approx(want_ops / cs.FP32_LANE_OPS_PER_S * 1e3, rel=1e-12)
    assert k1_ms == pytest.approx(0.02307, abs=1e-5)
    assert k1_ms > (8 * SAMPLES + 72 * B + 8 * N) / 3.35e12 * 1e3
    k2_ms, k2_by = cs.bound(*cs.k2_work(B, N))
    assert k2_by == "bytes"
    assert k2_ms == pytest.approx((8 * SAMPLES + 72 * B) / 3.35e12 * 1e3, rel=1e-12)
    assert SAMPLES * cs.STATS_LANE_OPS_PER_SAMPLE / cs.FP32_LANE_OPS_PER_S * 1e3 < k2_ms


@pytest.mark.parametrize("n", [1000, 88])
def test_k1_work_grows_with_log_n(n):
    nbytes, ops = cs.k1_work(3, n)
    assert nbytes == 8.0 * 3 * n + 72.0 * 3 + 8.0 * n
    assert ops == pytest.approx(3 * (59 * n + 3 * n * np.log2(n) - 3 * n + 4 + 3 * n))


LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112trunk_kernelEPKfS1_NS_5StackENS_6LayoutEPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112trunk_kernelEPKfS1_NS_5StackENS_6LayoutEPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 117 registers, used 1 barriers, 920 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12wg18trunk_wgmma_kernelEPKfS2_S2_S2_S2_S2_S2_S2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12wg18trunk_wgmma_kernelEPKfS2_S2_S2_S2_S2_S2_S2_Pfii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 26240 bytes smem, 456 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    report = cs.ptxas_report(LOG)
    assert list(report.values()) == [
        {"spill_stores": 0, "spill_loads": 0, "registers": 117},
        {"spill_stores": 12, "spill_loads": 16, "registers": 232},
    ]
    assert [e for e in report if "trunk_wgmma_kernel" in e] == [list(report)[1]]


def test_k3_checks_cover_both_kernels():
    """The smoke holds both of K3's kernels against the plain version:
    the default stack at the main path's shapes, ragged and shorter than a
    tile, and one other stack."""
    from amcpy_tpu_torch.ops.cnn_infer import trunk_path

    paths = [trunk_path(w) for w, _ in cs.K3_CHECKS]
    assert set(paths) == {"wgmma", "mma_sync"}
    default = [shape for w, shape in cs.K3_CHECKS if w == cs.CNN_WIDTHS]
    assert (4096, 2048) in default
    assert any(n % 64 for _, n in default) and any(n < 64 for _, n in default)


def test_k2_checks_cover_both_paths():
    """The smoke holds both of K2's routes against the plain version: the
    main path's 4096 x 2048 and a frame that is not a multiple of 4 (the
    scalar loads) on the warpgroup route, frames past 2048 samples on the
    block route."""
    from amcpy_tpu_torch.ops.pallas_features import stats_path

    paths = {stats_path(n) for _, n in cs.K2_CHECKS}
    assert paths == {"warpgroup", "block"}
    assert (4096, 2048) in cs.K2_CHECKS
    warpgroup = [(b, n) for b, n in cs.K2_CHECKS if stats_path(n) == "warpgroup"]
    assert any(n % 4 for _, n in warpgroup)
    assert any(b % 2 for b, _ in warpgroup)  # a ragged last block of two frames
    assert any(n == 2049 for _, n in cs.K2_CHECKS)

