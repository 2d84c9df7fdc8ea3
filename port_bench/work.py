"""The benchmark's frozen yardstick: peaks, and the work a frame or a step
needs, counted from shapes.

The kernel counts are copies of ``chip_smoke.py``'s ``k1_work``,
``k2_work``, ``k3_work``, ``bound`` and ``k3_bound`` with its peaks; they
give ``PERF.md``'s bounds (K1 0.0231 ms at 4096 x 2048, K3 0.1737 ms, K1's
cluster route 0.0268 ms at 128 x 65536). They live here so that the program
may change and the yardstick may not.

The ``mfu`` metrics count the work the model needs, whatever implements it,
in units with one peak each:

* ``fp32_lane_ops``: FP32 work outside the tensor cores, one issue slot on
  one of an SM's 128 FP32 lanes (a multiply and the add it feeds are one
  fused multiply-add), at ``FP32_LANE_OPS_PER_S``. K1's statistics and
  FFT, K3's float32 steps, and the float32 products of the MLP and of the
  CNN's head (one lane operation a multiply-accumulate) count here;
* ``bf16_tensor_flop``: K3's products after its first layer on the bf16
  tensor cores, two operations a multiply-accumulate, at
  ``BF16_TENSOR_FLOP_PER_S``.

The least time the card's peaks allow for a set of work is the largest of
its units' times (the units run side by side); :func:`least_seconds`.
"""

from __future__ import annotations

import math

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
#: 132 SMs x 128 FP32 lanes x 1.98 GHz; a fused multiply-add is one lane
#: operation (the data sheet's 67 TFLOP/s counts it as two)
FP32_LANE_OPS_PER_S = 132 * 128 * 1.98e9
#: the fewest lane operations per sample the 17 statistics need (see
#: ``chip_smoke.py``: amplitude 3, phase 2, means and max 4, centred phase
#: sums 4, normalized amplitude 4 and its centred sums 6, phase step 6 and
#: its centred sums 4, the mixed moments' powers and sums 26)
STATS_LANE_OPS_PER_SAMPLE = 59
#: the CNN's default widths: I/Q in, then IQConvNet's (32, 64, 128)
CNN_WIDTHS = (2, 32, 64, 128)

PEAKS = {"fp32_lane_ops": FP32_LANE_OPS_PER_S,
         "bf16_tensor_flop": BF16_TENSOR_FLOP_PER_S}


def k1_work(b: int, n: int) -> tuple[float, float]:
    """(bytes, FP32 lane operations) the fused kernel's function needs on a
    (b, n) batch: I and Q read once, 18 floats written a frame, one table of
    N complex twiddles; the statistics, and gamma_max as an FFT (the
    split-radix FFT's 3 N log2 N - 3 N + 4 real additions) followed by
    |X|^2 and its maximum (3 N)."""
    nbytes = 8.0 * b * n + 72.0 * b + 8.0 * n
    fft = 3.0 * n * math.log2(n) - 3.0 * n + 4.0
    ops = b * (STATS_LANE_OPS_PER_SAMPLE * n + fft + 3.0 * n)
    return nbytes, ops


def k2_work(b: int, n: int) -> tuple[float, float]:
    """(bytes, FP32 lane operations) of the statistics kernel on (b, 2, n)."""
    return 8.0 * b * n + 72.0 * b, float(b) * n * STATS_LANE_OPS_PER_SAMPLE


def bound(nbytes: float, lane_ops: float) -> tuple[float, str]:
    """(ms, what binds) of a kernel that moves ``nbytes`` and does
    ``lane_ops`` FP32 lane operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lane_ops / FP32_LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_work(b: int, n: int, widths=CNN_WIDTHS) -> tuple[float, float, float]:
    """(bytes, bf16 tensor-core operations, FP32 lane operations) of the
    CNN trunk on (b, n) planes: I and Q read once, 2 C_out floats written a
    frame, the folded weights read once; the products after the first
    layer; per sample the RMS (4), layer 0 (two FMAs a channel), the ReLU
    and bf16 rounding of each layer that feeds the tensor cores (one
    conversion per two values) and the last layer's ReLU, sum and max (3 a
    channel)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 8.0 * b * n + 8.0 * b * widths[-1] + 4.0 * sum(o * (i + 1) for i, o in pairs)
    tensor = float(b) * n * sum(2.0 * o * i for i, o in pairs[1:])
    fp32 = float(b) * n * (4 + 2 * widths[1] + sum(widths[1:-1]) / 2 + 3 * widths[-1])
    return nbytes, tensor, fp32


def k3_bound(b: int, n: int, widths=CNN_WIDTHS) -> tuple[float, str, dict[str, float]]:
    """(ms, what binds, the three times) of :func:`k3_work`."""
    nbytes, tensor, fp32 = k3_work(b, n, widths)
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "bf16_tensor_ops": tensor / BF16_TENSOR_FLOP_PER_S * 1e3,
             "fp32_lane_ops": fp32 / FP32_LANE_OPS_PER_S * 1e3}
    ms = max(parts.values())
    return ms, "bytes" if ms == parts["bytes"] else "operations", parts


def k1_bound_s(frames: int, n: int) -> float:
    """Least seconds of K1's work on ``frames`` frames of ``n`` samples."""
    return bound(*k1_work(frames, n))[0] / 1e3


def k3_bound_s(frames: int, n: int, widths=CNN_WIDTHS) -> float:
    """Least seconds of K3's work on ``frames`` frames of ``n`` samples."""
    return k3_bound(frames, n, widths)[0] / 1e3


def dense_macs(widths) -> int:
    """Multiply-accumulates of a dense stack of ``widths`` a row."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_widths(cfg: dict) -> list[int]:
    """The feature MLP's widths: used features, hidden sizes, classes."""
    return [len(cfg["features"]["used"]), *cfg["training"]["hidden_sizes"],
            len(cfg["signals"]["modulations"])]


def cnn_widths(cfg: dict) -> tuple[int, ...]:
    return (2, *cfg["model"]["channels"])


def head_widths(cfg: dict) -> list[int]:
    """The CNN's dense head: pooled mean and max, hidden, classes."""
    return [2 * cfg["model"]["channels"][-1], cfg["model"]["dense"],
            len(cfg["signals"]["modulations"])]


def serve_frame_work(cfg: dict) -> dict[str, float]:
    """Model work of classifying one frame, by unit: the ``frame_work`` of
    ``cfg``'s family (``families/<family>.py``)."""
    from port_bench.common import family

    return family(cfg).frame_work(cfg)


def extract_frame_work(cfg: dict) -> dict[str, float]:
    """Model work of extracting one frame's 18 features (K1's count)."""
    return {"fp32_lane_ops": k1_work(1, cfg["signals"]["frame_size"])[1]}


def mlp_train_sample_work(cfg: dict) -> dict[str, float]:
    """Model work of one training sample of the MLP: the forward products,
    and backward the weights' gradients of every layer and the inputs'
    gradients of every layer but the first (the features need none)."""
    widths = mlp_widths(cfg)
    fwd = dense_macs(widths)
    first = widths[0] * widths[1]
    return {"fp32_lane_ops": float(fwd + 2 * fwd - first)}


def mlp_eval_sample_work(cfg: dict) -> dict[str, float]:
    """Model work of one evaluated sample of the MLP: the forward products."""
    return {"fp32_lane_ops": float(dense_macs(mlp_widths(cfg)))}


def scaled(work: dict[str, float], count: float) -> dict[str, float]:
    return {unit: v * count for unit, v in work.items()}


def added(*works: dict[str, float]) -> dict[str, float]:
    out: dict[str, float] = {}
    for w in works:
        for unit, v in w.items():
            out[unit] = out.get(unit, 0.0) + v
    return out


def least_seconds(work: dict[str, float]) -> float:
    """The least time the card's peaks allow for ``work``: the largest of
    its units' times, each unit at its own peak."""
    return max(v / PEAKS[unit] for unit, v in work.items())


def share_pct(least_s: float, measured_s: float) -> float | None:
    """``least_s`` over ``measured_s`` in percent; None when either is not
    positive (nothing was read)."""
    if not (least_s > 0 and measured_s > 0):
        return None
    return 100.0 * least_s / measured_s


def window_share_pct(summary: dict, work: dict[str, float]) -> float | None:
    """The least time of ``work`` over a trace's window, in percent, where
    the device ran anything in it (a trace without device activity holds
    no share of a device's peak); None otherwise."""
    if summary.get("busy_s", 0.0) <= 0:
        return None
    return share_pct(least_seconds(work), summary.get("window_s", 0.0))
