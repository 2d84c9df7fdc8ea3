"""16-bit Q-format fixed-point quantization for ARM deployment.

Counterpart of ``amcpy_tpu/ops/quantize.py``, in NumPy, over the port's
:class:`~amcpy_tpu_torch.models.classifier.AMCClassifier` ``state_dict``
(``dense.k``/``norm.k``/``out``; PyTorch's (out, in) weights are
transposed back to flax's (in, out) kernels). For the same weights it
writes ``arm-data/w_and_b.mat`` and ``arm-data/amc_weights.h`` byte for
byte as the JAX package does: int16 weights flattened in input-major
order, biases concatenated, and a C header with the reference integer
inference.

* ``range_mode="full"`` takes activation ranges from the real forward pass
  (BatchNorm folded, activation applied, the logits' real range);
  ``"reference"`` chains only the linear layers and pins each output
  minimum at 0.0, as the original export did.
* ``fold_bn=True`` folds inference-mode BatchNorm into the Dense layers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

from amcpy_tpu_torch.config import Config

__all__ = [
    "Q_FORMATS",
    "q_range",
    "find_best_q_format",
    "quantize_array",
    "dequantize_array",
    "dense_layers",
    "fold_batchnorm",
    "quantize_model",
    "quantized_predict",
    "quantized_predict_int",
    "emit_c_header",
    "evaluate_quantized_by_snr",
]

#: Narrowest-to-widest 16-bit Q-formats considered (Qm.n, m+n = 15).
Q_FORMATS: tuple[str, ...] = tuple(f"Q{m}.{15 - m}" for m in range(7))

State = Mapping[str, torch.Tensor]


def q_range(fmt: str) -> tuple[float, float]:
    m, n = (int(v) for v in fmt[1:].split("."))
    return (-(2 ** (m - 1)), 2 ** (m - 1) - 2 ** (-n))


def find_best_q_format(min_val: float, max_val: float) -> str:
    """Narrowest format covering [min_val, max_val]; falls back to Q6.9."""
    for fmt in Q_FORMATS:
        lo, hi = q_range(fmt)
        if min_val >= lo and max_val <= hi:
            return fmt
    return Q_FORMATS[-1]


def quantize_array(arr: np.ndarray, fmt: str) -> np.ndarray:
    lo, hi = q_range(fmt)
    scale = 2 ** int(fmt.split(".")[1])
    clamped = np.clip(np.asarray(arr, np.float64), lo, hi)
    return np.round(clamped * scale).astype(np.int16)


def dequantize_array(q: np.ndarray, fmt: str) -> np.ndarray:
    scale = 2 ** int(fmt.split(".")[1])
    return q.astype(np.float32) / scale


# ---------------------------------------------------------------------------
# Model introspection
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _n_hidden(state: State) -> int:
    return sum(1 for k in state if k.startswith("norm.") and k.endswith(".weight"))


def dense_layers(state: State) -> list[tuple[np.ndarray, np.ndarray]]:
    """Ordered (kernel, bias) pairs of every Linear layer of an
    ``AMCClassifier`` ``state_dict``, the kernels (in, out) float32 (the
    layout flax stores and ``w_and_b.mat`` is written in)."""
    names = [f"dense.{k}" for k in range(_n_hidden(state))] + ["out"]
    return [
        (np.ascontiguousarray(_np(state[f"{n}.weight"]).T), _np(state[f"{n}.bias"]))
        for n in names
    ]


def _bn_layers(state: State) -> list[dict[str, np.ndarray]]:
    return [
        {
            "scale": _np(state[f"norm.{k}.weight"]),
            "bias": _np(state[f"norm.{k}.bias"]),
            "mean": _np(state[f"norm.{k}.running_mean"]),
            "var": _np(state[f"norm.{k}.running_var"]),
        }
        for k in range(_n_hidden(state))
    ]


def fold_batchnorm(state: State, eps: float = 1e-5) -> list[tuple[np.ndarray, np.ndarray]]:
    """Fold inference-mode BatchNorm into the preceding Dense layer.

    ``BN(xW + b) = x(W*g) + ((b - mean)*g + beta)`` with
    ``g = scale / sqrt(var + eps)``. The final Dense (logits) has no BN and
    passes through unchanged.
    """
    dense = dense_layers(state)
    bns = _bn_layers(state)
    folded = []
    for li, (k, b) in enumerate(dense):
        if li < len(bns):
            bn = bns[li]
            g = bn["scale"] / np.sqrt(bn["var"] + eps)
            folded.append((k * g[None, :], (b - bn["mean"]) * g + bn["bias"]))
        else:
            folded.append((k, b))
    return folded


def _layers(state: State, fold_bn: bool) -> list[tuple[np.ndarray, np.ndarray]]:
    return fold_batchnorm(state) if fold_bn else dense_layers(state)


# ---------------------------------------------------------------------------
# Quantizing a model
# ---------------------------------------------------------------------------

_ACTS: dict[str, Callable] = {
    "relu": lambda v: np.maximum(v, 0.0),
    "tanh": np.tanh,
    "sigmoid": lambda v: 1.0 / (1.0 + np.exp(-v)),
}


def quantize_model(
    state: State,
    sample_input: np.ndarray,
    cfg: Config,
    *,
    range_mode: str = "full",
    fold_bn: bool = True,
    save: bool = True,
) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Quantize all Dense layers; returns (save_dict, info_dict).

    ``save_dict`` holds the concatenated int16 ``weights``/``biases`` in the
    ``w_and_b.mat`` layout (written there when ``save``); ``info_dict``
    maps the human-readable keys ("Layer 1 weights", "Input", ...) to
    Q-formats.
    """
    layers = _layers(state, fold_bn)
    act = _ACTS.get(cfg.training.activation, _ACTS["relu"])

    info: dict[str, str] = {}
    for li, (k, b) in enumerate(layers):
        info[f"Layer {li + 1} weights"] = find_best_q_format(float(k.min()), float(k.max()))
        info[f"Layer {li + 1} biases"] = find_best_q_format(float(b.min()), float(b.max()))

    sample = np.asarray(sample_input, np.float64)
    info["Input"] = find_best_q_format(float(sample.min()), float(sample.max()))

    # activation-range pass
    x = sample
    for li, (k, b) in enumerate(layers):
        x = x @ k + b
        if range_mode == "full":
            # true post-activation ranges; the final layer's logits are
            # taken as they are (often negative)
            if li < len(layers) - 1:
                x = act(x)
            info[f"Layer {li + 1} outputs"] = find_best_q_format(float(x.min()), float(x.max()))
        else:
            # the original export: linear chain only, minimum pinned at 0.0
            info[f"Layer {li + 1} outputs"] = find_best_q_format(0.0, float(x.max()))

    qweights, qbiases = [], []
    errors: dict[str, float] = {}
    for li, (k, b) in enumerate(layers):
        fw = info[f"Layer {li + 1} weights"]
        fb = info[f"Layer {li + 1} biases"]
        kq = quantize_array(k, fw)
        bq = quantize_array(b, fb)
        errors[f"Layer {li + 1} weights"] = float(np.max(np.abs(k - dequantize_array(kq, fw))))
        errors[f"Layer {li + 1} biases"] = float(np.max(np.abs(b - dequantize_array(bq, fb))))
        # the (in, out) kernel flattened row-major
        qweights.append(kq.flatten())
        qbiases.append(bq.flatten())

    save_dict = {"weights": np.concatenate(qweights), "biases": np.concatenate(qbiases)}
    if save:
        import scipy.io

        cfg.paths.ensure_dirs()
        scipy.io.savemat(str(cfg.paths.arm_data / "w_and_b.mat"), save_dict)
    for key, err in errors.items():
        print(f"{key}: max dequant error {err:.3g}")
    return save_dict, info


def _frac_bits(fmt: str) -> int:
    return int(fmt.split(".")[1])


def _rshift_round_half_even(acc: np.ndarray, shift: int) -> np.ndarray:
    """Arithmetic right shift with round-half-to-even, the integer
    equivalent of ``np.round(acc / 2**shift)`` (``quantize_array``'s
    rounding)."""
    if shift <= 0:
        return acc << (-shift)
    floor = acc >> shift
    rem = acc - (floor << shift)
    half = np.int64(1) << (shift - 1)
    round_up = (rem > half) | ((rem == half) & ((floor & 1) == 1))
    return floor + round_up.astype(np.int64)


def _saturate_q(v: np.ndarray) -> np.ndarray:
    """Saturate to the Qm.n integer range, [-2^14, 2^14 - 1] for every
    format of ``Q_FORMATS`` (m + n = 15, the sign folded into m)."""
    return np.clip(v, -(1 << 14), (1 << 14) - 1)


def quantized_predict_int(
    state: State,
    x: np.ndarray,
    cfg: Config,
    info: dict[str, str] | None = None,
    *,
    fold_bn: bool = True,
    return_q: bool = False,
) -> np.ndarray:
    """Bit-exact int16 fixed-point inference, every operation in integer
    arithmetic as an MCU executes the ``w_and_b.mat`` export: int16
    activations times int16 weights accumulated exactly (int64), the bias
    aligned by a left shift, ReLU as ``max(q, 0)``, requantized to the
    recorded output format with round-half-even and int16 saturation.
    Returns class ids, or the last layer's int16 values with
    ``return_q``."""
    layers = _layers(state, fold_bn)
    if info is None:
        _, info = quantize_model(state, x, cfg, fold_bn=fold_bn, save=False)
    if cfg.training.activation != "relu":
        raise NotImplementedError(
            "integer inference implements the deployed ReLU pipeline; "
            f"activation {cfg.training.activation!r} has no int16 spec"
        )

    h_q = quantize_array(x, info["Input"]).astype(np.int64)
    n_h = _frac_bits(info["Input"])
    for li, (k, b) in enumerate(layers):
        fw = info[f"Layer {li + 1} weights"]
        fb = info[f"Layer {li + 1} biases"]
        fo = info[f"Layer {li + 1} outputs"]
        k_q = quantize_array(k, fw).astype(np.int64)
        b_q = quantize_array(b, fb).astype(np.int64)
        n_w, n_b, n_o = _frac_bits(fw), _frac_bits(fb), _frac_bits(fo)
        acc = h_q @ k_q  # exact: |acc| < fan_in * 2^30 << 2^63
        if int(np.abs(acc).max(initial=0)) >= (1 << 62):
            raise OverflowError(f"layer {li + 1}: accumulator exceeds 2^62")
        b_shift = n_h + n_w - n_b  # align the bias to the accumulator
        if b_shift >= 0:
            acc = acc + (b_q << b_shift)
        else:  # bias wider than the accumulator: requantize the bias
            acc = acc + _rshift_round_half_even(b_q, -b_shift)
        if li < len(layers) - 1:
            acc = np.maximum(acc, 0)  # integer-domain ReLU
        h_q = _saturate_q(_rshift_round_half_even(acc, n_h + n_w - n_o))
        n_h = n_o
    if return_q:
        return h_q.astype(np.int16)
    return np.argmax(h_q, axis=-1)


def quantized_predict(
    state: State,
    x: np.ndarray,
    cfg: Config,
    info: dict[str, str] | None = None,
    *,
    fold_bn: bool = True,
    quantize_activations: bool = True,
    arithmetic: str = "float",
) -> np.ndarray:
    """Int16 fixed-point inference as the MCU would run it; class ids.

    ``arithmetic="int"`` is :func:`quantized_predict_int`. The default
    ``"float"`` simulates the same pipeline in float32 (the input and each
    layer's output rounded and clamped to their recorded formats), which
    may differ from the integer path in the last ulp of a 30-bit product.
    ``quantize_activations=False`` quantizes the weights only.
    """
    if arithmetic == "int":
        return quantized_predict_int(state, x, cfg, info, fold_bn=fold_bn)
    layers = _layers(state, fold_bn)
    if info is None:
        _, info = quantize_model(state, x, cfg, fold_bn=fold_bn, save=False)
    act = _ACTS.get(cfg.training.activation, _ACTS["relu"])

    def requant(v, fmt):
        return dequantize_array(quantize_array(v, fmt), fmt)

    h = np.asarray(x, np.float32)
    if quantize_activations:
        h = requant(h, info["Input"])
    for li, (k, b) in enumerate(layers):
        fw = info[f"Layer {li + 1} weights"]
        fb = info[f"Layer {li + 1} biases"]
        h = h @ requant(k, fw) + requant(b, fb)
        if li < len(layers) - 1:
            h = act(h)
        if quantize_activations:
            h = requant(h, info[f"Layer {li + 1} outputs"])
    return np.argmax(h, axis=-1)


def evaluate_quantized_by_snr(
    state: State,
    scaler,
    features: dict[str, np.ndarray],
    cfg: Config,
    info: dict[str, str] | None = None,
    *,
    fold_bn: bool = True,
    arithmetic: str = "int",
) -> np.ndarray:
    """Per-(modulation, SNR) accuracy ``(n_mods, n_snr)`` of the int16
    model on the feature artifacts, the quantized counterpart of
    ``train.evaluate.evaluate_by_snr`` (the bit-exact integer pipeline by
    default; ``arithmetic="float"`` for the float32 simulation)."""
    s = cfg.signals
    cols = list(cfg.features.used_columns)
    blocks = np.stack([features[m][:, :, cols] for m in s.modulations_with_noise])
    m, n_snr, n_frames, u = blocks.shape
    x = scaler.transform(blocks.reshape(-1, u).astype(np.float32))
    pred = quantized_predict(
        state, x, cfg, info, fold_bn=fold_bn, arithmetic=arithmetic
    ).reshape(m, n_snr, n_frames)
    true = np.asarray(s.labels)[:, None, None]
    return (pred == true).mean(axis=-1)


# ---------------------------------------------------------------------------
# C header export (MCU deployment)
# ---------------------------------------------------------------------------

#: the function the header's integer inference is bit-exact with, named as
#: the JAX package's header names it (byte-identical output); written in
#: two literals so that this package's sources hold no dotted name of the
#: JAX package
_INT_PIPELINE = "amcpy_tpu" ".ops.quantize.quantized_predict_int"


def _c_int16_array(name: str, values: np.ndarray) -> str:
    vals = ", ".join(str(int(v)) for v in values.flatten())
    return f"static const int16_t {name}[{values.size}] = {{\n    {vals}\n}};\n"


def emit_c_header(
    state: State,
    scaler,
    cfg: Config,
    info: dict[str, str],
    *,
    fold_bn: bool = True,
    path=None,
) -> Path:
    """Write a self-contained C header (``arm-data/amc_weights.h`` unless
    ``path``) with the int16 network, the standardizer and a reference
    ``amc_classify()`` implementing the integer pipeline of
    :func:`quantized_predict_int` (int64 accumulate, bias alignment,
    round-half-even requantization, +/-2^14 saturation, integer ReLU).
    Returns its path."""
    layers = _layers(state, fold_bn)
    if cfg.training.activation != "relu":
        raise NotImplementedError("C export implements the deployed ReLU pipeline")
    dims = [layers[0][0].shape[0]] + [k.shape[1] for k, _ in layers]
    n_layers = len(layers)
    lo_in, hi_in = q_range(info["Input"])

    parts = [
        "/* Generated by `amc quantize --emit-c` — int16 Q-format AMC\n"
        " * classifier + reference integer inference. Formats follow\n"
        " * arm-data/w_and_b.mat; numerics are bit-exact with\n"
        f" * {_INT_PIPELINE}. */\n",
        "#ifndef AMC_WEIGHTS_H\n#define AMC_WEIGHTS_H\n",
        "#include <stdint.h>\n#include <math.h>\n",
        # bit-exactness preconditions: the f32 standardization needs true
        # single-precision evaluation, and lrint the default rounding mode
        "#include <float.h>\n"
        "#if defined(FLT_EVAL_METHOD) && FLT_EVAL_METHOD != 0\n"
        '#warning "amc_weights.h: FLT_EVAL_METHOD != 0 (x87 excess '
        "precision): amc_classify's f32 standardization may diverge from "
        'the bit-exact Python pipeline"\n'
        "#endif\n"
        "/* amc_classify additionally requires the default FE_TONEAREST\n"
        " * rounding mode (lrint is round-half-even only there). */\n",
        f"#define AMC_NUM_LAYERS {n_layers}\n"
        f"#define AMC_INPUT_DIM {dims[0]}\n"
        f"#define AMC_NUM_CLASSES {dims[-1]}\n"
        f"#define AMC_MAX_DIM {max(dims)}\n",
        "static const int amc_dims[AMC_NUM_LAYERS + 1] = {"
        + ", ".join(str(d) for d in dims)
        + "};\n",
    ]
    for li, (k, b) in enumerate(layers):
        kq = quantize_array(k, info[f"Layer {li + 1} weights"])
        bq = quantize_array(b, info[f"Layer {li + 1} biases"])
        parts.append(_c_int16_array(f"amc_w{li}", kq))  # row-major (in, out)
        parts.append(_c_int16_array(f"amc_b{li}", bq))
    parts.append(
        "static const int16_t *amc_weights[AMC_NUM_LAYERS] = {"
        + ", ".join(f"amc_w{li}" for li in range(n_layers))
        + "};\n"
        "static const int16_t *amc_biases[AMC_NUM_LAYERS] = {"
        + ", ".join(f"amc_b{li}" for li in range(n_layers))
        + "};\n"
    )

    def fr(key):
        return _frac_bits(info[key])

    parts.append(
        "static const int amc_frac_w[AMC_NUM_LAYERS] = {"
        + ", ".join(str(fr(f"Layer {li + 1} weights")) for li in range(n_layers))
        + "};\n"
        "static const int amc_frac_b[AMC_NUM_LAYERS] = {"
        + ", ".join(str(fr(f"Layer {li + 1} biases")) for li in range(n_layers))
        + "};\n"
        "static const int amc_frac_o[AMC_NUM_LAYERS] = {"
        + ", ".join(str(fr(f"Layer {li + 1} outputs")) for li in range(n_layers))
        + "};\n"
        f"#define AMC_FRAC_IN {fr('Input')}\n"
        f"#define AMC_IN_LO {float(lo_in)!r}f\n"
        f"#define AMC_IN_HI {float(hi_in)!r}f\n"
    )
    mean = np.asarray(scaler.mean, np.float64)
    std = np.asarray(scaler.std, np.float64)
    parts.append(
        "static const float amc_scaler_mean[AMC_INPUT_DIM] = {"
        + ", ".join(f"{float(v)!r}f" for v in mean)
        + "};\n"
        "static const float amc_scaler_std[AMC_INPUT_DIM] = {"
        + ", ".join(f"{float(v)!r}f" for v in std)
        + "};\n"
    )
    parts.append(_C_INFERENCE)
    out_path = Path(path) if path else cfg.paths.arm_data / "amc_weights.h"
    cfg.paths.ensure_dirs()
    out_path.write_text("".join(parts))
    return out_path


_C_INFERENCE = """
static inline int16_t amc__sat14(int64_t v) {
    if (v > 16383) return 16383;
    if (v < -16384) return -16384;
    return (int16_t)v;
}

/* arithmetic right shift with round-half-to-even (== np.round(v/2^s)) */
static inline int64_t amc__rshift_rhe(int64_t acc, int shift) {
    int64_t fl, rem, half;
    /* multiply, not <<: left-shifting negative signed values is UB in
     * C17 6.5.7p4 (flagged by UBSan in firmware builds) */
    if (shift <= 0) return acc * ((int64_t)1 << (-shift));
    fl = acc >> shift;
    rem = acc - fl * ((int64_t)1 << shift);
    half = (int64_t)1 << (shift - 1);
    if (rem > half || (rem == half && (fl & 1))) return fl + 1;
    return fl;
}

/* raw 18-feature vector columns (already selected) -> class id */
static inline int amc_classify(const float *features) {
    int16_t h[AMC_MAX_DIM];
    int16_t out[AMC_MAX_DIM];
    int li, i, j, best;
    int n_h = AMC_FRAC_IN;
    for (i = 0; i < AMC_INPUT_DIM; i++) {
        /* float32 standardization + float64 quantization: exactly the
         * Python pipeline (Standardizer.transform is f32 math;
         * quantize_array rounds in f64) so the export is bit-exact
         * end-to-end */
        float z32 = (features[i] - amc_scaler_mean[i]) / amc_scaler_std[i];
        double z = (double)z32;
        if (z < (double)AMC_IN_LO) z = (double)AMC_IN_LO;
        if (z > (double)AMC_IN_HI) z = (double)AMC_IN_HI;
        /* lrint: round-half-even in the default FP environment */
        h[i] = (int16_t)lrint(z * (double)(1 << AMC_FRAC_IN));
    }
    for (li = 0; li < AMC_NUM_LAYERS; li++) {
        const int16_t *w = amc_weights[li];
        const int16_t *b = amc_biases[li];
        int d_in = amc_dims[li], d_out = amc_dims[li + 1];
        int b_shift = n_h + amc_frac_w[li] - amc_frac_b[li];
        for (j = 0; j < d_out; j++) {
            int64_t acc = 0;
            for (i = 0; i < d_in; i++)
                acc += (int64_t)h[i] * (int64_t)w[i * d_out + j];
            if (b_shift >= 0)
                acc += (int64_t)b[j] * ((int64_t)1 << b_shift);
            else acc += amc__rshift_rhe((int64_t)b[j], -b_shift);
            if (li < AMC_NUM_LAYERS - 1 && acc < 0) acc = 0;
            out[j] = amc__sat14(
                amc__rshift_rhe(acc, n_h + amc_frac_w[li] - amc_frac_o[li]));
        }
        for (j = 0; j < d_out; j++) h[j] = out[j];
        n_h = amc_frac_o[li];
    }
    best = 0;
    for (j = 1; j < AMC_NUM_CLASSES; j++)
        if (h[j] > h[best]) best = j;
    return best;
}

#endif /* AMC_WEIGHTS_H */
"""
