"""The k=8 CNN's training on the card against the same training on the CPU.

The CNN record's k=8 control arm (``kernel_sizes=(8, 8, 8)``,
``strides=(2, 2, 2)``, default widths) is the one training route of the
port that takes PyTorch's strided ``F.conv1d`` (cuDNN on the card; the k=1
stacks take ``torch.matmul``). This script trains it from the same weights
on the same batches on both devices, 30 RMSprop steps at the config's lr
(1.418e-3), batch 128, frames of 512 samples, dropout 0, in float32 and in
bfloat16, and holds the card to the CPU after every step.

A CNN run at this learning rate is chaotic (``tests/test_torch_cnn_trajectory.py``):
runs that differ by roundoff part within a few steps, so the bars are
measured, step by step. Each device also runs the same steps twice more:
from the weights and frames moved by 2^-20 of themselves (the data-free
conv biases at +-lr), and with the rows of every batch permuted (the same
sums in another order). At step t the spread is the largest gap of those
four runs to their device's plain run at any step up to t (a loss gap can
cross zero at one step: the envelope keeps the bar from dipping there),
and the card passes where its gap to the CPU is at most ``SPREAD`` (4)
times the spread or the floor, at every step:

* the loss, floor 1e-5 in float32 and 5e-3 in bf16;
* every weight tensor's root-mean-square gap (the data-free conv biases
  and the running means left out: ROADMAP C-watch 10), floor ``rtol x
  rms(w) + atol`` with float32's (1e-5, 1e-6) and bf16's (1e-3, 6e-4).
  RMSprop's first step moves each weight by ten learning rates either way,
  so a weight whose gradient roundoff can flip moves a whole 20 lr: the
  largest element's gap is the same for a fault and for roundoff, the
  mean square is not;
* every weight's gradient of the step (those of the data-free conv biases
  left out), its rms gap over its own rms, floor the weights' rtol. The
  weights after RMSprop's first step keep only the gradient's signs; the
  gradient itself shows how far the convolution and its backward agree
  while both devices still hold the same weights.

After the run each conv layer's max |bias| on the card lies within
``BIAS_FACTOR`` (4) of the CPU runs' span (``[min / 4 - lr, max x 4 +
lr]``) and no channel's bias reaches the std of its product on either
device (``conv_bias_report``).

The bars are shown to catch a wrong convolution: ``PLANTS`` are faults
planted in the card's strided convolution for one more card run
(``kernels``: every kernel flipped in time, the forward and so its
gradients; ``weight_grad``: the weights' gradient flipped in time, the
forward right), each held to the same bars, where it must fail.

``chip_smoke.py`` phase 16 and ``tests/test_torch_cuda.py::
test_wide_stack_training_on_card_matches_cpu`` call :func:`card_vs_cpu`.

    python3 scripts/torch_training_card_vs_cpu.py [--out card_vs_cpu.json]

Prints one JSON line per dtype and exits 1 where the card passes a bar, a
planted fault passes them all, or there is no card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

#: the k=8 control arm's stack (``scripts/torch_cnn_wide_control.py``)
WIDE = {"kernel_sizes": (8, 8, 8), "strides": (2, 2, 2)}
SPREAD = 4.0
BIAS_FACTOR = 4.0
NUDGE = 2.0**-20
#: (loss atol, (weights rtol, atol)) where the measured spread is smaller
FLOOR = {"float32": (1e-5, (1e-5, 1e-6)), "bfloat16": (5e-3, (1e-3, 6e-4))}
#: faults planted in the strided convolution of one card run each
PLANTS = ("kernels", "weight_grad")


def frames(count: int, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``count`` planar frames of six classes (BPSK, QPSK, 8PSK, 16QAM,
    64QAM at a random phase plus AWGN at U(5, 20) dB, and white noise) and
    their labels, from numpy."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 6, count)
    x = np.empty((count, n), np.complex128)
    for i, c in enumerate(y):
        if c < 3:
            m = 2 << c
            s = np.exp(2j * np.pi * rng.integers(0, m, n) / m)
        elif c < 5:
            m = 4 if c == 3 else 8
            s = (2 * rng.integers(0, m, n) - m + 1) + 1j * (2 * rng.integers(0, m, n) - m + 1)
            s /= np.sqrt(np.mean(np.abs(s) ** 2))
        else:
            s = np.zeros(n)
        sigma = np.sqrt(10 ** (-rng.uniform(5, 20) / 10) / 2) if c < 5 else np.sqrt(0.5)
        x[i] = s * np.exp(2j * np.pi * rng.uniform()) + sigma * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([x.real, x.imag], axis=1).astype(np.float32), y.astype(np.int64)


def nudged(a: np.ndarray, seed: int) -> np.ndarray:
    """``a`` with each value moved by ``NUDGE`` of itself, up or down."""
    sign = np.random.default_rng(seed).choice(np.float32([-1, 1]), a.shape)
    return (a * (1 + np.float32(NUDGE) * sign)).astype(a.dtype)


@contextlib.contextmanager
def planted(fault: str | None):
    """``torch.nn.functional.conv1d`` (the strided convolution of
    ``IQConvNet``) with ``fault`` planted (one of ``PLANTS``) while the
    block runs; unchanged for None."""
    import torch

    real = torch.nn.functional.conv1d
    if fault is None:
        yield
        return

    class FlipGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w):
            return w.view_as(w)

        @staticmethod
        def backward(ctx, g):
            return g.flip(-1)

    if fault == "kernels":
        def conv1d(x, w, *args, **kwargs):
            return real(x, w.flip(-1), *args, **kwargs)
    elif fault == "weight_grad":
        def conv1d(x, w, *args, **kwargs):
            return real(x, FlipGrad.apply(w), *args, **kwargs)
    else:
        raise ValueError(f"unknown fault {fault!r}; choose from {PLANTS}")
    torch.nn.functional.conv1d = conv1d
    try:
        yield
    finally:
        torch.nn.functional.conv1d = real


def run(model, x: np.ndarray, y: np.ndarray, order: np.ndarray, batch: int, device,
        fault: str | None = None):
    """RMSprop steps of a copy of ``model`` on ``device`` over the batches
    of ``order``: (per-step losses, per-step state_dicts on the CPU, the
    model after the steps on the CPU)."""
    import torch

    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.train.training import make_optimizer, train_step
    from amcpy_tpu_torch.utils.device import no_tf32

    m = copy.deepcopy(model).to(device).train()
    opt = make_optimizer(Config(), m.parameters())
    xt = torch.from_numpy(x).to(device)
    yt = torch.from_numpy(y).to(device)
    idx = torch.from_numpy(order).to(device)
    losses, states = [], []
    with no_tf32(), planted(fault):
        for b in range(len(order) // batch):
            rows = idx[b * batch:(b + 1) * batch]
            loss, _ = train_step(m, opt, xt.index_select(0, rows), yt.index_select(0, rows))
            losses.append(loss)
            state = {k: v.detach() for k, v in m.state_dict().items() if checked(k)}
            state.update({"grad." + k: p.grad for k, p in m.named_parameters()
                          if checked(k)})
            states.append({k: v.to("cpu", torch.float64, copy=True)
                           for k, v in state.items()})
    return torch.stack(losses).cpu().double().numpy(), states, m.cpu()


def data_free(key: str) -> bool:
    """Conv biases that feed a BatchNorm, and the running means."""
    return (key.startswith("conv.") and key.endswith(".bias")) or key.endswith("running_mean")


def checked(key: str) -> bool:
    """The state the bars hold: all but the data-free entries and the
    step counters."""
    return not (data_free(key) or key.endswith("num_batches_tracked"))


def rms(t) -> float:
    return float(t.square().mean().sqrt())


def envelope(gaps: np.ndarray) -> np.ndarray:
    """Per step, the largest gap up to that step."""
    return np.maximum.accumulate(gaps)


def held(run_, ref, pairs, dtype: str) -> dict:
    """``run_`` against ``ref`` (both ``run`` results) step by step, each
    bar ``SPREAD`` times the envelope of the ``pairs``' gaps (each a run
    and its device's plain run) or the floor: per-step loss gaps and bars,
    per-tensor gaps and bars (weights, and gradients as ``grad.<name>``),
    and the failures."""
    loss_floor, (rtol, atol) = FLOOR[dtype]
    steps = len(ref[0])
    loss_gap = np.abs(run_[0] - ref[0])
    loss_spread = envelope(np.max([np.abs(a[0] - b[0]) for a, b in pairs], axis=0))
    loss_bar = np.maximum(SPREAD * loss_spread, loss_floor)
    failures = []
    bad = np.flatnonzero(~(loss_gap <= loss_bar))
    if len(bad) or not np.isfinite(run_[0]).all():
        t = int(bad[0]) if len(bad) else 0
        failures.append(f"loss at step {t + 1}: gap {loss_gap[t]:.3g} > {loss_bar[t]:.3g} "
                        f"({len(bad)} of {steps} steps)")
    tensors = {}
    for key in ref[1][0]:
        # a gradient's gap relative to its size; a weight's absolute
        grad = key.startswith("grad.")
        size = np.array([rms(ref[1][t][key]) for t in range(steps)])
        scale = np.where(size > 0, size, 1.0) if grad else np.ones(steps)
        gap = np.array([rms(run_[1][t][key] - ref[1][t][key]) for t in range(steps)]) / scale
        spread = envelope(np.max([[rms(a[1][t][key] - b[1][t][key]) for t in range(steps)]
                                  for a, b in pairs], axis=0) / scale)
        floor = np.full(steps, rtol) if grad else rtol * size + atol
        bar = np.maximum(SPREAD * spread, floor)
        tensors[key] = {"gap": gap.tolist(), "bar": bar.tolist()}
        bad = np.flatnonzero(~(gap <= bar))
        if len(bad):
            t = int(bad[0])
            failures.append(f"{key} at step {t + 1}: rms gap {gap[t]:.3g} > {bar[t]:.3g} "
                            f"({len(bad)} of {steps} steps)")
    ratio = {k: float(max(np.divide(v["gap"], v["bar"]))) for k, v in tensors.items()}
    worst = max(ratio, key=ratio.get)
    return {"loss_gap_per_step": loss_gap.tolist(), "loss_bar_per_step": loss_bar.tolist(),
            "worst_tensor": worst, "worst_tensor_gap_over_bar": ratio[worst],
            "step1": {k: [v["gap"][0], v["bar"][0]] for k, v in tensors.items()},
            "tensors": tensors, "failures": failures}


def card_vs_cpu(dtype: str, card, *, steps: int = 30, n: int = 512, batch: int = 128,
                seed: int = 0, cpu="cpu") -> dict:
    """The k=8 stack in ``dtype`` trained ``steps`` steps on ``card`` and
    on ``cpu`` from the same weights, frames and orders (10 steps an
    epoch), each also from the nudged start and with permuted rows: the
    per-step gaps and bars, the conv biases of each device's plain run;
    ``ok`` is False past a bar, with the reasons in ``failures``. Each of
    ``PLANTS`` is one more card run with that fault planted, held to the
    same bars under ``planted``, where ``caught`` must be True."""
    import torch

    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.models.cnn import IQConvNet, conv_bias_report
    from amcpy_tpu_torch.models.layers import init_flax_defaults

    lr = Config().training.learning_rate
    per_epoch = 10
    x, y = frames(per_epoch * batch + batch, n, seed)
    x_tr, y_tr, probe = x[:-batch], y[:-batch], x[-batch:]
    rng = np.random.default_rng(seed + 1)
    order = np.concatenate([rng.permutation(len(x_tr))
                            for _ in range(-(-steps // per_epoch))])[:steps * batch]
    within = np.concatenate([b * batch + rng.permutation(batch) for b in range(steps)])
    model = IQConvNet(6, **WIDE, dropout=0.0, dtype=dtype)
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    moved = copy.deepcopy(model)
    with torch.no_grad():
        for i, (k, p) in enumerate(moved.named_parameters()):
            if data_free(k):
                signs = np.random.default_rng(seed + 2 + i).choice([-1, 1], p.shape)
                p.copy_(torch.from_numpy((lr * signs).astype(np.float32)))
            else:
                p.copy_(torch.from_numpy(nudged(p.detach().numpy(), seed + 2 + i)))
    x_moved = nudged(x_tr, seed + 1000)

    runs = {}
    for where, dev in (("cpu", torch.device(cpu)), ("card", torch.device(card))):
        runs[where] = run(model, x_tr, y_tr, order, batch, dev)
        runs[where + "_moved"] = run(moved, x_moved, y_tr, order, batch, dev)
        runs[where + "_permuted"] = run(model, x_tr, y_tr, order[within], batch, dev)
    pairs = [(runs[w + v], runs[w]) for w in ("cpu", "card") for v in ("_moved", "_permuted")]

    line = held(runs["card"], runs["cpu"], pairs, dtype)
    failures = line.pop("failures")
    probe_t = torch.from_numpy(probe)
    reports = {k: conv_bias_report(runs[k][2], probe_t) for k in ("cpu", "cpu_moved", "card")}
    for layer, mine in enumerate(reports["card"]):
        span = [reports[k][layer]["max_abs_bias"] for k in ("cpu", "cpu_moved")]
        lo, hi = min(span) / BIAS_FACTOR - lr, max(span) * BIAS_FACTOR + lr
        if not lo <= mine["max_abs_bias"] <= hi:
            failures.append(f"conv {layer} max|bias| {mine['max_abs_bias']:.3g} "
                            f"outside [{lo:.3g}, {hi:.3g}]")
        if max(mine["ratio"], reports["cpu"][layer]["ratio"]) >= 1.0:
            failures.append(f"conv {layer}: a bias reaches its product's std")
    planted_lines = {}
    for fault in PLANTS:
        got = held(run(model, x_tr, y_tr, order, batch, torch.device(card), fault),
                   runs["cpu"], pairs, dtype)
        planted_lines[fault] = {"caught": bool(got["failures"]),
                                "failures": got["failures"],
                                "loss_gap_per_step": got["loss_gap_per_step"],
                                "worst_tensor": got["worst_tensor"],
                                "worst_tensor_gap_over_bar": got["worst_tensor_gap_over_bar"]}
        if not got["failures"]:
            failures.append(f"the planted fault {fault!r} passed every bar")
    return {
        "dtype": dtype, "steps": len(runs["card"][0]), "frame_size": n, "batch": batch,
        "card_loss": runs["card"][0].tolist(), "cpu_loss": runs["cpu"][0].tolist(), **line,
        "conv_bias": {"card": reports["card"], "cpu": reports["cpu"]},
        "planted": planted_lines, "spread_factor": SPREAD, "bias_factor": BIAS_FACTOR,
        "ok": not failures, "failures": failures,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines here (JSON)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card is available", file=sys.stderr)
        return 1
    lines = [card_vs_cpu(dtype, torch.device("cuda", 0)) for dtype in ("float32", "bfloat16")]
    for line in lines:
        print(json.dumps({k: v for k, v in line.items() if k != "tensors"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=2))
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
