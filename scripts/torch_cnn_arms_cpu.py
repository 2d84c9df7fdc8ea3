"""The CNN arms of the accuracy record, both packages on one platform: the
JAX package (``amcpy_tpu``) and the PyTorch port (``amcpy_tpu_torch``)
trained on the same arrays on the CPU.

The JAX record ``metrics/cnn_vs_mlp.json`` was taken on a TPU and the
port's ``metrics/torch_cnn_vs_mlp.json`` on a CUDA card, each with its own
random streams; this script takes the platform away. One dataset is drawn
once by the port's ``data/synth.py`` on the CPU (seed 0, the records'
generator; cut to ``--frames`` a block of ``--frame-size`` samples) and
handed to both packages as the same complex arrays. Each arm is trained
``--seeds`` times by each package's own ``train`` under the records'
protocol: the default config (RMSprop at lr 1.418e-3, batch 128, the
10-20 dB training blocks, dropout 0.5), ``preprocess_raw``'s split (the
same indices in both packages), held-out per-SNR accuracy by each
package's ``evaluate_by_snr_raw`` with ``train_frame_mask``. Arms
(``--arms``): ``cnn`` (k=1), ``cnn_aug`` (phase rotation and SNR mixing
from -12 to 25 dB), ``cnn_wide_kernel_control`` (k=8, stride 2), and
``cnn_wide_kernel_control_float32`` and ``cnn_aug_float32`` (those stacks
in float32).

Writes ``--out`` (default ``metrics/torch_cnn_arms_cpu.json``) after every
run, so a cut run keeps what it finished. Arms may run in separate
processes, each with its own ``--out``; ``--merge A.json B.json ...
--out R.json`` then unites those records (of one configuration) and
trains nothing. The record holds, per arm and package, ``scripts/torch_cnn_vs_mlp.py``'s summary keys, the
runs (seed, val accuracy, per-SNR curve, seconds, each conv layer's
``conv_bias_report`` after the last epoch on the first 512 test frames),
the data-free conv biases' gradients of both packages in bf16 and float32
(``bias_gradients``, ~1 min), and ``port_vs_jax``: the gaps in
``val_accuracy_mean`` and ``high_snr_mean`` against the bar ``2 *
sqrt(std_port^2 + std_jax^2) + 0.01`` (0.03 where a side has one seed;
``PERF.md`` section 2). Accuracy only: the seconds are this CPU's.

Imports both packages, so it runs where JAX does (the CPU), not on the
card's machine; it is a parity tool, not part of the port.

    JAX_PLATFORMS=cpu python scripts/torch_cnn_arms_cpu.py [--frames 200] \\
        [--frame-size 256] [--epochs 21] [--seeds 3] [--arms cnn,...] \\
        [--out metrics/torch_cnn_arms_cpu.json]
    JAX_PLATFORMS=cpu python scripts/torch_cnn_arms_cpu.py --merge A.json B.json \\
        --out metrics/torch_cnn_arms_cpu.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from scripts.torch_cnn_vs_mlp import (  # noqa: E402
    HIGH_SNR_LEVELS,
    ONE_SEED_BAR,
    PROBE_FRAMES,
    summarize,
)
from scripts.torch_records import environment  # noqa: E402

#: each arm's IQConvNet arguments besides ``n_classes`` (the records')
ARMS = {
    "cnn": {},
    "cnn_aug": {"aug_phase": True, "aug_noise_snr_db": (-12.0, 25.0)},
    "cnn_wide_kernel_control": {"kernel_sizes": (8, 8, 8), "strides": (2, 2, 2)},
    "cnn_wide_kernel_control_float32": {"kernel_sizes": (8, 8, 8), "strides": (2, 2, 2),
                                        "dtype": "float32"},
    "cnn_aug_float32": {"aug_phase": True, "aug_noise_snr_db": (-12.0, 25.0),
                        "dtype": "float32"},
}
PACKAGES = ("jax", "port")


def make_data(cfg) -> dict[str, np.ndarray]:
    """The dataset, keyed by modulation: the port's generator on the CPU,
    seeded as ``synth.write_dataset(cfg, seed=0)`` seeds each modulation."""
    from amcpy_tpu_torch.data import synth

    mods = cfg.signals.modulations_with_noise
    return {mod: synth.generate_modulation(mod, cfg, mi, device="cpu")
            for mi, mod in enumerate(mods)}


def run_jax(arm: str, seed: int, data: dict, signals: dict, epochs: int) -> dict:
    """One seed of ``arm`` trained and scored by the JAX package."""
    from amcpy_tpu.config import Config
    from amcpy_tpu.models.cnn import IQConvNet
    from amcpy_tpu.preprocessing import preprocess_raw, train_frame_mask
    from amcpy_tpu.train import train
    from amcpy_tpu.train.evaluate import evaluate_by_snr_raw
    from amcpy_tpu_torch.models.cnn import IQConvNet as PortNet
    from amcpy_tpu_torch.models.cnn import conv_bias_report
    from amcpy_tpu_torch.train.checkpoint import cnn_params_from_flax
    import jax
    import torch

    cfg = Config().replace(signals=signals, training={"epochs": epochs})
    x_tr, x_te, y_tr, y_te, (tr, _) = preprocess_raw(data, cfg, return_indices=True)
    kw = ARMS[arm]
    model = IQConvNet(n_classes=len(cfg.signals.modulations_with_noise), **kw)
    model, state, hist, _ = train(cfg, x_tr, y_tr, x_te, y_te, seed=seed, model=model)
    acc = evaluate_by_snr_raw(model, state, data, cfg,
                              exclude_mask=train_frame_mask(cfg, tr))
    # the trained weights in the port's module, to report its conv biases
    port = PortNet(len(cfg.signals.modulations_with_noise), **kw)
    port.load_state_dict(cnn_params_from_flax(jax.tree.map(np.asarray, state.params),
                                              jax.tree.map(np.asarray, state.batch_stats)))
    probe = torch.from_numpy(np.ascontiguousarray(x_te[:PROBE_FRAMES], np.float32))
    return {"curve": np.asarray(acc), "val": float(hist["val_accuracy"][-1]),
            "conv_bias": conv_bias_report(port, probe)}


def run_port(arm: str, seed: int, data: dict, signals: dict, epochs: int) -> dict:
    """One seed of ``arm`` trained and scored by the port on the CPU."""
    import torch

    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.models.cnn import IQConvNet, conv_bias_report
    from amcpy_tpu_torch.preprocessing import preprocess_raw, train_frame_mask
    from amcpy_tpu_torch.train.evaluate import evaluate_by_snr_raw
    from amcpy_tpu_torch.train.training import train

    cfg = Config().replace(signals=signals, training={"epochs": epochs})
    x_tr, x_te, y_tr, y_te, (tr, _) = preprocess_raw(data, cfg, return_indices=True)
    model = IQConvNet(len(cfg.signals.modulations_with_noise), **ARMS[arm])
    model, _, hist, _ = train(cfg, x_tr, y_tr, x_te, y_te, seed=seed, model=model,
                              device="cpu")
    acc = evaluate_by_snr_raw(model, data, cfg, exclude_mask=train_frame_mask(cfg, tr),
                              device="cpu")
    probe = torch.from_numpy(np.ascontiguousarray(x_te[:PROBE_FRAMES], np.float32))
    return {"curve": np.asarray(acc), "val": float(hist["val_accuracy"][-1]),
            "conv_bias": conv_bias_report(model, probe)}


def bias_gradients(dtype: str, n: int = 256, batch: int = 128, batches: int = 24) -> dict:
    """The gradient of the default k=1 stack's conv biases (the data-free
    ones: each feeds a BatchNorm, so its gradient is zero in exact
    arithmetic) in both packages, from the same flax-initialized weights
    (dropout 0, train mode) on ``batches`` numpy-made batches: per package
    the median |g| and the sign's consistency over the batches (per channel
    |mean of sign(g)|; about 1/sqrt(batches) for a random sign), the mean
    over channels and the share of channels above 0.8."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from amcpy_tpu.models.cnn import IQConvNet
    from amcpy_tpu_torch.models.cnn import IQConvNet as PortNet
    from amcpy_tpu_torch.train.checkpoint import cnn_params_from_flax
    from scripts.torch_training_card_vs_cpu import frames

    x, y = frames(batch * batches, n, seed=3)
    jm = IQConvNet(n_classes=6, dropout=0.0, dtype=dtype)
    init = jm.init(jax.random.key(0), jnp.zeros((1, 2, n)), train=False)

    def loss(params, xb, yb):
        logits, _ = jm.apply({"params": params, "batch_stats": init["batch_stats"]}, xb,
                             train=True, mutable=["batch_stats"])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, yb))

    grad = jax.jit(jax.grad(loss))
    model = PortNet(6, dropout=0.0, dtype=dtype)
    model.load_state_dict(cnn_params_from_flax(jax.tree.map(np.asarray, init["params"]),
                                               jax.tree.map(np.asarray, init["batch_stats"])))
    model.train()
    got = {"jax": [], "port": []}
    for k in range(batches):
        rows = slice(k * batch, (k + 1) * batch)
        g = grad(init["params"], x[rows], y[rows].astype(np.int32))
        got["jax"].append(np.concatenate([np.asarray(g[f"Conv_{i}"]["bias"]) for i in range(3)]))
        model.zero_grad()
        torch.nn.functional.cross_entropy(model(torch.from_numpy(x[rows])),
                                          torch.from_numpy(y[rows])).backward()
        got["port"].append(torch.cat([c.bias.grad for c in model.conv]).numpy())
    out = {}
    for pkg, gs in got.items():
        gs = np.stack(gs)
        held = np.abs(np.sign(gs).mean(axis=0))
        out[pkg] = {"median_abs": float(np.median(np.abs(gs))),
                    "sign_held_mean": float(held.mean()),
                    "share_sign_held_above_0.8": float((held > 0.8).mean())}
    return {"dtype": dtype, "frame_size": n, "batch": batch, "batches": batches, **out}


def compare(jax_arm: dict, port_arm: dict) -> dict:
    """The port's gaps to the JAX package in ``val_accuracy_mean`` and
    ``high_snr_mean``, each against the bar of the two seed spreads
    (``ONE_SEED_BAR`` where a side has one seed, as the records take it)."""
    if min(len(jax_arm["runs"]), len(port_arm["runs"])) == 1:
        bar = ONE_SEED_BAR
    else:
        bar = 2 * float(np.hypot(jax_arm["val_accuracy_std"],
                                 port_arm["val_accuracy_std"])) + 0.01
    row = {"bar": bar}
    for key in ("val_accuracy_mean", "high_snr_mean"):
        gap = port_arm[key] - jax_arm[key]
        row[key] = {"port": port_arm[key], "jax": jax_arm[key], "gap": gap,
                    "within": bool(abs(gap) <= bar)}
    return row


def rebuild(record: dict) -> None:
    """Each arm's per-package summary and ``port_vs_jax`` from its runs."""
    record["port_vs_jax"] = {}
    for arm, by_pkg in record["arms"].items():
        for pkg, entry in by_pkg.items():
            runs = entry["runs"]
            if runs:
                entry.update(summarize([np.asarray(r["curve"]) for r in runs],
                                       [r["val_accuracy"] for r in runs]))
        if all(by_pkg[p]["runs"] for p in PACKAGES):
            record["port_vs_jax"][arm] = compare(by_pkg["jax"], by_pkg["port"])


def merge(paths: list[Path], out: Path) -> int:
    """The records at ``paths`` (one configuration, any seed counts) as one
    record at ``out``: their runs by arm and package, the first record's
    environment and bias gradients."""
    records = [json.loads(p.read_text()) for p in paths]
    config = {k: v for k, v in records[0]["config"].items() if k != "seeds"}
    record = {**records[0], "arms": {}}
    for path, other in zip(paths, records):
        if {k: v for k, v in other["config"].items() if k != "seeds"} != config:
            raise SystemExit(f"--merge: {path} holds another configuration")
        for arm, by_pkg in other["arms"].items():
            mine = record["arms"].setdefault(arm, {p: {"runs": []} for p in PACKAGES})
            for pkg in PACKAGES:
                mine[pkg]["runs"] += by_pkg[pkg]["runs"]
    rebuild(record)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    print(f"[arms_cpu] merged {len(paths)} records into {out}", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200, help="frames a (modulation, SNR) block")
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=21)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--merge", nargs="+", default=None,
                    help="unite these records (arms run in separate processes) "
                         "into --out and train nothing")
    ap.add_argument("--out", default=str(ROOT / "metrics" / "torch_cnn_arms_cpu.json"))
    args = ap.parse_args(argv)
    arms = [a for a in args.arms.split(",") if a]
    unknown = set(arms) - set(ARMS)
    if unknown:
        raise SystemExit(f"unknown arms {sorted(unknown)}; choose from {list(ARMS)}")
    if args.merge:
        return merge([Path(m) for m in args.merge], Path(args.out))

    import torch

    from amcpy_tpu_torch.config import Config

    signals = {"num_frames": args.frames, "frame_size": args.frame_size}
    cfg = Config().replace(signals=signals, training={"epochs": args.epochs})
    out = Path(args.out)
    config = {"frames": args.frames, "frame_size": args.frame_size, "epochs": args.epochs,
              "seeds": args.seeds, "snr_db": list(cfg.signals.snr_db),
              "dataset": "amcpy_tpu_torch.data.synth.generate_modulation on the CPU, "
                         "seed 0 (modulation i seeded i, as write_dataset(seed=0))",
              "protocol": "default config (rmsprop, lr 1.418e-3, batch 128, dropout 0.5, "
                          "training SNR 10-20 dB); per-SNR accuracy excludes all "
                          "trained-on frames (train_frame_mask); val_accuracy is the 20% "
                          "held-out split",
              "reduced": {"frames_per_block": [1000, args.frames],
                          "frame_size": [2048, args.frame_size],
                          "seeds": "3 a package (the records: 3, k=8 one)"},
              "high_snr_levels": HIGH_SNR_LEVELS}
    record = {"config": config, **environment(torch.device("cpu")),
              "arms": {arm: {p: {"runs": []} for p in PACKAGES} for arm in arms}}
    record["bias_gradients"] = [bias_gradients(dt, n=args.frame_size)
                                for dt in ("bfloat16", "float32")]
    print(json.dumps({"bias_gradients": record["bias_gradients"]}), flush=True)
    t0 = time.perf_counter()
    data = make_data(cfg)
    print(f"[arms_cpu] dataset {args.frames} x {args.frame_size} a block in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    runners = {"jax": run_jax, "port": run_port}
    for seed in range(args.seeds):
        for arm in arms:
            for pkg in PACKAGES:
                runs = record["arms"][arm][pkg]["runs"]
                t0 = time.perf_counter()
                res = runners[pkg](arm, seed, data, signals, args.epochs)
                curve = res["curve"]
                runs.append({"seed": seed, "val_accuracy": res["val"],
                             "curve": curve.tolist(),
                             "seconds": time.perf_counter() - t0,
                             "conv_bias": res["conv_bias"]})
                print(f"[arms_cpu] {arm} {pkg} seed {seed}: val {res['val']:.4f}, "
                      f"high-SNR {curve[:, -HIGH_SNR_LEVELS:].mean():.4f}, max|bias| "
                      + " ".join(f"{b['max_abs_bias']:.3g}" for b in res["conv_bias"])
                      + f" in {runs[-1]['seconds']:.0f}s", flush=True)
                rebuild(record)
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(record, indent=2))
    rebuild(record)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    print(json.dumps({"port_vs_jax": record["port_vs_jax"]}), flush=True)
    print(f"[arms_cpu] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
