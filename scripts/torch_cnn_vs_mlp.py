"""Head-to-head of the PyTorch port on the card: the raw-IQ CNN family
against the feature MLP, the port's counterpart of ``scripts/cnn_vs_mlp.py``.

Trains each family (``--families``: ``mlp``, ``cnn``, ``cnn_aug``, the CNN
with phase-rotation and SNR-mixing augmentation) on the full-scale
synthetic dataset (default config: 6 modulations x 16 SNR x 1000 frames x
2048 samples, written by the port's ``synth.write_dataset(cfg, seed=0)``
where ``ROOT/mat-data/all_modulations.mat`` is absent), ``--seeds`` seeds
each, and records HELD-OUT per-SNR accuracy (mean and std over seeds): the
MLP's features come from ``run_extraction`` through K1 (its launches
counted and asserted on the card), training-SNR blocks are scored on the
frames ``train_frame_mask`` leaves out, the other SNRs on all their frames.
Then the CNN's inference at batch 4096 (or the whole dataset where it is
smaller), the median of 7 rounds of 20 calls,
through the module forward and through the K3 route (``cnn_logits_fused``).

The record keeps ``scripts/cnn_vs_mlp.py``'s keys, merges into an existing
``--out`` (so arms can run separately, and ``torch_cnn_wide_control.py``
adds its arm), and carries ``vs_jax``: each arm's gap to the JAX record
``metrics/cnn_vs_mlp.json`` in ``val_accuracy_mean`` and
``high_snr_mean``, against the bar ``2 * sqrt(std_port^2 + std_jax^2) +
0.01`` (``val_accuracy_std`` of each side; 0.03 for the one-seed k=8 arm).
The two packages' seeds name different random streams, so the bar
compares distributions, not seeds. Accuracy only: no TPU time is a target.

    python3 scripts/torch_cnn_vs_mlp.py [--root DIR] [--seeds 3] \\
        [--frames 1000] [--frame-size 2048] [--epochs 21] \\
        [--families mlp,cnn,cnn_aug] [--device cuda|cpu] \\
        [--out metrics/torch_cnn_vs_mlp.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from scripts.torch_records import (  # noqa: E402
    DEFAULT_ROOT,
    add_device_flags,
    ensure_dataset,
    environment,
    require_device,
)

#: the JAX package's record, held against for accuracy only
JAX_RECORD = ROOT / "metrics" / "cnn_vs_mlp.json"
#: the arms of a record and the bar of a one-seed arm
ARMS = ("mlp", "cnn", "cnn_aug", "cnn_wide_kernel_control")
ONE_SEED_BAR = 0.03
#: the SNR levels "high SNR" averages over: the last six
HIGH_SNR_LEVELS = 6
#: test frames a CNN arm's conv biases are reported on
PROBE_FRAMES = 512
#: the JAX record's arm each of the port's arms is held against, where the
#: names differ (the JAX record has only the bf16 k=8 arm)
JAX_ARM = {"cnn_wide_kernel_control_float32": "cnn_wide_kernel_control"}


def make_config(root: str, frames: int | None = None, frame_size: int | None = None,
                epochs: int | None = None):
    """The default config with the root, the dataset's size and the epochs
    a record asks for."""
    from amcpy_tpu_torch.config import Config

    signals = {k: v for k, v in (("num_frames", frames), ("frame_size", frame_size))
               if v is not None}
    training = {} if epochs is None else {"epochs": epochs}
    return Config().replace(paths={"root": root}, signals=signals, training=training)


def heldout_mask(cfg, features: dict) -> np.ndarray:
    """Every frame a model of either family trained on: the split is a
    function of (labels, test_size, seed) alone, so one mask serves both
    families and every training seed."""
    from amcpy_tpu_torch.preprocessing import preprocess, train_frame_mask

    return train_frame_mask(cfg, preprocess(features, cfg, return_indices=True)[-1][0])


def summarize(curves: list[np.ndarray], val_accs: list[float]) -> dict:
    """One arm's record from its per-seed ``(mods, snr)`` accuracy curves:
    per-SNR mean and std over seeds of the mean over modulations, the
    overall and high-SNR means, and the last val_accuracy of each seed."""
    stack = np.stack(curves)  # (seeds, mods, snr)
    per_snr = stack.mean(axis=1)  # (seeds, snr)
    return {
        "per_snr_mean": per_snr.mean(axis=0).tolist(),
        "per_snr_std": per_snr.std(axis=0).tolist(),
        "overall_mean": float(stack.mean()),
        "high_snr_mean": float(stack[:, :, -HIGH_SNR_LEVELS:].mean()),
        "val_accuracy_per_seed": list(val_accs),
        "val_accuracy_mean": float(np.mean(val_accs)),
        "val_accuracy_std": float(np.std(val_accs)),
    }


def _std(arm: dict) -> float:
    return float(arm.get("val_accuracy_std", np.std(arm["val_accuracy_per_seed"])))


def vs_jax(results: dict, jax_record: dict) -> dict:
    """Each arm's gap to the JAX record in val_accuracy_mean and
    high_snr_mean, and whether it lies within the bar."""
    out = {}
    for arm in (*ARMS, *JAX_ARM):
        ref_arm = JAX_ARM.get(arm, arm)
        if arm not in results or ref_arm not in jax_record:
            continue
        mine, ref = results[arm], jax_record[ref_arm]
        one_seed = len(mine["val_accuracy_per_seed"]) == 1 or len(
            ref["val_accuracy_per_seed"]) == 1
        bar = ONE_SEED_BAR if one_seed else 2 * float(
            np.hypot(_std(mine), _std(ref))) + 0.01
        row = {"bar": bar}
        for key in ("val_accuracy_mean", "high_snr_mean"):
            port = mine.get(key, float(np.mean(mine["val_accuracy_per_seed"])))
            jax = ref.get(key, float(np.mean(ref["val_accuracy_per_seed"])))
            row[key] = {"port": port, "jax": jax, "gap": port - jax,
                        "within": bool(abs(port - jax) <= bar)}
        out[arm] = row
    return out


def write_record(out: Path, update: dict) -> dict:
    """Merge ``update`` into the record at ``out``, recompute ``vs_jax``
    and write it."""
    results = json.loads(out.read_text()) if out.exists() else {}
    results.update(update)
    results["vs_jax"] = vs_jax(results, json.loads(JAX_RECORD.read_text()))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    return results


def train_arm(family: str, cfg, seeds: int, dev, *, features=None, data=None,
              excl=None, model_kw: dict | None = None, tag: str | None = None) -> dict:
    """Train ``family`` (``mlp`` on ``features``, else an ``IQConvNet`` on
    the raw ``data`` with ``model_kw``) for each seed and score it on the
    held-out frames. A CNN arm also keeps, for each seed, each conv layer's
    ``conv_bias_report`` after the last epoch on the first ``PROBE_FRAMES``
    test frames (``conv_bias_per_seed``)."""
    import torch

    from amcpy_tpu_torch.models.cnn import IQConvNet, conv_bias_report
    from amcpy_tpu_torch.preprocessing import preprocess, preprocess_raw
    from amcpy_tpu_torch.train.evaluate import evaluate_by_snr, evaluate_by_snr_raw
    from amcpy_tpu_torch.train.training import train

    n_classes = len(cfg.signals.modulations_with_noise)
    curves, val_accs, seconds, biases = [], [], [], []
    for seed in range(seeds):
        t0 = time.perf_counter()
        if family == "mlp":
            x_tr, x_te, y_tr, y_te, scaler = preprocess(features, cfg)
            model, _, hist, _ = train(cfg, x_tr, y_tr, x_te, y_te, seed=seed, device=dev)
            acc = evaluate_by_snr(model, scaler, features, cfg, exclude_mask=excl,
                                  device=dev)
        else:
            x_tr, x_te, y_tr, y_te = preprocess_raw(data, cfg)
            model, _, hist, _ = train(cfg, x_tr, y_tr, x_te, y_te, seed=seed,
                                      model=IQConvNet(n_classes, **(model_kw or {})),
                                      device=dev)
            acc = evaluate_by_snr_raw(model, data, cfg, exclude_mask=excl, device=dev)
            biases.append(conv_bias_report(model, torch.from_numpy(
                np.ascontiguousarray(x_te[:PROBE_FRAMES])).to(dev)))
            print(f"[{tag or family}] seed {seed}: max|bias| / product std per layer "
                  + ", ".join(f"{b['max_abs_bias']:.3g} / {b['product_std']:.3g}"
                              for b in biases[-1]), flush=True)
        curves.append(np.asarray(acc))
        val_accs.append(float(hist["val_accuracy"][-1]))
        seconds.append(time.perf_counter() - t0)
        print(f"[{tag or family}] seed {seed}: held-out mean acc {np.mean(acc):.4f} "
              f"(high-SNR {np.mean(acc[:, -HIGH_SNR_LEVELS:]):.4f}, val "
              f"{val_accs[-1]:.4f}) in {seconds[-1]:.1f}s", flush=True)
    out = {**summarize(curves, val_accs), "seconds_per_seed": seconds}
    if biases:
        out["conv_bias_per_seed"] = biases
    return out


def cnn_inference(dev, frame_size: int, n_classes: int, batch: int = 4096,
                  rounds: int = 7, reps: int = 20) -> dict:
    """ms a batch of a default ``IQConvNet`` (random weights from seed 0)
    through the module forward and through the K3 route, each the median
    of ``rounds`` rounds of ``reps`` calls on the host clock, the device
    synchronized at each round's end. On the card every K3 route call
    launches K3 once, on its wgmma kernel."""
    import torch

    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.models.layers import init_flax_defaults
    from amcpy_tpu_torch.ops.cnn_infer import cnn_logits_fused, cnn_trunk, fold_bn_params

    model = IQConvNet(n_classes)
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, 2, frame_size)).astype(np.float32)).to(dev)
    i, q = x[:, 0].contiguous(), x[:, 1].contiguous()
    folded = fold_bn_params(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def median_ms(fn) -> float:
        fn()
        sync()
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            times.append((time.perf_counter() - t0) / reps)
        return float(np.median(times) * 1e3)

    with torch.inference_mode():
        module_ms = median_ms(lambda: model(x))
        before = dict(cnn_trunk.launches_by_path)
        k3_ms = median_ms(lambda: cnn_logits_fused(model, i, q, folded=folded))
    launches = {k: v - before[k] for k, v in cnn_trunk.launches_by_path.items()}
    if dev.type == "cuda" and launches != {"wgmma": rounds * reps + 1, "mma_sync": 0}:
        raise AssertionError(f"the K3 route did not launch K3 on wgmma: {launches}")
    return {
        "batch": batch,
        "ms_per_batch": module_ms,
        "frames_per_s": batch / (module_ms / 1e3),
        "k3_route_ms_per_batch": k3_ms,
        "k3_route_frames_per_s": batch / (k3_ms / 1e3),
        "k3_launches": launches,
        "timing": f"median of {rounds} rounds of {reps} calls, host clock, synchronized",
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--frame-size", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=21)
    ap.add_argument("--families", default="mlp,cnn,cnn_aug",
                    help="comma list of mlp,cnn,cnn_aug")
    add_device_flags(ap, "metrics/torch_cnn_vs_mlp.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.extraction import run_extraction
    from amcpy_tpu_torch.ops.fused import extract_features_fused, extract_features_fused_any

    cfg = make_config(args.root, args.frames, args.frame_size, args.epochs)
    ensure_dataset(cfg, dev)
    data = io_mat.load_dataset(cfg)
    families = [f for f in args.families.split(",") if f]

    print("[cnn_vs_mlp] extracting features for the MLP arm ...", flush=True)
    before = extract_features_fused.launches, extract_features_fused_any.reroutes
    features = run_extraction(cfg, force=True, device=dev)
    k1 = extract_features_fused.launches - before[0]
    if dev.type == "cuda":
        from amcpy_tpu_torch.extraction import _default_chunk_size

        s = cfg.signals
        chunks = -(-s.num_snr * s.num_frames // _default_chunk_size(dev, s.frame_size))
        want = chunks * len(s.modulations_with_noise)
        if k1 != want or extract_features_fused_any.reroutes != before[1]:
            raise AssertionError(f"run_extraction launched K1 {k1} times, expected {want}")
    excl = heldout_mask(cfg, features)

    update: dict = {
        "config": {
            "frames": args.frames, "frame_size": args.frame_size, "epochs": args.epochs,
            "seeds": args.seeds, "snr_db": list(cfg.signals.snr_db),
            "heldout": ("per-SNR accuracy excludes all trained-on frames "
                        "(train_frame_mask); val_accuracy is the 20% held-out split"),
            "k1_launches_extraction": k1,
        },
        **environment(dev),
    }
    cnn_kw = {"cnn": {},
              "cnn_aug": {"aug_phase": True, "aug_noise_snr_db": (-12.0, 25.0)}}
    for family in families:
        update[family] = {**train_arm(family, cfg, args.seeds, dev, features=features,
                                      data=data, excl=excl, model_kw=cnn_kw.get(family)),
                          **environment(dev)}
    update["cnn_inference"] = {
        **cnn_inference(dev, args.frame_size, len(cfg.signals.modulations_with_noise),
                        batch=min(4096, sum(len(f.reshape(-1, f.shape[-1]))
                                            for f in data.values()))),
        "device": update["device"],
    }
    inf = update["cnn_inference"]
    print(f"[cnn_vs_mlp] CNN inference @{inf['batch']}: module forward "
          f"{inf['ms_per_batch']:.3f} ms, K3 route {inf['k3_route_ms_per_batch']:.3f} ms",
          flush=True)
    out = Path(args.out)
    results = write_record(out, update)
    print(json.dumps({"vs_jax": results["vs_jax"]}), flush=True)
    print(f"[cnn_vs_mlp] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
