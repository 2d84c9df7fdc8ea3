"""Command-line interface of the port: ``python -m amcpy_tpu_torch``.

Counterpart of ``amcpy_tpu/cli.py``, every subcommand with the same flags:
``info``, ``generate``, ``extract`` (``--force``, ``--profile DIR``,
``--from-synthetic SEED``), ``plot``, ``train`` (``--model mlp|cnn``,
``--resume``), ``eval``, ``quantize``, ``classify``, ``serve``, ``sweep``,
``parity`` and ``full`` (extract -> plot -> train). Every flag reaches the
frozen config through ``Config.replace`` before any work starts. The
global ``--device`` (default ``cuda``) is the counterpart of
``JAX_PLATFORMS``: every command runs on that device, and ``cuda`` without
a card raises.

Every command that the JAX package draws figures for writes the numbers
too: ``figures/{id}_figure_data.mat`` (the per-SNR accuracy matrix),
``figures/cm-{id}.json`` (the confusion matrix),
``figures/features/feature_stats.mat`` (``plot``) and
``figures/quant-accuracy-{id}.mat`` (``quantize --compare``); the PNGs and
``all_plots.html`` are drawn as well where matplotlib imports (the card's
machine has none). ``sweep`` writes ``metrics/sweep_best.yaml`` in YAML,
or in YAML's JSON form where PyYAML is absent; ``--config`` reads either.
A model id names the port's ``ann/model-{id}.pt`` or, where there is none,
the JAX package's ``ann/model-{id}.msgpack``; without an id the newest of
either is taken. ``parity --ref`` has no default: it names the original
amcpy checkout.

``--distributed`` (or ``AMCPY_NUM_PROCESSES`` in the environment) joins
the process group first (``parallel/mesh.py::init_distributed``: one rank
a device, NCCL on a card, gloo with ``--device cpu``) and prints a
``[distributed] process r/W ...`` line. Every subcommand then runs on
every rank: ``extract`` splits the modulations round-robin, ``train``
is data-parallel, the evaluations split their rows, checkpoints are
written by rank 0 and copied where absent, and only rank 0 writes the
figures and their numbers.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from amcpy_tpu_torch.config import Config

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="amc-torch",
        description="amcpy_tpu_torch: Automatic Modulation Classification "
                    "on PyTorch and CUDA",
    )
    parser.add_argument("--root", default=None, help="project root directory")
    parser.add_argument("--config", default=None, help="YAML config file")
    parser.add_argument(
        "--device", default="cuda",
        help="device every command runs on (cuda, cuda:N or cpu)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="join the process group before any work (torch.distributed; "
             "also triggered by AMCPY_NUM_PROCESSES, with AMCPY_COORDINATOR "
             "and AMCPY_PROCESS_ID, or torchrun's variables)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="Show device and config diagnostics")

    gen_p = sub.add_parser("generate", help="Generate a synthetic IQ dataset")
    gen_p.add_argument("--seed", type=int, default=0)
    gen_p.add_argument("--frames", type=int, default=None)
    gen_p.add_argument("--frame-size", type=int, default=None)

    ext_p = sub.add_parser("extract", help="Extract features from raw .mat data")
    ext_p.add_argument("--force", action="store_true",
                       help="recompute even if artifacts exist")
    ext_p.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler Chrome trace to DIR")
    ext_p.add_argument(
        "--from-synthetic", type=int, default=None, metavar="SEED",
        help="synthesize frames on the device and extract in one pass (no "
             "raw-IQ host round trip; no mat-data needed)",
    )

    sub.add_parser("plot", help="Generate feature visualisations")

    train_p = sub.add_parser("train", help="Train the neural network")
    train_p.add_argument(
        "--model", choices=["mlp", "cnn"], default="mlp",
        help="mlp = feature MLP (needs `extract` artifacts); cnn = raw-IQ "
             "IQConvNet trained straight on all_modulations.mat",
    )
    train_p.add_argument("--epochs", type=int, default=None)
    train_p.add_argument("--batch-size", type=int, default=None)
    train_p.add_argument("--lr", type=float, default=None)
    train_p.add_argument("--dropout", type=float, default=None)
    train_p.add_argument(
        "--optimizer", choices=["rmsprop", "adam", "nadam"], default=None
    )
    train_p.add_argument("--activation", default=None)
    train_p.add_argument("--seed", type=int, default=None)
    train_p.add_argument(
        "--resume", default=None, metavar="MODEL_ID",
        help="resume mid-training from a checkpoint (weights + optimizer "
             "state + epoch counter)",
    )

    eval_p = sub.add_parser("eval", help="Evaluate a trained model")
    eval_p.add_argument("model_id", nargs="?", default=None)
    eval_p.add_argument(
        "--mode", choices=["training", "test"], default="test",
        help="with --full-data: training = high-SNR only; test = all SNR",
    )
    eval_p.add_argument(
        "--full-data", action="store_true",
        help="confusion matrix over the FULL --mode dataset (includes "
             "trained-on frames). Default: the checkpoint's own held-out "
             "split, the confusion matrix `train` reports",
    )

    quant_p = sub.add_parser("quantize", help="Quantize model for ARM deployment")
    quant_p.add_argument("model_id", nargs="?", default=None)
    quant_p.add_argument("--range-mode", choices=["full", "reference"], default="full")
    quant_p.add_argument(
        "--no-fold-bn", action="store_true",
        help="export raw Dense weights without folding BatchNorm",
    )
    quant_p.add_argument(
        "--compare", action="store_true",
        help="evaluate the int16 fixed-point model against float32: per-SNR "
             "accuracy of both and both confusion matrices",
    )
    quant_p.add_argument(
        "--full-data", action="store_true",
        help="with --compare: confusion matrices over the full dataset "
             "instead of the checkpoint's held-out split",
    )
    quant_p.add_argument(
        "--emit-c", action="store_true",
        help="also write arm-data/amc_weights.h, a self-contained C header "
             "(weights + standardizer + integer inference, bit-exact with "
             "the int16 pipeline)",
    )

    cls_p = sub.add_parser("classify", help="Classify raw IQ frames with a trained model")
    cls_p.add_argument(
        "input", help=".mat dataset variable (mod name) or binary capture file"
    )
    cls_p.add_argument("--model-id", default=None)
    cls_p.add_argument("--frame-size", type=int, default=None)
    cls_p.add_argument("--out", default=None, help="write predictions to .mat/.npy")

    srv_p = sub.add_parser("serve", help="HTTP classification server over a trained model")
    srv_p.add_argument("--model-id", default=None)
    srv_p.add_argument(
        "--host", default="127.0.0.1",
        help="bind address; the server has no auth layer, so exposing it "
             "beyond loopback is an explicit --host 0.0.0.0 opt-in",
    )
    srv_p.add_argument("--port", type=int, default=8000)

    sweep_p = sub.add_parser("sweep", help="Hyperparameter sweep")
    sweep_p.add_argument("--spec", default=None,
                         help="W&B-format sweep YAML (default: reference space)")
    sweep_p.add_argument("--trials", type=int, default=20)
    sweep_p.add_argument("--seed", type=int, default=0)
    sweep_p.add_argument(
        "--method", choices=["bayes", "random"], default="bayes",
        help="bayes = Tree-structured Parzen Estimator (the reference "
             "sweep.yaml method), random = uniform search",
    )
    sweep_p.add_argument(
        "--parallel", type=int, default=1,
        help="trials per round, trained concurrently on the device",
    )

    par_p = sub.add_parser(
        "parity",
        help="Diff the original amcpy extractor against this pipeline on the "
             "dataset (features + downstream accuracy)",
    )
    par_p.add_argument("--ref", required=True,
                       help="path to the original amcpy checkout")
    par_p.add_argument(
        "--frames-per-snr", type=int, default=None,
        help="subsample frames per (mod, SNR) block (default: all)",
    )
    par_p.add_argument("--no-train", action="store_true",
                       help="skip the downstream accuracy comparison")
    par_p.add_argument("--seed", type=int, default=0)
    par_p.add_argument(
        "--seeds", type=int, default=3,
        help="training seeds per feature set: the accuracy delta is diffed "
             "on mean curves and compared against seed noise",
    )
    par_p.add_argument("--processes", type=int, default=None,
                       help="reference-extractor worker processes")

    sub.add_parser("full", help="Run full pipeline: extract -> plot -> train")
    return parser


def _load_config(args: argparse.Namespace) -> Config:
    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.root:
        cfg = cfg.replace(paths={"root": args.root})
    return cfg


def _require(path, hint: str) -> None:
    if not path.exists():
        raise SystemExit(f"error: {path} not found — {hint}")


def _adopt_checkpoint_training(cfg: Config, args, meta) -> Config:
    """On ``--resume``, the checkpoint's recorded architecture and
    optimizer settings become the defaults (explicit flags still win):
    resuming an rmsprop-trained model without ``--optimizer rmsprop`` must
    restore an rmsprop optimizer around its saved state."""
    t = meta["config"]["training"]
    over = {}
    if "hidden_sizes" in t:
        over["hidden_sizes"] = tuple(t["hidden_sizes"])
    for flag, key in (
        ("dropout", "dropout"),
        ("activation", "activation"),
        ("optimizer", "optimizer"),
        ("lr", "learning_rate"),
        ("seed", "seed"),        # keeps the train/test split identical
        ("_test_size", "test_size"),
    ):
        if getattr(args, flag, None) is None and key in t:
            over[key] = t[key]
    return cfg.replace(training=over) if over else cfg


def _training_overrides(cfg: Config, args: argparse.Namespace) -> Config:
    over = {}
    for flag, key in [
        ("epochs", "epochs"),
        ("batch_size", "batch_size"),
        ("lr", "learning_rate"),
        ("dropout", "dropout"),
        ("optimizer", "optimizer"),
        ("activation", "activation"),
        ("seed", "seed"),
    ]:
        v = getattr(args, flag, None)
        if v is not None:
            over[key] = v
    return cfg.replace(training=over) if over else cfg


def _load_features(cfg: Config) -> dict:
    from amcpy_tpu_torch.data import io_mat

    _require(
        cfg.paths.calculated_features
        / f"{cfg.signals.modulations_with_noise[0]}_features.mat",
        "run `extract` first",
    )
    return {m: io_mat.load_features(cfg, m) for m in cfg.signals.modulations_with_noise}


def _load_raw(cfg: Config) -> dict:
    from amcpy_tpu_torch.data import io_mat

    _require(cfg.paths.mat_data / cfg.paths.mat_filename,
             "provide all_modulations.mat")
    return io_mat.load_dataset(cfg)


def _resume(cfg: Config, args):
    """(cfg with the checkpoint's training settings, initial, prior
    history, model, scaler) of ``--resume``; Nones without it."""
    if not getattr(args, "resume", None):
        return cfg, None, {}, None, None
    model, prev, scaler, meta = _load_evaluated(cfg, args.resume)
    cfg = _adopt_checkpoint_training(cfg, args, meta)
    initial = (model.state_dict(), prev.opt_state, int(meta.get("epoch") or 0))
    print(f"Resuming from {args.resume} at epoch {initial[2]}")
    return cfg, initial, meta.get("history") or {}, model, scaler


def _report(cfg: Config, model_id: str, acc, cm, history=None) -> None:
    """Write and print the per-SNR accuracy and the confusion matrix, and
    where matplotlib imports draw them (and the training history)."""
    import numpy as np

    from amcpy_tpu_torch import graphics
    from amcpy_tpu_torch.parallel.mesh import is_primary
    from amcpy_tpu_torch.train.evaluate import save_confusion_matrix, save_figure_data

    # every rank evaluated; only the primary writes the shared artifacts
    if is_primary():
        save_figure_data(cfg, model_id, acc)
        path = save_confusion_matrix(cfg, model_id, cm)
        print(f"Confusion matrix -> {path}")
        if graphics.have_matplotlib():
            graphics.plot_accuracy_by_snr(acc, model_id, cfg)
            graphics.plot_confusion_matrix(np.asarray(cm), model_id, cfg)
            if history is not None:
                graphics.plot_history(history, model_id, cfg)
    print(np.array2string(np.asarray(cm), precision=2))
    print(f"Mean accuracy across SNR: {np.mean(acc):.4f}")


def cmd_info(cfg: Config, args: argparse.Namespace) -> None:
    import torch

    import amcpy_tpu_torch
    from amcpy_tpu_torch.extraction import resolve_kernel

    from amcpy_tpu_torch.parallel.mesh import group_up

    print(f"amcpy_tpu_torch {amcpy_tpu_torch.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        print("devices: no CUDA device (use --device cpu)")
    dev = torch.device(args.device)
    if group_up():
        import torch.distributed as dist

        print(f"processes: {dist.get_world_size()} (this is rank {dist.get_rank()}), "
              f"backend {dist.get_backend()}; devices: {dist.get_world_size()}, one a "
              f"rank (this rank's: {dev})")
    else:
        print("processes: 1")
    print(f"mesh shape: {tuple(cfg.compute.mesh_shape) or 'auto'} "
          f"({cfg.compute.data_axis}, {cfg.compute.seq_axis})")
    kernel = cfg.compute.kernel
    print(f"device: {dev}; extraction kernel: {kernel}"
          + (f" (resolves to {resolve_kernel(kernel, dev)})" if kernel == "auto" else ""))
    print(f"wire format: {cfg.compute.wire_format}")
    from amcpy_tpu_torch.data.native_io import available

    print(f"native amc_io: {'built' if available() else 'unavailable (NumPy fallback)'}")
    print(f"project root: {cfg.paths.root}")
    for name, p in [
        ("dataset", cfg.paths.mat_data / cfg.paths.mat_filename),
        ("features", cfg.paths.calculated_features),
        ("checkpoints", cfg.paths.trained_ann),
    ]:
        if p.is_dir():
            print(f"{name}: {p} ({len(list(p.glob('*')))} files)")
        else:
            print(f"{name}: {p} ({'present' if p.exists() else 'MISSING'})")


def cmd_generate(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.data.synth import write_dataset

    over = {}
    if args.frames:
        over["num_frames"] = args.frames
    if args.frame_size:
        over["frame_size"] = args.frame_size
    if over:
        cfg = cfg.replace(signals=over)
    path = write_dataset(cfg, seed=args.seed, device=args.device)
    print(f"Dataset written -> {path}")


def cmd_extract(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.extraction import run_extraction, run_extraction_synthetic

    if getattr(args, "from_synthetic", None) is not None:
        run_extraction_synthetic(cfg, seed=args.from_synthetic, device=args.device)
    else:
        _require(
            cfg.paths.mat_data / cfg.paths.mat_filename,
            "provide all_modulations.mat, run `generate` first, or extract "
            "with --from-synthetic SEED",
        )
        run_extraction(cfg, force=getattr(args, "force", False),
                       profile_dir=getattr(args, "profile", None), device=args.device)
    print("All feature calculations complete!")


def cmd_plot(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.graphics import run_plots

    run_plots(cfg)


def cmd_train(cfg: Config, args: argparse.Namespace) -> None:
    if getattr(args, "model", "mlp") == "cnn":
        _cmd_train_cnn(cfg, args)
        return
    from amcpy_tpu_torch.preprocessing import preprocess
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.train.evaluate import confusion_counts, evaluate_by_snr
    from amcpy_tpu_torch.train.training import train

    cfg = _training_overrides(cfg, args)
    cfg.paths.ensure_dirs()
    cfg, initial, prior_history, _, prev_scaler = _resume(cfg, args)
    features = _load_features(cfg)
    x_train, x_test, y_train, y_test, scaler = preprocess(features, cfg)
    if prev_scaler is not None:
        # the same artifacts refit the same standardizer; keep the
        # checkpoint's copy for the saved model regardless
        scaler = prev_scaler
    model, state, history, model_id = train(
        cfg, x_train, y_train, x_test, y_test, initial=initial, device=args.device
    )
    # the whole run's record: restored epochs + new epochs
    history = {k: list(prior_history.get(k, [])) + v for k, v in history.items()}
    save_checkpoint(cfg, model_id, model, scaler, history, cfg.training.epochs, state=state)
    print(f"Model saved -> {cfg.paths.trained_ann}/model-{model_id}.pt")
    acc = evaluate_by_snr(model, scaler, features, cfg, device=args.device)
    cm = confusion_counts(model, x_test, y_test, len(cfg.signals.modulations_with_noise),
                          device=args.device)
    _report(cfg, model_id, acc, cm, history)


def _cmd_train_cnn(cfg: Config, args: argparse.Namespace) -> None:
    """Train the raw-IQ CNN straight on the ``.mat`` dataset (no feature
    stage), through the same training, evaluation and checkpoints as the
    MLP."""
    import numpy as np

    from amcpy_tpu_torch.config import TrainingConfig
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.preprocessing import Standardizer, preprocess_raw
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.train.evaluate import confusion_counts, evaluate_by_snr_raw
    from amcpy_tpu_torch.train.training import train

    # the config's training defaults are the MLP's tuned RMSprop 1.418e-3;
    # they destabilize the CNN, whose default is Adam 3e-4 unless the user
    # says otherwise
    ref = TrainingConfig()
    cnn_defaults = {}
    if args.optimizer is None and cfg.training.optimizer == ref.optimizer:
        cnn_defaults["optimizer"] = "adam"
    if args.lr is None and cfg.training.learning_rate == ref.learning_rate:
        cnn_defaults["learning_rate"] = 3e-4
    if cnn_defaults:
        cfg = cfg.replace(training=cnn_defaults)
    cfg = _training_overrides(cfg, args)
    cfg.paths.ensure_dirs()
    cfg, initial, prior_history, model, _ = _resume(cfg, args)
    data = _load_raw(cfg)
    n_classes = len(cfg.signals.modulations_with_noise)
    if model is None:
        model = IQConvNet(
            n_classes=n_classes, dropout=args.dropout if args.dropout is not None else 0.5
        )
    x_train, x_test, y_train, y_test = preprocess_raw(data, cfg)
    model, state, history, model_id = train(
        cfg, x_train, y_train, x_test, y_test, initial=initial, model=model,
        device=args.device,
    )
    history = {k: list(prior_history.get(k, [])) + v for k, v in history.items()}
    # the CNN is per-frame scale-invariant: an identity scaler keeps the
    # sidecar's schema
    scaler = Standardizer(mean=np.zeros(1, np.float32), std=np.ones(1, np.float32))
    save_checkpoint(cfg, model_id, model, scaler, history, cfg.training.epochs, state=state)
    print(f"Model saved -> {cfg.paths.trained_ann}/model-{model_id}.pt")
    acc = evaluate_by_snr_raw(model, data, cfg, device=args.device)
    cm = confusion_counts(model, x_test, y_test, n_classes, chunk=4096, device=args.device)
    _report(cfg, model_id, acc, cm, history)


def _eval_cm_dataset(cfg: Config, args, meta, build):
    """Rows for the eval confusion matrix.

    Default: the checkpoint's own held-out split, reproduced from the split
    provenance in the sidecar (seed + test_size; the stratified split is a
    pure function of those), so ``eval`` and ``train`` report the same
    confusion matrix for the same checkpoint. ``--full-data`` takes the
    full ``--mode`` dataset (trained-on frames included).
    """
    if getattr(args, "full_data", False):
        return build(args.mode)
    from amcpy_tpu_torch.preprocessing import stratified_split_indices

    tmeta = meta["config"]["training"]
    # the split reproduces the held-out set only if the assembled dataset
    # is the one trained on: refuse on drift of the recorded provenance
    smeta = meta["config"].get("signals")
    drift = []
    if smeta is not None:
        for key, now in (
            ("num_frames", cfg.signals.num_frames),
            ("num_snr", cfg.signals.num_snr),
            ("modulations", list(cfg.signals.modulations_with_noise)),
        ):
            if smeta.get(key) != now:
                drift.append(f"{key}: checkpoint {smeta.get(key)} vs {now}")
    if "training_snr" in tmeta and tmeta["training_snr"] != list(cfg.training.training_snr):
        drift.append(
            f"training_snr: checkpoint {tmeta['training_snr']} vs "
            f"{list(cfg.training.training_snr)}"
        )
    if drift:
        raise SystemExit(
            "error: cannot reproduce this checkpoint's held-out split — "
            "the dataset/config changed since training ("
            + "; ".join(drift)
            + "). Re-run with the training-time config, or pass "
            "--full-data for the (labeled, trained-rows-included) "
            "full-dataset confusion matrix."
        )
    x, y = build("training")
    _, te = stratified_split_indices(
        y,
        float(tmeta.get("test_size", cfg.training.test_size)),
        int(tmeta.get("seed", cfg.training.seed)),
    )
    return x[te], y[te]


#: the families ``eval``, ``quantize`` and ``train --resume`` take (the JAX
#: package's); the port only serves the rest
_EVALUATED = ("mlp", "cnn")


def _load_evaluated(cfg: Config, model_id: str):
    """``load_checkpoint``, or ``SystemExit`` for a family not in :data:`_EVALUATED`."""
    from amcpy_tpu_torch.train.checkpoint import load_checkpoint

    loaded = load_checkpoint(cfg, model_id)
    family = loaded[0].family
    if family not in _EVALUATED:
        raise SystemExit(
            f"checkpoint {model_id} is a {family} model: the port serves this family "
            "only (amc-torch serve); it does not evaluate, quantize or train it."
        )
    return loaded


def cmd_eval(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.preprocessing import build_dataset, build_raw_dataset
    from amcpy_tpu_torch.train.checkpoint import resolve_model_id
    from amcpy_tpu_torch.train.evaluate import (
        confusion_counts,
        evaluate_by_snr,
        evaluate_by_snr_raw,
    )

    model_id = resolve_model_id(cfg, args.model_id)
    model, _, scaler, meta = _load_evaluated(cfg, model_id)
    n_classes = len(cfg.signals.modulations_with_noise)
    if model.takes_iq:
        data = _load_raw(cfg)
        acc = evaluate_by_snr_raw(model, data, cfg, device=args.device)
        x, y = _eval_cm_dataset(cfg, args, meta,
                                lambda mode: build_raw_dataset(data, cfg, mode))
        cm = confusion_counts(model, x, y, n_classes, chunk=4096, device=args.device)
    else:
        features = _load_features(cfg)
        acc = evaluate_by_snr(model, scaler, features, cfg, device=args.device)
        x, y = _eval_cm_dataset(cfg, args, meta,
                                lambda mode: build_dataset(features, cfg, mode))
        cm = confusion_counts(model, scaler.transform(x), y, n_classes, device=args.device)
    _report(cfg, model_id, acc, cm)


def cmd_quantize(cfg: Config, args: argparse.Namespace) -> None:
    import numpy as np

    from amcpy_tpu_torch.ops.quantize import emit_c_header, quantize_model
    from amcpy_tpu_torch.preprocessing import build_dataset
    from amcpy_tpu_torch.train.checkpoint import resolve_model_id

    model_id = resolve_model_id(cfg, args.model_id)
    model, _, scaler, meta = _load_evaluated(cfg, model_id)
    if model.takes_iq:
        raise SystemExit(
            "quantize targets the feature-MLP/MCU deployment path (Q-format "
            f"Dense export); checkpoint {model_id} is a raw-IQ CNN. Train "
            "with --model mlp to produce a quantizable model."
        )
    state = model.state_dict()
    features = _load_features(cfg)
    x, _ = build_dataset(features, cfg, "test")
    sample = scaler.transform(x).astype(np.float32)
    fold = not args.no_fold_bn
    _, info = quantize_model(state, sample, cfg, range_mode=args.range_mode, fold_bn=fold)
    for k, v in info.items():
        print(f"  {k} -> {v}")
    print(f"Quantized weights -> {cfg.paths.arm_data / 'w_and_b.mat'}")

    if args.emit_c:
        p = emit_c_header(state, scaler, cfg, info, fold_bn=fold)
        print(f"C header -> {p} (bit-exact with the int16 pipeline)")

    if args.compare:
        import scipy.io

        from amcpy_tpu_torch.ops.quantize import (
            evaluate_quantized_by_snr,
            quantized_predict,
        )
        from amcpy_tpu_torch.train.evaluate import (
            confusion_counts,
            evaluate_by_snr,
            save_confusion_matrix,
        )

        acc_f = evaluate_by_snr(model, scaler, features, cfg, device=args.device)
        acc_q = evaluate_quantized_by_snr(state, scaler, features, cfg, info, fold_bn=fold)
        p = cfg.paths.figures / f"quant-accuracy-{model_id}.mat"
        scipy.io.savemat(str(p), {"acc_float": acc_f, "acc_int16": acc_q})
        print(f"Float vs int16 per-SNR accuracy -> {p}")
        # held-out rows, as `eval` takes them
        x_all, y_all = _eval_cm_dataset(
            cfg, argparse.Namespace(mode="test", full_data=args.full_data), meta,
            lambda mode: build_dataset(features, cfg, mode),
        )
        xs = scaler.transform(x_all).astype(np.float32)
        n_cls = len(cfg.signals.modulations_with_noise)
        cm_f = confusion_counts(model, xs, y_all, n_cls, device=args.device)
        pred_q = quantized_predict(state, xs, cfg, info, fold_bn=fold, arithmetic="int")
        cm_q = np.zeros((n_cls, n_cls), dtype=np.float64)
        np.add.at(cm_q, (np.asarray(y_all), pred_q), 1.0)
        cm_q = np.around(cm_q / np.maximum(cm_q.sum(axis=1, keepdims=True), 1), 2)
        p_f = save_confusion_matrix(cfg, model_id, cm_f, tag="quant-cm-float")
        p_q = save_confusion_matrix(cfg, model_id, cm_q, tag="quant-cm-int16")
        print(f"Confusion matrices -> {p_f}, {p_q}")
        from amcpy_tpu_torch import graphics

        if graphics.have_matplotlib():
            graphics.plot_quantization_comparison(acc_f, acc_q, model_id, cfg)
            graphics.plot_confusion_matrix(np.asarray(cm_f), model_id, cfg,
                                           tag="quant-cm-float")
            graphics.plot_confusion_matrix(cm_q, model_id, cfg, tag="quant-cm-int16")
        delta = np.abs(acc_f - acc_q)
        print(
            f"Max per-SNR accuracy delta float vs int16: {delta.max() * 100:.2f} pp "
            f"(mean {delta.mean() * 100:.2f} pp)"
        )


def cmd_classify(cfg: Config, args: argparse.Namespace) -> None:
    import numpy as np

    from amcpy_tpu_torch.serve import AMCPipeline

    pipe = AMCPipeline.from_checkpoint(cfg, args.model_id, device=args.device)
    mods = cfg.signals.modulations_with_noise
    if args.input in mods:
        from amcpy_tpu_torch.data import io_mat

        raw = io_mat.load_modulation(cfg, args.input)  # (S, F, N)
        preds = pipe.predict(raw.reshape(-1, raw.shape[-1])).reshape(raw.shape[:2])
        acc = (preds == mods.index(args.input)).mean(axis=-1)
        for si, a in enumerate(acc):
            print(f"SNR {cfg.signals.snr_db[si]:+d} dB: {a * 100:5.1f}%")
    else:
        preds = pipe.classify_stream(args.input, frame_size=args.frame_size)
        counts = np.bincount(preds, minlength=len(mods))
        for mi, mod in enumerate(mods):
            print(f"{mod}: {counts[mi]} frames "
                  f"({100.0 * counts[mi] / max(len(preds), 1):.1f}%)")
    if args.out:
        if args.out.endswith(".mat"):
            import scipy.io

            scipy.io.savemat(args.out, {"predictions": preds})
        else:
            np.save(args.out, preds)
        print(f"Predictions -> {args.out}")


def cmd_serve(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.server import serve_forever

    serve_forever(cfg, args.model_id, host=args.host, port=args.port, device=args.device)


def _write_best_config(cfg: Config, best: dict) -> Path:
    """``metrics/sweep_best.yaml``: the best trial's training settings, in
    YAML, or in YAML's JSON form where PyYAML is absent."""
    import json

    hidden = [
        int(best["params"].get(f"layer_size_hl{k}", d))
        for k, d in ((1, 26), (2, 29), (3, 30))
    ]
    doc = {
        "training": {
            **{
                k: best["params"][k]
                for k in ("batch_size", "dropout", "epochs", "learning_rate",
                          "optimizer", "activation")
                if k in best["params"]
            },
            "hidden_sizes": hidden,
        }
    }
    try:
        import yaml
    except ImportError:
        text = json.dumps(doc, indent=2)
    else:
        text = yaml.safe_dump(doc)
    path = cfg.paths.metrics / "sweep_best.yaml"
    path.write_text(text)
    return path


def cmd_sweep(cfg: Config, args: argparse.Namespace) -> None:
    import json

    from amcpy_tpu_torch.preprocessing import preprocess
    from amcpy_tpu_torch.train.sweep import load_sweep_spec, run_sweep

    features = _load_features(cfg)
    x_train, x_test, y_train, y_test, _ = preprocess(features, cfg)
    spec = load_sweep_spec(args.spec) if args.spec else None
    best, _ = run_sweep(
        cfg, x_train, y_train, x_test, y_test,
        spec=spec, n_trials=args.trials, seed=args.seed,
        method=args.method, parallel=args.parallel, device=args.device,
    )
    print(f"Best trial: {json.dumps(best, indent=2)}")
    path = _write_best_config(cfg, best)
    print(f"Best config -> {path} (use with: --config {path} train)")


def cmd_parity(cfg: Config, args: argparse.Namespace) -> None:
    from amcpy_tpu_torch.parity import run_parity

    _require(cfg.paths.mat_data / cfg.paths.mat_filename, "run `generate` first")
    report = run_parity(
        cfg,
        ref_root=args.ref,
        frames_per_snr=args.frames_per_snr,
        train_models=not args.no_train,
        seed=args.seed,
        n_seeds=args.seeds,
        processes=args.processes,
        device=args.device,
    )
    worst = report["worst_error_fraction_of_tolerance"]
    bad = report["frames_outside_tolerance"]
    print(
        f"Feature parity: {bad}/{report['frames_total']} frames outside "
        f"tolerance (worst {worst * 100:.1f}% of budget)"
    )
    if "accuracy" in report:
        a = report["accuracy"]
        b = a["budget"]
        print(
            "Accuracy parity (paired seeds): mean |delta| "
            f"{a['mean_abs_delta'] * 100:.2f} pp, max |delta| "
            f"{a['max_abs_delta'] * 100:.2f} pp per (mod, SNR) cell "
            f"({a.get('n_seeds', 1)} paired seeds) -> budget "
            f"{'PASS' if b['pass'] else 'FAIL'} "
            f"(mean<={b['mean_pp']}pp, max<={b['max_pp']}pp)"
        )
        if a.get("delta_within_seed_noise") is not None:
            print(
                "  -> "
                + ("within paired-seed noise" if a["delta_within_seed_noise"]
                   else "EXCEEDS paired-seed noise (systematic)")
                + f" ({a['cells_exceeding_noise']}/{a['n_cells']} cells "
                "over the family-wise noise bound)"
            )


def cmd_full(cfg: Config, args: argparse.Namespace) -> None:
    cmd_extract(cfg, args)
    cmd_plot(cfg, args)
    cmd_train(cfg, args)


COMMANDS = {
    "info": cmd_info,
    "generate": cmd_generate,
    "extract": cmd_extract,
    "plot": cmd_plot,
    "train": cmd_train,
    "eval": cmd_eval,
    "quantize": cmd_quantize,
    "classify": cmd_classify,
    "serve": cmd_serve,
    "sweep": cmd_sweep,
    "parity": cmd_parity,
    "full": cmd_full,
}


def main(argv: list[str] | None = None) -> None:
    import os

    args = build_parser().parse_args(argv)
    joined = False
    if args.distributed or os.environ.get("AMCPY_NUM_PROCESSES"):
        import torch.distributed as dist

        from amcpy_tpu_torch.parallel.mesh import group_up, init_distributed

        was_up = group_up()
        if init_distributed(device=args.device):
            joined = not was_up
            import torch

            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend() == "nccl" else torch.device("cpu"))
            print(f"[distributed] process {dist.get_rank()}/{dist.get_world_size()}, "
                  f"backend {dist.get_backend()}, device {dev}", flush=True)
    try:
        cfg = _load_config(args)
        cfg.paths.ensure_dirs()
        COMMANDS[args.command](cfg, args)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
