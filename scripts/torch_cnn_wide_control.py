"""Wide-kernel control arm of the raw-IQ CNN family on the card: the port's
counterpart of ``scripts/cnn_wide_control.py``.

On symbol-rate iid IQ (one constellation symbol a sample) a wide temporal
kernel averages independent symbols, so the classic k=8 strided stack
should trail the k=1 per-sample default where fine constellation geometry
decides (high SNR). Trains the k=8 stack (``kernel_sizes=(8, 8, 8)``,
``strides=(2, 2, 2)``) on the same dataset as ``torch_cnn_vs_mlp.py``
(written where absent), scores it on the held-out frames and merges
``cnn_wide_kernel_control`` (with ``vs_jax``, bar 0.03 for one seed) into
that script's record. ``--dtype float32`` trains the same stack in float32
(flax's ``dtype="float32"``; bf16 is the default, as in the JAX record) and
merges it as ``cnn_wide_kernel_control_float32``, held against the JAX
record's bf16 arm. Each arm keeps the card (name, power limit) it ran on
and each seed's conv biases after the last epoch.

    python3 scripts/torch_cnn_wide_control.py [--root DIR] [--seeds 1] \\
        [--frames 1000] [--frame-size 2048] [--epochs 21] \\
        [--dtype bfloat16|float32] [--device cuda|cpu] \\
        [--out metrics/torch_cnn_vs_mlp.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts.torch_cnn_vs_mlp import make_config, train_arm, write_record  # noqa: E402
from scripts.torch_records import (  # noqa: E402
    DEFAULT_ROOT,
    add_device_flags,
    ensure_dataset,
    environment,
    require_device,
)

ARCH = {"kernel_sizes": (8, 8, 8), "strides": (2, 2, 2)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--frame-size", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=21)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    add_device_flags(ap, "metrics/torch_cnn_vs_mlp.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.preprocessing import preprocess_raw, train_frame_mask

    cfg = make_config(args.root, args.frames, args.frame_size, args.epochs)
    ensure_dataset(cfg, dev)
    data = io_mat.load_dataset(cfg)
    excl = train_frame_mask(cfg, preprocess_raw(data, cfg, return_indices=True)[-1][0])
    arch = {**ARCH, "dtype": args.dtype}
    name = "cnn_wide_kernel_control" + ("" if args.dtype == "bfloat16" else "_float32")
    arm = train_arm("cnn", cfg, args.seeds, dev, data=data, excl=excl, model_kw=arch,
                    tag=f"wide-control k=8 {args.dtype}")
    record = {
        "arch": {k: v if isinstance(v, str) else list(v) for k, v in arch.items()},
        "seeds": args.seeds,
        "epochs": args.epochs,
        **arm,
        **environment(dev),
        "note": ("wide temporal kernels on symbol-rate iid IQ: control for the k=1 "
                 "default (chance = 0.167)"),
    }
    out = Path(args.out)
    results = write_record(out, {name: record})
    print(json.dumps({"vs_jax": results["vs_jax"].get(name)}), flush=True)
    print(f"[wide-control] merged into {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
