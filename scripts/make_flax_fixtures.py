#!/usr/bin/env python3
"""Write the JAX package's checkpoints that the port's tests and
``chip_smoke.py`` read: ``model-{id}.msgpack`` and its JSON sidecar, each
written by ``amcpy_tpu.train.save_checkpoint`` after a few training steps.

    python scripts/make_flax_fixtures.py [--out tests/fixtures/flax_ckpt]

Writes into ``OUT`` (copy them into a project's ``ann/`` to use them):

* ``model-jax-mlp``: the default MLP (26, 29, 30) -> 6, RMSprop at the
  default learning rate, 3 epochs of 3 steps (batch 64) on the features of
  a small synthetic dataset, with the Standardizer fit on them;
* ``model-jax-cnn``: the default ``IQConvNet(n_classes=6)`` (k=1, channels
  32/64/128, dense 128, bf16), Adam at 3e-4 as ``amc train --model cnn``
  sets it, one epoch of 3 steps (batch 64) on the raw frames, N = 2048.

The dataset is ``amcpy_tpu.data.synth`` at 8 frames a block (6 modulations
x 16 SNR levels x 8 frames x 2048 samples, seed 3). Both runs use a
one-device mesh, so the files do not depend on how many devices the host
has. It needs the JAX package (JAX on the CPU is enough);
``tests/test_torch_checkpoint_flax.py`` regenerates the files and holds
them against the committed copies.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_OUT = ROOT / "tests" / "fixtures" / "flax_ckpt"
MLP_ID, CNN_ID = "jax-mlp", "jax-cnn"
#: frames a block of the synthetic dataset, its seed, the batch
FRAMES, SEED, BATCH = 8, 3, 64


def make_fixtures(out: Path) -> list[Path]:
    """Write both checkpoints and their sidecars into ``out``; return the
    four paths."""
    with tempfile.TemporaryDirectory() as tmp:
        _train_and_save(Path(tmp))
        out.mkdir(parents=True, exist_ok=True)
        return [Path(shutil.copy(p, out / p.name))
                for p in sorted((Path(tmp) / "ann").iterdir())]


def _train_and_save(root: Path) -> None:
    """Both training runs of the module docstring, saved under
    ``root/ann``."""
    import jax
    import numpy as np

    from amcpy_tpu.config import Config
    from amcpy_tpu.data.synth import generate_dataset
    from amcpy_tpu.extraction import extract_batch
    from amcpy_tpu.models.cnn import IQConvNet
    from amcpy_tpu.preprocessing import Standardizer, preprocess, preprocess_raw
    from amcpy_tpu.train.checkpoint import save_checkpoint
    from amcpy_tpu.train.training import train

    mesh = jax.make_mesh((1, 1), ("data", "seq"), devices=jax.devices()[:1])
    cfg = Config().replace(
        paths={"root": str(root)},
        signals={"num_frames": FRAMES},
        training={"batch_size": BATCH, "epochs": 3},
    )
    by_var = generate_dataset(cfg, seed=SEED)
    data = {mod: by_var[cfg.signals.mat_info[mod]]
            for mod in cfg.signals.modulations_with_noise}
    features = {
        mod: extract_batch(raw.reshape(-1, raw.shape[-1]), mesh=mesh).reshape(
            *raw.shape[:2], -1
        )
        for mod, raw in data.items()
    }
    x_tr, x_te, y_tr, y_te, scaler = preprocess(features, cfg)
    _, state, history, _ = train(cfg, x_tr, y_tr, x_te, y_te, mesh=mesh)
    save_checkpoint(cfg, MLP_ID, state, scaler, history, cfg.training.epochs)

    ccfg = cfg.replace(
        training={"optimizer": "adam", "learning_rate": 3e-4, "epochs": 1}
    )
    model = IQConvNet(n_classes=len(cfg.signals.modulations_with_noise))
    x_tr, x_te, y_tr, y_te = preprocess_raw(data, ccfg)
    _, state, history, _ = train(ccfg, x_tr, y_tr, x_te, y_te, mesh=mesh, model=model)
    meta = {
        "family": "cnn",
        "input_shape": [2, cfg.signals.frame_size],
        "arch": {
            "channels": list(model.channels),
            "kernel_sizes": list(model.kernel_sizes),
            "strides": list(model.strides),
            "dense": model.dense,
            "dropout": model.dropout,
            "dtype": model.dtype,
        },
    }
    identity = Standardizer(mean=np.zeros(1, np.float32), std=np.ones(1, np.float32))
    save_checkpoint(ccfg, CNN_ID, state, identity, history, ccfg.training.epochs,
                    model_meta=meta)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    for p in make_fixtures(args.out):
        print(f"{p} ({p.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
