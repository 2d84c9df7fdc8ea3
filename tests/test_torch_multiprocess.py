"""Two processes of the port's command line in one gloo world, the
counterpart of ``tests/test_multiprocess.py``.

Each command runs as two ``python -m amcpy_tpu_torch --device cpu``
processes with ``AMCPY_COORDINATOR`` (a ``file://`` store),
``AMCPY_NUM_PROCESSES`` and ``AMCPY_PROCESS_ID`` set, and a root each (no
filesystem shared between the two "hosts"; only the input dataset is on
both): ``extract`` (round-robin over the ranks, the features exchanged by
broadcast), then ``train --epochs 2`` (data-parallel, the checkpoint
written by rank 0 and copied by rank 1, the evaluations split over the
ranks, the figures' numbers written by rank 0 alone). The processes run
without matplotlib, as on a machine without it, so no PNG is drawn.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat, synth
from amcpy_tpu_torch.train.checkpoint import load_checkpoint
from amcpy_tpu_torch.train.evaluate import evaluate_by_snr

REPO = Path(__file__).resolve().parent.parent
SIGNALS = {"frame_size": 128, "num_frames": 24}
#: seconds a command's two processes may take
DEADLINE = 240


def _cfg(root: Path) -> Config:
    return Config().replace(paths={"root": str(root)}, signals=SIGNALS)


def _run_pair(roots, argv, store, no_mpl) -> list[str]:
    """One command on two ranks; each process's output."""
    env = dict(os.environ, AMCPY_COORDINATOR=f"file://{store}", AMCPY_NUM_PROCESSES="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(no_mpl), str(REPO)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "amcpy_tpu_torch", "--device", "cpu", "--root", str(root),
         "--config", str(root / "cfg.yaml"), *argv],
        env=dict(env, AMCPY_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank, root in enumerate(roots)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{argv} rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def test_two_process_extract_train_checkpoint(tmp_path):
    roots = [tmp_path / "host0", tmp_path / "host1"]
    for root in roots:
        synth.write_dataset(_cfg(root), seed=5, device="cpu")
        # YAML's JSON form
        (root / "cfg.yaml").write_text(json.dumps({
            "signals": SIGNALS, "training": {"epochs": 2, "batch_size": 64}}))
    no_mpl = tmp_path / "no_matplotlib" / "matplotlib"
    no_mpl.mkdir(parents=True)
    (no_mpl / "__init__.py").write_text('raise ImportError("no matplotlib in this run")\n')

    outs = _run_pair(roots, ["extract"], tmp_path / "store-extract", no_mpl.parent)
    for rank, out in enumerate(outs):
        assert f"[distributed] process {rank}/2, backend gloo" in out
    # the round-robin split: each rank extracted only its modulations
    assert "[BPSK]" in outs[0] and "[BPSK]" not in outs[1]
    assert "[QPSK]" in outs[1] and "[QPSK]" not in outs[0]
    mods = _cfg(roots[0]).signals.modulations_with_noise
    feats = [{m: io_mat.load_features(_cfg(r), m) for m in mods} for r in roots]
    for m in mods:  # every root holds all six, equal bit for bit
        np.testing.assert_array_equal(feats[0][m], feats[1][m], err_msg=m)

    outs = _run_pair(roots, ["train", "--epochs", "2", "--seed", "0"],
                     tmp_path / "store-train", no_mpl.parent)
    ids = []
    for root in roots:  # one checkpoint a root, the same id
        ckpts = sorted((root / "ann").glob("model-*.pt"))
        assert len(ckpts) == 1, ckpts
        ids.append(ckpts[0].stem[len("model-"):])
    assert ids[0] == ids[1]
    model_id = ids[0]
    # both ranks trained the same replicated model
    accs = [re.findall(r"val_acc: ([0-9.]+)", out) for out in outs]
    assert len(accs[0]) == 2 and accs[0] == accs[1]
    metas = [json.loads((r / "ann" / f"model-{model_id}.json").read_text()) for r in roots]
    assert metas[0]["history"] == metas[1]["history"]
    # the figures' numbers on rank 0's root only
    for name in (f"{model_id}_figure_data.mat", f"cm-{model_id}.json"):
        assert (roots[0] / "figures" / name).exists(), name
        assert not (roots[1] / "figures" / name).exists(), name
    # each root's checkpoint reloads and evaluates in one process
    for root, f in zip(roots, feats):
        model, _, scaler, meta = load_checkpoint(_cfg(root), model_id)
        assert len(meta["history"]["loss"]) == 2
        acc = evaluate_by_snr(model, scaler, f, _cfg(root), device="cpu")
        assert acc.shape == (6, 16) and np.isfinite(acc).all()
