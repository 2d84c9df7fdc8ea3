"""The port's process groups, mesh and collective audit
(``amcpy_tpu_torch/parallel``) on the CPU over gloo, and the launcher of
the multi-rank worlds the other ``test_torch_*`` files spawn.

This module imports no JAX: it is also the worlds' worker script.
:func:`run_world` starts ``world`` processes of ``python
tests/test_torch_parallel.py CASE RANK WORLD ROOT`` (one thread each, a
``file://`` store under ``ROOT``, so parallel test workers never race for
a port) and fails the test when a rank exits non-zero or the world
outlives its deadline. A case reads what the test wrote under ``ROOT``
(frames, weights, orders as ``.npy``/``.npz``, made with numpy in the
parent, where the JAX references are computed) and writes its results
there.

The tests here run in this process, in a world of one rank brought up and
torn down around each test.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
#: the seconds a world may take, start-up included, before it is killed
WORLD_DEADLINE = 240


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def run_world(case: str, world: int, root: Path, deadline: float = WORLD_DEADLINE) -> list[str]:
    """Run ``case`` on ``world`` ranks under ``root``; returns each rank's
    output. Fails if a rank exits non-zero or the deadline passes (every
    rank is then killed)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    logs = [root / f"{case}.rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, case, str(r), str(world), str(root)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(root)))
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    assert not hung, f"{case}: ranks {hung} outlived {deadline} s:\n" + outs[hung[0]][-3000:]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{case} rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"
    return outs


# ---------------------------------------------------------------------------
# the worlds' cases (run in the spawned ranks)
# ---------------------------------------------------------------------------

#: frame sizes of the sequence-parallel cases (as tests/test_sharding.py:
#: a power of two, 900 = 12 x 75 whose default factorization (9, 100) does
#: not split over 4, and 48, which no factorization splits over 4 or 2)
SP_SIZES = (2048, 900, 48)
SP_FRAMES = 8
#: the small dataset of the extraction worlds
EXTRACT_SIGNALS = {"frame_size": 128, "num_frames": 24}


def sp_modes(n: int) -> tuple[str, ...]:
    return ("matmul", "fft") if n == 2048 else ("matmul",)


def _case_sp(rank: int, world: int, root: Path, shape: tuple[int, int]) -> None:
    """``extract_features_sp`` at every size and mode of the SP tests on
    this mesh, each under an audit window; the data blocks' features are
    gathered (outside the window) and rank 0 writes them with the audits.
    On (1, 2) also the round-robin ``run_extraction``, on (2, 2) the
    sequence-parallel one, each rank on a root of its own."""
    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.extraction import extract_batch, run_extraction
    from amcpy_tpu_torch.parallel.audit import all_gather, audit_collectives
    from amcpy_tpu_torch.parallel.mesh import make_mesh
    from amcpy_tpu_torch.parallel.sp import extract_features_sp

    mesh = make_mesh(shape=shape)
    d, s = shape
    di, si = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
    assert (di, si) == divmod(rank, s), "ranks are not laid out row-major"
    out, audits = {}, {}
    for n in SP_SIZES:
        frames = np.load(root / f"frames_{n}.npy")  # (B, 2, n) float32
        b = frames.shape[0] // d
        block = frames[di * b : (di + 1) * b, :, si * (n // s) : (si + 1) * (n // s)]
        i, q = (torch.from_numpy(np.ascontiguousarray(block[:, k])) for k in (0, 1))
        for mode in sp_modes(n):
            with audit_collectives() as audit:
                local = extract_features_sp(i, q, mesh, gmax_mode=mode)
            out[f"{n}_{mode}"] = all_gather(local, mesh.get_group("data")).numpy()
            audits[f"{n}_{mode}"] = audit
    if rank == 0:
        np.savez(root / "sp.npz", **out)
        (root / "sp_audit.json").write_text(json.dumps(audits))
    if shape in ((1, 2), (2, 2)):
        mesh_shape = () if shape == (1, 2) else shape
        cfg = Config().replace(paths={"root": str(root / f"rank{rank}")},
                               signals=EXTRACT_SIGNALS, compute={"mesh_shape": mesh_shape})
        with audit_collectives() as audit:
            run_extraction(cfg, device="cpu")
        with audit_collectives() as batch_audit:
            extract_batch(np.load(root / "batch.npy"), device="cpu")
        (root / f"rank{rank}" / "audit.json").write_text(
            json.dumps({"run_extraction": audit, "extract_batch": batch_audit}))


def _case_dp(rank: int, world: int, root: Path) -> None:
    """The data-parallel cases of ``tests/test_torch_dp.py`` in one world
    of two ranks; rank 0 writes each case's results under ``root``."""
    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.models.layers import init_flax_defaults
    from amcpy_tpu_torch.parallel.audit import audit_collectives, collective_bytes
    from amcpy_tpu_torch.parallel.mesh import data_shard, make_mesh
    from amcpy_tpu_torch.train.training import (
        HISTORY_KEYS,
        make_optimizer,
        predict_logits,
        predict_logits_global,
        run_epoch,
        train,
        train_step,
    )

    shard = data_shard(make_mesh())
    assert (shard.index, shard.size) == (rank, world)
    saved = {}

    def save(name, model, history, **extra):
        saved[name] = {**{f"state/{k}": v.detach().double().numpy()
                          for k, v in model.state_dict().items()},
                       **{f"history/{k}": np.asarray(history[k]) for k in HISTORY_KEYS},
                       **extra}

    def epochs(model, opt, data, orders, bs_local, gen=None):
        x_tr, y_tr, x_te, y_te = (torch.from_numpy(shard.local(np.asarray(a))) for a in data)
        history = {k: [] for k in HISTORY_KEYS}
        for order in orders:
            m = run_epoch(model, opt, x_tr, y_tr.long(), x_te, y_te.long(),
                          torch.from_numpy(order[rank]), bs_local, gen, shard)
            for k in HISTORY_KEYS:
                history[k].append(float(m[k]))
        return history

    # 1. the MLP from JAX's initial weights on JAX's per-shard orders
    data = [np.load(root / f"dp_{k}.npy") for k in ("x_tr", "y_tr", "x_te", "y_te")]
    model = AMCClassifier(6, (26, 29, 30), dropout=0.0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(root / "dp_init.npz").items()})
    opt = make_optimizer(Config(), model.parameters())
    save("jax", model, epochs(model, opt, data, np.load(root / "dp_orders.npy"), 64))

    # 2. dropout 0.4 in float64 against one process on the global batches
    model = AMCClassifier(6, (26, 29, 30), dropout=0.4).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(root / "dp_init64.npz").items()})
    opt = make_optimizer(Config(), model.parameters())
    gen = torch.Generator().manual_seed(7)
    data64 = [a.astype(np.float64) if a.dtype == np.float32 else a for a in data]
    save("dropout64", model, epochs(model, opt, data64, np.load(root / "dp_orders64.npy"), 64,
                                    gen))

    # 3. one CNN epoch with augmentation, float64
    cnn = IQConvNet(6, channels=(4, 8), kernel_sizes=(1, 3), strides=(1, 2), dense=8,
                    dropout=0.5, dtype="float32", aug_phase=True,
                    aug_noise_snr_db=(-5.0, 20.0)).double()
    cnn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         np.load(root / "cnn_init.npz").items()})
    opt = make_optimizer(Config().replace(training={"optimizer": "adam",
                                                    "learning_rate": 3e-3}), cnn.parameters())
    cdata = [np.load(root / f"cnn_{k}.npy") for k in ("x_tr", "y_tr", "x_te", "y_te")]
    save("cnn64", cnn, epochs(cnn, opt, cdata, np.load(root / "cnn_orders.npy"), 8,
                              torch.Generator().manual_seed(3)))

    # 4. one default MLP step's collectives (every rank from one seed)
    model = AMCClassifier(6, (26, 29, 30))
    init_flax_defaults(model, torch.Generator().manual_seed(4))
    opt = make_optimizer(Config(), model.parameters())
    xb = torch.from_numpy(shard.local(data[0][:128]))
    yb = torch.from_numpy(shard.local(data[1][:128])).long()
    with audit_collectives() as audit:
        train_step(model, opt, xb, yb, torch.Generator().manual_seed(0), shard)
    n_params = sum(p.numel() for p in model.parameters())

    # 5. predict_logits_global at a row count that is not a multiple of 2
    x = data[2][:37]
    spread = predict_logits_global(model, x, device="cpu")
    whole = predict_logits(model.eval(), torch.from_numpy(x))

    # 6. train() itself, dropout 0.4, on sizes that round (1001, 501 rows)
    cfg = Config().replace(training={"epochs": 2, "dropout": 0.4, "batch_size": 127})
    extra = np.load(root / "dp_extra.npz")
    tmodel, _, thistory, model_id = train(cfg, extra["x_tr"], extra["y_tr"], extra["x_te"],
                                          extra["y_te"], device="cpu", seed=11)
    if rank == 0:
        save("train", tmodel, thistory)
        for name, arrays in saved.items():
            np.savez(root / f"dp_{name}.npz", **arrays)
        (root / "dp_step.json").write_text(json.dumps({
            "audit": audit, "bytes": collective_bytes(audit), "n_params": n_params,
            "global_minus_local": float((spread - whole).abs().max()),
            "global_rows": int(spread.shape[0]), "model_id": model_id}))
    else:
        (root / "dp_rank1.json").write_text(json.dumps({"model_id": model_id}))


CASES = {
    "sp_1x2": lambda r, w, root: _case_sp(r, w, root, (1, 2)),
    "sp_2x2": lambda r, w, root: _case_sp(r, w, root, (2, 2)),
    "sp_1x4": lambda r, w, root: _case_sp(r, w, root, (1, 4)),
    "dp": _case_dp,
}


def _worker(case: str, rank: int, world: int, root: Path) -> None:
    import torch.distributed as dist

    from amcpy_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    assert init_distributed(f"file://{root}/store-{case}", world, rank, device="cpu")
    try:
        CASES[case](rank, world, root)
    finally:
        dist.destroy_process_group()
    print(f"{case} rank {rank}/{world} OK", flush=True)


# ---------------------------------------------------------------------------
# tests in this process: a world of one
# ---------------------------------------------------------------------------

#: torch's launch variables and the JAX package's; the tests clear them
_LAUNCH_ENV = ("AMCPY_COORDINATOR", "AMCPY_NUM_PROCESSES", "AMCPY_PROCESS_ID", "WORLD_SIZE",
               "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launch_env(monkeypatch):
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)


@pytest.fixture
def world1(tmp_path, no_launch_env):
    """A gloo group of one rank (this process), torn down after the test."""
    import torch.distributed as dist

    from amcpy_tpu_torch.parallel.mesh import init_distributed

    assert init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_init_distributed_is_a_no_op_without_a_launch(no_launch_env, monkeypatch):
    from amcpy_tpu_torch.parallel.mesh import group_up, init_distributed, is_primary

    assert init_distributed(device="cpu") is False
    monkeypatch.setenv("AMCPY_NUM_PROCESSES", "1")
    assert init_distributed(device="cpu") is False
    assert not group_up() and is_primary()


def test_init_distributed_needs_a_coordinator(no_launch_env):
    from amcpy_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0, device="cpu")


def test_world_of_one(world1, tmp_path):
    """A group already up returns True; the mesh of one rank, its axis
    names from the config, and a shape that does not cover the world."""
    import torch.distributed as dist

    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.parallel.mesh import (
        data_shard,
        init_distributed,
        is_primary,
        make_mesh,
        shard_rows,
    )

    assert dist.get_backend() == "gloo"
    assert init_distributed(f"file://{tmp_path}/other", 2, 1) is True
    assert is_primary()
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("data", "seq") and tuple(mesh.shape) == (1, 1)
    assert make_mesh() is mesh
    cfg = Config().replace(compute={"data_axis": "d", "seq_axis": "s", "mesh_shape": (1, 1)})
    assert make_mesh(cfg).mesh_dim_names == ("d", "s")
    for shape in ((2, 1), (1, 2), (1,), (1, 1, 1)):
        with pytest.raises(ValueError, match="does not cover"):
            make_mesh(shape=shape)
    shard = data_shard(mesh)
    assert (shard.index, shard.size) == (0, 1)
    x = np.arange(6)
    np.testing.assert_array_equal(shard_rows(x, mesh), x)


def test_pipeline_in_a_group_keeps_to_its_device(world1):
    """A rank owns one device: a pipeline built in a group fans out over
    its own device alone unless ``devices`` names others."""
    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    scaler = Standardizer(np.zeros(6, np.float32), np.ones(6, np.float32))
    pipe = AMCPipeline(AMCClassifier(6, in_features=6), scaler, Config(), device="cpu")
    assert pipe.devices == [pipe.device] and pipe.fanout(4096) is None
    two = AMCPipeline(pipe.model, scaler, Config(), device="cpu", devices=["cpu", "cpu:0"])
    assert len(two.fanout(128)) == 2


def test_make_mesh_needs_a_group(no_launch_env):
    from amcpy_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_data_shard_rows():
    from amcpy_tpu_torch.parallel.mesh import DataShard

    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(DataShard(None, 1, 3).local(x), x[2:4])
    with pytest.raises(ValueError, match="do not split"):
        DataShard(None, 0, 4).local(x)


def test_pad_to_multiple():
    from amcpy_tpu_torch.parallel.mesh import pad_to_multiple

    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, orig = pad_to_multiple(x, 4)
    assert padded.shape == (8, 2) and orig == 5
    np.testing.assert_array_equal(padded[5:], np.tile(x[-1], (3, 1)))
    same, orig2 = pad_to_multiple(x, 5)
    assert same.shape == (5, 2) and orig2 == 5


def test_audit_counts_each_collective_on_its_result(world1):
    """Counts and bytes as the JAX audit counts them (the result's shape),
    nested windows both counting, a barrier not counted."""
    from amcpy_tpu_torch.parallel import audit as A

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with A.audit_collectives() as outer:
        with A.audit_collectives() as inner:
            torch.testing.assert_close(A.all_reduce(x.clone(), "max"), x)
            torch.testing.assert_close(A.all_gather(x), x)
            torch.testing.assert_close(A.reduce_scatter(x), x)
            torch.testing.assert_close(A.broadcast(x.double(), 0), x.double())
            torch.testing.assert_close(A.permute(x[:, :1], []), torch.zeros(3, 1))
            A.barrier()
        y = A.all_reduce_autograd(x.clone().requires_grad_(True))
        y.sum().backward()
    assert set(inner) == set(A.COLLECTIVE_OPS)
    assert inner["all-reduce"] == {"count": 1, "bytes": 48}
    assert inner["collective-broadcast"] == {"count": 1, "bytes": 96}
    assert inner["collective-permute"] == {"count": 1, "bytes": 12}
    # the differentiable sum counts its forward and its backward
    assert outer["all-reduce"] == {"count": 3, "bytes": 3 * 48}
    assert A.collective_bytes(inner) == 48 + 48 + 48 + 96 + 12


def test_train_in_a_world_of_one_is_the_plain_run(tmp_path, no_launch_env):
    """At W = 1 the data-parallel path draws, sums and steps as the plain
    one: the same history and weights, bit for bit (dropout 0.4)."""
    import torch.distributed as dist

    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.parallel.audit import audit_collectives
    from amcpy_tpu_torch.parallel.mesh import init_distributed
    from amcpy_tpu_torch.train.training import train

    rng = np.random.default_rng(0)
    y = rng.integers(0, 6, 600)
    x = (rng.standard_normal((6, 6))[y] + rng.standard_normal((600, 6))).astype(np.float32)
    cfg = Config().replace(training={"epochs": 2})
    model, _, hist, _ = train(cfg, x[:400], y[:400], x[400:], y[400:], device="cpu")
    assert init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        with audit_collectives() as audit:
            dp_model, _, dp_hist, _ = train(cfg, x[:400], y[:400], x[400:], y[400:],
                                            device="cpu")
    finally:
        dist.destroy_process_group()
    # 3 steps an epoch: per step 3 BatchNorm sums forward, 3 backward and
    # the gradients; per epoch the metrics
    assert audit["all-reduce"]["count"] == 2 * (3 * 7 + 1)
    assert audit["collective-broadcast"]["count"] == 1  # the model id
    assert dp_hist == hist
    for (k, a), b in zip(dp_model.state_dict().items(), model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
                "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
                "reduce_scatter_single", "broadcast", "broadcast_object_list", "barrier",
                "all_to_all", "all_to_all_single", "scatter", "gather", "reduce", "send",
                "recv", "isend", "irecv", "batch_isend_irecv", "P2POp", "monitored_barrier")


def test_collectives_only_in_the_audit_module():
    """No module of the port but ``parallel/audit.py`` calls a collective
    of ``torch.distributed`` (or imports one by name)."""
    names = "|".join(_COLLECTIVES)
    call = re.compile(rf"\b(?:dist|torch\.distributed|c10d)\.({names})\b")
    imported = re.compile(
        rf"from\s+torch\.distributed(?:\.\w+)*\s+import\s+[^\n]*\b({names})\b")
    offenders = []
    for path in sorted((REPO / "amcpy_tpu_torch").rglob("*.py")):
        if path.relative_to(REPO).as_posix() == "amcpy_tpu_torch/parallel/audit.py":
            continue
        text = path.read_text()
        offenders += [f"{path.name}: {m.group(0)}" for pat in (call, imported)
                      for m in pat.finditer(text)]
    assert not offenders, offenders
    audit_src = (REPO / "amcpy_tpu_torch" / "parallel" / "audit.py").read_text()
    assert call.search(audit_src), "the grep no longer sees the audit's own calls"


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
