"""The port's record scripts on the CPU at a tiny size: the wire gate
(``scripts/torch_wire_gate.py``) and the CNN-versus-MLP record
(``scripts/torch_cnn_vs_mlp.py``, ``scripts/torch_cnn_wide_control.py``).

A dataset of 6 modulations x 16 SNR x 8 frames x 64 samples is written
once by the scripts themselves (``synth.write_dataset`` on the CPU). The
records must carry the JAX records' keys (read from the committed
``metrics/wire_gate.json`` and ``metrics/cnn_vs_mlp.json``); the held-out
mask must be the JAX package's; the per-SNR aggregation must be the numpy
one; and each script must refuse to run without a card unless it is told
``--device cpu``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.preprocessing import preprocess as jax_preprocess
from amcpy_tpu.preprocessing import train_frame_mask as jax_train_frame_mask
from amcpy_tpu_torch.ops import features as F
from amcpy_tpu_torch.ops.fused import split_planes
from amcpy_tpu_torch.ops.wire import decode_planes, encode_planes
from scripts import torch_cnn_vs_mlp, torch_cnn_wide_control, torch_wire_gate

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--frames", "8", "--frame-size", "64"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A dataset root shared by the module's runs (written by the first)."""
    return tmp_path_factory.mktemp("records")


def _keys(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def _plain_codec(fmt: str):
    """The plain extractor behind the port's codec: encode on the host,
    decode to float32 planes, extract."""
    def run(flat):
        i, q = split_planes(flat)
        if fmt == "f32":
            planes = torch.from_numpy(i), torch.from_numpy(q)
        else:
            enc = encode_planes(i, q, fmt)
            planes = decode_planes(*(torch.from_numpy(e) for e in enc), fmt=fmt)
        feats = F._extract_planar(*planes, normalize_scale=True, compute_gmax=True,
                                  gmax_mode="matmul")
        return feats.numpy(), {"wall_s": 1.0, "h2d_s": 0.0, "wire": fmt,
                               "bytes_h2d": sum(p.numel() for p in planes)}

    return run


def test_gate_core_with_the_plain_extractor_behind_the_codecs():
    rng = np.random.default_rng(4)
    batches = [
        (f"b{k}", (rng.standard_normal((3, 6, 128)) + 1j * rng.standard_normal((3, 6, 128)))
         .astype(np.complex64) * np.exp(rng.uniform(-3, 3, (3, 1, 1))).astype(np.float32))
        for k in range(2)
    ]
    report = torch_wire_gate.gate(
        batches, {f: _plain_codec(f) for f in ("f32", "int24", "int16")}, budget_frac=0.85)
    assert report["f32"]["frames"] == 36
    assert report["f32"]["pass"] and report["f32"]["worst_budget_fraction"] < 0.85
    int24 = report["formats"]["int24"]["worst_budget_fraction"]
    int16 = report["formats"]["int16"]["worst_budget_fraction"]
    assert int16 > int24 > 0
    assert "k2_f32" not in report
    for fmt in ("int24", "int16"):
        e = report["formats"][fmt]
        assert 0 <= e["frames_with_branch_cut_flips"] <= e["branch_cut_flips"]


def test_branch_cut_flips_count_sign_changes_of_q_on_the_negative_real_side():
    """A Q far below the int16 codec's step on the negative real side
    rounds to +0 (phase -pi -> pi); on the positive side, or with a Q the
    codec keeps, nothing flips."""
    x = np.ones((2, 8), np.complex64)
    x[0, 1] = -1 - 1e-9j  # flips: I < 0, Q < 0 -> 0
    x[0, 2] = 1 - 1e-9j  # I > 0: no branch cut there
    x[1, 3] = -1 - 0.5j  # kept negative
    assert torch_wire_gate.branch_cut_flips(x, "int16").tolist() == [1, 0]
    assert torch_wire_gate.branch_cut_flips(x, "int24").tolist() == [1, 0]


def test_gate_record_has_the_jax_keys(root, tmp_path):
    out = tmp_path / "gate.json"
    rc = torch_wire_gate.main(["--device", "cpu", "--root", str(root), *TINY,
                               "--take", "8", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    jax = json.loads((ROOT / "metrics" / "wire_gate.json").read_text())
    assert _keys(jax) <= _keys(report)
    assert {"k2_f32", "device", "host"} <= set(report)
    assert report["device"]["type"] == "cpu" and report["host"]["cores"] >= 1
    assert report["f32"]["frames"] == 6 * 16 * 8
    for key in ("f32", "k2_f32"):
        assert report[key]["worst_budget_fraction"] < 0.85
    assert (report["formats"]["int16"]["worst_budget_fraction"]
            > report["formats"]["int24"]["worst_budget_fraction"])


def test_cnn_vs_mlp_record_has_the_jax_keys(root, tmp_path):
    out = tmp_path / "cnn_vs_mlp.json"
    common = ["--device", "cpu", "--root", str(root), *TINY, "--epochs", "1",
              "--seeds", "1", "--out", str(out)]
    assert torch_cnn_vs_mlp.main([*common, "--families", "mlp,cnn,cnn_aug"]) == 0
    assert torch_cnn_wide_control.main(common) == 0
    assert torch_cnn_wide_control.main([*common, "--dtype", "float32"]) == 0
    record = json.loads(out.read_text())
    jax = json.loads((ROOT / "metrics" / "cnn_vs_mlp.json").read_text())
    assert _keys(jax) <= _keys(record)
    assert record["config"]["frames"] == 8 and record["config"]["seeds"] == 1
    for arm in ("mlp", "cnn", "cnn_aug", "cnn_wide_kernel_control"):
        assert len(record[arm]["per_snr_mean"]) == 16
        row = record["vs_jax"][arm]
        assert row["bar"] == torch_cnn_vs_mlp.ONE_SEED_BAR
        for key in ("val_accuracy_mean", "high_snr_mean"):
            assert row[key]["jax"] == pytest.approx(
                jax[arm].get(key, np.mean(jax[arm]["val_accuracy_per_seed"])))
            assert row[key]["gap"] == pytest.approx(row[key]["port"] - row[key]["jax"])
    for arm in ("cnn", "cnn_aug", "cnn_wide_kernel_control",
                "cnn_wide_kernel_control_float32"):
        (layers,) = record[arm]["conv_bias_per_seed"]
        assert len(layers) == 3 and all(b["product_std"] > 0 for b in layers)
        assert record[arm]["device"]["type"] == "cpu"
    assert record["cnn_wide_kernel_control"]["arch"]["dtype"] == "bfloat16"
    assert record["cnn_wide_kernel_control_float32"]["arch"]["dtype"] == "float32"
    row = record["vs_jax"]["cnn_wide_kernel_control_float32"]
    assert row["val_accuracy_mean"]["jax"] == pytest.approx(
        np.mean(jax["cnn_wide_kernel_control"]["val_accuracy_per_seed"]))
    inf = record["cnn_inference"]
    assert inf["batch"] == 6 * 16 * 8 and inf["ms_per_batch"] > 0 and inf["k3_route_ms_per_batch"] > 0
    assert inf["device"]["type"] == "cpu"


def test_vs_jax_bar_for_seeded_arms():
    """Three seeds a side: 2 * sqrt(std_port^2 + std_jax^2) + 0.01."""
    mine = {"mlp": {"val_accuracy_per_seed": [0.9, 0.92, 0.94], "val_accuracy_mean": 0.92,
                    "val_accuracy_std": 0.02, "high_snr_mean": 0.92}}
    ref = {"mlp": {"val_accuracy_per_seed": [0.9, 0.9, 0.9], "val_accuracy_mean": 0.9,
                   "val_accuracy_std": 0.015, "high_snr_mean": 0.99}}
    row = torch_cnn_vs_mlp.vs_jax(mine, ref)["mlp"]
    assert row["bar"] == pytest.approx(2 * 0.025 + 0.01)
    assert row["val_accuracy_mean"]["within"]
    assert not row["high_snr_mean"]["within"]


def test_heldout_mask_is_the_jax_packages():
    cfg = torch_cnn_vs_mlp.make_config("unused", frames=8, frame_size=64)
    jcfg = JaxConfig().replace(signals={"num_frames": 8, "frame_size": 64})
    rng = np.random.default_rng(2)
    features = {m: rng.standard_normal((16, 8, 18)).astype(np.float32)
                for m in cfg.signals.modulations_with_noise}
    got = torch_cnn_vs_mlp.heldout_mask(cfg, features)
    tr = jax_preprocess(features, jcfg, return_indices=True)[-1][0]
    want = jax_train_frame_mask(jcfg, tr)
    assert got.shape == (6, 16, 8)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_summarize_is_the_numpy_aggregation():
    rng = np.random.default_rng(3)
    curves = [rng.random((6, 16)) for _ in range(3)]
    vals = [0.5, 0.6, 0.7]
    got = torch_cnn_vs_mlp.summarize(curves, vals)
    stack = np.stack(curves)
    np.testing.assert_allclose(got["per_snr_mean"], stack.mean(axis=(0, 1)))
    np.testing.assert_allclose(got["per_snr_std"], stack.mean(axis=1).std(axis=0))
    assert got["overall_mean"] == pytest.approx(stack.mean())
    assert got["high_snr_mean"] == pytest.approx(stack[:, :, 10:].mean())
    assert got["val_accuracy_mean"] == pytest.approx(0.6)
    assert got["val_accuracy_std"] == pytest.approx(np.std(vals))


@pytest.mark.parametrize("script", [torch_wire_gate, torch_cnn_vs_mlp,
                                    torch_cnn_wide_control])
def test_default_device_raises_without_a_card(script, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        script.main(["--root", str(tmp_path), "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_card_vs_cpu_runs_on_two_cpu_devices():
    """``scripts/torch_training_card_vs_cpu.py``'s comparison with the CPU
    in the card's place, at a small size: the two plain runs are the same
    run (gap 0), the moved start gives a spread, every bar holds, and each
    fault planted in the strided convolution is caught at the first step
    its gradients reach (the flipped kernels' loss, both faults' conv
    weight gradients)."""
    from scripts.torch_training_card_vs_cpu import PLANTS, card_vs_cpu

    for dtype in ("float32", "bfloat16"):
        result = card_vs_cpu(dtype, "cpu", steps=6, n=128, batch=32)
        assert result["ok"], result["failures"]
        assert result["steps"] == 6 and max(result["loss_gap_per_step"]) == 0.0
        assert max(result["loss_bar_per_step"]) > result["loss_bar_per_step"][0]
        assert result["worst_tensor_gap_over_bar"] == 0.0
        assert len(result["conv_bias"]["card"]) == 3
        assert set(result["planted"]) == set(PLANTS)
        for fault, got in result["planted"].items():
            assert got["caught"], (dtype, fault)
            first = [f for f in got["failures"] if " at step 1:" in f]
            assert any(f.startswith("grad.conv.1.weight") for f in first), (dtype, fault)
        assert any(f.startswith("loss at step 1:")
                   for f in result["planted"]["kernels"]["failures"]), dtype


def test_arms_cpu_runs_both_packages_and_merges(tmp_path):
    """``scripts/torch_cnn_arms_cpu.py`` at a tiny size: each package's runs
    and summary of two arms, the port-against-JAX rows with the one-seed
    bar, both packages' bias gradients in bf16 and float32; then the two
    arms split into two records and united again by ``--merge``."""
    from scripts import torch_cnn_arms_cpu

    tiny = ["--frames", "4", "--frame-size", "64", "--epochs", "1", "--seeds", "1"]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert torch_cnn_arms_cpu.main([*tiny, "--arms", "cnn,cnn_wide_kernel_control",
                                    "--out", str(a)]) == 0
    whole = json.loads(a.read_text())
    assert set(whole["port_vs_jax"]) == {"cnn", "cnn_wide_kernel_control"}
    for arm in whole["port_vs_jax"]:
        for pkg in ("jax", "port"):
            entry = whole["arms"][arm][pkg]
            (run,) = entry["runs"]
            assert np.asarray(run["curve"]).shape == (6, 16) and len(run["conv_bias"]) == 3
            assert entry["val_accuracy_mean"] == run["val_accuracy"]
        assert whole["port_vs_jax"][arm]["bar"] == torch_cnn_arms_cpu.ONE_SEED_BAR
    assert [g["dtype"] for g in whole["bias_gradients"]] == ["bfloat16", "float32"]
    assert all(g[pkg]["median_abs"] >= 0 for g in whole["bias_gradients"]
               for pkg in ("jax", "port"))
    c = tmp_path / "c.json"
    b.write_text(json.dumps({**whole, "arms": {"cnn": whole["arms"]["cnn"]}}))
    a.write_text(json.dumps({**whole, "arms": {
        "cnn_wide_kernel_control": whole["arms"]["cnn_wide_kernel_control"]}}))
    assert torch_cnn_arms_cpu.main(["--merge", str(a), str(b), "--out", str(c)]) == 0
    merged = json.loads(c.read_text())
    assert merged["port_vs_jax"] == whole["port_vs_jax"]
    assert merged["bias_gradients"] == whole["bias_gradients"]
    assert merged["arms"] == whole["arms"]
