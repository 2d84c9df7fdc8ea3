"""``run_extraction_synthetic`` (frames drawn on the device and extracted in
one pass) and ``run_extraction(profile_dir=...)`` on the CPU.

The cases of ``tests/test_extraction.py``'s synthetic tests: a ragged
batch of 5 SNR levels x 4 frames (the JAX package pads it to its mesh; the
port has nothing to pad and must still get every row), and the synthetic
path equal to ``write_dataset`` followed by ``run_extraction`` for the same
seed. On one device both draw the same frames (``data/synth.py``) and cut
them into the same chunks, so the features are identical, not only close.
"""

import json

import numpy as np
import pytest

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.extraction import run_extraction_synthetic as jax_run_extraction_synthetic
from amcpy_tpu_torch import extraction
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat, synth
from amcpy_tpu_torch.extraction import run_extraction, run_extraction_synthetic
from amcpy_tpu_torch.utils.metrics import MetricsLogger

RAGGED = {"frame_size": 128, "num_frames": 4, "snr_db": (0, 4, 8, 12, 16)}


@pytest.mark.parametrize("kernel", ["auto", "fused"])
@pytest.mark.parametrize("chunk", [None, 7])
def test_ragged_batch(tmp_path, monkeypatch, kernel, chunk):
    """5 x 4 = 20 rows a modulation, in one chunk or in chunks of 7, 7 and
    6; both routes (packed planes for the plain extractor, separate planes
    for the fused wrapper) give every row, finite, as one chunk does (to
    float32 roundoff: the plain DFT's sums run in an order that depends on
    the batch's size)."""
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals=RAGGED,
                           compute={"kernel": kernel})
    whole = run_extraction_synthetic(cfg, seed=2, device="cpu")
    if chunk is not None:
        monkeypatch.setattr(extraction, "_default_chunk_size", lambda dev, n: chunk)
    got = run_extraction_synthetic(cfg, seed=2, device="cpu")
    for mod, feats in got.items():
        assert feats.shape == (5, 4, 18)
        assert np.isfinite(feats).all(), mod
        np.testing.assert_allclose(feats, whole[mod], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(io_mat.load_features(cfg, mod), feats)


def test_ragged_batch_runs_in_jax_too(tmp_path):
    """The JAX package's side of the case, for the record: the same shapes
    come back."""
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path)}, signals=RAGGED)
    got = jax_run_extraction_synthetic(jcfg, seed=2)
    assert {m: f.shape for m, f in got.items()} == {
        m: (5, 4, 18) for m in Config().signals.modulations_with_noise
    }


@pytest.mark.parametrize("seed", [9, 10])
def test_matches_write_dataset_then_run_extraction(tmp_path, seed):
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"frame_size": 128, "num_frames": 6})
    synth.write_dataset(cfg, seed=seed, device="cpu")
    host = run_extraction(cfg, force=True, device="cpu")
    log = tmp_path / "synthetic.jsonl"
    dev = run_extraction_synthetic(cfg, seed=seed, device="cpu", logger=MetricsLogger(log))
    for mod in host:
        np.testing.assert_array_equal(dev[mod], host[mod])
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["modulation"] for r in recs] == list(cfg.signals.modulations_with_noise)
    assert all(r["event"] == "extract_synthetic" and r["frames"] == 96
               and r["kernel"] == "xla" and r["wall_s"] >= 0 for r in recs)


def test_extract_profile_writes_a_trace(tmp_path):
    cfg = Config().replace(paths={"root": str(tmp_path)},
                           signals={"frame_size": 128, "num_frames": 2, "snr_db": (0, 10)})
    synth.write_dataset(cfg, seed=1, device="cpu")
    plain = run_extraction(cfg, device="cpu")
    traced = run_extraction(cfg, force=True, device="cpu", profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "extract_trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    for mod in plain:
        np.testing.assert_array_equal(traced[mod], plain[mod])
