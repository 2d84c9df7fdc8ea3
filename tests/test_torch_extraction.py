"""The port's extraction runtime (``amcpy_tpu_torch/extraction.py``) against
the JAX package's ``run_extraction`` on the CPU: one tiny
``all_modulations.mat`` (6 modulations x 2 SNR x 4 frames x 512 samples)
through both, six ``{MOD}_features.mat`` artifacts compared within
``2e-4 * term_scales + 2e-5 * |want|`` (``tests/test_fused.py``), and the
runtime's own contracts: skip-if-exists, corrupt-artifact recompute, the
routing check and the ``timings`` keys.
"""

import json

import numpy as np
import pytest
import scipy.io
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.extraction import run_extraction as jax_run_extraction
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat
from amcpy_tpu_torch.extraction import (
    extract_batch,
    prepare_frames,
    resolve_kernel,
    run_extraction,
)
from amcpy_tpu_torch.ops.features import extract_features_planar, to_planar
from amcpy_tpu_torch.ops.wire import resolve_wire_format

from .oracle import term_scales

N = 512
SIGNALS = {"frame_size": N, "num_frames": 4, "snr_db": (0, 10)}


def _write_mat(cfg, seed=0):
    """Random complex64 frames under every modulation's variable name;
    returns ``{mod: (2, 4, N)}``."""
    rng = np.random.default_rng(seed)
    s = cfg.signals
    data = {}
    for mod in s.modulations_with_noise:
        shape = (s.num_snr, s.num_frames, N)
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        data[mod] = (x * np.exp(rng.uniform(-2, 2, shape[:2] + (1,)))).astype(
            np.complex64
        )
    cfg.paths.ensure_dirs()
    scipy.io.savemat(
        str(cfg.paths.mat_data / cfg.paths.mat_filename),
        {s.mat_info[m]: a for m, a in data.items()},
    )
    return data


@pytest.fixture
def cfg(tmp_path):
    return Config().replace(paths={"root": str(tmp_path)}, signals=SIGNALS)


def test_artifacts_match_jax_run_extraction(tmp_path):
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path / "jax")}, signals=SIGNALS)
    cfg = Config().replace(paths={"root": str(tmp_path / "torch")}, signals=SIGNALS)
    data = _write_mat(jcfg, seed=1)
    _write_mat(cfg, seed=1)

    want = jax_run_extraction(jcfg)
    got = run_extraction(cfg, device="cpu")
    assert set(got) == set(want) == set(cfg.signals.modulations_with_noise)
    for mod in cfg.signals.modulations_with_noise:
        name = f"{mod}_features.mat"
        jpath = jcfg.paths.calculated_features / name
        path = cfg.paths.calculated_features / name
        assert sorted(scipy.io.whosmat(str(path))) == sorted(
            scipy.io.whosmat(str(jpath))
        )
        mine, theirs = scipy.io.loadmat(str(path)), scipy.io.loadmat(str(jpath))
        assert mine["Modulation"] == theirs["Modulation"]
        var = cfg.signals.mat_info[mod]
        assert mine[var].shape == (2, 4, 18) and mine[var].dtype == np.float32
        np.testing.assert_array_equal(mine[var], got[mod])

        frames = data[mod].reshape(-1, N)
        scales = np.stack([term_scales(f) for f in frames])
        a, b = got[mod].reshape(-1, 18), want[mod].reshape(-1, 18)
        assert (np.abs(a - b) <= 2e-4 * scales + 2e-5 * np.abs(b)).all(), mod


def test_skips_existing_and_recomputes_corrupt_artifact(cfg):
    _write_mat(cfg, seed=2)
    first = run_extraction(cfg, device="cpu")
    qpsk = cfg.paths.calculated_features / "QPSK_features.mat"
    bpsk = cfg.paths.calculated_features / "BPSK_features.mat"
    bpsk_mtime = bpsk.stat().st_mtime_ns
    qpsk.write_bytes(b"not a mat file")

    second = run_extraction(cfg, device="cpu")
    for mod in first:
        np.testing.assert_array_equal(second[mod], first[mod])
    assert bpsk.stat().st_mtime_ns == bpsk_mtime  # skipped, not rewritten
    np.testing.assert_array_equal(io_mat.load_features(cfg, "QPSK"), first["QPSK"])

    events = [
        json.loads(line)
        for line in (cfg.paths.metrics / "run.jsonl").read_text().splitlines()
    ]
    second_run = events[len(first):]  # the first run logged one "extract" per mod
    assert [e["event"] for e in events[: len(first)]] == ["extract"] * len(first)
    assert sum(e["event"] == "extract_skip" for e in second_run) == len(first) - 1
    corrupt = [e for e in second_run if e["event"] == "extract_corrupt_artifact"]
    assert [e["modulation"] for e in corrupt] == ["QPSK"]
    redone = [e for e in second_run if e["event"] == "extract"]
    assert [e["modulation"] for e in redone] == ["QPSK"]

    forced = run_extraction(cfg, device="cpu", force=True)
    assert bpsk.stat().st_mtime_ns != bpsk_mtime
    for mod in first:
        np.testing.assert_array_equal(forced[mod], first[mod])


def test_prepared_batch_routing_mismatch_raises():
    frames = np.ones((4, 256), np.complex64)
    prepared = prepare_frames(frames, kernel="fused", device="cpu")
    assert prepared.wants_planes
    with pytest.raises(ValueError, match="routing"):
        extract_batch(prepared, kernel="xla", device="cpu")


@pytest.mark.parametrize("kernel", ["xla", "fused", "pallas"])
def test_extract_batch_routes_agree(kernel):
    """Every route, chunked and prepared ahead, gives the plain extractor's
    features; on the CPU the kernel routes take their plain versions."""
    rng = np.random.default_rng(3)
    frames = (
        rng.standard_normal((45, 256)) + 1j * rng.standard_normal((45, 256))
    ).astype(np.complex64)
    want = extract_features_planar(
        torch.from_numpy(to_planar(frames)), gmax_mode="matmul"
    ).numpy()
    tim: dict = {}
    direct = extract_batch(frames, kernel=kernel, chunk_size=16, timings=tim, device="cpu")
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=0)
    assert set(tim) == {
        "host_prep_s", "prep_total_s", "h2d_s", "wait_s", "bytes_h2d", "wire"
    }
    assert tim["bytes_h2d"] == 45 * 2 * 256 * 4 and tim["wire"] == "f32"
    prepared = prepare_frames(frames, kernel=kernel, chunk_size=16, device="cpu")
    assert len(prepared.chunks) == 3
    np.testing.assert_array_equal(
        extract_batch(prepared, kernel=kernel, device="cpu"), direct
    )


def test_kernel_and_wire_resolution():
    assert resolve_kernel("auto", torch.device("cpu")) == "xla"
    assert resolve_kernel("auto", torch.device("cuda")) == "fused"
    assert resolve_kernel("pallas", torch.device("cpu")) == "pallas"
    with pytest.raises(ValueError, match="kernel"):
        resolve_kernel("mosaic", torch.device("cpu"))
    assert resolve_wire_format("auto") == resolve_wire_format("f32") == "f32"
    for fmt in ("int16", "int24"):
        assert resolve_wire_format(fmt) == fmt
    with pytest.raises(ValueError, match="wire format"):
        resolve_wire_format("bf16")


def test_run_extraction_refuses_unported_wire_format(cfg):
    """A format the JAX package does not know either raises before any
    work; its codecs run (``tests/test_torch_wire.py``)."""
    _write_mat(cfg)
    with pytest.raises(ValueError, match="bf16"):
        run_extraction(cfg.replace(compute={"wire_format": "bf16"}), device="cpu")
    assert not list(cfg.paths.calculated_features.glob("*.mat"))


def test_io_mat_matches_jax(tmp_path):
    """Dataset reading and the artifact format are shared with the JAX
    package: the same arrays come out, and each reads the other's files."""
    from amcpy_tpu.data import io_mat as jax_io_mat

    jcfg = JaxConfig().replace(paths={"root": str(tmp_path)}, signals=SIGNALS)
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals=SIGNALS)
    data = _write_mat(cfg, seed=4)
    mine, theirs = io_mat.load_dataset(cfg), jax_io_mat.load_dataset(jcfg)
    assert list(mine) == list(theirs)
    for mod, arr in mine.items():
        assert arr.dtype == np.complex64
        np.testing.assert_array_equal(arr, theirs[mod])
        np.testing.assert_array_equal(arr, data[mod])
        np.testing.assert_array_equal(io_mat.load_modulation(cfg, mod), arr)
    np.testing.assert_array_equal(
        io_mat.stacked_batch(mine, cfg), jax_io_mat.stacked_batch(theirs, jcfg)
    )

    feats = np.random.default_rng(5).standard_normal((2, 4, 18)).astype(np.float32)
    io_mat.save_features(cfg, "8PSK", feats)
    np.testing.assert_array_equal(jax_io_mat.load_features(jcfg, "8PSK"), feats)
    jax_io_mat.save_features(jcfg, "WGN", feats)
    np.testing.assert_array_equal(io_mat.load_features(cfg, "WGN"), feats)


def test_stage_timer_logs_and_trace_region_records(tmp_path):
    from amcpy_tpu_torch.utils.metrics import MetricsLogger, clear_spans, span, spans, stage_timer

    log = MetricsLogger(tmp_path / "m" / "run.jsonl")
    with stage_timer(log, "extract", device=torch.device("cpu"), modulation="BPSK") as rec:
        rec["frames"] = 8
    (line,) = (tmp_path / "m" / "run.jsonl").read_text().splitlines()
    got = json.loads(line)
    assert got["event"] == "extract" and got["frames"] == 8 and got["wall_s"] >= 0
    assert MetricsLogger(None).log("x", a=1)["a"] == 1  # no sink: nothing written

    clear_spans()
    with torch.profiler.profile() as prof:
        with span("amc_region", frames=4):
            torch.ones(4).sum()
    assert "amc_region" in {e.key for e in prof.key_averages()}
    (rec,) = spans()
    assert rec.name == "amc_region" and rec.counts == {"frames": 4} and rec.t1_ns > rec.t0_ns
    clear_spans()
