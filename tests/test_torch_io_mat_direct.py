"""The direct route of ``amcpy_tpu_torch/data/io_mat.py``: a modulation's I
and Q planes read straight from an uncompressed MAT v5 file's bytes
(``locate_planes``, ``read_planes``) and reordered into frames
(``planes_to_frames``), against ``scipy.io.loadmat`` and the host split of
``extraction._prep_chunk``, bit for bit; every file the route does not
take reads through ``loadmat``, counted; ``run_extraction`` writes the
same artifacts from an uncompressed and a compressed copy of a dataset.

This file imports nothing of JAX. The ``cuda`` cases (skipped without a
card) hold the card's route, pinned buffers and all, to the ``loadmat``
route's features:

    python -m pytest --noconftest -m cuda tests/test_torch_io_mat_direct.py
"""

import json

import numpy as np
import pytest
import scipy.io
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat
from amcpy_tpu_torch.extraction import (
    _prep_chunk,
    extract_batch,
    prepare_file_planes,
    prepare_frames,
    run_extraction,
)
from amcpy_tpu_torch.utils.metrics import clear_spans, spans


def _frames(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (x * np.exp(rng.uniform(-3, 3, shape[:-1] + (1,)))).astype(dtype)


def _savemat(path, variables, **kw):
    """``variables`` between a ``Modulation`` string and a real array, as
    scipy writes them."""
    scipy.io.savemat(str(path), {"Modulation": "BPSK", **variables,
                                 "after": np.arange(5.0)}, **kw)


def _loadmat_planes(path, var, frame_size):
    """Today's host route: loadmat, the complex64 copy, the float32 split."""
    raw = np.ascontiguousarray(scipy.io.loadmat(str(path))[var][..., :frame_size],
                               dtype=np.complex64)
    return _prep_chunk(raw.reshape(-1, raw.shape[-1]), True, False)


def _direct_planes(path, var, frame_size):
    layout = io_mat.locate_planes(path, var)
    assert layout is not None
    s, f, _ = layout.dims
    return tuple(io_mat.planes_to_frames(p, s, f)
                 for p in io_mat.read_planes(path, layout, frame_size))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["single", "double"])
@pytest.mark.parametrize("frame_size", [37, 20], ids=["whole", "prefix"])
@pytest.mark.parametrize("var", ["ab", "signal_with_a_longer_name"], ids=["small_name", "name"])
def test_direct_planes_equal_loadmat(tmp_path, dtype, frame_size, var):
    """Odd S and F, N = 37 read whole or as its first 20 samples, a name of
    a small element and of a regular one, a string before and an array
    after: the same float32 planes bit for bit, one direct read."""
    path = tmp_path / "d.mat"
    _savemat(path, {"before": _frames((2, 3, 4), dtype, 1),
                    var: _frames((3, 5, 37), dtype, 2)})
    layout = io_mat.locate_planes(path, var)
    assert layout.dims == (3, 5, 37)
    assert layout.dtype == (torch.float32 if dtype == np.complex64 else torch.float64)
    reads = io_mat.direct_reads
    got = _direct_planes(path, var, frame_size)
    assert io_mat.direct_reads == reads + 1
    for g, w in zip(got, _loadmat_planes(path, var, frame_size)):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert g.shape == (15, min(frame_size, 37))
        assert torch.equal(g, w)


def _mismatched_class(path, var):
    """A complex64 variable ``v`` whose array flags say class double: its
    planes are stored as miSINGLE, which the direct route does not take."""
    assert var == "v"
    _savemat(path, {var: _frames((2, 3, 8), np.complex64, 3)})
    blob = bytearray(path.read_bytes())
    at = blob.index(b"\x01\x00\x01\x00v\x00\x00\x00") - 32  # flags word, dims, then the name
    assert blob[at] == 7  # mxSINGLE_CLASS
    blob[at] = 6
    path.write_bytes(bytes(blob))


def _header(version: bytes):
    def write(path, var):
        _savemat(path, {var: _frames((2, 3, 8), np.complex64, 3)})
        blob = bytearray(path.read_bytes())
        blob[124:128] = version
        path.write_bytes(bytes(blob))
    return write


FALLBACKS = {
    "compressed": lambda p, v: _savemat(p, {v: _frames((2, 3, 8), np.complex64, 3)},
                                        do_compression=True),
    "real_only": lambda p, v: _savemat(p, {v: _frames((2, 3, 8), np.complex64, 3).real}),
    "two_dims": lambda p, v: _savemat(p, {v: _frames((3, 8), np.complex64, 3)}),
    "class_not_storage": _mismatched_class,
    "big_endian": _header(b"\x01\x00MI"),
    "v73": _header(b"\x00\x02IM"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_files_the_route_does_not_take_are_located_as_none(tmp_path, case):
    path = tmp_path / "f.mat"
    FALLBACKS[case](path, "v")
    assert io_mat.locate_planes(path, "v") is None


@pytest.mark.parametrize("case", ["compressed", "real_only", "two_dims"])
def test_a_fallback_reads_through_loadmat_and_counts_it(tmp_path, case):
    cfg = Config().replace(paths={"root": str(tmp_path)}, signals={"frame_size": 8})
    cfg.paths.ensure_dirs()
    var = cfg.signals.mat_info["BPSK"]
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    FALLBACKS[case](path, var)
    assert io_mat.locate_planes(path, var) is None
    reads, direct = io_mat.loadmat_reads, io_mat.direct_reads
    got = io_mat.load_modulation(cfg, "BPSK")
    assert (io_mat.loadmat_reads, io_mat.direct_reads) == (reads + 1, direct)
    want = np.ascontiguousarray(scipy.io.loadmat(str(path))[var], dtype=np.complex64)
    np.testing.assert_array_equal(got, want)


SIGNALS = {"frame_size": 64, "num_frames": 5, "snr_db": (0, 10, 20)}


def _dataset(root, dtype, seed, **kw):
    """Every modulation's ``(3, 5, 64)`` frames in ``root``'s
    ``all_modulations.mat``; returns the config."""
    cfg = Config().replace(paths={"root": str(root)}, signals=SIGNALS)
    cfg.paths.ensure_dirs()
    s = cfg.signals
    _savemat(cfg.paths.mat_data / cfg.paths.mat_filename,
             {s.mat_info[m]: _frames((s.num_snr, s.num_frames, 64), dtype, seed + k)
              for k, m in enumerate(s.modulations_with_noise)}, **kw)
    return cfg


def test_a_missing_variable_raises_key_error(tmp_path):
    cfg = _dataset(tmp_path, np.complex64, 4)
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    raw = scipy.io.loadmat(str(path))
    del raw[cfg.signals.mat_info["QPSK"]]
    scipy.io.savemat(str(path), {k: v for k, v in raw.items() if not k.startswith("__")})
    assert io_mat.locate_planes(path, cfg.signals.mat_info["QPSK"]) is None
    with pytest.raises(KeyError, match=cfg.signals.mat_info["QPSK"]):
        run_extraction(cfg, device="cpu")


def _records(cfg):
    lines = (cfg.paths.metrics / "run.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["event"] == "extract"]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["single", "double"])
@pytest.mark.parametrize("kernel", ["xla", "fused"], ids=["packed", "planes"])
def test_run_extraction_writes_the_same_artifacts_from_either_route(tmp_path, dtype, kernel):
    """An uncompressed and a compressed copy of one dataset: the same
    ``{MOD}_features.mat`` bytes of features, six direct reads against six
    ``loadmat`` reads, and the route in the spans and the stage records."""
    cfgs = [_dataset(tmp_path / name, dtype, 7, do_compression=name == "zipped")
            .replace(compute={"kernel": kernel}) for name in ("plain", "zipped")]
    mods = cfgs[0].signals.modulations_with_noise
    got, counts = [], []
    for cfg in cfgs:
        reads = io_mat.direct_reads, io_mat.loadmat_reads
        clear_spans()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run_extraction(cfg, device="cpu")
        counts.append((io_mat.direct_reads - reads[0], io_mat.loadmat_reads - reads[1]))
        loads = [r for r in spans() if r.name == "amc.io.load_modulation"]
        assert len(loads) == len(mods)
        direct = int(cfg is cfgs[0])
        assert {r.counts["direct"] for r in loads} == {direct}
        assert {r["mat_read"] for r in _records(cfg)} == {"direct" if direct else "loadmat"}
        got.append({m: io_mat.load_features(cfg, m) for m in mods})
    clear_spans()
    assert counts == [(len(mods), 0), (0, len(mods))]
    for m in mods:
        assert got[0][m].shape == (3, 5, 18)
        np.testing.assert_array_equal(got[0][m], got[1][m])


@pytest.mark.parametrize("kernel", ["xla", "fused", "pallas"])
def test_file_order_chunks_equal_prepared_chunks(tmp_path, kernel):
    """``extract_batch`` of the raw planes in chunks of 4 frames equals it
    of ``prepare_frames``'s chunks of 4, on every route."""
    path = tmp_path / "c.mat"
    _savemat(path, {"v": _frames((3, 5, 64), np.complex64, 9)})
    layout = io_mat.locate_planes(path, "v")
    planes = io_mat.read_planes(path, layout, 64)
    direct = prepare_file_planes(*planes, 3, 5, chunk_size=4, kernel=kernel, device="cpu")
    frames = scipy.io.loadmat(str(path))["v"].reshape(15, 64)
    prepared = prepare_frames(frames, chunk_size=4, kernel=kernel, device="cpu")
    tim: dict = {}
    got = extract_batch(direct, kernel=kernel, timings=tim, device="cpu")
    np.testing.assert_array_equal(got, extract_batch(prepared, kernel=kernel, device="cpu"))
    assert tim["bytes_h2d"] == 2 * 15 * 64 * 4 and tim["wire"] == "f32"


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_dataset(root, dtype, **kw):
    cfg = Config().replace(paths={"root": str(root)},
                           signals={"frame_size": 2048, "num_frames": 40, "snr_db": (0, 10, 20)})
    cfg.paths.ensure_dirs()
    s = cfg.signals
    _savemat(cfg.paths.mat_data / cfg.paths.mat_filename,
             {s.mat_info[m]: _frames((3, 40, 2048), dtype, 20 + k)
              for k, m in enumerate(s.modulations_with_noise)}, **kw)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["single", "double"])
def test_card_route_equals_the_loadmat_route(cuda, tmp_path, dtype):
    """K1 of the planes read straight into pinned memory and reordered on
    the card equals K1 of the ``loadmat`` route, bit for bit."""
    plain = _card_dataset(tmp_path / "plain", dtype)
    zipped = _card_dataset(tmp_path / "zipped", dtype, do_compression=True)
    reads = io_mat.direct_reads, io_mat.loadmat_reads
    got = run_extraction(plain, device=cuda)
    assert (io_mat.direct_reads - reads[0], io_mat.loadmat_reads - reads[1]) == (6, 0)
    want = run_extraction(zipped, device=cuda)
    assert io_mat.loadmat_reads - reads[1] == 6
    assert {r["mat_read"] for r in _records(plain)} == {"direct"}
    assert {r["mat_read"] for r in _records(zipped)} == {"loadmat"}
    for m in got:
        assert np.isfinite(got[m]).all()
        np.testing.assert_array_equal(got[m], want[m])


@pytest.mark.cuda
def test_two_passes_reuse_the_pinned_planes(cuda, tmp_path, monkeypatch):
    """Two passes read their twelve planes into reused page-locked blocks,
    and both give the ``loadmat`` route's features."""
    plain = _card_dataset(tmp_path / "plain", np.complex64)
    want = run_extraction(_card_dataset(tmp_path / "zipped", np.complex64,
                                        do_compression=True), device=cuda)
    ptrs = []
    read = io_mat.read_planes

    def spy(*args, **kw):
        planes = read(*args, **kw)
        assert all(p.is_pinned() for p in planes)
        ptrs.extend(p.data_ptr() for p in planes)
        return planes

    monkeypatch.setattr(io_mat, "read_planes", spy)
    for _ in range(2):
        got = run_extraction(plain, device=cuda, force=True)
        for m in got:
            np.testing.assert_array_equal(got[m], want[m])
    assert len(ptrs) == 24 and len(set(ptrs)) < len(ptrs)


@pytest.mark.cuda
def test_a_plane_in_flight_is_not_overwritten(cuda, tmp_path):
    """A plane's copy queued behind a long kernel, its host tensor dropped
    and a second file read at once into new pinned memory: the copy lands
    the first file's samples."""
    paths = [tmp_path / "a.mat", tmp_path / "b.mat"]
    for k, path in enumerate(paths):
        _savemat(path, {"v": _frames((4, 64, 2048), np.complex64, 30 + k)})
    layout = io_mat.locate_planes(paths[0], "v")
    first = io_mat.read_planes(paths[0], layout, 2048, pin=True)
    want = [p.clone() for p in first]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream
    on_card = [p.to(cuda, non_blocking=True) for p in first]
    del first
    second = io_mat.read_planes(paths[1], io_mat.locate_planes(paths[1], "v"), 2048, pin=True)
    torch.cuda.synchronize()
    for got, w, other in zip(on_card, want, second):
        assert torch.equal(got.cpu(), w) and not torch.equal(w, other)
