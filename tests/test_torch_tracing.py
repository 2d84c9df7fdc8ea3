"""The port's host spans (``amcpy_tpu_torch/utils/metrics.py``) in the
server, the staging path and extraction, on the CPU: with no profiler
running nothing is recorded and no ``record_function`` is opened; under
``torch.profiler.profile`` (this thread's, or every thread's) each request
has its ``amc.request``, ``amc.queue`` and ``amc.reply`` under one id and
one ``amc.dispatch`` that lists it, the counts are the requests' shapes,
spans nest under their parents across threads, and the Chrome trace holds
the spans of work and none of the waiting ones. The recorder's cap, and
the profiler flag that is the one switch, are pinned here too.

The staging buffer's ``amc.stage.wait`` and ``amc.stage.enqueue``, a
coalesced dispatch written into it in pieces with no ``amc.concat``, and
the copies' device seconds of ``extract_batch(timings=)['h2d_s']``, exist
only on a card (``cuda`` marker; skips without one).
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import scipy.io
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.extraction import extract_batch, run_extraction
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.server import AMCServer
from amcpy_tpu_torch.train.checkpoint import save_checkpoint
from amcpy_tpu_torch.utils import metrics
from amcpy_tpu_torch.utils.metrics import clear_spans, span, spans, spans_dropped

N = 256
SIGNALS = {"frame_size": N, "num_frames": 3, "snr_db": (0, 10)}
#: spans that do host work: in the profiler's trace
SERVE_WORK = {"amc.dispatch", "amc.concat", "amc.stage.write", "amc.model", "amc.fetch",
              "amc.reply"}
EXTRACT_WORK = {"amc.extract.pass", "amc.io.load_modulation", "amc.extract.prepare",
                "amc.extract", "amc.io.save_features"}
#: spans that only wait for another thread: recorded, not in the trace
WAITING = {"amc.request", "amc.queue", "amc.extract.load_wait"}


def _frames(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N)) + 1j * rng.standard_normal((b, N))
    return (x * np.exp(rng.uniform(-1, 1, (b, 1)))).astype(np.complex64)


def _profile(all_threads: bool):
    from torch.profiler import ProfilerActivity, profile

    extra = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        extra["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], **extra)


def _trace_names(prof, tmp_path) -> set[str]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


@pytest.fixture(autouse=True)
def empty_recorder():
    clear_spans()
    yield
    clear_spans()


@contextlib.contextmanager
def _running_server(tmp_path, device):
    """A running server of a seeded MLP checkpoint at N = 256 on ``device``."""
    cfg = Config().replace(paths={"root": str(tmp_path / "root")}, signals={"frame_size": N})
    torch.manual_seed(0)
    feats = extract_batch(_frames(32, seed=1), device="cpu")
    scaler = Standardizer.fit(feats[:, list(cfg.features.used_columns)])
    save_checkpoint(cfg, "srv", AMCClassifier(6), scaler)
    srv = AMCServer(cfg, "srv", host="127.0.0.1", port=0, device=device)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown()
    th.join(10)
    assert not th.is_alive()


@pytest.fixture
def server(tmp_path):
    """A running CPU server of a seeded MLP checkpoint at N = 256."""
    with _running_server(tmp_path, "cpu") as srv:
        yield srv


def _clients(srv, sizes: list[int]) -> list[dict]:
    """One request a thread, the first held in its dispatch for 50 ms so
    that the others queue behind it and are coalesced."""
    logits, first = srv.pipe.logits, threading.Event()

    def slow_first(frames):
        if not first.is_set():
            first.set()
            time.sleep(0.05)
        return logits(frames)

    srv.pipe.logits = slow_first
    out: list = [None] * len(sizes)

    def go(k):
        if k:
            first.wait(10)
        out[k] = srv.classify(_frames(sizes[k], seed=10 + k).tobytes(), "c64", N, True)

    threads = [threading.Thread(target=go, args=(k,)) for k in range(len(sizes))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
        assert not th.is_alive()
    srv.pipe.logits = logits
    return out


def _write_mat(cfg, seed=0) -> None:
    rng = np.random.default_rng(seed)
    s = cfg.signals
    data = {m: (rng.standard_normal((s.num_snr, s.num_frames, N))
                + 1j * rng.standard_normal((s.num_snr, s.num_frames, N))).astype(np.complex64)
            for m in s.modulations_with_noise}
    cfg.paths.ensure_dirs()
    scipy.io.savemat(str(cfg.paths.mat_data / cfg.paths.mat_filename),
                     {s.mat_info[m]: a for m, a in data.items()})


@pytest.fixture
def dataset(tmp_path):
    cfg = Config().replace(paths={"root": str(tmp_path / "ext")}, signals=SIGNALS)
    _write_mat(cfg)
    return cfg


def _raise(*args, **kwargs):
    raise AssertionError("record_function opened with no profiler running")


def test_no_profiler_records_nothing_and_opens_no_record_function(server, dataset,
                                                                  monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    replies = _clients(server, [4, 8, 12])
    assert [len(r["labels"]) for r in replies] == [4, 8, 12]
    run_extraction(dataset, force=True, device="cpu")
    assert spans() == [] and spans_dropped() == 0
    with span("amc.x", frames=3) as sp:
        assert not sp and sp.id is None
        sp.set(frames=4)
    assert spans() == []


@pytest.mark.parametrize("all_threads", [False, True], ids=["this_thread", "all_threads"])
def test_served_requests_each_have_their_spans(server, tmp_path, all_threads):
    sizes = [4, 8, 12, 16]
    with _profile(all_threads) as prof:
        _clients(server, sizes)
    recs = spans()
    by_name: dict[str, list] = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    requests = by_name["amc.request"]
    assert sorted(r.counts["frames"] for r in requests) == sizes
    for req in requests:
        k = req.counts["frames"]
        assert req.request == req.id and req.counts["bytes"] == k * N * 8
        assert req.thread != "amc-batcher"
        for name in ("amc.queue", "amc.reply"):
            (mine,) = [r for r in by_name[name] if r.request == req.id]
            assert mine.parent == req.id and mine.counts["frames"] == k
            assert req.t0_ns <= mine.t0_ns <= mine.t1_ns <= req.t1_ns
        (queue,) = [r for r in by_name["amc.queue"] if r.request == req.id]
        assert queue.thread == "amc-batcher"  # its end is stamped by the batcher
        (disp,) = [d for d in by_name["amc.dispatch"] if req.id in d.request]
        assert queue.t1_ns <= disp.t0_ns
    for disp in by_name["amc.dispatch"]:
        mine = [r for r in requests if r.id in disp.request]
        assert disp.counts["requests"] == len(mine) == len(disp.request)
        assert disp.counts["frames"] == sum(r.counts["frames"] for r in mine)
        kids = {r.name: r for r in recs if r.parent == disp.id}
        assert {"amc.stage.write", "amc.model", "amc.fetch"} <= set(kids)
        assert kids["amc.stage.write"].counts["bytes"] == disp.counts["frames"] * N * 8
        assert kids["amc.model"].counts["frames"] == disp.counts["frames"]
        assert kids["amc.fetch"].counts["frames"] == disp.counts["frames"]
        if len(mine) > 1:
            assert kids["amc.concat"].counts["bytes"] == sum(r.counts["bytes"] for r in mine)
        else:
            assert "amc.concat" not in kids
    assert max(d.counts["requests"] for d in by_name["amc.dispatch"]) > 1
    names = _trace_names(prof, tmp_path)
    if all_threads:
        assert SERVE_WORK <= names
    else:  # this thread's alone: none of the batcher's or the clients'
        assert not SERVE_WORK & names
    assert not WAITING & names


@pytest.mark.parametrize("all_threads", [False, True], ids=["this_thread", "all_threads"])
def test_an_extraction_pass_has_its_spans(dataset, tmp_path, all_threads):
    with _profile(all_threads) as prof:
        run_extraction(dataset, force=True, device="cpu")
    recs = spans()
    (pas,) = [r for r in recs if r.name == "amc.extract.pass"]
    mods = list(dataset.signals.modulations_with_noise)
    per_mod = dataset.signals.num_snr * dataset.signals.num_frames
    assert pas.counts["frames"] == len(mods) * per_mod
    for name in ("amc.io.load_modulation", "amc.extract.prepare", "amc.extract",
                 "amc.io.save_features", "amc.extract.load_wait"):
        mine = [r for r in recs if r.name == name]
        assert len(mine) == len(mods), name
        for r in mine:
            assert r.parent == pas.id, name
            assert pas.t0_ns <= r.t0_ns <= r.t1_ns <= pas.t1_ns, name
    for r in recs:
        if r.name in ("amc.io.load_modulation", "amc.extract.prepare"):
            assert r.thread != pas.thread  # the loader's
            assert r.counts["bytes"] == per_mod * N * 8
        if r.name in ("amc.extract.prepare", "amc.extract"):
            assert r.counts["frames"] == per_mod
        if r.name == "amc.io.save_features":
            assert r.counts["bytes"] == per_mod * 18 * 4
    names = _trace_names(prof, tmp_path)
    mine = EXTRACT_WORK if all_threads else EXTRACT_WORK - {"amc.io.load_modulation",
                                                            "amc.extract.prepare"}
    assert mine <= names
    assert not WAITING & names


def test_extract_profile_dir_traces_the_loader(dataset, tmp_path):
    """``amc extract --profile DIR`` profiles every thread: the loader's
    spans are in its trace."""
    run_extraction(dataset, force=True, device="cpu", profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "extract_trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert EXTRACT_WORK <= names and not WAITING & names


def test_the_request_split_accounts_for_each_request(server):
    """``scripts/torch_span_split.py``'s split of served requests: each
    request's parts lie inside it, three spans a request."""
    from scripts.torch_span_split import REQUEST_PARTS, request_split

    with _profile(True):
        _clients(server, [4, 8, 12, 16])
    split = request_split(spans())
    assert split["requests"] == 4 and split["spans_per_request"] == 3
    assert 1 <= split["dispatches"] < 4
    assert 0 < split["covered_min"] <= split["covered_median"] <= 1
    assert 0 < split["covered_all"] <= 1
    med = split["median_request_ms"]
    assert sum(med[p] for p in REQUEST_PARTS) <= med["request"]
    assert split["median_request_counts"]["frames"] in (4, 8, 12, 16)
    assert request_split([]) == {}


def test_the_pass_split_adds_up(dataset):
    """``scripts/torch_span_split.py``'s split of an extraction pass: one
    pass, five spans a modulation besides it, shares of the pass."""
    from scripts.torch_span_split import PASS_LEAVES, leaf_label_share, pass_split

    with _profile(True):
        run_extraction(dataset, force=True, device="cpu")
    split = pass_split(spans())
    mods = len(dataset.signals.modulations_with_noise)
    assert split["passes"] == 1 and split["spans_per_pass"] == 1 + 5 * mods
    assert split["share_pct"]["amc.extract.pass"] == pytest.approx(100.0)
    assert 0 < split["stage_wait_save_pct"] <= 100
    assert all(split["counts"][name] == mods for name in PASS_LEAVES)
    gaps = [["amc.io.load_modulation", 3.0], ["port_bench.run_extraction", 1.0],
            ["shorter gaps", 5.0]]
    assert leaf_label_share(gaps) == pytest.approx(0.75)
    assert leaf_label_share([["shorter gaps", 1.0]]) is None


def test_nesting_and_a_parent_on_another_thread():
    with torch.profiler.profile():
        with span("outer") as outer:
            with span("inner", frames=2) as inner:
                inner.set(bytes=5)
            with span("side", parent=outer.id, wait=True) as side:
                pass
    recs = {r.name: r for r in spans()}
    assert set(recs) == {"outer", "inner", "side"}
    assert recs["outer"].parent is None
    assert recs["inner"].parent == outer.id and recs["inner"].counts == {"frames": 2, "bytes": 5}
    assert recs["side"].parent == outer.id and side.id != inner.id
    with torch.profiler.profile():
        def far():
            with span("far", parent=outer.id):
                pass

        th = threading.Thread(target=far)
        th.start()
        th.join(10)
    (far_rec,) = [r for r in spans() if r.name == "far"]
    assert far_rec.parent == outer.id and far_rec.thread != recs["outer"].thread


def test_record_span_keeps_two_threads_edges_and_the_switch():
    metrics.record_span("amc.queue", 1, 5, parent=7, request=7, frames=3)
    assert spans() == []
    with torch.profiler.profile():
        metrics.record_span("amc.queue", 1_000, 5_000, parent=7, request=7, frames=3)
    (r,) = spans()
    assert (r.name, r.parent, r.request, r.counts) == ("amc.queue", 7, 7, {"frames": 3})
    assert r.t1_ns - r.t0_ns == 4_000


def test_the_recorder_drops_past_its_cap_and_counts_them(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAP", 3)
    with torch.profiler.profile():
        for k in range(5):
            with span("s", k=k):
                pass
    assert [r.counts["k"] for r in spans()] == [0, 1, 2]
    assert spans_dropped() == 2
    clear_spans()
    assert spans() == [] and spans_dropped() == 0


def test_the_profiler_flag_is_the_switch(monkeypatch):
    """``torch.autograd.profiler._is_profiler_enabled`` is the one switch: a
    bool, False with no session, True on every thread while one records. A
    PyTorch that renames it fails here rather than recording nothing."""
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False and not span("x")
    seen = []
    with torch.profiler.profile():
        assert torch.autograd.profiler._is_profiler_enabled is True
        th = threading.Thread(target=lambda: seen.append(
            (torch.autograd.profiler._is_profiler_enabled, bool(span("y")))))
        th.start()
        th.join(10)
    assert seen == [(True, True)]
    assert torch.autograd.profiler._is_profiler_enabled is False
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with span("z", wait=True):
        pass
    assert [r.name for r in spans()] == ["z"]


def test_stage_timer_opens_its_span():
    log = metrics.MetricsLogger(None)
    with metrics.stage_timer(log, "extract", device=torch.device("cpu")) as rec:
        rec["frames"] = 9
    assert spans() == []
    with torch.profiler.profile() as prof:
        with metrics.stage_timer(log, "extract", device=torch.device("cpu")) as rec:
            rec["frames"] = 9
    (r,) = spans()
    assert r.name == "amc.extract" and r.counts == {"frames": 9}
    assert "amc.extract" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_staging_spans_on_the_card(cuda):
    from amcpy_tpu_torch.serve import _Staging

    st = _Staging(cuda)
    a = _frames(64, seed=3)
    st.upload([(a, np.complex64)])
    with torch.profiler.profile():
        (t,) = st.upload([(a, np.complex64)])
        torch.cuda.synchronize()
    names = [r.name for r in spans()]
    assert names == ["amc.stage.wait", "amc.stage.write", "amc.stage.enqueue"]
    assert all(r.counts.get("bytes", a.nbytes) == a.nbytes for r in spans())
    np.testing.assert_array_equal(t.cpu().numpy(), a)


@pytest.mark.cuda
def test_a_coalesced_dispatch_on_the_card_writes_its_pieces(cuda, tmp_path):
    """On the card a coalesced dispatch opens no ``amc.concat``: its
    ``amc.stage.write`` writes every request's array (``pieces``) and the
    group's bytes, and the pipeline counts it as written in place."""
    with _running_server(tmp_path, cuda) as srv:
        with _profile(all_threads=True):
            _clients(srv, [4, 8, 12, 16])
        recs = spans()
        dispatches = [r for r in recs if r.name == "amc.dispatch"]
        coalesced = sum(d.counts["requests"] > 1 for d in dispatches)
        assert coalesced >= 1
        assert (srv.pipe.coalesced_in_place, srv.pipe.coalesced_concatenated) == (coalesced, 0)
    assert not [r for r in recs if r.name == "amc.concat"]
    for disp in dispatches:
        (write,) = [r for r in recs if r.parent == disp.id and r.name == "amc.stage.write"]
        assert write.counts["pieces"] == disp.counts["requests"]
        assert write.counts["bytes"] == disp.counts["frames"] * N * 8


@pytest.mark.cuda
def test_h2d_s_is_the_copies_device_time(cuda):
    """``h2d_s`` on a card: the copies' device seconds, not their enqueue.
    The copies cannot pass the host link's 64 GB/s (PCIe 5.0 x16), so
    ``h2d_s`` is at least their bytes over it, where the enqueue of
    ``non_blocking`` copies from pinned memory takes microseconds; and it
    lies inside the call."""
    rng = np.random.default_rng(4)
    frames = (rng.standard_normal((8192, 2048))
              + 1j * rng.standard_normal((8192, 2048))).astype(np.complex64)
    extract_batch(frames, kernel="fused", chunk_size=4096, device=cuda)
    tim: dict = {}
    t0 = time.perf_counter()
    extract_batch(frames, kernel="fused", chunk_size=4096, timings=tim, device=cuda)
    wall = time.perf_counter() - t0
    assert tim["bytes_h2d"] == frames.size * 8
    assert tim["bytes_h2d"] / 64e9 <= tim["h2d_s"] <= wall
