"""The port's HTTP server (``amcpy_tpu_torch/server.py``) and the int24
serving program of ``serve.py`` on the CPU: the cases of
``tests/test_serve.py:122-520`` (classify and health, concurrent requests,
bad and mismatched frame sizes, coalescing, mixed shapes and dtypes,
``stop`` failing late items, the 503, the wire program against float32),
and the shutdown race: ``stop()`` never leaves an ``infer`` caller waiting.

Labels over HTTP are held to ``AMCPipeline.predict`` of the same frames on
the same pipeline (identical). The int24 program: logits within 1e-3 of
the float32 program and at least 99 % identical argmax (the JAX package's
bars, ``tests/test_serve.py:493-520``), and within the serving tolerance of
``tests/test_torch_serve.py`` (2e-4) of the JAX package's own int24
program on the same weights.
"""

import concurrent.futures as cf
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.preprocessing import Standardizer as JaxStandardizer
from amcpy_tpu.serve import AMCPipeline as JaxPipeline
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.extraction import extract_batch
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.server import AMCServer, _Batcher, _WorkItem
from amcpy_tpu_torch.train.checkpoint import params_from_flax, save_checkpoint

from .test_torch_serve import _flax_weights

N = 256


def _frames(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N)) + 1j * rng.standard_normal((b, N))
    return (x * np.exp(rng.uniform(-1, 1, (b, 1)))).astype(np.complex64)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """(cfg, model id, flax weights, scaler) of a seeded MLP checkpoint at
    N = 256, its Standardizer fit on the features of numpy-made frames."""
    root = tmp_path_factory.mktemp("server")
    cfg = Config().replace(paths={"root": str(root)}, signals={"frame_size": N})
    feats = extract_batch(_frames(64, seed=1), device="cpu")
    scaler = Standardizer.fit(feats[:, list(cfg.features.used_columns)])
    jmodel, params, stats = _flax_weights("relu", seed=2)
    model = AMCClassifier(6)
    model.load_state_dict(params_from_flax(params, stats))
    save_checkpoint(cfg, "srv", model, scaler)
    return cfg, "srv", (jmodel, params, stats), scaler


@pytest.fixture
def server(project):
    """A factory of running CPU servers of the project's checkpoint (its
    keywords go to :class:`AMCServer`), each shut down after the test."""
    servers = []

    def start(**kw):
        cfg, model_id, _, _ = project
        srv = AMCServer(cfg, model_id, host="127.0.0.1", port=0, device="cpu", **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        host, port = srv.address
        return srv, f"http://{host}:{port}"

    yield start
    for srv in servers:
        srv.shutdown()


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _http_error(url, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body, timeout=30)
    return e.value.code, json.loads(e.value.read())["error"]


def test_http_server_classify_and_health(server):
    """Complex64 bytes in, labels out; the planar format and probabilities;
    the health counters; a malformed body is a 400."""
    srv, base = server()
    h = _get(f"{base}/healthz")
    assert h["status"] == "ok" and h["frame_size"] == N
    assert h["device"] == "cpu" and h["device_name"] == "cpu"
    assert (h["family"], h["route"]) == ("mlp", "features")  # "auto" on the CPU
    assert h["classes"][0] == "BPSK"

    frames = _frames(60, seed=3)
    out = _post(f"{base}/classify", frames.tobytes())
    assert len(out["labels"]) == 60
    np.testing.assert_array_equal(out["class_ids"], srv.pipe.predict(frames))
    mods = Config().signals.modulations_with_noise
    assert out["labels"] == [mods[k] for k in out["class_ids"]]

    planar = np.stack([frames.real, frames.imag], axis=1).astype(np.float32)
    out2 = _post(f"{base}/classify?format=planar&probs=1", planar.tobytes())
    assert out2["class_ids"] == out["class_ids"]
    probs = np.asarray(out2["probs"])
    assert probs.shape == (60, 6)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(probs, srv.pipe.predict_proba(frames), atol=1e-6)

    code, msg = _http_error(f"{base}/classify", b"\x00" * 13)
    assert code == 400 and "whole number" in msg
    code, msg = _http_error(f"{base}/classify?format=c128", frames.tobytes())
    assert code == 400 and "format" in msg

    h2 = _get(f"{base}/healthz")
    assert h2["requests"] == 2 and h2["frames_classified"] == 120


def test_http_server_serves_a_cnn_checkpoint(project, tmp_path):
    """A raw-IQ CNN checkpoint behind the same server: labels over HTTP are
    ``predict``'s."""
    from amcpy_tpu_torch.models.cnn import IQConvNet

    cfg = project[0].replace(paths={"root": str(tmp_path)})
    identity = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    save_checkpoint(cfg, "cnn", IQConvNet(6, channels=(8, 16), kernel_sizes=(1, 1), strides=(1, 1), dense=16), identity)
    srv = AMCServer(cfg, "cnn", port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        host, port = srv.address
        frames = _frames(12, seed=7)
        out = _post(f"http://{host}:{port}/classify", frames.tobytes())
        np.testing.assert_array_equal(out["class_ids"], srv.pipe.predict(frames))
    finally:
        srv.shutdown()


def test_http_server_concurrent_requests(server):
    """Concurrent POSTs all succeed, each gets its own labels, and the
    counters count every frame once."""
    srv, base = server()
    bodies = [_frames(16, seed=10 + k) for k in range(8)]

    with cf.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda f: _post(f"{base}/classify", f.tobytes()), bodies))
    for f, o in zip(bodies, outs):
        np.testing.assert_array_equal(o["class_ids"], srv.pipe.predict(f))
    h = _get(f"{base}/healthz")
    assert h["requests"] == 8 and h["frames_classified"] == 128
    b = h["batcher"]
    assert b["coalesced_requests"] == 8 and b["dispatches"] <= 8


@pytest.mark.parametrize("query,match", [
    ("frame_size=0", "frame_size"),
    ("frame_size=128", "allow_any_frame_size"),
])
def test_http_server_rejects_bad_frame_size(server, query, match):
    """frame_size 0 and a frame size other than the model's are client
    errors (400); the second goes through with allow_any_frame_size=1."""
    _, base = server()
    body = (np.zeros(128, np.complex64) + 1).tobytes()  # one frame of 128
    code, msg = _http_error(f"{base}/classify?{query}", body)
    assert code == 400 and match in msg
    if "128" in query:
        out = _post(f"{base}/classify?{query}&allow_any_frame_size=1", body)
        assert len(out["labels"]) == 1


def test_http_server_backpressure_503(server):
    """Past the resident-bytes budget a POST gets 503, not a buffer."""
    _, base = server(max_resident_bytes=1024)
    code, msg = _http_error(f"{base}/classify", _frames(2, seed=4).tobytes())
    assert code == 503 and "overloaded" in msg


def test_http_server_shutdown_with_clients_in_flight(server):
    """``shutdown()`` while eight clients post in a loop: every client
    returns (an answer, an error status or a refused connection)."""
    srv, base = server()
    body = _frames(8, seed=5).tobytes()
    answered = []

    def client():
        while True:
            try:
                _post(f"{base}/classify", body, timeout=10)
                answered.append(1)
            except (urllib.error.URLError, ConnectionError, OSError):
                return

    threads = [threading.Thread(target=client, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    srv.shutdown()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert answered


def _pieces(frames):
    """A dispatch's arrays: the list a coalesced group crosses as, or the
    lone request's array."""
    return frames if isinstance(frames, list) else [frames]


class _SlowPipe:
    """A stand-in pipeline whose first dispatch waits for ``release``; its
    logits repeat each frame's first value, so a caller can tell its rows.
    ``calls`` holds each dispatch's dtype and shape of all its rows,
    ``handed`` what the batcher handed over (an array, or a group's list)."""

    def __init__(self):
        self.calls = []
        self.handed = []
        self.release = threading.Event()

    def logits(self, frames):
        pieces = _pieces(frames)
        self.handed.append(frames)
        self.calls.append((pieces[0].dtype,
                           (sum(len(p) for p in pieces), *pieces[0].shape[1:])))
        if len(self.calls) == 1:
            self.release.wait(timeout=30)
        first = np.concatenate([p.reshape(len(p), -1)[:, :1].real for p in pieces])
        return torch.from_numpy(np.repeat(first.astype(np.float32), 6, axis=1))


def test_batcher_coalesces_concurrent_requests():
    """A backlog of requests goes out in one dispatch, each caller gets
    exactly its own rows, and a lone request does not wait."""
    pipe = _SlowPipe()
    b = _Batcher(pipe, window_s=0.05)
    try:
        frames = [np.full((k + 1, 2, 8), float(k), np.float32) for k in range(5)]
        outs: list = [None] * 5
        gate = threading.Barrier(5)

        def go(k):
            gate.wait()
            if k:
                time.sleep(0.05)  # queue behind the held dispatch
            outs[k] = b.infer(frames[k])

        threads = [threading.Thread(target=go, args=(k,)) for k in range(5)]
        for t in threads:
            t.start()
        time.sleep(0.5)  # requests 1 ... 4 are queued
        pipe.release.set()
        for t in threads:
            t.join(timeout=30)
        for k in range(5):
            assert outs[k].shape == (k + 1, 6)
            np.testing.assert_array_equal(outs[k], float(k))
        sizes = [shape[0] for _, shape in pipe.calls]
        assert sizes[0] == 1 and len(sizes) <= 3
        assert sum(sizes) == 15
        assert b.coalesced_requests == 5 and b.max_coalesced >= 2
    finally:
        b.stop()


@pytest.mark.parametrize("held,other", [
    (np.ones((2, 2, 16), np.float32), np.ones((3, 2, 32), np.float32)),
    (np.ones((2, 16), np.complex64), np.ones((3, 2, 16), np.float32)),
    (np.ones((2, 16), np.complex64), np.ones((3, 16), np.complex128)),
], ids=["frame_sizes", "c64_and_planar", "dtypes"])
def test_batcher_groups_mixed_frame_shapes(held, other):
    """Requests of another frame size, layout or dtype coalesced into one
    batch go out as separate groups: a concatenate of them would fail or
    cast every co-batched request."""
    pipe = _SlowPipe()
    b = _Batcher(pipe, window_s=0.05)
    try:
        outs = {}

        def go(name, frames):
            outs[name] = b.infer(frames)

        t0 = threading.Thread(target=go, args=("hold", held[:1]))
        t0.start()
        time.sleep(0.3)  # the first dispatch is held open
        ts = [threading.Thread(target=go, args=("a", held)),
              threading.Thread(target=go, args=("b", other))]
        for t in ts:
            t.start()
        time.sleep(0.3)  # both queued behind it
        pipe.release.set()
        for t in [t0, *ts]:
            t.join(timeout=30)
        assert outs["a"].shape == (2, 6) and outs["b"].shape == (3, 6)
        assert (held.dtype, held.shape) in pipe.calls
        assert (other.dtype, other.shape) in pipe.calls
    finally:
        b.stop()


def test_batcher_hands_a_group_over_unjoined():
    """A coalesced group reaches the pipeline as its requests' own arrays,
    in the order they were queued, with no concatenate; a lone request
    arrives as its array; each caller gets exactly its own rows."""
    pipe = _SlowPipe()
    b = _Batcher(pipe, window_s=0.05)
    try:
        frames = [np.full((k + 2, 16), complex(k, -k), np.complex64) for k in range(4)]
        outs: list = [None] * 4

        def go(k):
            outs[k] = b.infer(frames[k])

        threads = [threading.Thread(target=go, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.2)  # the first dispatch is held; the rest queue in order
        pipe.release.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert pipe.handed[0] is frames[0]
        group = pipe.handed[1]
        assert isinstance(group, list) and len(pipe.handed) == 2
        assert [id(a) for a in group] == [id(f) for f in frames[1:]]
        for k in range(4):
            assert outs[k].shape == (k + 2, 6)
            np.testing.assert_array_equal(outs[k], float(k))
        assert b.dispatches == 2 and b.max_coalesced == 3
    finally:
        b.stop()


def test_pipeline_concatenates_a_list_on_the_cpu(project):
    """On the CPU a list of arrays is one request of their rows: its
    logits are exactly those of their concatenate, the join is counted as
    concatenated (never in place) and traced as ``amc.concat`` with its
    bytes; a list of one is that array; a list that mixes shapes or dtypes
    is refused."""
    from amcpy_tpu_torch.utils.metrics import clear_spans, spans

    cfg, model_id, _, _ = project
    pipe = AMCPipeline.from_checkpoint(cfg, model_id, device="cpu")
    pieces = [_frames(k, seed=20 + k) for k in (3, 1, 5)]
    want = pipe.logits(np.concatenate(pieces))
    clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = pipe.logits(pieces)
        (concat,) = [r for r in spans() if r.name == "amc.concat"]
        assert concat.counts["bytes"] == sum(p.nbytes for p in pieces)
    finally:
        clear_spans()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (pipe.coalesced_concatenated, pipe.coalesced_in_place) == (1, 0)
    planar = [np.stack([p.real, p.imag], axis=1) for p in pieces]
    torch.testing.assert_close(pipe.logits(planar), want, rtol=0, atol=0)
    torch.testing.assert_close(pipe.logits(pieces[:1]), pipe.logits(pieces[0]), rtol=0, atol=0)
    assert (pipe.coalesced_concatenated, pipe.coalesced_in_place) == (2, 0)
    for bad in ([pieces[0], planar[1]], [pieces[0], pieces[1].astype(np.complex128)], []):
        with pytest.raises(ValueError):
            pipe.logits(bad)


def test_pipeline_joins_a_list_for_the_wire_program_and_the_fan_out(project):
    """The int24 wire program and a request fanned out over devices take
    one array: a list is concatenated first, and its logits are those of
    the concatenate."""
    pipe_w, _, _ = _wire_pipelines(project)
    pieces = [_frames(k, seed=30 + k) for k in (300, 212)]
    assert pipe_w._wire_eligible(512, N)
    torch.testing.assert_close(pipe_w.logits(pieces), pipe_w.logits(np.concatenate(pieces)),
                               rtol=0, atol=0)
    assert (pipe_w.coalesced_concatenated, pipe_w.coalesced_in_place) == (1, 0)
    cfg, model_id, _, _ = project
    pipe = AMCPipeline.from_checkpoint(cfg, model_id, device="cpu")
    pipe.devices = [torch.device("cpu"), torch.device("cpu")]
    assert pipe.fanout(512) is not None
    torch.testing.assert_close(pipe.logits(pieces), pipe.logits(np.concatenate(pieces)),
                               rtol=0, atol=0)
    assert (pipe.coalesced_concatenated, pipe.coalesced_in_place) == (1, 0)


def test_healthz_reports_the_coalesced_routes(server):
    """``/healthz`` counts the pipeline's coalesced groups by route: on the
    CPU every group of more than one request is concatenated."""
    srv, base = server()
    h = _get(f"{base}/healthz")["batcher"]
    assert h["coalesced_in_place"] == h["coalesced_concatenated"] == 0
    logits, first = srv.pipe.logits, threading.Event()

    def slow_first(frames):
        if not first.is_set():
            first.set()
            time.sleep(0.2)  # the others queue behind it and are coalesced
        return logits(frames)

    srv.pipe.logits = slow_first
    bodies = [_frames(8, seed=40 + k) for k in range(4)]

    def post(k):
        if k:
            first.wait(10)
        return _post(f"{base}/classify", bodies[k].tobytes())

    with cf.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(post, range(4)))
    srv.pipe.logits = logits
    for f, o in zip(bodies, outs):
        np.testing.assert_array_equal(o["class_ids"], srv.pipe.predict(f))
    h = _get(f"{base}/healthz")["batcher"]
    assert h["max_coalesced"] >= 2
    assert h["coalesced_concatenated"] >= 1 and h["coalesced_in_place"] == 0
    assert h["coalesced_concatenated"] == srv.pipe.coalesced_concatenated


class _Pipe:
    def logits(self, frames):
        return torch.zeros((sum(len(p) for p in _pieces(frames)), 6))


def test_batcher_stop_fails_late_items():
    """An item queued around shutdown is answered or failed, never left
    waiting; after stop, infer raises."""
    b = _Batcher(_Pipe(), window_s=0.0)
    late = _WorkItem(np.zeros((1, 2, 8), np.float32))
    b.q.put(late)  # queued directly, past infer's check
    b.stop()
    assert late.done.wait(timeout=10)
    assert late.error is not None or late.logits is not None
    with pytest.raises(RuntimeError, match="shutting down"):
        b.infer(np.zeros((1, 2, 8), np.float32))


@pytest.mark.parametrize("round_", range(5))
def test_stop_racing_infer_leaves_no_caller_waiting(round_):
    """200 ``infer`` calls race ``stop()``: every one returns (logits or
    ``RuntimeError``) within 5 s, under a short switch interval."""
    b = _Batcher(_Pipe(), window_s=1e-4)
    results: list = []
    start = threading.Barrier(201)

    def call():
        start.wait()
        try:
            results.append(b.infer(np.zeros((1, 2, 8), np.float32)).shape)
        except RuntimeError:
            results.append("stopped")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, daemon=True) for _ in range(200)]
        for t in threads:
            t.start()
        start.wait()
        time.sleep(0.0002 * round_)
        b.stop()
        deadline = time.monotonic() + 5.0
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 200
    assert all(r in ((1, 6), "stopped") for r in results)


def test_stop_between_check_and_queue_waits_for_the_queue():
    """The race by construction: ``stop()`` starts while an ``infer`` has
    passed its check and not yet queued its item. ``stop`` waits for the
    item to be queued, so the item is answered or failed, and the caller
    returns."""
    b = _Batcher(_Pipe(), window_s=0.0)
    in_put, real_put = threading.Event(), b.q.put

    def slow_put(item, *args, **kw):
        if isinstance(item, _WorkItem):
            in_put.set()
            time.sleep(0.3)
        real_put(item, *args, **kw)

    b.q.put = slow_put
    out: list = []

    def call():
        try:
            out.append(b.infer(np.zeros((1, 2, 8), np.float32)).shape)
        except RuntimeError:
            out.append("stopped")

    t = threading.Thread(target=call, daemon=True)
    t.start()
    assert in_put.wait(timeout=5)
    b.stop()
    t.join(timeout=5)
    assert not t.is_alive() and out in ([(1, 6)], ["stopped"])


def _wire_pipelines(project):
    """(port int24, port f32, JAX int24) pipelines on the project's weights
    and scaler, all on the fused route."""
    cfg, _, (jmodel, params, stats), scaler = project
    model = AMCClassifier(6)
    model.load_state_dict(params_from_flax(params, stats))
    pipes = [
        AMCPipeline(model, scaler, cfg.replace(compute={"kernel": "fused",
                                                         "wire_format": w}),
                    device="cpu")
        for w in ("int24", "f32")
    ]
    jcfg = JaxConfig().replace(signals={"frame_size": N},
                               compute={"kernel": "fused", "wire_format": "int24"})
    jpipe = JaxPipeline(jmodel, params, stats, JaxStandardizer.from_dict(scaler.to_dict()),
                        jcfg)
    jpipe.multi_device = False
    return (*pipes, jpipe)


def test_pipeline_wire_path_matches_f32(project):
    """Requests of at least ``WIRE_MIN_BATCH`` frames take the int24 program
    (decode, K1, standardize, MLP): close to the float32 program, and to
    the JAX package's int24 program; smaller requests stay on float32."""
    pipe_w, pipe_f, jpipe = _wire_pipelines(project)
    assert pipe_w._wire == "int24" and pipe_f._wire == "f32" and jpipe._wire == "int24"
    frames = _frames(512, seed=6)
    assert pipe_w._wire_eligible(512, N) and jpipe._wire_eligible(512, N)
    lw, lf = pipe_w.logits(frames).numpy(), pipe_f.logits(frames).numpy()
    assert lw.shape == lf.shape == (512, 6)
    np.testing.assert_allclose(lw, lf, rtol=1e-3, atol=1e-3)
    assert (lw.argmax(-1) == lf.argmax(-1)).mean() > 0.99
    np.testing.assert_allclose(lw, np.asarray(jpipe.logits(frames)), rtol=2e-4, atol=2e-4)
    planar = np.stack([frames.real, frames.imag], axis=1)
    np.testing.assert_array_equal(pipe_w.logits(planar).numpy(), lw)
    assert not pipe_w._wire_eligible(511, N) and not pipe_w._wire_eligible(512, 101)
    assert not pipe_f._wire_eligible(512, N)


@pytest.mark.parametrize("fmt,wire", [("auto", "f32"), ("int16", "f32"), ("int24", "int24")])
def test_serving_takes_the_int24_codec_only(project, fmt, wire):
    """As in the JAX package, serving runs int24 and sends float32 for
    every other format."""
    cfg, model_id, _, _ = project
    pipe = AMCPipeline.from_checkpoint(
        cfg.replace(compute={"kernel": "fused", "wire_format": fmt}), model_id, device="cpu"
    )
    assert pipe._wire == wire
    assert pipe._wire_eligible(512, N) == (wire == "int24")
