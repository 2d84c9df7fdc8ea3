"""HTTP classification server: ``python -m amcpy_tpu_torch serve``.

Counterpart of ``amcpy_tpu/server.py``: raw IQ frames in, modulation labels
(and probabilities) out, over plain HTTP with the standard library's
``http.server``, in front of one :class:`~amcpy_tpu_torch.serve.AMCPipeline`
on the card (``device=None``) or on the CPU (``device="cpu"``).

* **Request coalescing.** One batcher thread owns the pipeline. It takes
  every request already queued into one dispatch (up to ``max_frames``
  frames), and only after it has coalesced at least one waiting request
  does it wait a bounded window (2 ms) for stragglers: a lone client is
  dispatched at once. Requests are grouped by dtype and per-frame shape,
  so a complex request and a planar one, or two frame sizes, never share
  a dispatch. A group crosses as its pieces: the requests' arrays, in
  order, go to the pipeline unjoined, and on the card each is written
  straight into the staging buffer (the pipeline concatenates them only
  on the routes that need one array).
* **Bodies cross as they arrive.** A ``format=c64`` body is handed to the
  pipeline as a complex64 ``(B, N)`` array and a ``format=planar`` body as
  float32 ``(B, 2, N)``; the pipeline copies either once to the card and
  splits the planes there.
* **Bounded memory.** At most ``max_concurrent_reads`` bodies are read at
  once, and a request whose body would take the resident bytes of all
  requests in flight past ``max_resident_bytes`` gets 503.
* **Shutdown.** A request is queued under the lock that :meth:`_Batcher.stop`
  takes to stop the queue, so every queued request is either answered or
  failed, and no caller of :meth:`_Batcher.infer` waits forever.
* **Spans** (``utils/metrics.py``, recorded while a ``torch.profiler``
  session records): ``amc.request`` (a call of :meth:`AMCServer.classify`;
  its id is the request id) and ``amc.queue`` (queued until the batcher
  takes it), which only wait; ``amc.dispatch`` (one group), ``amc.fetch``
  (the logits' copy back, where the batcher waits on the card) and
  ``amc.reply``, which work, beside the pipeline's ``amc.concat`` (its
  routes that join a group), ``amc.stage.*`` and ``amc.model``.

Endpoints:

* ``GET  /healthz`` — the device, the model's family, the pipeline's
  ``route`` (:attr:`~amcpy_tpu_torch.serve.AMCPipeline.route`), frame size
  and classes, the requests refused for their frame size, the model's
  counters (``model_counters``: those of ``forwards``, ``frames`` and
  ``steps`` it keeps), the module forward's row chunks
  (``forward_chunks``), and the batcher's counters, with the pipeline's
  count of coalesced groups written into the staging buffer in pieces and
  of those concatenated;
* ``POST /classify?format=c64|planar&probs=1`` — labels and class ids (and
  probabilities).

A ``frame_size`` other than the model's gets 400 unless
``allow_any_frame_size=1``: the features shift with N. A model with a
fixed input length (the pipeline's ``frame_size``: the ResNet, whose
flatten ties it to its N, and MCLDNN, whose reshape does) takes no other,
override or not: :meth:`AMCServer.classify` raises ``ValueError`` and the handler answers
400 (``frame_size_refused`` counts both). The server binds 127.0.0.1
unless told otherwise; it has no authentication.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.utils.metrics import Span, record_span, span

__all__ = ["AMCServer", "serve_forever"]


_STOP = object()


class _WorkItem:
    __slots__ = ("frames", "logits", "error", "done", "request", "queued_ns")

    def __init__(self, frames: np.ndarray, request: Span | None = None):
        self.frames = frames
        self.logits: np.ndarray | None = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        #: the ``amc.request`` span of a traced request, else None
        self.request = request
        self.queued_ns = 0


class _Batcher:
    """The one thread that runs the pipeline, with request coalescing.

    Items already queued are coalesced into one dispatch; once at least
    one was coalesced, the batcher waits up to ``window_s`` for stragglers.
    """

    def __init__(self, pipe: AMCPipeline, *, window_s: float = 2e-3,
                 max_frames: int = 16384):
        self.pipe = pipe
        self.window_s = window_s
        self.max_frames = max_frames
        self.q: queue.Queue[Any] = queue.Queue()
        #: held while checking ``_stopped`` and queueing, and by stop()
        self._lock = threading.Lock()
        self._stopped = False
        self.dispatches = 0
        self.coalesced_requests = 0
        self.max_coalesced = 1
        self._thread = threading.Thread(target=self._loop, name="amc-batcher",
                                        daemon=True)
        self._thread.start()

    def infer(self, frames: np.ndarray, request: Span | None = None) -> np.ndarray:
        """Submit ``(B, N)`` complex or ``(B, 2, N)`` planar frames; block
        until their logits are ready. Raises ``RuntimeError`` once the
        batcher is stopping. ``request`` is the caller's ``amc.request``
        span, when traced: the queue's span is recorded under it."""
        item = _WorkItem(frames, request or None)
        with self._lock:
            if self._stopped:
                raise RuntimeError("server shutting down")
            if item.request is not None:
                item.queued_ns = time.perf_counter_ns()
            self.q.put(item)
        # stop() fails every item still queued when the loop is done, so
        # this wait ends
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.logits

    def stop(self) -> None:
        """Refuse new items, let the loop finish the queued ones (for up to
        5 s), then fail whatever is left."""
        with self._lock:
            self._stopped = True
            self.q.put(_STOP)
        self._thread.join(timeout=5)
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            item.error = RuntimeError("server shutting down")
            item.done.set()
        if self._thread.is_alive():  # a dispatch outlived the timeout
            self.q.put(_STOP)

    # ------------------------------------------------------------------

    @staticmethod
    def _taken(item: _WorkItem) -> None:
        """Record a traced item's wait in the queue, as the batcher takes it."""
        req = item.request
        if req is not None:
            record_span("amc.queue", item.queued_ns, time.perf_counter_ns(),
                        parent=req.id, request=req.id, frames=item.frames.shape[0])

    def _collect(self) -> list[_WorkItem] | None:
        """Block for the first item, then coalesce the backlog."""
        item = self.q.get()
        if item is _STOP:
            return None
        self._taken(item)
        batch = [item]
        n = item.frames.shape[0]
        stop_seen = False
        while n < self.max_frames:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                stop_seen = True
                break
            self._taken(nxt)
            batch.append(nxt)
            n += nxt.frames.shape[0]
        if len(batch) > 1 and not stop_seen and self.window_s > 0:
            # under load: a bounded wait for stragglers
            deadline = time.monotonic() + self.window_s
            while n < self.max_frames:
                tmo = deadline - time.monotonic()
                if tmo <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=tmo)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_seen = True
                    break
                self._taken(nxt)
                batch.append(nxt)
                n += nxt.frames.shape[0]
        if stop_seen:
            self.q.put(_STOP)  # the loop ends after this batch
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            groups: dict[tuple, list[_WorkItem]] = {}
            for b in batch:
                key = (b.frames.dtype.str, tuple(b.frames.shape[1:]))
                groups.setdefault(key, []).append(b)
            for group in groups.values():
                try:
                    self._dispatch(group)
                except BaseException as exc:  # every waiter gets the error
                    for b in group:
                        b.error = exc
                    if not isinstance(exc, Exception):
                        raise
                finally:
                    self.dispatches += 1
                    self.coalesced_requests += len(group)
                    self.max_coalesced = max(self.max_coalesced, len(group))
                    for b in group:
                        b.done.set()

    def _dispatch(self, group: list[_WorkItem]) -> None:
        """One pipeline call and one fetch for ``group``: the items' arrays
        go to the pipeline as they are, in order (a lone item's array
        alone), with no concatenate here; each item gets its rows of the
        logits."""
        rows = sum(b.frames.shape[0] for b in group)
        with span("amc.dispatch") as sp:
            if sp:
                sp.set(requests=len(group), frames=rows)
                sp.request = tuple(b.request.id for b in group if b.request is not None)
            frames = group[0].frames if len(group) == 1 else [b.frames for b in group]
            logits = self.pipe.logits(frames)
            with span("amc.fetch", frames=rows):
                logits = logits.cpu().numpy()
            off = 0
            for b in group:
                k = b.frames.shape[0]
                b.logits = logits[off : off + k]
                off += k


class AMCServer:
    """An :class:`AMCPipeline` behind a threaded HTTP server."""

    def __init__(
        self,
        cfg: Config,
        model_id: str | None = None,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_body: int = 256 << 20,
        warmup: bool = True,
        batch_window_ms: float = 2.0,
        max_concurrent_reads: int = 4,
        max_resident_bytes: int = 1 << 30,
        device: "str | torch.device | None" = None,
    ):
        self.cfg = cfg
        self.pipe = AMCPipeline.from_checkpoint(cfg, model_id, device=device)
        self.mods = list(cfg.signals.modulations_with_noise)
        #: the model's frame size: a fixed-length model's own, else the
        #: configuration's (what the features were trained at)
        self.frame_size = self.pipe.frame_size or cfg.signals.frame_size
        #: requests refused for their frame size
        self.frame_size_refused = 0
        self.max_body = max_body
        #: bounds the request bodies being read at once
        self._read_sem = threading.Semaphore(max(1, max_concurrent_reads))
        #: bounds the body bytes of every request in flight (read or queued)
        self.max_resident_bytes = max_resident_bytes
        self._resident_bytes = 0
        self._resident_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._frames = 0
        # bind first, so that early clients wait in the accept backlog while
        # the pipeline warms up
        handler = _make_handler(self)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # the default backlog of 5 resets a burst of concurrent connects
            request_queue_size = 128

        self.httpd = _Server((host, port), handler)
        if warmup:
            dummy = np.zeros((1, 2, self.frame_size), np.float32)
            dummy[:, 0, 0] = 1.0  # a frame with a nonzero RMS
            self.pipe.predict(dummy)
        self.batcher = _Batcher(self.pipe, window_s=batch_window_ms / 1e3)

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    # ------------------------------------------------------------------

    def check_frame_size(self, frame_size: int, allow_any: bool) -> None:
        """Raise ``ValueError`` for a frame size the model does not take: any
        other than a fixed-length model's own, or, unless ``allow_any``,
        any other than the configuration's. Each refusal is counted."""
        fixed = self.pipe.frame_size
        if fixed is not None and frame_size != fixed:
            msg = (f"frame_size {frame_size} != {fixed}: the {self.pipe.model.family} "
                   f"model takes frames of {fixed} samples only (its flatten is "
                   "fixed to it); allow_any_frame_size does not apply")
        elif fixed is None and frame_size != self.frame_size and not allow_any:
            msg = (f"frame_size {frame_size} != model's training frame size "
                   f"{self.frame_size}: the feature statistics shift with "
                   "N, so labels would be unreliable. Pass "
                   "allow_any_frame_size=1 to override.")
        else:
            return
        with self._stats_lock:
            self.frame_size_refused += 1
        raise ValueError(msg)

    def classify(self, body, fmt: str, frame_size: int, want_probs: bool) -> dict[str, Any]:
        """Labels (and probabilities) of the frames in ``body``: complex64
        ``(B, frame_size)`` for ``c64``, float32 ``(B, 2, frame_size)`` for
        ``planar``. A fixed-length model refuses any other ``frame_size``
        (``ValueError``)."""
        with span("amc.request", wait=True) as req:
            self.check_frame_size(frame_size, allow_any=True)
            if fmt not in ("c64", "planar"):
                raise ValueError(f"unknown format {fmt!r} (use c64|planar)")
            if len(body) % (8 * frame_size):
                what = ("complex64 frames of" if fmt == "c64"
                        else "planar f32 (2, N) frames of")
                raise ValueError(f"body is {len(body)} bytes — not a whole number "
                                 f"of {what} {frame_size} samples")
            if fmt == "c64":
                frames = np.frombuffer(body, dtype=np.complex64).reshape(-1, frame_size)
            else:
                frames = np.frombuffer(body, dtype=np.float32).reshape(-1, 2, frame_size)
            if frames.shape[0] == 0:
                raise ValueError("empty request")
            if req:
                req.request = req.id
                req.set(frames=frames.shape[0], bytes=len(body))
            logits = self.batcher.infer(frames, req)
            with self._stats_lock:
                self._requests += 1
                self._frames += int(frames.shape[0])
            with span("amc.reply", request=req.id, frames=frames.shape[0]):
                pred = logits.argmax(-1)
                out: dict[str, Any] = {
                    "labels": [self.mods[int(k)] for k in pred],
                    "class_ids": [int(k) for k in pred],
                }
                if want_probs:
                    z = np.exp(logits - logits.max(-1, keepdims=True))
                    out["probs"] = np.round(z / z.sum(-1, keepdims=True), 6).tolist()
            return out

    def _reserve(self, nbytes: int) -> bool:
        with self._resident_lock:
            if self._resident_bytes + nbytes > self.max_resident_bytes:
                return False
            self._resident_bytes += nbytes
            return True

    def _release(self, nbytes: int) -> None:
        with self._resident_lock:
            self._resident_bytes -= nbytes

    def health(self) -> dict[str, Any]:
        dev = self.pipe.device
        b = self.batcher
        return {
            "status": "ok",
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
            "family": self.pipe.model.family,
            "route": self.pipe.route,
            "frame_size": self.frame_size,
            "classes": self.mods,
            "frame_size_refused": self.frame_size_refused,
            "model_counters": {k: getattr(self.pipe.model, k)
                               for k in ("forwards", "frames", "steps")
                               if hasattr(self.pipe.model, k)},
            "forward_chunks": self.pipe.forward_chunks,
            "requests": self._requests,
            "frames_classified": self._frames,
            "batcher": {
                "dispatches": b.dispatches,
                "coalesced_requests": b.coalesced_requests,
                "max_coalesced": b.max_coalesced,
                "window_ms": b.window_s * 1e3,
                "coalesced_in_place": self.pipe.coalesced_in_place,
                "coalesced_concatenated": self.pipe.coalesced_concatenated,
            },
        }

    # ------------------------------------------------------------------

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()


def _read_body(rfile, length: int) -> bytearray:
    """Exactly ``length`` bytes of the request body, in a writable buffer
    (the pipeline's copy to the card reads it with every host thread)."""
    body = bytearray(length)
    view, got = memoryview(body), 0
    while got < length:
        n = rfile.readinto(view[got:])
        if not n:
            raise ValueError(f"body ended after {got} of {length} bytes")
        got += n
    return body


def _make_handler(server: AMCServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; counters in /healthz
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._reply(200, server.health())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/classify":
                # the body is not read: close the connection so that its
                # bytes are not parsed as the next request
                self.close_connection = True
                self._reply(404, {"error": "unknown path"})
                return
            body_read = False
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("missing body")
                if length > server.max_body:
                    raise ValueError(f"body {length} bytes exceeds limit {server.max_body}")
                q = parse_qs(url.query)
                fmt = q.get("format", ["c64"])[0]
                frame_size = int(q.get("frame_size", [server.frame_size])[0])
                if frame_size <= 0:
                    raise ValueError(f"frame_size must be > 0, got {frame_size}")
                server.check_frame_size(frame_size, q.get(
                    "allow_any_frame_size", ["0"])[0] in ("1", "true"))
                want_probs = q.get("probs", ["0"])[0] in ("1", "true")
                if not server._reserve(length):
                    self.close_connection = True  # the body is not read
                    self._reply(503, {"error": "overloaded: resident request bytes "
                                               "budget exhausted, retry later"})
                    return
                try:
                    with server._read_sem:
                        body = _read_body(self.rfile, length)
                    body_read = True
                    self._reply(200, server.classify(body, fmt, frame_size, want_probs))
                finally:
                    server._release(length)
            except ValueError as exc:
                if not body_read:
                    self.close_connection = True
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # the request fails, the server goes on
                if not body_read:
                    self.close_connection = True
                self._reply(500, {"error": repr(exc)})

    return Handler


def serve_forever(
    cfg: Config,
    model_id: str | None = None,
    host: str = "127.0.0.1",
    port: int = 8000,
    device: "str | torch.device | None" = None,
) -> None:
    """Serve until interrupted (Ctrl-C or SIGINT), then shut down."""
    srv = AMCServer(cfg, model_id, host=host, port=port, device=device)
    h, p = srv.address
    print(f"amc serve: listening on http://{h}:{p} (POST /classify, GET /healthz) "
          f"on {srv.pipe.device}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        srv.shutdown()
