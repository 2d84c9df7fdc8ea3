"""Driver of ``serve`` traffic: closed-loop clients calling
``AMCServer.classify`` with raw complex64 bodies, as the HTTP handler
does once it has read a body.

Set-up makes a pool of distinct seeded frames on the host (of the
configuration's ``signals.pool_modulations``, by default its
``modulations``) and, through the configuration's family
(``families/<family>.py``), the model's weights on the device from the
seed and its scaler. It writes them as the program's checkpoint and starts
an ``AMCServer`` from it (its HTTP loop runs on a thread of its own and
gets no request). It warms the pipeline at the largest dispatch the
clients can make and runs every client for a few requests.

In the window each client sends requests one after another. A request
holds ``k`` consecutive pool frames from a seeded offset; the sizes are a
fixed grid from ``k_min`` to ``k_max`` that every seed sends alike, each
client in an order of its own drawn from the seed. The body is a writable
view of the pool's bytes, as a body read from a socket into a
``bytearray`` is.

The end-to-end metric is the card's time each answered frame costs: an
untraced window runs under a device-only profiler (CUPTI's kernels, copies
and memsets), from before the clients start until the last of them has
its answer, and ``serve_card_us_per_frame`` is the union of the device's
activity over every frame answered in it. The frames answered a second of
the window, which follow the host's speed, are read in the traced run
(``frames_per_s.serve``).

``correct``: every answered frame of every request is held against the
reference's logits of its frame: the widest gap by which the logit of the
served class lies below the reference's best (``max_logit_gap``), and,
since every request asks for probabilities (``want_probs``, the HTTP
API's ``probs=1``), the largest error of a served probability against the
reference's softmax (``max_prob_err``; the server rounds them to six
decimals). The second sees an answer sent to the wrong request even where
both requests' frames take one class. A request that failed, or came back
with another number of answers, reads ``MISSING``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from port_bench import common, signals
from port_bench.trace import Tracer, span

#: the gap a request without its answers reads
MISSING = 1e9
#: requests each client sends to warm up
WARM_REQUESTS = 4
#: the traced slice: where in the window it starts, and its seconds
TRACE_AT, TRACE_S = 0.3, 2.0
#: seconds a client may take to finish its request once the window closes
JOIN_S = 60.0


class Driver:
    def __init__(self, ctx):
        from amcpy_tpu_torch.server import AMCServer
        from amcpy_tpu_torch.train.checkpoint import save_checkpoint

        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        s = cfg["signals"]
        self.n = s["frame_size"]
        self.pool, _ = signals.make_pool(ctx.seed, t["pool_frames"], self.n,
                                         s.get("pool_modulations", s["modulations"]),
                                         s["snr_db"])
        self.bytes = memoryview(self.pool).cast("B")
        dev = ctx.device
        self.family = common.family(cfg)
        self.params = self.family.params(cfg, ctx.seed, dev)
        scaler, self.state = self.family.scaler(cfg, self.pool, self.params, dev)
        pcfg = common.port_config(cfg, ctx.workdir / "root")
        save_checkpoint(pcfg, "bench", self.family.program_model(cfg, self.params), scaler)
        self.srv = AMCServer(pcfg, "bench", port=0, device=dev)
        self._http = threading.Thread(target=self.srv.serve_forever, name="http", daemon=True)
        self._http.start()
        # the largest dispatch the clients can make: each one's largest request
        top = min(t["clients"] * t["k_max"], t["pool_frames"])
        self.srv.classify(self.bytes[: top * 8 * self.n], "c64", self.n, False)
        sizes = np.arange(t["k_min"], t["k_max"] + 1, t["k_step"])
        self.orders = [np.random.default_rng([ctx.seed, 100 + c]).permutation(sizes)
                       for c in range(t["clients"])]
        self.records: list[list[tuple]] = [[] for _ in range(t["clients"])]
        self._run(warm=True)
        self.records = [[] for _ in range(t["clients"])]
        self.attempted = self.failed = 0
        self.e2e: dict[str, float] = {}

    # ------------------------------------------------------------------

    def _run(self, warm: bool = False, seconds: float = 0.0, tracer=None) -> tuple[float, float]:
        """Run the clients: ``WARM_REQUESTS`` each, or for ``seconds`` (with
        a traced slice when ``tracer`` is given). Returns the window's
        start and end on the host clock."""
        t = self.ctx.traffic
        n, stop = self.n, threading.Event()
        gate = common.Gate()
        alive = [t["clients"]]
        lock = threading.Lock()

        def client(c: int) -> None:
            rng = np.random.default_rng([self.ctx.seed, 200 + c, int(warm)])
            order, j = self.orders[c], 0
            try:
                while not stop.is_set() and not (warm and j >= WARM_REQUESTS):
                    phase = gate.wait()
                    k = int(order[j % len(order)])
                    j += 1
                    off = int(rng.integers(0, t["pool_frames"] - k + 1))
                    body = self.bytes[off * 8 * n : (off + k) * 8 * n]
                    t0 = time.perf_counter()
                    try:
                        with span("classify"):
                            reply = self.srv.classify(body, "c64", n, t["want_probs"])
                        t1 = time.perf_counter()
                        ans = (np.asarray(reply["class_ids"], np.int64),
                               np.asarray(reply.get("probs", np.zeros((k, 0))), np.float64))
                    except Exception as exc:  # a failed request is a miss
                        t1, ans = time.perf_counter(), None
                        self.ctx.log(f"request failed: {exc!r}")
                    self.records[c].append((t0, t1, off, k, ans, phase))
            finally:
                with lock:
                    alive[0] -= 1

        threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
                   for c in range(t["clients"])]
        start = time.perf_counter()
        for th in threads:
            th.start()
        if not warm:
            if tracer is not None:
                time.sleep(seconds * TRACE_AT)
                gate.hold(lambda: alive[0])
                before = self.srv.batcher.dispatches
                tracer.start()
                gate.release()
                time.sleep(TRACE_S)
                gate.hold(lambda: alive[0])
                tracer.counts["dispatches"] = self.srv.batcher.dispatches - before
                tracer.stop()
                gate.release()
                remaining = seconds - (time.perf_counter() - start)
                time.sleep(max(remaining, 0.0))
            else:
                time.sleep(seconds)
            stop.set()
        end = time.perf_counter()
        for th in threads:
            th.join(JOIN_S)
            if th.is_alive():
                raise RuntimeError(f"{th.name} still waiting {JOIN_S} s after the window")
        if tracer is not None:
            inside = [r for rec in self.records for r in rec if r[5] == 1]
            tracer.counts["frames"] = sum(r[3] for r in inside)
            tracer.counts["requests"] = len(inside)
        return start, end

    def window(self, seconds: float, tracer=None) -> None:
        clock = None
        if tracer is None and self.ctx.device.type == "cuda":
            clock = Tracer(self.ctx.workdir, host=False)
            clock.start()
        start, end = self._run(seconds=seconds, tracer=tracer)
        if clock is not None:  # every request of the window has been answered
            clock.stop()
        wall = end - start
        recs = [r for rec in self.records for r in rec]
        self.attempted = len(recs)
        self.failed = sum(r[4] is None for r in recs)
        # a failed request misses every latency limit
        lat = [(r[1] - r[0]) * 1e3 if r[4] is not None else MISSING for r in recs]
        answered = sum(r[3] for r in recs if r[4] is not None and r[1] <= end)
        q = common.quantiles(lat)
        if tracer is not None:  # the rate, and the tail outside the traced (profiled) slice
            tracer.counts["frames_per_s"] = answered / wall
            tracer.counts["request_p95_ms"] = common.quantiles(
                [v for v, r in zip(lat, recs) if r[5] != 1])["p95"]
        elif clock is not None:
            served = sum(r[3] for r in recs if r[4] is not None)
            busy = clock.summary["busy_s"]
            self.e2e = {"serve_card_us_per_frame": busy / served * 1e6} if served and busy else {}
            self.ctx.log(f"card busy {busy} s over {clock.summary['window_s']} s for "
                         f"{served} frames answered")
        self.ctx.log(f"requests {q['n']}, failed {self.failed}, latency ms p50 "
                     f"{q['p50']} p95 {q['p95']} p99 {q['p99']}; frames answered "
                     f"{answered} in {wall} s; dispatches {self.srv.batcher.dispatches}, "
                     f"max coalesced {self.srv.batcher.max_coalesced}")

    def release(self) -> None:
        self.srv.shutdown()
        self._http.join(JOIN_S)
        del self.srv

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _pool_logits(self, control: bool) -> torch.Tensor:
        """The reference's logits of every pool frame (the control's, in the
        precision below the configuration's, with ``control``)."""
        return self.family.reference_logits(self.ctx.cfg, self.params, self.state, self.pool,
                                            self.ctx.device, control)

    def compare(self, control: bool = False) -> dict[str, float]:
        ref = self._pool_logits(False).double()
        best = ref.max(-1).values.cpu().numpy()
        probs = torch.softmax(ref, -1).cpu().numpy()
        ref = ref.cpu().numpy()
        if control:
            ctrl = self._pool_logits(True).double()
            ctrl_ids = ctrl.argmax(-1).cpu().numpy()
            ctrl_probs = torch.softmax(ctrl, -1).cpu().numpy()
        gap = err = 0.0
        classes = ref.shape[1]
        for rec in self.records:
            for _, _, off, k, ans, _ in rec:
                rows = slice(off, off + k)
                if control:
                    ids, p = ctrl_ids[rows], ctrl_probs[rows]
                elif ans is None:
                    gap = err = MISSING
                    continue
                else:
                    ids, p = ans
                if ids.shape != (k,) or ids.min() < 0 or ids.max() >= classes:
                    gap = MISSING
                else:
                    gap = max(gap, float((best[rows] - ref[rows][np.arange(k), ids]).max()))
                if self.ctx.traffic["want_probs"]:
                    err = (max(err, float(np.abs(p - probs[rows]).max()))
                           if p.shape == (k, classes) else MISSING)
        out = {"max_logit_gap": gap}
        if self.ctx.traffic["want_probs"]:
            out["max_prob_err"] = err
        return out
