"""Where a served request's and an extraction pass's host time goes, from
the port's span records (``amcpy_tpu_torch/utils/metrics.py``).

Runs each named cell of ``port_bench`` traced, in this process, and splits
the spans of its traced slice:

* a served request (``amc.request``): its wait in the batcher's queue, its
  dispatch's concatenate, staging wait, write and enqueue, model enqueue
  and device wait (``amc.fetch``), and its own reply; the share of the
  request those cover, for the median request and over all;
* an extraction pass (``amc.extract.pass``): each span's share of it,
  the loader's read and prep, the wait on the loader, the ``extract``
  stage and the saves; the direct reads a pass (the loader's ``direct``
  counts), and over the whole run ``io_mat``'s counters of direct and
  ``loadmat`` reads;
* the spans a request, a dispatch and a pass, and the program spans'
  share of the labelled idle gaps of the device trace.

With ``--cost 1`` it first times a span off and on in a loop.

    python3 scripts/torch_span_split.py --seconds 51 --seed 7 \\
        [--cells mlp-2048.bulk,cnn-2048.bulk,mlp-2048.extract] [--cost 1]

It needs a CUDA card; the JSON report goes to ``chiprun_out/`` and each
cell's line to standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the parts of a served request's split, in the order they happen
REQUEST_PARTS = ("queue", "concat", "stage_wait", "stage_write", "enqueue", "model",
                 "device_wait", "reply")
_DISPATCH_SPANS = {"concat": "amc.concat", "stage_wait": "amc.stage.wait",
                   "stage_write": "amc.stage.write", "enqueue": "amc.stage.enqueue",
                   "model": "amc.model", "device_wait": "amc.fetch"}
#: the program's spans that do the extract pass's work on either thread
PASS_LEAVES = ("amc.io.load_modulation", "amc.extract.prepare", "amc.extract",
               "amc.io.save_features")


def _ns(records) -> int:
    return sum(r.t1_ns - r.t0_ns for r in records)


def request_split(records) -> dict:
    """Each served request's time as the parts of :data:`REQUEST_PARTS`
    (nanoseconds), its dispatch's parts shared by the dispatch's requests;
    then the median request, each part's median and the share covered."""
    by_name: dict[str, list] = {}
    kids: dict[int, dict[str, list]] = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
        if r.parent is not None:
            kids.setdefault(r.parent, {}).setdefault(r.name, []).append(r)
    dispatch_of = {rid: d for d in by_name.get("amc.dispatch", []) for rid in d.request}
    rows = []
    for req in by_name.get("amc.request", []):
        d = dispatch_of.get(req.id)
        if d is None:  # failed before it was dispatched
            continue
        mine, theirs = kids.get(req.id, {}), kids.get(d.id, {})
        row = {"request": req.t1_ns - req.t0_ns, "dispatch": d.t1_ns - d.t0_ns,
               "queue": _ns(mine.get("amc.queue", [])),
               "reply": _ns(mine.get("amc.reply", []))}
        row.update({part: _ns(theirs.get(name, [])) for part, name in _DISPATCH_SPANS.items()})
        row["covered"] = sum(row[p] for p in REQUEST_PARTS)
        row.update(frames=req.counts.get("frames", 0),
                   dispatch_frames=d.counts.get("frames", 0),
                   dispatch_requests=d.counts.get("requests", 0))
        rows.append(row)
    if not rows:
        return {}
    rows.sort(key=lambda r: r["request"])
    median = rows[len(rows) // 2]
    timed = ("request", "dispatch", *REQUEST_PARTS)
    shares = [r["covered"] / r["request"] for r in rows]
    n_req, n_disp = len(by_name["amc.request"]), len(by_name.get("amc.dispatch", []))
    per_request = sum(len(by_name.get(n, [])) for n in ("amc.request", "amc.queue",
                                                        "amc.reply"))
    return {
        "requests": n_req, "dispatches": n_disp,
        "spans_per_request": per_request / n_req,
        "spans_per_dispatch": (len(records) - per_request) / max(n_disp, 1),
        "median_request_ms": {k: median[k] / 1e6 for k in timed},
        "median_request_counts": {k: median[k] for k in ("frames", "dispatch_frames",
                                                         "dispatch_requests")},
        "median_request_covered": median["covered"] / median["request"],
        "part_medians_ms": {k: statistics.median(r[k] for r in rows) / 1e6 for k in timed},
        "covered_all": sum(r["covered"] for r in rows) / sum(r["request"] for r in rows),
        "covered_median": statistics.median(shares),
        "covered_min": min(shares),
    }


def pass_split(records) -> dict:
    """Each span's summed time over the extraction passes' (%), with the
    seconds and counts behind it, and the modulations a pass read by the
    direct route."""
    secs: dict[str, float] = {}
    count: dict[str, int] = {}
    for r in records:
        secs[r.name] = secs.get(r.name, 0.0) + (r.t1_ns - r.t0_ns) / 1e9
        count[r.name] = count.get(r.name, 0) + 1
    passes, whole = count.get("amc.extract.pass", 0), secs.get("amc.extract.pass", 0.0)
    if not passes or whole <= 0:
        return {}
    return {"passes": passes, "spans_per_pass": len(records) / passes, "seconds": secs,
            "share_pct": {k: 100.0 * v / whole for k, v in secs.items()}, "counts": count,
            "direct_per_pass": sum(r.counts.get("direct", 0) for r in records
                                   if r.name == "amc.io.load_modulation") / passes,
            "stage_wait_save_pct": 100.0 * sum(secs.get(k, 0.0) for k in (
                "amc.extract", "amc.extract.load_wait", "amc.io.save_features")) / whole}


def leaf_label_share(idle_gaps, leaves=PASS_LEAVES) -> float | None:
    """The share of the labelled idle seconds of the device trace
    (``breakdown.idle_gaps``: pairs of label and seconds) under ``leaves``."""
    labelled = {k: v for k, v in idle_gaps if k != "shorter gaps"}
    total = sum(labelled.values())
    return sum(v for k, v in labelled.items() if k in leaves) / total if total else None


def span_cost(n: int = 100_000) -> dict:
    """Microseconds a span costs: off, off with a count, and on (a span of
    work, which opens a ``record_function``, and a waiting one), in loops
    of ``n``."""
    import torch

    from amcpy_tpu_torch.utils import metrics

    def loop(**kw):
        t0 = time.perf_counter()
        for _ in range(n):
            with metrics.span("amc.cost", **kw):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    loop()
    out = {"loop": n, "off_us": loop(), "off_with_count_us": loop(frames=1)}
    for key, kw in (("on_work_us", {}), ("on_wait_us", {"wait": True})):
        metrics.clear_spans()
        with torch.profiler.profile(activities=acts):
            out[key] = loop(frames=1, **kw)
    metrics.clear_spans()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="mlp-2048.bulk,cnn-2048.bulk,mlp-2048.extract")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--cost", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "span_split.json"))
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.utils import metrics
    from port_bench.harness import run_cell

    dev = torch.device("cuda", 0)
    report: dict = {"card": torch.cuda.get_device_name(dev)}
    if args.cost:
        report["cost"] = span_cost()
        print("cost", json.dumps(report["cost"]), flush=True)
    for k, cell in enumerate(c for c in args.cells.split(",") if c):
        metrics.clear_spans()
        reads = io_mat.direct_reads, io_mat.loadmat_reads
        out = run_cell(ROOT, cell, args.seed + k, args.seconds, True, dev,
                       log=lambda line: print(line, file=sys.stderr, flush=True))
        records = metrics.spans()
        row = {"correct": out["correct"], "dropped": metrics.spans_dropped(),
               "metrics": {n: m["value"] for n, m in out["metrics"].items()},
               "idle_gaps": out["breakdown"]["idle_gaps"]}
        if any(r.name == "amc.extract.pass" for r in records):
            row["split"] = pass_split(records)
            row["leaf_label_share"] = leaf_label_share(row["idle_gaps"])
            row["mat_reads"] = {"direct": io_mat.direct_reads - reads[0],
                                "loadmat": io_mat.loadmat_reads - reads[1],
                                "window_frames": out["attempted"]}
        else:
            row["split"] = request_split(records)
        report[cell] = row
        print(cell, json.dumps(row), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
