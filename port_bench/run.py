#!/usr/bin/env python3
"""Run one cell of the benchmark of ``amcpy_tpu_torch`` once, on this
machine's NVIDIA card:

    python3 port_bench/run.py --workload mlp-2048.bulk --seed 7 --seconds 10 --trace 0

from the root of a checkout. It prints informational lines, then, as its
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` (and ``breakdown`` with
``--trace 1``), and last ``checks``, each number the comparison with the
reference read beside its limit; the same numbers are the last lines of
standard error. It exits non-zero and prints no result without a card (or
with fewer cards than the cell asks for), when the program cannot be
imported, or when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the path: the folder's module
# names (``trace``) must not shadow the standard library's
if sys.path and Path(sys.path[0]).resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)


def _host() -> str:
    cpu = platform.processor() or platform.machine()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.lower().startswith(("model name", "cpu model")):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"host: {cpu}, {os.cpu_count()} cores, python {platform.python_version()}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from port_bench.harness import held_forbidden, run_cell

    print(_host(), f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=T_START,
                      log=lambda line: print(line, flush=True))
    held = held_forbidden()
    if held:
        print(f"the process holds {held} once the window has closed", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
