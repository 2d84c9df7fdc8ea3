#!/usr/bin/env python3
"""Read the numbers a cell's limits are set from, on the card, in one
process (the benchmark's own runs never do this):

    python3 port_bench/calibrate.py --workload mlp-2048.bulk --seconds 3 \\
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11,12,13 \\
        --out build/calibrate.mlp-2048.bulk.json

For each of ``--seeds`` one run of the program at the cell's own sizes
and load (a short window), its compared numbers; for each of
``--control-seeds`` the control's numbers on the same inputs (the
reference in the precision below the configuration's, in the program's
place); for each of ``--fault-seeds`` a run with each fault the cell can
have (``faults.py``) planted underneath the timed path. The file is
rewritten after every run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="the faults to plant (default: every "
                    "fault the cell can have)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    from port_bench import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = harness.load_cell(ROOT, args.workload).traffic["kind"]
    out = {"workload": args.workload, "seconds": args.seconds, "program": [],
           "control": [], "faults": []}
    control = set(_seeds(args.control_seeds))
    plan = [(s, None) for s in _seeds(args.seeds)]
    plan += [(s, None) for s in sorted(control - set(_seeds(args.seeds)))]
    planted = [f for f in args.faults.split(",") if f] or list(faults.FAULTS[kind])
    plan += [(s, f) for s in _seeds(args.fault_seeds) for f in planted]
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    for seed, fault in plan:
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, dev,
                               fault=fault, control=fault is None and seed in control,
                               numbers=True, log=lambda _: None)
        values = res["numbers"]
        row = {"seed": seed, "correct": res["correct"], "values": values,
               "attempted": res["attempted"], "failed": res["failed"],
               "seconds": time.perf_counter() - t0}
        if fault is not None:
            out["faults"].append(dict(row, fault=fault))
        elif seed in _seeds(args.seeds):
            out["program"].append(row)
        if res.get("control") is not None:
            out["control"].append({"seed": seed, "values": res["control"]})
        print(json.dumps({"seed": seed, "fault": fault, "values": values,
                          "control": res.get("control"), "correct": res["correct"]}),
              flush=True)
        path.write_text(json.dumps(out, indent=1))
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
