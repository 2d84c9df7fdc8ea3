#!/usr/bin/env python3
"""Where K3's time goes: the CNN trunk kernels of
``amcpy_tpu_torch/csrc/cnn_trunk.cu`` on the default stack (2, 32, 64, 128),
timed as shipped and in variants made by text edits of that source, on one
NVIDIA card, with a count of each kernel's compiled instructions.

    python3 scripts/k3_ablation.py [--sass-dir DIR]

Variants: ``shipped`` (the wgmma kernel), ``mma_sync`` (the library routes
the default stack to the mma.sync kernel, which every other stack takes)
and ``products_only`` (the wgmma kernel without its pooling and its tile
loop's sample loads). Each is built by ``nvcc`` into its own directory
under ``build/k3_ablation/`` and timed through ``cnn_trunk`` at 4096 x 2048
with inputs rotated past the 50 MB L2 (``chip_smoke.rotated``,
``chip_smoke.cuda_ms``), in the order shipped, mma_sync, products_only and
back; its output is compared with ``cnn_trunk_plain`` (the largest error
over K3's tolerance).

The SASS of the ``shipped`` and ``mma_sync`` builds (``cuobjdump -sass``)
is read per kernel: the instructions by opcode, and each loop (the span of
a backward branch) with the instructions it holds, for counting the
instructions a tile costs. ``--sass-dir`` also writes both listings there.
Prints one JSON line with the card's name and power limit and, per variant,
the route that ran, its times, its largest error over the tolerance,
ptxas's registers and spills, and the counts. Needs a CUDA card; without
one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: name -> [(text in cnn_trunk.cu, replacement)]
VARIANTS = {
    "shipped": [],
    # the library routes the default stack to the mma.sync kernel
    "mma_sync": [("return dflt ? 2 : 1;", "return 1;")],
    # neither the pooling epilogue (layer 2's accumulators barely read) nor
    # the tile loop's sample loads (layer 0 from made-up values): the
    # products and what feeds them; its output is wrong by design
    "products_only": [
        ("""      if (n - t0 >= kRows) {
        pool<false>(acc2, s, m, true, true);
      } else {
        pool<true>(acc2, s, m, t0 + row < n, t0 + row + 8 < n);
      }""", "      s[0] += acc2[0] + acc2[63];"),
        ("""        if (t2 < n) {
          ni_lo = ip_next[0];
          nq_lo = qp_next[0];
        }
        if (t2 + 8 < n) {
          ni_hi = ip_next[8];
          nq_hi = qp_next[8];
        }""", "        ni_lo = nq_lo = ni_hi = nq_hi = 1e-3f * t2;"),
    ],
}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_counts(sass: str) -> dict[str, dict]:
    """Per kernel of a ``cuobjdump -sass`` listing: instructions by opcode
    (the part before the first dot), and every loop, a backward branch's
    span, with its instructions by opcode."""
    out: dict[str, dict] = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        instrs = []  # (address, opcode, operands)
        for m in _INSTR.finditer(chunk):
            instrs.append((int(m[1], 16), m[3].split(".")[0], m[4]))
        loops = []
        for addr, op, args in instrs:
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t[1], 16) <= addr:
                start = int(t[1], 16)
                body = Counter(o for a, o, _ in instrs if start <= a <= addr)
                loops.append({"start": hex(start), "end": hex(addr),
                              "instructions": sum(body.values()),
                              "by_opcode": dict(body.most_common())})
        total = Counter(op for _, op, _ in instrs)
        out[name] = {"instructions": sum(total.values()),
                     "by_opcode": dict(total.most_common()), "loops": loops}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-dir", type=Path)
    args = ap.parse_args()
    import chip_smoke as cs
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.cnn_infer import cnn_trunk, cnn_trunk_plain

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n = 4096, 2048
    x = cs.test_frames(b, n, 0)
    i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
    planes = cs.rotated(i, q)
    convs = cs.folded_default_stack(torch, dev, seed=20)
    want = cnn_trunk_plain(i, q, convs)

    def trunk(a, c):
        return cnn_trunk(a, c, convs)

    source = (_build.CSRC / "cnn_trunk.cu").read_text()
    names = list(VARIANTS)
    rows: dict[str, dict] = {}
    for name in names + names[::-1]:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} is not in cnn_trunk.cu")
            text = text.replace(old, new)
        d = ROOT / "build" / "k3_ablation" / name
        (d / "csrc").mkdir(parents=True, exist_ok=True)
        (d / "csrc" / "cnn_trunk.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "build"
        _build._libs.clear()
        path = _build.build("cnn_trunk")

        row = rows.get(name)
        if row is None:
            log = path.with_suffix(".log").read_text()
            sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                  text=True, check=True).stdout
            if args.sass_dir and name in ("shipped", "mma_sync"):
                args.sass_dir.mkdir(parents=True, exist_ok=True)
                (args.sass_dir / f"{name}.sass").write_text(sass)
            by_path = dict(cnn_trunk.launches_by_path)
            got = trunk(i, q)
            torch.cuda.synchronize()
            try:
                err = cs.k3_error(got, want)[1]
            except AssertionError:  # products_only may overflow
                err = None
            row = rows[name] = {
                "route": [r for r, c in cnn_trunk.launches_by_path.items()
                          if c > by_path[r]],
                "max_err_over_tol": err,
                "ptxas": cs.ptxas_report(log),
                "sass": sass_counts(sass) if name in ("shipped", "mma_sync") else None,
                "ms": [],
            }
        row["ms"].append(cs.cuda_ms(trunk, planes, 30))
    print(json.dumps({"nvidia_smi": smi, "shape": [b, n],
                      "bound_ms": cs.k3_bound(b, n)[0], "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
