#!/usr/bin/env python3
"""Where the ResNet stack kernel's time goes: ``amc_resnet_stack`` of
``amcpy_tpu_torch/csrc/resnet_trunk.cu`` timed as shipped and in variants
made by text edits of that source, on one NVIDIA card, with a count of each
build's compiled instructions.

    python3 scripts/resnet_ablation.py [--frames 16384] [--sass-dir DIR]

Variants, each the design choice it stands for:

* ``shipped``: a warp owns 8 output channels at 256 positions, so a
  (c_in, tap)'s weights are warp broadcasts; an input channel's operands
  loaded while the channel before it is multiplied; the input-channel
  loop unrolled by 4; the next pass's input staged by ``cp.async`` under
  the last conv's products;
* ``lanes_mixed``: the other tiling of the same 8 x 8 register tile, a warp
  owning all 32 channels at 64 positions (lane = 4 channel groups x 8
  position groups), so lanes share inputs instead of weights;
* ``load_just_before``: an input channel's operands loaded just before its
  products, not while the channel before it is multiplied;
* ``unroll_1``, ``unroll_2``: the input-channel loop unrolled by 1 and 2;
* ``no_halo``: the tiles' halo convs left out (stack 0's seams read stale
  halo columns; its output is wrong by design), their cost;
* ``staged_after``: the next pass's input staged after the last conv
  instead of under its products (``cp.async`` then overlaps nothing);
* ``no_input_load``: no pass's input staged after the first (the stale
  buffer is read; wrong by design): what is left to gain from the loads.

Each is built by ``nvcc`` into its own directory under
``build/resnet_ablation/`` and timed through ``resnet_stack`` on the six
stacks of ``--frames`` frames of 1024 samples (each stack's input rotated
past the 50 MB L2, ``chip_smoke.rotated`` and ``chip_smoke.cuda_ms``), in
the order shipped ... no_input_load and back; its six stacks' output is
compared with the module forward's (the largest gap over the largest
magnitude). The SASS of each build (``cuobjdump -sass``) is counted per
kernel: instructions by opcode and each loop's instructions (FFMA against
loads in the input-channel loop). Prints one JSON line with the card's name
and power limit, the bound, and per variant its ms a stack and in all, its
share of the FP32 lane peak, its gap, ptxas's registers and spills and the
counts. Needs a CUDA card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: name -> [(text in resnet_trunk.cu, replacement)]
VARIANTS = {
    "shipped": [],
    "lanes_mixed": [
        ("  ln.cg = warp & 3;\n", "  ln.cg = lane >> 3;\n"),
        ("  const int v0 = (warp >> 2) * (kPass / 2) + 4 * lane;\n"
         "  const int vs[2] = {v0, v0 + kPass / 4};\n",
         "  const int v0 = warp * 64 + 4 * (lane & 7);\n"
         "  const int vs[2] = {v0, v0 + 32};\n"),
    ],
    "load_just_before": [("constexpr bool kLoadAhead = true;", "constexpr bool kLoadAhead = false;")],
    "unroll_1": [("#pragma unroll 4\n  for (int ci = 0; ci < kC; ++ci) {",
                  "#pragma unroll 1\n  for (int ci = 0; ci < kC; ++ci) {")],
    "unroll_2": [("#pragma unroll 4\n  for (int ci = 0; ci < kC; ++ci) {",
                  "#pragma unroll 2\n  for (int ci = 0; ci < kC; ++ci) {")],
    "no_halo": [("  if (k >= count) return;\n", "  if (k >= 0) return;\n")],
    "staged_after": [(
        """    if (pass + static_cast<int>(gridDim.x) < p.passes) {
      stage_input<CIN>(in, pass + gridDim.x, b, p, X);
    }
    acc_conv<kTaps>(a, sw + 3 * kConvW, A, p.stride, ln);
    acc_store<kPool>(a, nullptr, p.stride, ln, out, b, lout);
""",
        """    acc_conv<kTaps>(a, sw + 3 * kConvW, A, p.stride, ln);
    acc_store<kPool>(a, nullptr, p.stride, ln, out, b, lout);
    if (pass + static_cast<int>(gridDim.x) < p.passes) {
      stage_input<CIN>(in, pass + gridDim.x, b, p, X);
    }
""")],
    "no_input_load": [("    if (pass + static_cast<int>(gridDim.x) < p.passes) {\n"
                       "      stage_input<CIN>",
                       "    if (false) {\n      stage_input<CIN>")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resnet_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--sass-dir", type=Path)
    args = ap.parse_args()
    import chip_smoke as cs
    from k3_ablation import sass_counts

    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.resnet_trunk import pack_params, resnet_stack

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = args.frames
    model = cs.resnet_model(torch, dev)
    packed = pack_params(model)
    ins, wants = [], []
    with torch.inference_mode():
        x = cs.resnet_frames(torch, dev, b, seed=1)
        for st in model.stacks:
            ins.append(cs.rotated(x))
            x = st(x)
            wants.append(x)
    bound_ms = [cs.bound(0.0, b * cs.resnet_stack_work(t[0][0].shape[1], t[0][0].shape[2]))[0]
                for t in ins]

    source = (_build.CSRC / "resnet_trunk.cu").read_text()
    names = list(VARIANTS)
    rows: dict[str, dict] = {}
    for name in names + names[::-1]:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} is not in resnet_trunk.cu")
            text = text.replace(old, new)
        d = ROOT / "build" / "resnet_ablation" / name
        (d / "csrc").mkdir(parents=True, exist_ok=True)
        (d / "csrc" / "resnet_trunk.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "build"
        _build._libs.clear()
        path = _build.build("resnet_trunk")
        row = rows.get(name)
        if row is None:
            log = path.with_suffix(".log").read_text()
            sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                  text=True, check=True).stdout
            if args.sass_dir:
                args.sass_dir.mkdir(parents=True, exist_ok=True)
                (args.sass_dir / f"resnet_{name}.sass").write_text(sass)
            with torch.inference_mode():
                gaps = [float((resnet_stack(t[0][0], p) - w).abs().max() / w.abs().max())
                        for t, p, w in zip(ins, packed, wants)]
            torch.cuda.synchronize()
            row = rows[name] = {
                "gap_over_scale": gaps,
                "ptxas": cs.ptxas_report(log),
                "sass": {k: {"instructions": v["instructions"],
                             "by_opcode": v["by_opcode"],
                             "loops": [lp for lp in v["loops"] if lp["instructions"] > 200]}
                         for k, v in sass_counts(sass).items()},
                "ms": [],
            }
        with torch.inference_mode():
            row["ms"].append([cs.cuda_ms(lambda a, p=p: resnet_stack(a, p), t, 20)
                              for t, p in zip(ins, packed)])
    for row in rows.values():
        per_stack = [min(r[s] for r in row["ms"]) for s in range(len(packed))]
        row["best_ms"] = per_stack
        row["trunk_ms"] = sum(per_stack)
        row["lane_peak_share"] = sum(bound_ms) / row["trunk_ms"]
    print(json.dumps({"nvidia_smi": smi, "frames": b, "bound_ms": bound_ms,
                      "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
