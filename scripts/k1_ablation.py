#!/usr/bin/env python3
"""Where K1's time goes: the fused feature kernel (``amc_fused_features``)
and the statistics kernel (``amc_stats_features``) of
``amcpy_tpu_torch/csrc/features.cu``, timed as shipped and in variants made
by text edits of that source, on one NVIDIA card.

    python3 scripts/k1_ablation.py [VARIANTS.json]

A JSON file ``{"name": [[text, replacement], ...], ...}`` replaces the
built-in variants (``shipped`` is always timed first).

Each variant is built by ``nvcc`` into its own directory under
``build/k1_ablation/`` and timed at 4096 x 2048 with inputs rotated past
the 50 MB L2 (``chip_smoke.rotated``, ``chip_smoke.cuda_ms``), in the order
shipped, variants, variants reversed, shipped. Each variant's output is
compared with the shipped kernel's (the relative difference; a variant
that skips gamma_max differs in column 0 by design). Prints one JSON line
with the card's name and power limit, the ``torch.fft`` yardstick and, per
variant, the two times of each kernel and ptxas's registers and spills.
Needs a CUDA card; without one it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: name -> [(text in features.cu, replacement)]
VARIANTS = {
    "shipped": [],
    # gamma_max skipped: the statistics alone (column 0 differs)
    "no_gmax": [("mx = gmax_fft(xi, xq, ph, tw, w1r, w1i, twr, twi, n, n1, n2);",
                 "mx = 0.f;")],
    # the frame planes without the bank swizzle
    "no_swizzle": [("{ return x ^ (((x >> 5) & 7) << 2); }", "{ return x; }")],
    # CUDA's atan2f for the phase (a division and branches) in place of
    # phase_of
    "atan2f": [("const float p = phase_of(q, i);", "const float p = atan2f(q, i);")],
    # three blocks a SM for both kernels (no register cap at 64)
    "three_blocks": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fused import extract_features_fused
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    x = cs.test_frames(4096, 2048, 0)
    i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
    planes = cs.rotated(i, q)
    packed = cs.rotated(torch.stack([i, q], 1).contiguous())

    def k2(t):
        return extract_features_pallas(t, compute_gmax=False)

    variants = VARIANTS
    if len(sys.argv) > 1:
        variants = {"shipped": [], **json.loads(Path(sys.argv[1]).read_text())}
    source = (_build.CSRC / "features.cu").read_text()
    names = list(variants)
    rows: dict[str, dict] = {}
    shipped_out = None
    for name in names + names[::-1]:
        text = source
        for old, new in variants[name]:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} is not in features.cu")
            text = text.replace(old, new)
        d = ROOT / "build" / "k1_ablation" / name
        (d / "csrc").mkdir(parents=True, exist_ok=True)
        (d / "csrc" / "features.cu").write_text(text)
        _build.CSRC, _build.BUILD_DIR = d / "csrc", d / "build"
        _build._libs.clear()
        lib = _build.build("features")
        out = extract_features_fused(i, q)
        if shipped_out is None:
            shipped_out = out.clone()
        row = rows.setdefault(name, {"k1_ms": [], "k2_ms": [], "ptxas": [
            line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in line or "spill" in line
        ]})
        row["max_rel_diff_vs_shipped"] = float(
            ((out - shipped_out).abs() / shipped_out.abs().clamp_min(1e-30)).max()
        )
        row["k1_ms"].append(cs.cuda_ms(extract_features_fused, planes, 30))
        row["k2_ms"].append(cs.cuda_ms(k2, packed, 30))
    library_ms = cs.cuda_ms(lambda c: torch.fft.fft(c).abs().amax(dim=-1),
                            cs.rotated(torch.complex(i, q)), 30)
    print(json.dumps({"nvidia_smi": smi, "shape": [4096, 2048],
                      "library_ms": library_ms, "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
