#!/usr/bin/env python3
"""Where K1's and K2's time goes: the fused feature kernel
(``amc_fused_features``) and the statistics kernel (``amc_stats_features``)
of ``amcpy_tpu_torch/csrc/features.cu``, timed as shipped and in variants
made by text edits of that source, on one NVIDIA card.

    python3 scripts/k1_ablation.py [VARIANTS.json]

A JSON file ``{"name": [[text, replacement], ...], ...}`` replaces the
built-in variants (``shipped`` is always timed first).

Each variant is built by ``nvcc`` into its own directory under
``build/k1_ablation/`` and timed at 4096 x 2048 with inputs rotated past
the 50 MB L2 (``chip_smoke.rotated``, ``chip_smoke.cuda_ms``), in the order
shipped, variants, variants reversed, shipped. Each variant's output is
compared with the shipped kernel's (the relative difference, K1's and K2's;
a variant that skips gamma_max differs in column 0 by design). Prints one JSON line
with the card's name and power limit, the ``torch.fft`` yardstick and, per
variant, the two times of each kernel and ptxas's registers and spills.
Then K2 as shipped is timed at batches of whole and partial waves of
resident frames (``K2_BATCHES``, in order and reversed), the card's SM
clock and power are read by nvidia-smi while K2 runs back to back, and
the shipped warpgroup kernel's SASS (``cuobjdump -sass``, 16-byte loads)
is counted between its named barriers: the load and pass 1, pass 2, pass
3, and warp 0's tail with the slow paths of the divisions and roots.
Needs a CUDA card; without one it exits 1.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts.k3_ablation import _INSTR as SASS_INSTR  # noqa: E402

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
    "atan2f": [("add1(j, k, sqrtf(i * i + q * q), phase_of(q, i));",
                "add1(j, k, sqrtf(i * i + q * q), atan2f(q, i));")],
    # the arithmetic of the kernels before the tiny-amplitude repair: no
    # thread goes over its samples again through polar() (the amplitude of
    # a sample below 2^-50 from its subnormal squares), no 2^64 scale
    # before |x| / mean|x|, and |x / s|^2 as |x|^2 (1/s)^2
    "before_repair": [("const bool tiny = key < kTinyKey;", "const bool tiny = false;"),
                      ("return mean_a < 0x1p-100f ? 0x1p64f : 1.f;", "return 1.f;"),
                      ("if (key < kTinyKey) {", "if (false) {"),
                      ("const float a2 = iu * iu + qu * qu;",
                       "const float a2 = (i * i + q * q) * (inv * inv);")],
    # three blocks a SM for K1 and K2's block route (no register cap at 64)
    "three_blocks": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
    # K2 at N = 2048 on the block route (one 256-thread block a frame, the
    # frame in shared memory), the design before the warpgroup route
    "k2_block": [("return n >= 2 && n <= kWgMaxN ? 1 : 0;",
                  "return n >= 2 && n < kWgMaxN ? 1 : 0;")],
    # K2's warpgroup route at 16 warps a SM (128 registers, no spills) in
    # place of 24 (80 registers, ~130-150 bytes spilled)
    "k2_16_warps": [("constexpr int kWgMinBlocks = 3;", "constexpr int kWgMinBlocks = 2;")],
    # ... and at 24 warps with one frame a block (128 threads) in place of two
    "k2_one_frame": [("constexpr int kWgFrames = 2; ", "constexpr int kWgFrames = 1; "),
                     ("constexpr int kWgMinBlocks = 3;", "constexpr int kWgMinBlocks = 6;")],
}

#: K2's batches for the wave sweep: multiples of the 792 frames an H100
#: holds at once on the warpgroup route (132 SMs x 3 blocks x 2 frames),
#: and the main path's 4096. Below 3 waves a launch takes less time than
#: the wrapper's host work, and the card waits on the host
K2_BATCHES = (2376, 3168, 3960, 4096)

SMI_CLOCKS = ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
              "--format=csv,noheader"]


def barrier_sections(sass: str, kernel: str) -> list[dict]:
    """The instructions of the first kernel whose name holds ``kernel`` in
    a ``cuobjdump -sass`` listing, cut after each barrier (``BAR``): the
    count of each section and its five commonest opcodes."""
    chunk = next(c for c in sass.split("Function : ")[1:] if kernel in c.split()[0])
    sections, current = [], Counter()
    for m in SASS_INSTR.finditer(chunk):
        op = m[3].split(".")[0]
        current[op] += 1
        if op == "BAR":
            sections.append(current)
            current = Counter()
    sections.append(current)
    return [{"instructions": sum(c.values()), "top": dict(c.most_common(5))}
            for c in sections]


def clocks_while(torch, fn, seconds: float = 2.0) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read halfway
    through ``seconds`` of ``fn()`` called back to back."""
    out: dict[str, str] = {}

    def probe():
        time.sleep(seconds / 2)
        out["smi"] = subprocess.run(SMI_CLOCKS, capture_output=True, text=True,
                                    timeout=60).stdout.strip()

    th = threading.Thread(target=probe)
    th.start()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    th.join()
    return out.get("smi", "")


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
        out2 = k2(packed[0][0])
        if shipped_out is None:
            shipped_out, shipped_out2 = out.clone(), out2.clone()
        row = rows.setdefault(name, {"k1_ms": [], "k2_ms": [], "ptxas": [
            line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]})
        for key, got, want in (("max_rel_diff_vs_shipped", out, shipped_out),
                               ("k2_max_rel_diff_vs_shipped", out2, shipped_out2)):
            row[key] = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        row["k1_ms"].append(cs.cuda_ms(extract_features_fused, planes, 30))
        row["k2_ms"].append(cs.cuda_ms(k2, packed, 30))
    library_ms = cs.cuda_ms(lambda c: torch.fft.fft(c).abs().amax(dim=-1),
                            cs.rotated(torch.complex(i, q)), 30)
    # the last variant built is the shipped source
    k2_batches = {b: [] for b in K2_BATCHES}
    for b in list(K2_BATCHES) + list(K2_BATCHES)[::-1]:
        k2_batches[b].append(cs.cuda_ms(k2, cs.rotated(packed[0][0][:b].contiguous()), 30))
    k2_clocks = clocks_while(torch, lambda: k2(packed[0][0]))
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    print(json.dumps({"nvidia_smi": smi, "shape": [4096, 2048],
                      "library_ms": library_ms, "variants": rows,
                      "k2_ms_by_batch": k2_batches,
                      "k2_clocks_sm_max_power": k2_clocks,
                      "k2_wg_sass_by_barrier": barrier_sections(
                          sass, "stats_wg_kernelILb1")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
