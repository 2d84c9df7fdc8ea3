#!/usr/bin/env python3
"""Where K1's and K2's time goes: the fused feature kernel
(``amc_fused_features``) and the statistics kernel (``amc_stats_features``)
of ``amcpy_tpu_torch/csrc/features.cu``, timed as shipped and in variants
made by text edits of that source, on one NVIDIA card.

    python3 scripts/k1_ablation.py [--reference REF.cu] [--cluster-only] [VARIANTS.json]

Two sections, each printing one JSON line with the card's name and power
limit (nvidia-smi).

**K1's cluster route** (frames of N = C x M past one block): the variants
of ``CLUSTER_VARIANTS``, each a text edit of the package's source or of
``--reference`` (another version of ``features.cu``, e.g. the parent
commit's, unpacked with ``git archive``; its variants are left out without
it). ``reference`` builds that version as it is, the interleaved baseline
for any version; the ``ref_*`` split variants edit the text of the cluster
kernel before its redesign (one 256-thread block a slice,
``cluster_gmax``) and are built only where every text they edit is in the
given source, else listed under ``left_out``. Timed at ``CLUSTER_SHAPES``
(C = 2, 4, 8) and K1's block route at 4096 x 2048, inputs rotated past the 50 MB L2 (``chip_smoke.rotated``),
in ``ROUNDS`` rounds of the order variants, variants reversed: each launch
timed by its own pair of CUDA events, the median and interquartile range
over all of a variant's launches. Per variant: ptxas's registers and
spills of ``fused_cluster_kernel``, the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``) and the waves (frames / clusters) at
each shape, and the largest relative difference from the shipped kernel's
output (a variant that skips part of the work differs by design). Built-in
variants remove one part of the kernel at a time, so the differences of
their times split it: the slice's load, the statistics' three passes,
gamma_max's C-point DFT over the slices and its length-M FFT.

**The block route and K2** (left out with ``--cluster-only``): each variant
of ``VARIANTS`` (or of the JSON file ``{"name": [[text, replacement],
...], ...}``, ``shipped`` always first) built and timed at 4096 x 2048
in the order shipped, variants, variants reversed, shipped; each variant's
output compared with the shipped kernel's; the ``torch.fft`` yardstick;
K2 as shipped at batches of whole and partial waves of resident frames
(``K2_BATCHES``, in order and reversed); the card's SM clock and power
read by nvidia-smi while K2 runs back to back; and the shipped warpgroup
kernel's SASS (``cuobjdump -sass``, 16-byte loads) counted between its
named barriers: the load and pass 1, pass 2, pass 3, and warp 0's tail.

Each variant is built by ``nvcc`` into its own directory under
``build/k1_ablation/``. Needs a CUDA card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
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

#: K1's cluster route, timed at C = 2, 4 and 8 (the 4096 x 2048 block
#: route's 8.4 M samples at 65536 and 131072)
CLUSTER_SHAPES = ((256, 32768), (128, 65536), (64, 131072))
#: rounds of (variants, variants reversed); launches timed a shape and turn
CLUSTER_ROUNDS = 2
CLUSTER_REPS = 15

# the reference's cluster kernel (one 256-thread block a slice, the C-point
# DFT read by every block at every place): the call of the statistics and
# of gamma_max in fused_cluster_kernel, and gamma_max's parts
_REF_STATS = ("  frame_stats<0, true>(gi + at, gq + at, xi, xq, ph, red, m, normalize != 0,\n"
              "                       row, xch);\n")
_REF_GMAX = "  float mx = cluster_gmax(xi, xq, twn, tws, m, rank, ranks);"
#: the slice into shared memory as pass 1 reads it (one sample a thread and
#: turn), nothing computed; its values feed mx, so nothing is dropped
_REF_LOAD = ("  for (int k = threadIdx.x; k < m; k += kThreads) {\n"
             "    xi[sw(k)] = __ldg(gi + at + k);\n"
             "    xq[sw(k)] = __ldg(gq + at + k);\n"
             "  }\n"
             "  __syncthreads();\n")

# the package's cluster kernel: the same calls
_STATS = ("  frame_stats<kClusterPer, true, kClusterThreads>(\n"
          "      nullptr, nullptr, xi, xq, ph, red, m, normalize != 0, row, xch);\n"
          "  // the statistics' last cluster barrier has passed every block's reads of\n"
          "  // its slice\n")
_CDFT = "  cluster_cdft<kC, kClusterThreads>(xi, np, twn, m, rank);\n"
_FFT = ("  float mx = gmax_fft<kClusterThreads, true>(xi, xq, nullptr, tws, nullptr,\n"
        "                                             nullptr, nullptr, nullptr, m, 8,\n"
        "                                             m / 8);")
_GMAX = (_CDFT + "  cl.sync();\n"
         "  // the block route's FFT of length m (a power of two: no direct stage),\n"
         "  // its twiddles products of one table value a butterfly\n" + _FFT)
_LOAD = "  load_slice<kClusterThreads>(gi + at, gq + at, xi, xq, m);\n"
_PASS1 = ("    if (tail_step) halo = cg::this_cluster().map_shared_rank(ph, rank + 1)[0];\n"
          "  }\n",
          "    if (tail_step) halo = cg::this_cluster().map_shared_rank(ph, rank + 1)[0];\n"
          "    if (t1 == 1.2345f) out[1] = halo;\n"
          "    return;\n"
          "  }\n")
_THREADS = "constexpr int kClusterThreads = 1024;"
_PER = "constexpr int kClusterPer = kSliceMax / kClusterThreads;"

# the package's kernel made persistent: the frame loop, B passed to the
# kernel, and the launch sized by the card's occupancy
_PERSISTENT = [
    ("float* __restrict__ out, int n, int m, int normalize) {\n"
     "  extern __shared__ __align__(16) float cl_smem[];",
     "float* __restrict__ out, int b, int n, int m, int normalize) {\n"
     "  extern __shared__ __align__(16) float cl_smem[];"),
    ("  const size_t f = blockIdx.x / kC;\n"
     "  float* row = out + f * kNumFeatures;\n"
     "  const size_t at = f * n + static_cast<size_t>(rank) * m;\n",
     "  for (int f = blockIdx.x / kC; f < b; f += gridDim.x / kC) {\n"
     "  float* row = out + static_cast<size_t>(f) * kNumFeatures;\n"
     "  const size_t at = static_cast<size_t>(f) * n + static_cast<size_t>(rank) * m;\n"),
    ("    for (int r = 1; r < kC; ++r) g = fmaxf(g, xch->g[r]);\n"
     "    row[0] = g / static_cast<float>(n);\n  }\n}\n",
     "    for (int r = 1; r < kC; ++r) g = fmaxf(g, xch->g[r]);\n"
     "    row[0] = g / static_cast<float>(n);\n  }\n  }\n}\n"),
    ("const float2*, float*, int, int, int);",
     "const float2*, float*, int, int, int, int);"),
    ("    const cudaLaunchConfig_t cfg = cluster_config(b, c, smem, st, &attr);\n"
     "    err = cudaLaunchKernelEx(&cfg, kernel, i, q, tw2,\n"
     "                             reinterpret_cast<const float2*>(tws), out, n, m,\n"
     "                             normalize);",
     "    int blocks = 0;\n"
     "    const int clusters = amc_fused_cluster_occupancy(n, &blocks);\n"
     "    if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);\n"
     "    const cudaLaunchConfig_t cfg =\n"
     "        cluster_config(b < clusters ? b : clusters, c, smem, st, &attr);\n"
     "    err = cudaLaunchKernelEx(&cfg, kernel, i, q, tw2,\n"
     "                             reinterpret_cast<const float2*>(tws), out, b, n,\n"
     "                             m, normalize);"),
]

#: name -> (source: "package" or "reference", [(text, replacement)])
CLUSTER_VARIANTS = {
    "shipped": ("package", []),
    # the launch, the cluster's scheduling and its last barrier alone
    "empty": ("package", [(_LOAD + _STATS + _GMAX, "  float mx = 0.f;")]),
    # ... and the slice's load into shared memory (cp.async)
    "load_only": ("package", [(_STATS + _GMAX,
                               "  float mx = fabsf(xi[sw(threadIdx.x)] + xq[sw(threadIdx.x)]);")]),
    # the statistics up to pass 1's cluster barrier, no gamma_max
    "pass1_only": ("package", [_PASS1, (_GMAX, "  float mx = 0.f;")]),
    # the three passes of the statistics, no gamma_max
    "stats_only": ("package", [(_GMAX, "  float mx = 0.f;")]),
    # gamma_max without the C-point DFT over the slices
    "no_cdft": ("package", [(_CDFT, "")]),
    # gamma_max's C-point DFT without the length-M FFT
    "no_fft": ("package", [(_FFT, "  float mx = fabsf(xi[sw(threadIdx.x)]);")]),
    # a persistent grid: as many clusters as the card holds at once (or B),
    # each walking frames f = cluster, cluster + clusters, ...
    "persistent": ("package", _PERSISTENT),
    # the FFT's twiddles W^{jk} each read from the table (R - 1 strided
    # loads a butterfly), as the block route reads them
    "fft_table_twiddles": ("package", [("gmax_fft<kClusterThreads, true>(",
                                        "gmax_fft<kClusterThreads, false>(")]),
    # the statistics' samples recomputed in each pass (no register cache)
    "no_cache": ("package", [(_PER, "constexpr int kClusterPer = 0;")]),
    # 512 threads a block (16 warps, 128 registers), with and without the
    # register cache (32 samples a thread)
    "threads_512": ("package", [(_THREADS, "constexpr int kClusterThreads = 512;")]),
    "threads_512_no_cache": ("package", [(_THREADS, "constexpr int kClusterThreads = 512;"),
                                         (_PER, "constexpr int kClusterPer = 0;")]),
    "threads_512_stats_only": ("package", [(_THREADS, "constexpr int kClusterThreads = 512;"),
                                           (_GMAX, "  float mx = 0.f;")]),
    "threads_512_no_fft": ("package", [(_THREADS, "constexpr int kClusterThreads = 512;"),
                                       (_FFT, "  float mx = fabsf(xi[sw(threadIdx.x)]);")]),
    # the reference's kernel as it is
    "reference": ("reference", []),
    # the launch, the cluster's scheduling and its last two barriers alone
    "ref_empty": ("reference", [(_REF_STATS + _REF_GMAX, "  float mx = 0.f;")]),
    # ... and the slice's load into shared memory
    "ref_load_only": ("reference", [(
        _REF_STATS + _REF_GMAX,
        _REF_LOAD + "  float mx = fabsf(xi[sw(threadIdx.x)] + xq[sw(threadIdx.x)]);")]),
    # the statistics up to pass 1's cluster barrier (load, amplitude, phase,
    # the first reduction), no gamma_max
    "ref_pass1_only": ("reference", [
        ("    if (tail_step) halo = cg::this_cluster().map_shared_rank(ph, rank + 1)[0];\n"
         "  }\n",
         "    if (tail_step) halo = cg::this_cluster().map_shared_rank(ph, rank + 1)[0];\n"
         "    if (t1 == 1.2345f) out[1] = halo;\n"
         "    return;\n"
         "  }\n"),
        (_REF_GMAX, "  float mx = 0.f;")]),
    # the three passes of the statistics, no gamma_max
    "ref_stats_only": ("reference", [(_REF_GMAX, "  float mx = 0.f;")]),
    # gamma_max without the C-point DFT over the slices (the length-M FFT
    # of the block's own slice)
    "ref_no_cdft": ("reference", [(
        "for (int c0 = 0; c0 < m; c0 += kThreads * kGmaxPer) {",
        "for (int c0 = m; c0 < m; c0 += kThreads * kGmaxPer) {")]),
    # gamma_max's C-point DFT without the length-M FFT
    "ref_no_fft": ("reference", [(
        "  return gmax_fft(xr, xi, nullptr, tws, nullptr, nullptr, nullptr, nullptr, m,\n"
        "                  8, m / 8);",
        "  return fabsf(xr[sw(threadIdx.x)]);")]),
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


def build_variants(variants: dict[str, tuple[str, list]]) -> dict[str, Path]:
    """{name: (source text, edits)} -> {name: library}: each source with its
    edits applied, built by nvcc with the package's flags into its own
    directory under ``build/k1_ablation/`` (all at once, one nvcc each),
    ptxas's report beside it as ``.log``."""
    from amcpy_tpu_torch.ops import _build

    def build(name: str) -> Path:
        text, edits = variants[name]
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} is not in its features.cu")
            text = text.replace(old, new)
        d = ROOT / "build" / "k1_ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "features.cu").write_text(text)
        lib = d / "libfeatures.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                               str(d / "features.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        lib.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
        return lib

    with ThreadPoolExecutor(min(8, len(variants))) as pool:
        return dict(zip(variants, pool.map(build, variants)))


def load_variant(path: Path) -> None:
    """Make the built library ``path`` the package's ``features`` library
    (the entry points it lacks, e.g. an older version's, left unset)."""
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fused import cluster_occupancy

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _build.SIGNATURES["features"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    _build._libs["features"] = lib
    cluster_occupancy.cache_clear()


def raw_k1(torch, b: int, n: int):
    """A call of ``amc_fused_features`` of the loaded library on (b, n)
    planes with the wrapper's tables, without its Python checks: a few
    microseconds of host time a launch, so a launch's events time the
    kernel even where it is shorter than the wrapper (``extract_features_fused``,
    which the outputs are compared through)."""
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fft import best_factorization, device_fft_twiddles, device_tables
    from amcpy_tpu_torch.ops.fused import fused_route

    dev = torch.device("cuda", 0)
    n1, n2 = best_factorization(n)
    route, c = fused_route(n)
    tw = device_fft_twiddles(n, dev).data_ptr()
    tws, w = 0, (0,) * 6
    if route == "cluster":
        tws = device_fft_twiddles(n // c, dev).data_ptr()
    else:  # the FFT path (N2 a power of two)
        w = tuple(t.data_ptr() for t in device_tables(n1, n2, dev)[:4]) + (0, 0)
    out = torch.empty((b, 18), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i, q):
        lib = _build._libs["features"]
        err = lib.amc_fused_features(i.data_ptr(), q.data_ptr(), tw, tws, *w,
                                     out.data_ptr(), b, n, n1, n2, 1, stream)
        _build.check(lib, err, "amc_fused_features")

    return call


def ptxas_lines(lib: Path, kernel: str | None = None) -> list[str]:
    """ptxas's entry, register and spill lines of a built library's log
    (of the entries whose name holds ``kernel`` only, where given)."""
    lines, keep = [], kernel is None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            keep = kernel is None or kernel in line
        if keep and ("registers" in line or "spill" in line or "Compiling entry" in line):
            lines.append(line.strip())
    return lines


def ms_each(torch, fn, inputs: list[tuple], reps: int) -> list[float]:
    """Device time of each of ``reps`` calls ``fn(*inputs[k % len])``, a
    pair of CUDA events around each, after a warm-up."""
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for k, (a, b) in enumerate(events):
        a.record()
        fn(*inputs[k % len(inputs)])
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def summary(ms: list[float]) -> dict[str, float]:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "iqr": float(q3 - q1), "n": len(ms)}


def cluster_section(torch, smi: str, reference: Path | None) -> dict:
    """The cluster route's variants at ``CLUSTER_SHAPES`` (see the module's
    docstring)."""
    import chip_smoke as cs
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fused import cluster_occupancy, extract_features_fused, fused_route

    dev = torch.device("cuda", 0)
    sources = {"package": (_build.CSRC / "features.cu").read_text()}
    if reference is not None:
        sources["reference"] = reference.read_text()
    # a reference variant whose texts its source lacks (another version's
    # kernel) is left out; a package variant's missing text fails the build
    names, left_out = [], []
    for k, (src, edits) in CLUSTER_VARIANTS.items():
        if src == "package" or (src in sources
                                and all(old in sources[src] for old, _ in edits)):
            names.append(k)
        elif src in sources:
            left_out.append(k)
    t0 = time.perf_counter()
    libs = build_variants({k: (sources[CLUSTER_VARIANTS[k][0]], CLUSTER_VARIANTS[k][1])
                           for k in names})
    build_s = time.perf_counter() - t0
    shapes = {}
    for b, n in CLUSTER_SHAPES + ((4096, 2048),):
        x = cs.test_frames(b, n, b + n)
        i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        shapes[f"{b}x{n}"] = (b, n, cs.rotated(i, q), raw_k1(torch, b, n))
    rows: dict[str, dict] = {}
    shipped = {}
    for name in (names + names[::-1]) * CLUSTER_ROUNDS:
        load_variant(libs[name])
        row = rows.setdefault(name, {"source": CLUSTER_VARIANTS[name][0],
                                     "ptxas": ptxas_lines(libs[name], "fused_cluster_kernel"),
                                     "ms": {}, "clusters": {}, "waves": {},
                                     "max_rel_diff_vs_shipped": {}})
        for key, (b, n, planes, launch) in shapes.items():
            out = extract_features_fused(*planes[0])
            if name == "shipped":
                shipped.setdefault(key, out.clone())
            elif key in shipped:
                want = shipped[key]
                rel = ((out - want).abs() / want.abs().clamp_min(1e-30)).amax(0)
                row["max_rel_diff_vs_shipped"][key] = [float(v) for v in rel.cpu()]
            if fused_route(n)[0] == "cluster":
                clusters = cluster_occupancy(n, 0)[0]
                row["clusters"][key] = clusters
                row["waves"][key] = b / clusters
            row["ms"].setdefault(key, []).extend(ms_each(torch, launch, planes, CLUSTER_REPS))
    for row in rows.values():
        row["ms"] = {k: summary(v) for k, v in row["ms"].items()}
    bounds = {k: cs.bound(*cs.k1_work(b, n)) for k, (b, n, _, _) in shapes.items()}
    return {"section": "cluster", "nvidia_smi": smi, "reference": str(reference),
            "build_s": build_s, "left_out": left_out,
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()},
            "variants": rows}


def block_section(torch, smi: str, variants: dict) -> dict:
    """K1's block route and K2 in ``variants`` at 4096 x 2048, then K2's
    batches, clocks and SASS (see the module's docstring)."""
    import chip_smoke as cs
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops.fused import extract_features_fused
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

    dev = torch.device("cuda", 0)
    x = cs.test_frames(4096, 2048, 0)
    i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
    planes = cs.rotated(i, q)
    packed = cs.rotated(torch.stack([i, q], 1).contiguous())

    def k2(t):
        return extract_features_pallas(t, compute_gmax=False)

    source = (_build.CSRC / "features.cu").read_text()
    names = list(variants)
    libs = build_variants({f"block_{k}": (source, variants[k]) for k in names})
    rows: dict[str, dict] = {}
    shipped_out = None
    for name in names + names[::-1]:
        lib = libs[f"block_{name}"]
        load_variant(lib)
        out = extract_features_fused(i, q)
        out2 = k2(packed[0][0])
        if shipped_out is None:
            shipped_out, shipped_out2 = out.clone(), out2.clone()
        row = rows.setdefault(name, {"k1_ms": [], "k2_ms": [], "ptxas": ptxas_lines(lib)})
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
    return {"section": "block", "nvidia_smi": smi, "shape": [4096, 2048],
            "library_ms": library_ms, "variants": rows,
            "k2_ms_by_batch": k2_batches,
            "k2_clocks_sm_max_power": k2_clocks,
            "k2_wg_sass_by_barrier": barrier_sections(sass, "stats_wg_kernelILb1")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", type=Path,
                    help="JSON of block-route variants in place of the built-in ones")
    ap.add_argument("--reference", type=Path,
                    help="another version of features.cu for the reference variants")
    ap.add_argument("--cluster-only", action="store_true",
                    help="time the cluster route's variants only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps(cluster_section(torch, smi, args.reference)), flush=True)
    if not args.cluster_only:
        variants = VARIANTS
        if args.variants is not None:
            variants = {"shipped": [], **json.loads(args.variants.read_text())}
        print(json.dumps(block_section(torch, smi, variants)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
