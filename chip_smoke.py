#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``amcpy_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build  — nvcc builds every kernel source of the package (all at once),
   with the ptxas report (registers, shared memory, spills);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, on numpy-seeded Gaussian frames with a per-frame scale spread of
   exp(U(-6, 6)) and a few frames holding -0.0 samples, within
   2e-4 * term_scales + 2e-5 * |want| per feature; times of the kernel, of
   the plain version and of one PyTorch library call where one computes the
   same function;
4. extraction — the main path: a numpy-made ``all_modulations.mat`` at the
   default config (6 modulations x 16 SNR x 1000 frames x 2048 samples)
   through ``run_extraction`` with ``kernel="auto"``; six artifacts of
   shape (16, 1000, 18), all finite, 512 random rows against the plain
   version on the card;
5. serving — a seeded random MLP (26, 29, 30) -> 6 with a Standardizer fit
   on phase 4's features, written with ``save_checkpoint`` and served by
   ``AMCPipeline.from_checkpoint``: requests of 1, 100 and 4096 frames,
   complex and planar, each checked against the same pipeline with the
   plain extractor (argmax identical, logits within 1e-3) and then timed
   (first call, median and maximum of repeats); the statistics-only
   kernel's route answers the 4096-frame request too; the stage split of a
   4096-frame request; ``classify_stream`` on a GNU Radio capture written
   here.

Three paths are driven: extraction and serving with ``kernel="auto"``
(both through K1), and serving with ``kernel="pallas"`` (through K2). Every
launch counter is set to 0 just before each path and read just after it;
the run fails if a path did not launch its kernel. The checked call of
each request also records its own launches. Then come the
``{"kernels": [...]}`` line (``launches`` summed over the paths that run
through the kernel, and per path), nvidia-smi's name and power limit, and
the last line ``{"ok": true, "device": {...}}``. Any failure raises and the
process exits non-zero; without a CUDA device it exits 1 and prints no
result.

``bound_ms`` counts what each kernel's function needs, whatever the
design (``k1_work``, ``k2_work``); ``design_ops_ms`` is the least time of
K1's own matrix-product DFT at the FP32 rate, which is not a bound.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: the fewest operations per sample the 17 statistics need, whatever the
#: kernel, each sample's values computed once (a transcendental counted as
#: one): amplitude 4 (|x|^2, sqrt), phase 2 (atan2, |phase|), the means'
#: sums and max|x| 4, the centred phase sums 6, the normalized amplitude
#: and its sums 5, its centred sums 8, the wrapped phase step and its sum
#: 6, its centred sums 5, the powers of x / max|x| behind the nine mixed
#: moments 26 and their 14 sums 14
STATS_OPS_PER_SAMPLE = 80

TOL_SCALE, TOL_REL = 2e-4, 2e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def term_scales(x: np.ndarray) -> np.ndarray:
    """Per-frame magnitude of each feature's terms (B, 18), float64: the
    tolerance of a cumulant is judged against its terms, not its
    (possibly cancelled) value."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    a = np.abs(x)
    a2 = a * a
    p2 = a2.mean(-1)
    m20 = np.abs((x * x).mean(-1))
    m40 = (x**4).mean(-1)
    m42 = (a2 * a2).mean(-1)
    m63 = (a2**3).mean(-1)
    s = np.empty((x.shape[0], 18))
    s[:, 0] = a2.sum(-1)
    s[:, 1] = s[:, 2] = np.pi
    s[:, 3] = 1.0
    s[:, 4] = 0.5
    s[:, 5] = np.maximum(a.mean(-1), 1e-30)
    s[:, 6] = np.maximum(np.sqrt(a.sum(-1)) / n, 1e-30)
    s[:, 7] = s[:, 8] = 10.0
    s[:, 9] = s[:, 10] = p2
    s[:, 11:14] = np.maximum.reduce([m42, 3 * m20**2, p2**2])[:, None]
    s[:, 14:18] = np.maximum.reduce(
        [m63, 15 * m20 * np.abs(m40), p2**3]
    )[:, None]
    return s


def compare(got, want, frames) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / tol) over all features."""
    got = got.detach().cpu().double().numpy()
    want = want.detach().cpu().double().numpy()
    tol = TOL_SCALE * term_scales(frames) + TOL_REL * np.abs(want)
    err = np.abs(got - want)
    if not np.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return float(err.max()), float((err / tol).max())


def test_frames(b: int, n: int, seed: int) -> np.ndarray:
    """Gaussian complex64 frames, per-frame scale exp(U(-6, 6)); the first
    two frames hold -0.0 imaginary parts on negative real samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    x = (x * np.exp(rng.uniform(-6, 6, (b, 1)))).astype(np.complex64)
    k = min(b, 2)
    x.real[:k, ::5] = -np.abs(x.real[:k, ::5])
    x.imag[:k, ::5] = -0.0  # through the view: re + 1j*im drops the sign
    return x


#: bytes of input copies a timing rotates over: more than the H100's
#: 50 MB L2, so every call reads its input from device memory, as a chunk
#: fresh from the host does on the main path
ROTATE_BYTES = 128 << 20


def rotated(*tensors) -> list[tuple]:
    """The input set and enough clones of it to exceed ``ROTATE_BYTES``."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(2, -(-ROTATE_BYTES // size))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]


def cuda_ms(fn, inputs: list[tuple], reps: int) -> float:
    """Mean device time of one call ``fn(*inputs[k % len(inputs)])``:
    CUDA events around ``reps`` calls after a warm-up."""
    import torch

    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for k in range(reps):
        fn(*inputs[k % len(inputs)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dft_table_bytes(n1: int, n2: int) -> int:
    """Bytes of the fused kernel's DFT tables (W_N1, twiddle, W_N2)."""
    return 4 * 2 * (n1 * n1 + n1 * n2 + n2 * n2)


def k1_work(b: int, n: int, n1: int, n2: int) -> tuple[float, float]:
    """(bytes, operations) the fused kernel's function needs on a (b, n)
    batch, whatever the design: I and Q read once, 18 floats written per
    frame, the DFT tables read once; the statistics, and gamma_max as an
    FFT (5 N log2 N) followed by |X|^2 and its maximum (4 N)."""
    nbytes = 8.0 * b * n + 72.0 * b + dft_table_bytes(n1, n2)
    ops = b * (STATS_OPS_PER_SAMPLE * n + 5.0 * n * np.log2(n) + 4.0 * n)
    return nbytes, ops


def k1_design_ms(b: int, n: int, n1: int, n2: int) -> float:
    """Least time of this kernel's own DFT at the FP32 rate: stage 1
    (8 N1^2 N2), the twiddle (6 N) and the stage-2 matrix product
    (8 N1 N2^2) per frame. Not a bound of the function: an FFT needs far
    fewer operations."""
    ops = b * (8.0 * n1 * n1 * n2 + 6.0 * n + 8.0 * n1 * n2 * n2)
    return ops / FP32_FLOP_PER_S * 1e3


def k2_work(b: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of the statistics kernel on a (b, 2, n) batch."""
    return 8.0 * b * n + 72.0 * b, float(b) * n * STATS_OPS_PER_SAMPLE


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev) -> dict[str, dict]:
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fft import best_factorization
    from amcpy_tpu_torch.ops.fused import extract_features_fused
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

    rows: dict[str, dict] = {}
    checks = []

    def plain_k1(i, q):
        return F._extract_planar(
            i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
        )

    k1 = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    before = extract_features_fused.launches
    for seed, (b, n) in enumerate([(4096, 2048), (1000, 2048), (37, 1024), (64, 256)]):
        x = test_frames(b, n, seed)
        i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        got = extract_features_fused(i, q)
        torch.cuda.synchronize()
        err, ratio = compare(got, plain_k1(i, q), x)
        checks.append({"kernel": "K1", "shape": [b, n], "max_abs_err": err,
                       "max_err_over_tol": ratio})
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["max_err_over_tol"] = max(k1["max_err_over_tol"], ratio)
        if (b, n) == (4096, 2048):
            n1, n2 = best_factorization(n)
            planes = rotated(i, q)
            k1["ms"] = cuda_ms(extract_features_fused, planes, 20)
            # the same input again and again: as much of it in L2 as fits
            k1["warm_l2_ms"] = cuda_ms(extract_features_fused, planes[:1], 20)
            k1["plain_ms"] = cuda_ms(plain_k1, planes, 5)
            k1["library_ms"] = cuda_ms(
                lambda c: torch.fft.fft(c).abs().amax(dim=-1),
                rotated(torch.complex(i, q)), 20,
            )
            k1["bound_ms"], k1["bound_by"] = bound(*k1_work(b, n, n1, n2))
            k1["design_ops_ms"] = k1_design_ms(b, n, n1, n2)
            k1["shape"] = [b, n]
    if extract_features_fused.launches <= before:
        raise AssertionError("the fused kernel's launch counter did not rise")
    rows["fused"] = k1

    k2 = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    before = extract_features_pallas.launches
    for seed, (b, n) in enumerate([(4096, 2048), (37, 1024)], start=10):
        x = test_frames(b, n, seed)
        iq = torch.from_numpy(F.to_planar(x)).to(dev)
        got = extract_features_pallas(iq, gmax_mode="matmul")
        torch.cuda.synchronize()
        err, ratio = compare(
            got, F.extract_features_planar(iq, gmax_mode="matmul"), x
        )
        checks.append({"kernel": "K2", "shape": [b, n], "max_abs_err": err,
                       "max_err_over_tol": ratio})
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["max_err_over_tol"] = max(k2["max_err_over_tol"], ratio)
        if (b, n) == (4096, 2048):
            # the kernel alone: column 0 stays zero, as the Pallas kernel's
            packed = rotated(iq)
            def k2_alone(t):
                return extract_features_pallas(t, compute_gmax=False)

            k2["ms"] = cuda_ms(k2_alone, packed, 20)
            k2["warm_l2_ms"] = cuda_ms(k2_alone, packed[:1], 20)
            k2["plain_ms"] = cuda_ms(
                lambda t: F.extract_features_planar(t, compute_gmax=False),
                packed, 5,
            )
            k2["library_ms"] = None
            k2["bound_ms"], k2["bound_by"] = bound(*k2_work(b, n))
            k2["shape"] = [b, n]
    if extract_features_pallas.launches <= before:
        raise AssertionError("the statistics kernel's launch counter did not rise")
    rows["pallas"] = k2
    emit({"phase": "kernels", "tolerance": "2e-4*term_scales + 2e-5*|want|",
          "checks": checks})
    for key, r in rows.items():
        if r["max_err_over_tol"] > 1.0:
            raise AssertionError(f"{key} kernel disagrees with its plain version: {r}")
    return rows


MODS_POINTS = {
    "BPSK": np.array([-1, 1], np.complex128),
    "QPSK": np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))),
    "8PSK": np.exp(1j * np.pi / 4 * np.arange(8)),
    "16QAM": None,
    "64QAM": None,
}


def _qam(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    lv = np.arange(side) * 2.0 - (side - 1)
    pts = (lv[:, None] + 1j * lv[None, :]).reshape(-1)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def make_dataset(cfg, seed: int) -> dict[str, np.ndarray]:
    """Unit-power symbols plus AWGN at each SNR level (WGN: noise only),
    ``{mod: (num_snr, num_frames, frame_size) complex64}``."""
    s = cfg.signals
    snr = np.asarray(s.snr_db, np.float64)
    shape = (s.num_snr, s.num_frames, s.frame_size)
    out = {}
    for mi, mod in enumerate(s.modulations_with_noise):
        rng = np.random.default_rng(seed + mi)
        noise = rng.standard_normal((*shape, 2), dtype=np.float32)
        noise = (noise[..., 0] + 1j * noise[..., 1]) * np.float32(np.sqrt(0.5))
        if mod == "WGN":
            out[mod] = noise.astype(np.complex64)
            continue
        pts = MODS_POINTS.get(mod)
        if pts is None:
            pts = _qam(16 if mod == "16QAM" else 64)
        sym = pts[rng.integers(0, len(pts), shape)]
        sigma = np.sqrt(10 ** (-snr / 10))[:, None, None]
        out[mod] = (sym + sigma * noise).astype(np.complex64)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.extraction import run_extraction
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fused import (
        extract_features_fused,
        extract_features_fused_any,
    )
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.utils.metrics import MetricsLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = _build.build("features")
    ptxas = [
        line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    rows = phase_kernels(torch, dev)

    work = Path(tempfile.mkdtemp(prefix="amc_chip_smoke_"))
    try:
        cfg = Config().replace(paths={"root": str(work)})
        t0 = time.perf_counter()
        data = make_dataset(cfg, seed=7)
        cfg.paths.ensure_dirs()
        import scipy.io

        scipy.io.savemat(
            str(cfg.paths.mat_data / cfg.paths.mat_filename),
            {cfg.signals.mat_info[m]: a for m, a in data.items()},
        )
        setup_s = time.perf_counter() - t0

        def counts() -> dict[str, int]:
            return {"fused": extract_features_fused.launches,
                    "pallas": extract_features_pallas.launches,
                    "reroutes": extract_features_fused_any.reroutes}

        def zero_counts() -> None:
            extract_features_fused.launches = 0
            extract_features_pallas.launches = 0
            extract_features_fused_any.reroutes = 0

        # each path is driven with every count set to 0 just before it and
        # read just after it; {path: (kernel it must launch, counts)}
        paths: dict[str, tuple[str, dict[str, int]]] = {}

        # ---- path 1: extraction, kernel="auto" -----------------------------
        log_path = work / "metrics" / "smoke.jsonl"
        zero_counts()
        t0 = time.perf_counter()
        results = run_extraction(cfg, device=dev, logger=MetricsLogger(log_path))
        wall = time.perf_counter() - t0
        paths["extraction"] = ("fused", counts())
        mods = cfg.signals.modulations_with_noise
        for mod in mods:
            art = io_mat.load_features(cfg, mod)
            if art.shape != (16, 1000, 18) or not np.isfinite(art).all():
                raise AssertionError(f"{mod}: artifact {art.shape} not finite/shaped")
        recs = [json.loads(s) for s in log_path.read_text().splitlines()]
        split = {
            key: sum(r.get(key, 0.0) for r in recs if r["event"] == "extract")
            for key in ("wall_s", "host_prep_s", "prep_total_s", "h2d_s",
                        "wait_s", "bytes_h2d")
        }
        # 512 random rows against the plain version on the card
        rng = np.random.default_rng(11)
        flat = np.stack([data[m] for m in mods]).reshape(-1, cfg.signals.frame_size)
        feats = np.stack([results[m] for m in mods]).reshape(-1, 18)
        rows_idx = np.sort(rng.choice(flat.shape[0], 512, replace=False))
        sample = flat[rows_idx]
        iq = torch.from_numpy(F.to_planar(sample)).to(dev)
        want = F.extract_features_planar(iq, gmax_mode="matmul")
        err, ratio = compare(torch.from_numpy(feats[rows_idx]), want, sample)
        n_frames = flat.shape[0]
        # what the wall time holds besides the per-modulation device stages:
        # reading the .mat (one modulation timed alone here) and writing
        # the artifacts
        t0 = time.perf_counter()
        io_mat.load_modulation(cfg, mods[0])
        mat_read_s = time.perf_counter() - t0
        emit({"phase": "extraction", "frames": n_frames,
              "frame_size": cfg.signals.frame_size, "dataset_setup_s": setup_s,
              "wall_s": wall, "frames_per_s": n_frames / wall,
              "split": split, "outside_stages_s": wall - split["wall_s"],
              "one_mat_read_s": mat_read_s,
              "launches": paths["extraction"][1],
              "rows_checked": 512, "max_abs_err": err,
              "max_err_over_tol": ratio})
        if ratio > 1.0:
            raise AssertionError("extracted rows disagree with the plain version")

        # ---- paths 2 and 3: serving, kernel="auto" and kernel="pallas" ------
        cols = list(cfg.features.used_columns)
        scaler = Standardizer.fit(feats[:, cols])
        g = torch.Generator().manual_seed(3)
        model = AMCClassifier(6, (26, 29, 30), in_features=len(cols))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
            for norm in model.norm:
                norm.running_mean.copy_(torch.randn(norm.num_features, generator=g) * 0.1)
                norm.running_var.copy_(torch.rand(norm.num_features, generator=g) + 0.5)
        save_checkpoint(cfg, "smoke", model, scaler)
        pipe = AMCPipeline.from_checkpoint(cfg, "smoke", device=dev)
        plain = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "xla"}), "smoke", device=dev
        )
        stats_pipe = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "pallas"}), "smoke", device=dev
        )
        if (pipe._kernel, stats_pipe._kernel) != ("fused", "pallas"):
            raise AssertionError("serving did not resolve to the CUDA kernels")
        requests = []
        order = rng.permutation(flat.shape[0])
        atol = rtol = 1e-3

        def timed(fn) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        def serve(p, x, name, size, reps):
            """One checked request, then ``reps`` timed ones: the first
            call of a shape pays the allocator's and cuBLAS's set-up. The
            launches of the checked request alone are recorded."""
            first_ms = timed(lambda: p.logits(x))
            before = counts()
            out = p.logits(x)
            launched = {k: v - before[k] for k, v in counts().items()}
            ref = plain.logits(x)
            diff = float((out - ref).abs().max())
            mismatch = int((out.argmax(-1) != ref.argmax(-1)).sum())
            ms = sorted(timed(lambda: p.logits(x)) for _ in range(reps))
            requests.append({"route": name, "frames": size, "first_ms": first_ms,
                             "ms_median": ms[len(ms) // 2], "ms_max": ms[-1],
                             "reps": reps, "launches": launched,
                             "max_logit_diff": diff,
                             "argmax_mismatch": mismatch})
            if mismatch or not torch.allclose(out, ref, atol=atol, rtol=rtol):
                raise AssertionError(f"serving {name} x{size} disagrees with plain")

        zero_counts()
        for size, reps in ((1, 21), (100, 21), (4096, 11)):
            x = flat[order[:size]]
            serve(pipe, x, "fused/complex", size, reps)
            serve(pipe, F.to_planar(x), "fused/planar", size, reps)
        # where a 4096-frame request's time goes, stage by stage (median
        # of 11): host layout + copy to the card, the fused kernel, and
        # standardize + MLP
        x = flat[order[:4096]]
        arrs = pipe._to_device(x)
        feats_dev = pipe._extract(*arrs)
        stages = {
            "to_device": lambda: pipe._to_device(x),
            "features": lambda: pipe._extract(*arrs),
            "standardize_mlp": lambda: pipe._classify(
                (feats_dev[:, pipe._cols] - pipe._mean) / pipe._std
            ),
        }
        with torch.inference_mode():
            split_4096 = {
                k: sorted(timed(fn) for _ in range(11))[5] for k, fn in stages.items()
            }

        capture = work / "capture.bin"
        stream_frames = flat[order[:64]]
        np.concatenate(
            [np.zeros(2400, np.complex64), stream_frames.reshape(-1)]
        ).tofile(capture)
        preds = pipe.classify_stream(capture)
        if not np.array_equal(preds, pipe.predict(stream_frames)):
            raise AssertionError("classify_stream disagrees with predict")
        paths["serving"] = ("fused", counts())

        zero_counts()
        serve(stats_pipe, x, "pallas/complex", 4096, 11)
        paths["serving_kernel_pallas"] = ("pallas", counts())
        emit({"phase": "serving", "atol": atol, "rtol": rtol,
              "requests": requests, "split_4096_complex_ms": split_4096,
              "stream_frames": int(preds.shape[0]),
              "launches": {k: v for k, (_, v) in paths.items()}})
        for path, (key, c) in paths.items():
            if c[key] == 0 or c["reroutes"]:
                raise AssertionError(f"path {path} did not run through {key}: {c}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    meta = {
        "fused": ("amc_fused_features (K1)", "amcpy_tpu/ops/fused.py:267"),
        "pallas": ("amc_stats_features (K2)", "amcpy_tpu/ops/pallas_features.py:73"),
    }
    per_request = {r["route"]: r["launches"] for r in requests
                   if r["frames"] == 4096 and r["route"].endswith("/complex")}
    kernels = []
    for key, r in rows.items():
        name, replaces = meta[key]
        by_path = {path: c[key] for path, (_, c) in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "amcpy_tpu_torch/csrc/features.cu",
            "replaces": replaces,
            # summed over the paths that run through this kernel
            "launches": sum(c[key] for k, c in paths.values() if k == key),
            "launches_by_path": by_path,
            "launches_per_4096_frame_request": per_request[f"{key}/complex"][key],
            "max_abs_err": r["max_abs_err"],
            "max_err_over_tol": r["max_err_over_tol"],
            "ms": r["ms"], "warm_l2_ms": r["warm_l2_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            # least time of K1's own matrix-product DFT (not a bound)
            "design_ops_ms": r.get("design_ops_ms"),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
