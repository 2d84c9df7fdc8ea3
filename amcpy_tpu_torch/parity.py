"""Reference-parity harness: the original amcpy extractor against the
port's on a dataset (``parity``).

Counterpart of ``amcpy_tpu/parity.py``. The original extractor runs from
its own checkout (``ref_root``): its ``calculate_features``
(``src/amcpy/features.py``) is imported and applied frame by frame in
worker subprocesses (``python -c`` into this module, data through
``.npy`` files). The extraction under test is the port's
:func:`amcpy_tpu_torch.extraction.extract_batch` on the device (K1, the
fused CUDA kernel, under ``kernel="auto"`` on a card).

Outputs:

* per-feature error statistics against the float32-versus-float64 budget
  ``1e-4 * term_scale + 1e-5 * |ref|`` (the budget the tests hold);
* optional downstream accuracy parity: the classifier is trained with
  paired seeds, seed k on the reference's features and on the port's, and
  the per-SNR accuracy curves are diffed against the budget below;
* ``metrics/parity.json`` and ``metrics/parity_report.md``.

Unlike the JAX command, the checkout's path has no default.
"""

from __future__ import annotations

import importlib.util
import json
import multiprocessing as mp
import time
from pathlib import Path
from typing import Any

import numpy as np

from amcpy_tpu_torch.config import Config

#: features a frame (``ops.features.NUM_FEATURES``; not imported from
#: there, so the worker subprocesses start without torch)
NUM_FEATURES = 18

__all__ = [
    "run_parity",
    "reference_features_batch",
    "paired_accuracy_stats",
]

#: accuracy-parity budget: the mean |paired delta| over all (mod, SNR)
#: cells must stay within 1 pp and the worst cell within 5 pp; a
#: systematic feature-set effect fails these.
ACC_BUDGET_MEAN_PP = 1.0
ACC_BUDGET_MAX_PP = 5.0


def paired_accuracy_stats(
    acc_ours: np.ndarray,
    acc_ref: np.ndarray,
    *,
    budget_mean_pp: float = ACC_BUDGET_MEAN_PP,
    budget_max_pp: float = ACC_BUDGET_MAX_PP,
) -> dict[str, Any]:
    """Paired-seed accuracy-parity statistics.

    Both stacks are ``(n_seeds, mods, snrs)`` per-SNR accuracy curves
    where seed k of one stack was trained with the same seed (identical
    init and shuffle stream) as seed k of the other, so the per-seed
    difference cancels the cell-level training bistability that dominates
    the unpaired spread, and the residual noise bound can fail.
    """
    acc_ours = np.asarray(acc_ours, np.float64)
    acc_ref = np.asarray(acc_ref, np.float64)
    assert acc_ours.shape == acc_ref.shape and acc_ours.ndim == 3
    n_seeds = acc_ours.shape[0]
    paired = acc_ours - acc_ref  # (seeds, mods, snrs)
    mean_delta = paired.mean(axis=0)
    out: dict[str, Any] = {
        "n_seeds": n_seeds,
        "mean_abs_delta": float(np.abs(mean_delta).mean()),
        "max_abs_delta": float(np.abs(mean_delta).max()),
        "mean_ours": float(acc_ours.mean()),
        "mean_reference": float(acc_ref.mean()),
        "budget": {
            "mean_pp": budget_mean_pp,
            "max_pp": budget_max_pp,
            "pass": bool(
                np.abs(mean_delta).mean() * 100 <= budget_mean_pp
                and np.abs(mean_delta).max() * 100 <= budget_max_pp
            ),
        },
    }
    if n_seeds > 1:
        # Per-cell std of the paired deltas. The "systematic?" verdict
        # tests all cells at once, so the per-cell threshold is
        # family-wise corrected: with ~96 cells a plain 3-sigma bound is
        # expected to be exceeded by ~0.3 cells under pure noise. z*
        # solves 2 (1 - Phi(z*)) = alpha / n_cells (Bonferroni, alpha 1 %).
        from scipy.stats import norm

        cell_sd = paired.std(axis=0, ddof=1)
        n_cells = int(mean_delta.size)
        z_star = float(norm.ppf(1.0 - 0.01 / (2.0 * n_cells)))
        se = cell_sd / np.sqrt(n_seeds)
        exceed_fw = np.abs(mean_delta) > np.maximum(z_star * se, 1e-9)
        exceed_3s = np.abs(mean_delta) > np.maximum(3.0 * se, 1e-9)
        out.update(
            paired_cell_sd_max=float(cell_sd.max()),
            paired_cell_sd_mean=float(cell_sd.mean()),
            noise_bound_z=round(z_star, 2),
            noise_bound_fw_max=float((z_star * se).max()),
            cells_exceeding_3sigma=int(exceed_3s.sum()),
            cells_expected_3sigma_by_chance=round(0.0027 * n_cells, 2),
            cells_exceeding_noise=int(exceed_fw.sum()),
            n_cells=n_cells,
            delta_within_seed_noise=bool(not exceed_fw.any()),
        )
    return out

_REF_MOD = None
_REF_ROOT = None


def _load_reference_features(ref_root: str | Path):
    """Import the reference's features module from its checkout without
    installing it (it only needs numpy + scipy.stats)."""
    global _REF_MOD, _REF_ROOT
    if _REF_MOD is not None and _REF_ROOT == str(ref_root):
        return _REF_MOD
    path = Path(ref_root) / "src" / "amcpy" / "features.py"
    if not path.exists():
        raise FileNotFoundError(
            f"reference checkout not found: {path} — pass --ref"
        )
    spec = importlib.util.spec_from_file_location(
        "_amcpy_reference_features", path
    )
    mod = importlib.util.module_from_spec(spec)
    assert spec.loader is not None
    spec.loader.exec_module(mod)
    _REF_MOD, _REF_ROOT = mod, str(ref_root)
    return mod


def _ref_worker(ref_root: str, frames: np.ndarray) -> np.ndarray:
    """Reference calculate_features over a frame chunk, in-process."""
    mod = _load_reference_features(ref_root)
    ids = list(range(1, NUM_FEATURES + 1))
    out = np.empty((frames.shape[0], NUM_FEATURES), dtype=np.float64)
    for i, frame in enumerate(frames):
        out[i] = mod.calculate_features(ids, frame)
    return out


def _subproc_main() -> None:
    """Entry for the worker subprocesses: argv = in.npy out.npy ref_root."""
    import sys

    in_path, out_path, ref_root = sys.argv[1:4]
    frames = np.load(in_path)
    np.save(out_path, _ref_worker(ref_root, frames))


def reference_features_batch(
    frames: np.ndarray,
    ref_root: str | Path,
    processes: int | None = None,
) -> np.ndarray:
    """Reference features for ``(B, N)`` complex frames, in parallel.

    Workers are plain subprocesses whose entry point is this module (data
    through ``.npy`` files), not ``multiprocessing``: its spawn context
    re-imports the caller's ``__main__`` in every worker, and a fork after
    CUDA is initialized is unsafe. The workers import neither torch nor
    the device.
    """
    import os
    import subprocess
    import sys
    import tempfile

    frames = np.asarray(frames)
    if processes is None:
        processes = min(mp.cpu_count() or 1, 8)
    processes = max(1, min(processes, frames.shape[0]))
    if processes == 1:
        return _ref_worker(str(ref_root), frames)

    repo_root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    bounds = np.linspace(0, frames.shape[0], processes + 1).astype(int)
    with tempfile.TemporaryDirectory(prefix="amc_parity_") as td:
        procs = []
        for w, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            inp = f"{td}/in_{w}.npy"
            outp = f"{td}/out_{w}.npy"
            np.save(inp, frames[lo:hi])
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        "-c",
                        "from amcpy_tpu_torch.parity import _subproc_main; "
                        "_subproc_main()",
                        inp,
                        outp,
                        str(ref_root),
                    ],
                    env=env,
                )
            )
        failed = [w for w, p in enumerate(procs) if p.wait() != 0]
        if failed:
            raise RuntimeError(f"reference workers {failed} failed")
        parts = [np.load(f"{td}/out_{w}.npy") for w in range(len(procs))]
    return np.concatenate(parts, axis=0)


def _term_scales_batch(frames: np.ndarray) -> np.ndarray:
    """Per-frame magnitude scale of each feature's largest constituent
    term, the denominator of the float32 error budget. Mirrors the test
    oracle (``tests/oracle.py``), vectorized over the batch."""
    x = np.asarray(frames, dtype=np.complex128)
    a = np.abs(x)
    n = x.shape[-1]
    a2 = a * a
    p2 = np.mean(a2, axis=-1)
    x2 = x * x
    m20 = np.abs(np.mean(x2, axis=-1))
    m40 = np.abs(np.mean(x2 * x2, axis=-1))
    m42 = np.mean(a2 * a2, axis=-1)
    m63 = np.mean(a2 * a2 * a2, axis=-1)
    s = np.empty((x.shape[0], NUM_FEATURES))
    s[:, 0] = np.sum(a2, axis=-1)  # Parseval bound on gmax
    s[:, 1] = s[:, 2] = np.pi
    s[:, 3] = 1.0
    s[:, 4] = 0.5
    s[:, 5] = np.maximum(np.mean(a, axis=-1), 1e-30)
    s[:, 6] = np.maximum(np.sqrt(np.sum(a, axis=-1)) / n, 1e-30)
    s[:, 7] = s[:, 8] = 10.0
    s[:, 9] = s[:, 10] = p2
    c4 = np.maximum.reduce([m42, 3 * m20**2, p2**2])
    s[:, 11] = s[:, 12] = s[:, 13] = c4
    c6 = np.maximum.reduce([m63, 15 * m20 * m40, p2**3])
    s[:, 14] = s[:, 15] = s[:, 16] = s[:, 17] = c6
    return s


def run_parity(
    cfg: Config,
    *,
    ref_root: str | Path,
    frames_per_snr: int | None = None,
    train_models: bool = True,
    seed: int = 0,
    n_seeds: int = 3,
    processes: int | None = None,
    atol_scale: float = 1e-4,
    rtol: float = 1e-5,
    device: "str | torch.device | None" = None,
) -> dict[str, Any]:
    """Full parity run on ``device`` (the card when None); returns (and
    writes) the report dict."""
    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.extraction import _default_chunk_size, extract_batch
    from amcpy_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg.paths.ensure_dirs()
    s = cfg.signals
    take = frames_per_snr or s.num_frames
    extract_kw = dict(
        normalize_scale=cfg.compute.normalize_scale,
        gmax_mode=cfg.compute.gmax_mode,
        kernel=cfg.compute.kernel,
        wire=cfg.compute.wire_format,
        device=dev,
    )

    # one-time costs (building and loading the kernel library, the first
    # allocations) are paid before the timed loop, at the real chunk shape
    t = time.perf_counter()
    n_warm = min(s.num_snr * take, _default_chunk_size(dev, s.frame_size))
    warm = np.zeros((n_warm, s.frame_size), np.complex64)
    warm[:, 0] = 1.0  # non-degenerate frames
    extract_batch(warm, **extract_kw)
    warmup_s = time.perf_counter() - t

    feats_ours: dict[str, np.ndarray] = {}
    feats_ref: dict[str, np.ndarray] = {}
    per_feature_max_frac = np.zeros(NUM_FEATURES)
    per_feature_max_abs = np.zeros(NUM_FEATURES)
    n_frames_total = 0
    n_violations = 0
    t0 = time.perf_counter()
    t_ref = 0.0
    t_ours = 0.0
    tim: dict[str, Any] = {}
    per_mod_wall: dict[str, dict[str, float]] = {}

    for mod in s.modulations_with_noise:
        raw = io_mat.load_modulation(cfg, mod)[:, :take]  # (S, take, N)
        n_snr, n_f, n = raw.shape
        flat = raw.reshape(-1, n)

        t = time.perf_counter()
        mod_tim: dict[str, Any] = {}
        ours = extract_batch(flat, timings=mod_tim, **extract_kw).astype(np.float64)
        mod_wall = time.perf_counter() - t
        t_ours += mod_wall
        per_mod_wall[mod] = {
            "wall_s": round(mod_wall, 2),
            **{k: round(v, 2) for k, v in mod_tim.items() if isinstance(v, float)},
        }
        for k, v in mod_tim.items():
            if isinstance(v, (int, float)):
                tim[k] = tim.get(k, 0.0 if isinstance(v, float) else 0) + v
            else:  # the wire format's name
                tim[k] = v

        t = time.perf_counter()
        ref = reference_features_batch(flat, ref_root, processes=processes)
        t_ref += time.perf_counter() - t

        tol = atol_scale * _term_scales_batch(flat) + rtol * np.abs(ref)
        frac = np.abs(ours - ref) / tol
        per_feature_max_frac = np.maximum(per_feature_max_frac, frac.max(axis=0))
        per_feature_max_abs = np.maximum(
            per_feature_max_abs, np.abs(ours - ref).max(axis=0)
        )
        n_violations += int((frac > 1.0).any(axis=-1).sum())
        n_frames_total += flat.shape[0]
        feats_ours[mod] = ours.reshape(n_snr, n_f, NUM_FEATURES).astype(np.float32)
        feats_ref[mod] = ref.reshape(n_snr, n_f, NUM_FEATURES).astype(np.float32)
        print(
            f"[parity] {mod}: {flat.shape[0]} frames, "
            f"worst error = {frac.max() * 100:.1f}% of tolerance",
            flush=True,
        )

    report: dict[str, Any] = {
        "dataset": str(cfg.paths.mat_data / cfg.paths.mat_filename),
        "device": str(dev),
        "frames_per_snr": take,
        "frames_total": n_frames_total,
        "tolerance": {"atol_scale": atol_scale, "rtol": rtol},
        "frames_outside_tolerance": n_violations,
        "worst_error_fraction_of_tolerance": float(per_feature_max_frac.max()),
        "per_feature_max_tolerance_fraction": [
            round(float(v), 4) for v in per_feature_max_frac
        ],
        "wall_s": {
            "reference_extractor": round(t_ref, 2),
            "this_pipeline": round(t_ours, 2),
            "warmup_s": round(warmup_s, 2),
            "pipeline_host_prep_s": round(tim.get("host_prep_s", 0.0), 2),
            "pipeline_h2d_s": round(tim.get("h2d_s", 0.0), 2),
            "pipeline_wait_s": round(tim.get("wait_s", 0.0), 2),
            "pipeline_bytes_h2d": int(tim.get("bytes_h2d", 0)),
            "per_modulation": per_mod_wall,
        },
        "pipeline_frames_per_s": round(n_frames_total / max(t_ours, 1e-9), 1),
        "reference_frames_per_s": round(n_frames_total / max(t_ref, 1e-9), 1),
    }

    if train_models:
        from amcpy_tpu_torch.preprocessing import preprocess
        from amcpy_tpu_torch.train.evaluate import evaluate_by_snr
        from amcpy_tpu_torch.train.training import train

        tcfg = cfg if take == s.num_frames else cfg.replace(
            signals={"num_frames": take}
        )
        # paired seeds: seed k trains both feature sets from the same
        # initialization and shuffle stream, so the per-seed difference
        # cancels the cell-level training bistability
        n_seeds = max(1, n_seeds)
        accs: dict[str, np.ndarray] = {}
        for name, feats in (("reference", feats_ref), ("ours", feats_ours)):
            runs = []
            for k in range(n_seeds):
                x_tr, x_te, y_tr, y_te, scaler = preprocess(feats, tcfg)
                model, _, hist, _ = train(
                    tcfg, x_tr, y_tr, x_te, y_te, seed=seed + k, device=dev
                )
                runs.append(evaluate_by_snr(model, scaler, feats, tcfg, device=dev))
                print(
                    f"[parity] trained on {name} features (seed {seed + k}):"
                    f" val_acc={hist['val_accuracy'][-1]:.4f}",
                    flush=True,
                )
            accs[name] = np.stack(runs)  # (n_seeds, mods, snrs)
        stats = paired_accuracy_stats(accs["ours"], accs["reference"])
        stats["per_snr_ours"] = np.round(accs["ours"].mean(axis=0), 4).tolist()
        stats["per_snr_reference"] = np.round(
            accs["reference"].mean(axis=0), 4
        ).tolist()
        # per-seed stacks: the statistics can be recomputed later without
        # running the extractors or the trainings again
        stats["per_seed"] = {name: np.round(a, 4).tolist() for name, a in accs.items()}
        report["accuracy"] = stats

    report["total_wall_s"] = round(time.perf_counter() - t0, 2)
    out = cfg.paths.metrics / "parity.json"
    out.write_text(json.dumps(report, indent=2))
    _write_markdown(cfg, report)
    print(f"[parity] report -> {out}")
    return report


def _write_markdown(cfg: Config, r: dict[str, Any]) -> Path:
    lines = [
        "# Reference parity report",
        "",
        f"Dataset: `{r['dataset']}` — {r['frames_total']} frames "
        f"({r['frames_per_snr']} per SNR), reference extractor executed "
        f"from its checkout, frame-by-frame; this pipeline on {r['device']}.",
        "",
        f"- Tolerance model: `{r['tolerance']['atol_scale']} * term_scale"
        f" + {r['tolerance']['rtol']} * |ref|` (float32-vs-float64 budget)",
        f"- Frames with ANY feature outside tolerance: "
        f"**{r['frames_outside_tolerance']} / {r['frames_total']}**",
        f"- Worst observed error: "
        f"**{r['worst_error_fraction_of_tolerance'] * 100:.1f}% of budget**",
        f"- Wall: reference {r['wall_s']['reference_extractor']}s "
        f"({r.get('reference_frames_per_s', 0):,.0f} frames/s) vs "
        f"this pipeline {r['wall_s']['this_pipeline']}s "
        f"(**{r.get('pipeline_frames_per_s', 0):,.0f} frames/s**, host "
        "round-trips included; one-time backend warmup of "
        f"{r['wall_s'].get('warmup_s', 0)}s paid before timing)",
        f"- Pipeline host-path split: planarize "
        f"{r['wall_s'].get('pipeline_host_prep_s', 0)}s, host-to-device copies "
        f"{r['wall_s'].get('pipeline_h2d_s', 0)}s "
        f"({r['wall_s'].get('pipeline_bytes_h2d', 0) / 1e9:.2f} GB), "
        f"result waits {r['wall_s'].get('pipeline_wait_s', 0)}s",
    ]
    if "accuracy" in r:
        a = r["accuracy"]
        b = a["budget"]
        lines += [
            "",
            "## Downstream accuracy parity (paired seeds)",
            "",
            f"Classifier trained with {a.get('n_seeds', 1)} PAIRED seed(s):"
            " seed k trains on reference-extracted features and on ours "
            "with the identical init/shuffle stream, and the per-seed "
            "difference curves are analyzed (cancels the cell-level "
            "training bistability that made unpaired bounds vacuous):",
            "",
            f"- mean per-SNR accuracy: ours {a['mean_ours']:.4f} vs "
            f"reference-features {a['mean_reference']:.4f}",
            f"- paired delta over all (mod, SNR) cells: mean |delta| "
            f"**{a['mean_abs_delta'] * 100:.2f} pp**, max |delta| "
            f"**{a['max_abs_delta'] * 100:.2f} pp**",
            f"- budget (asserted in the suite): mean <= {b['mean_pp']} pp,"
            f" max <= {b['max_pp']} pp -> "
            f"**{'PASS' if b['pass'] else 'FAIL'}**",
        ]
        if a.get("n_seeds", 1) > 1:
            verdict = (
                "WITHIN paired-seed noise"
                if a.get("delta_within_seed_noise")
                else "EXCEEDS paired-seed noise (systematic)"
            )
            lines += [
                f"- paired per-cell sd: mean "
                f"{a['paired_cell_sd_mean'] * 100:.2f} pp, max "
                f"{a['paired_cell_sd_max'] * 100:.2f} pp; cells over a "
                f"plain 3-sigma bound: {a['cells_exceeding_3sigma']}"
                f"/{a['n_cells']} (noise alone is expected to produce "
                f"~{a['cells_expected_3sigma_by_chance']}); cells over "
                f"the family-wise Bonferroni bound "
                f"(z*={a['noise_bound_z']}): "
                f"{a['cells_exceeding_noise']}/{a['n_cells']} -> "
                f"**{verdict}**",
            ]
    p = cfg.paths.metrics / "parity_report.md"
    p.write_text("\n".join(lines) + "\n")
    return p
