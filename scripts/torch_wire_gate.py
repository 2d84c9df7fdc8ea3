"""The wire-codec gate of the PyTorch port, on the full-scale dataset and
the card: the port's counterpart of ``scripts/wire_gate.py``.

For each candidate wire format (int24, int16) it extracts every
modulation's first ``--take`` frames of each SNR level through
``extract_batch(kernel="fused", wire=...)`` (K1 behind the codec's decode
on the card) and holds the features against the float64 oracle
(``tests/oracle.py``) at the parity budget ``1e-4 * term_scales + 1e-5 *
|oracle|``. The term scales are taken over each modulation's whole batch,
as ``scripts/wire_gate.py`` takes them, so the fractions compare with its
record (``metrics/wire_gate.json``); the fractions under each frame's own
term scales, as the port's tests take them, are recorded beside them
(``*_frame_scales``). A format passes when its worst
fraction stays at or under ``--budget-frac``. Two float32 controls run on
the same frames: K1 (``f32``, the reference script's control) and the
statistics kernel K2 (``kernel="pallas"``, under ``k2_f32``). A control
over the gate is a kernel fault: the record is written and the script
exits 1. A codec's FAIL is a result and exits 0.

Every extraction asserts the wire it asked for (``timings["wire"]``) and,
on the card, that K1's (or K2's, all on its warpgroup route at N <= 2048)
launch counter moved by one a chunk: nothing takes the plain version on
the card. ``--device cpu`` runs the plain PyTorch versions instead.

Where ``ROOT/mat-data/all_modulations.mat`` is absent it is written first
by the port's ``synth.write_dataset(cfg, seed=0)`` on the device (the
default config: 6 x 16 x 1000 x 2048, 1.57 GB). The oracle runs in one
process a core beside the card.

    python3 scripts/torch_wire_gate.py [--root DIR] [--take 1000] \\
        [--budget-frac 0.85] [--formats int24,int16] [--device cuda|cpu] \\
        [--out metrics/torch_wire_gate.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import sys
import time
from pathlib import Path
from typing import Callable, Iterable

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402

from scripts.torch_records import (  # noqa: E402
    DEFAULT_ROOT,
    add_device_flags,
    ensure_dataset,
    environment,
    require_device,
)

#: an extractor: complex (B, N) frames -> ((B, 18) features, timings with
#: ``wall_s``, ``h2d_s``, ``bytes_h2d`` and ``wire``)
Extractor = Callable[[np.ndarray], "tuple[np.ndarray, dict]"]

#: frames a worker takes at a time
ORACLE_CHUNK = 500


def oracle_budget(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The float64 oracle of ``frames`` and each frame's term scales,
    ``(B, 18)`` each."""
    from oracle import features_batch, term_scales

    want = features_batch(np.asarray(frames, np.complex128))
    return want, np.stack([term_scales(f) for f in frames])


def branch_cut_flips(frames: np.ndarray, fmt: str) -> np.ndarray:
    """Per frame, the samples on the negative real side (I < 0) whose Q
    changes sign through the codec ``fmt`` (encoded and decoded on the
    host): their phase moves by 2 pi, between -pi and pi, which moves
    feature 3 (the std of the phase) and not feature 2 (of its magnitude)."""
    import torch

    from amcpy_tpu_torch.ops.fused import split_planes
    from amcpy_tpu_torch.ops.wire import decode_planes, encode_planes

    i, q = split_planes(frames)
    enc = encode_planes(i, q, fmt)
    _, dq = decode_planes(*(torch.from_numpy(e) for e in enc), fmt=fmt)
    return ((np.signbit(q) != np.signbit(dq.numpy())) & (i < 0)).sum(axis=-1)


def _oracle(frames: np.ndarray, pool: cf.Executor | None):
    """:func:`oracle_budget` of ``frames`` in chunks on ``pool`` (inline
    without one); a callable that returns the chunks' results."""
    chunks = [frames[k:k + ORACLE_CHUNK] for k in range(0, len(frames), ORACLE_CHUNK)]
    if pool is None:
        parts = [oracle_budget(c) for c in chunks]
        return lambda: parts
    futs = [pool.submit(oracle_budget, c) for c in chunks]
    return lambda: [f.result() for f in futs]


def gate(
    batches: Iterable[tuple[str, np.ndarray]],
    extractors: dict[str, Extractor],
    *,
    budget_frac: float = 0.85,
    pool: cf.Executor | None = None,
) -> dict:
    """Hold every extractor against the float64 oracle on every batch.

    ``extractors`` maps ``"f32"`` (the control), each wire format and
    optionally ``"k2_f32"`` to an :data:`Extractor`. Returns the record:
    ``f32`` and ``k2_f32`` (the controls), ``formats.{fmt}`` (the codecs,
    with bytes and speed against ``f32`` and their branch-cut flips, see
    :func:`branch_cut_flips`), each with the worst fraction of
    the budget over all frames (batch-wide term scales, and per frame),
    the worst per feature, ``pass`` at ``budget_frac``, wall, copy and
    byte totals and frames/s.
    """
    from oracle import term_scales

    worst = {k: np.zeros(18) for k in extractors}
    worst_frame = {k: np.zeros(18) for k in extractors}
    totals = {k: {"wall_s": 0.0, "h2d_s": 0.0, "bytes": 0} for k in extractors}
    codecs = [k for k in extractors if k not in ("f32", "k2_f32")]
    flips = {k: [0, 0] for k in codecs}  # samples, frames
    n_total = 0
    for name, frames in batches:
        flat = np.ascontiguousarray(frames.reshape(-1, frames.shape[-1]))
        n_total += flat.shape[0]
        pending = _oracle(flat, pool)
        got = {}
        for key, extract in extractors.items():
            feats, tim = extract(flat)
            got[key] = np.asarray(feats, np.float64)
            totals[key]["wall_s"] += tim["wall_s"]
            totals[key]["h2d_s"] += tim["h2d_s"]
            totals[key]["bytes"] += int(tim["bytes_h2d"])
        for fmt in codecs:
            per_frame_flips = branch_cut_flips(flat, fmt)
            flips[fmt][0] += int(per_frame_flips.sum())
            flips[fmt][1] += int((per_frame_flips > 0).sum())
        parts = pending()
        want = np.concatenate([p[0] for p in parts])
        per_frame = np.concatenate([p[1] for p in parts])
        # the budget of the reference script: term scales of the whole batch
        tol = 1e-4 * term_scales(flat) + 1e-5 * np.abs(want)
        tol_frame = 1e-4 * per_frame + 1e-5 * np.abs(want)
        for key, feats in got.items():
            err = np.abs(feats - want)
            fr = (err / tol).max(axis=0)
            worst[key] = np.maximum(worst[key], fr)
            worst_frame[key] = np.maximum(worst_frame[key], (err / tol_frame).max(axis=0))
            top = np.argsort(fr)[-3:][::-1]
            print(f"[gate] {name} {key}: worst budget fraction {fr.max():.4f} (top "
                  + ", ".join(f"F{k + 1}={fr[k]:.4f}" for k in top) + ")", flush=True)

    def entry(key: str) -> dict:
        t = totals[key]
        return {
            "worst_budget_fraction": float(worst[key].max()),
            "worst_per_feature": worst[key].tolist(),
            "worst_budget_fraction_frame_scales": float(worst_frame[key].max()),
            "worst_per_feature_frame_scales": worst_frame[key].tolist(),
            "pass": bool(worst[key].max() <= budget_frac),
            "wall_s": t["wall_s"],
            "h2d_s": t["h2d_s"],
            "bytes": t["bytes"],
            "frames": n_total,
            "frames_per_s": n_total / t["wall_s"],
        }

    report: dict = {"budget_frac_gate": budget_frac, "formats": {}}
    report["f32"] = entry("f32")
    if "k2_f32" in extractors:
        report["k2_f32"] = entry("k2_f32")
    for fmt in codecs:
        e = entry(fmt)
        e["bytes_vs_f32"] = e["bytes"] / max(report["f32"]["bytes"], 1)
        e["speedup_vs_f32"] = report["f32"]["wall_s"] / e["wall_s"]
        e["branch_cut_flips"], e["frames_with_branch_cut_flips"] = flips[fmt]
        report["formats"][fmt] = e
    return report


def device_extractors(dev, formats: list[str]) -> dict[str, Extractor]:
    """K1 at f32 and each wire format, and K2 at f32, through
    ``extract_batch`` on ``dev``. On the card each call asserts its wire
    and that its kernel's launch counter moved by one a chunk (K2's on
    its warpgroup route wherever N <= 2048); on the CPU the wrappers take
    their plain versions."""
    import torch

    from amcpy_tpu_torch.extraction import _default_chunk_size, extract_batch
    from amcpy_tpu_torch.ops.fused import extract_features_fused, extract_features_fused_any
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas, stats_path

    def counted(kernel: str, wire: str) -> Extractor:
        def run(flat: np.ndarray):
            b, n = flat.shape
            before = (extract_features_fused.launches, extract_features_pallas.launches,
                      dict(extract_features_pallas.launches_by_path),
                      extract_features_fused_any.reroutes)
            tim: dict = {}
            t0 = time.perf_counter()
            feats = extract_batch(flat, kernel=kernel, wire=wire, timings=tim, device=dev)
            tim["wall_s"] = time.perf_counter() - t0
            if tim["wire"] != wire:
                raise AssertionError(f"asked for the {wire} wire, ran {tim['wire']}")
            if dev.type == "cuda":
                chunks = -(-b // _default_chunk_size(dev, n))
                k1 = extract_features_fused.launches - before[0]
                k2 = extract_features_pallas.launches - before[1]
                want = (chunks, 0) if kernel == "fused" else (0, chunks)
                if (k1, k2) != want or extract_features_fused_any.reroutes != before[3]:
                    raise AssertionError(
                        f"{kernel}/{wire}: {k1} K1 and {k2} K2 launches, expected {want}")
                if kernel == "pallas":
                    path = stats_path(n)
                    moved = extract_features_pallas.launches_by_path[path] - before[2][path]
                    if moved != chunks:
                        raise AssertionError(f"K2 left its {path} route: {moved}/{chunks}")
                torch.cuda.synchronize(dev)
            return feats, tim

        return run

    out = {"f32": counted("fused", "f32")}
    for fmt in formats:
        out[fmt] = counted("fused", fmt)
    out["k2_f32"] = counted("pallas", "f32")
    return out


def dataset_batches(cfg, take: int):
    """``(modulation, (num_snr, take, N) frames)`` for every modulation,
    read one at a time."""
    from amcpy_tpu_torch.data import io_mat

    for mod in cfg.signals.modulations_with_noise:
        yield mod, io_mat.load_modulation(cfg, mod)[:, :take]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--take", type=int, default=1000,
                    help="frames per SNR per modulation")
    ap.add_argument("--budget-frac", type=float, default=0.85)
    ap.add_argument("--formats", default="int24,int16")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a (modulation, SNR) block of a dataset written "
                         "here holds (the config's 1000 by default)")
    ap.add_argument("--frame-size", type=int, default=None)
    add_device_flags(ap, "metrics/torch_wire_gate.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    from amcpy_tpu_torch.config import Config

    signals = {k: v for k, v in (("num_frames", args.frames),
                                 ("frame_size", args.frame_size)) if v is not None}
    cfg = Config().replace(paths={"root": args.root}, signals=signals)
    ensure_dataset(cfg, dev)
    formats = [f for f in args.formats.split(",") if f]
    # the oracle in one process a core, where a block holds more than a chunk
    pool = None
    if args.take * cfg.signals.num_snr > ORACLE_CHUNK:
        pool = cf.ProcessPoolExecutor(os.cpu_count(), mp_context=mp.get_context("spawn"))
    t0 = time.perf_counter()
    try:
        report = gate(dataset_batches(cfg, args.take), device_extractors(dev, formats),
                      budget_frac=args.budget_frac, pool=pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    report = {"take_per_snr": args.take, **report, **environment(dev),
              "frame_size": cfg.signals.frame_size, "seconds": time.perf_counter() - t0}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    for key in ("f32", "k2_f32", *formats):
        v = report["formats"].get(key) or report[key]
        extra = (f", {v['speedup_vs_f32']:.3f}x the f32 wire's speed, "
                 f"{v['bytes_vs_f32']:.3f}x its bytes, {v['branch_cut_flips']} "
                 f"branch-cut flips" if key in formats else "")
        print(f"[gate] {key}: {'PASS' if v['pass'] else 'FAIL'} (worst "
              f"{v['worst_budget_fraction']:.4f} of the budget, gate "
              f"{args.budget_frac}; per-frame scales "
              f"{v['worst_budget_fraction_frame_scales']:.4f}), "
              f"{v['frames_per_s']:,.0f} frames/s{extra}", flush=True)
    print(f"[gate] wrote {out}", flush=True)
    faults = [k for k in ("f32", "k2_f32") if not report[k]["pass"]]
    if faults:
        print(f"[gate] kernel fault: the float32 control(s) {faults} exceed the gate",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
