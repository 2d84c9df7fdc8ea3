"""Extraction runtime: ``.mat`` dataset -> per-modulation feature artifacts.

Counterpart of ``amcpy_tpu/extraction.py`` on one device. Frames are
planarized on the host by a prefetch thread into pinned buffers, copied to
the device with ``non_blocking=True`` chunk by chunk, and run through the
extractor that :func:`resolve_kernel` picks; chunk k+1 is prepared while
chunk k is copied and computed. The per-modulation ``.mat`` artifacts keep
the reference layout, and a re-run skips modulations whose artifact
exists (``force=True`` overrides) and recomputes a corrupt one.

Not ported here: device meshes, sequence parallelism, multi-host
partitioning and the integer wire codecs.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Callable

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat
from amcpy_tpu_torch.ops.features import NUM_FEATURES, extract_features_planar
from amcpy_tpu_torch.utils.device import resolve_device
from amcpy_tpu_torch.utils.metrics import MetricsLogger, stage_timer

__all__ = [
    "extract_batch",
    "prepare_frames",
    "PreparedBatch",
    "resolve_kernel",
    "resolve_wire_format",
    "run_extraction",
]

KERNELS = ("fused", "pallas", "xla")


def resolve_kernel(kernel: str, device: torch.device) -> str:
    """``"auto"`` -> ``"fused"`` (the CUDA kernel) on a CUDA device and
    ``"xla"`` (the plain PyTorch extractor) on the CPU. Used by extraction
    and serving, so the two never route differently."""
    if kernel == "auto":
        return "fused" if device.type == "cuda" else "xla"
    if kernel not in KERNELS:
        raise ValueError(f"unknown extraction kernel {kernel!r}")
    return kernel


def resolve_wire_format(fmt: str) -> str:
    """``"auto"`` and ``"f32"`` ship raw float32 planes (the JAX package
    also resolves ``"auto"`` to f32 off the TPU)."""
    if fmt in ("auto", "f32"):
        return "f32"
    if fmt in ("int24", "int16"):
        raise NotImplementedError(
            f"wire format {fmt!r} is not ported yet (ROADMAP Queue A, item 16)"
        )
    raise ValueError(f"unknown wire format {fmt!r} (use auto|f32)")


def _kernel_fn(
    kernel: str, normalize_scale: bool, gmax_mode: str, device: torch.device
) -> tuple[Callable[..., torch.Tensor], bool]:
    """The per-chunk extractor for ``kernel`` and whether it takes separate
    ``(B, N)`` I and Q planes (``wants_planes``) or packed ``(B, 2, N)``."""
    kernel = resolve_kernel(kernel, device)
    if kernel == "fused":
        from amcpy_tpu_torch.ops.fused import extract_features_fused_any

        def fused(i, q):
            return extract_features_fused_any(
                i, q, normalize_scale=normalize_scale, gmax_mode=gmax_mode
            )

        return fused, True
    if kernel == "pallas":
        from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas

        def pallas(iq):
            return extract_features_pallas(
                iq, normalize_scale=normalize_scale, gmax_mode=gmax_mode
            )

        return pallas, False

    def plain(iq):
        return extract_features_planar(
            iq, normalize_scale=normalize_scale, gmax_mode=gmax_mode
        )

    return plain, False


def _default_chunk_size(device: torch.device, frame_size: int) -> int:
    # 8M samples (64 MB of planar float32) per chunk on the card: small
    # enough that a modulation splits into a few chunks whose host prep
    # overlaps the device work; 2M samples on the CPU
    samples = 1 << 23 if device.type == "cuda" else 1 << 21
    return max(256, samples // max(frame_size, 1))


def _prep_chunk(
    frames_slice: np.ndarray, wants_planes: bool, pin: bool
) -> tuple[torch.Tensor, ...]:
    """Host phase of one chunk: split into I/Q planes or pack to
    ``(B, 2, N)``, in page-locked memory when the device is a card (so the
    copy can run asynchronously). Pure host work, safe on a thread."""
    b, n = frames_slice.shape
    shape = (b, n) if wants_planes else (b, 2, n)
    count = 2 if wants_planes else 1
    bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=pin)
            for _ in range(count)]
    views = [t.numpy() for t in bufs]
    if wants_planes:
        np.copyto(views[0], frames_slice.real, casting="same_kind")
        np.copyto(views[1], frames_slice.imag, casting="same_kind")
    else:
        np.copyto(views[0][:, 0, :], frames_slice.real, casting="same_kind")
        np.copyto(views[0][:, 1, :], frames_slice.imag, casting="same_kind")
    return tuple(bufs)


class PreparedBatch:
    """Host-prepared chunks for :func:`extract_batch` (build with
    :func:`prepare_frames`, typically on a loader thread)."""

    __slots__ = ("b", "frame_size", "wire", "wants_planes", "chunks", "prep_s")

    def __init__(self, b, frame_size, wire, wants_planes, chunks, prep_s):
        self.b = b
        self.frame_size = frame_size
        self.wire = wire
        self.wants_planes = wants_planes
        #: list of (start_row, payload_tensors)
        self.chunks = chunks
        self.prep_s = prep_s


def prepare_frames(
    frames: np.ndarray,
    *,
    chunk_size: int | None = None,
    kernel: str = "xla",
    wire: str = "f32",
    device: "str | torch.device | None" = None,
) -> PreparedBatch:
    """Run :func:`extract_batch`'s host phase ahead of time. The caller
    passes the SAME ``kernel`` and ``device`` to ``extract_batch``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    frames = np.asarray(frames)
    wire = resolve_wire_format(wire)
    if chunk_size is None:
        chunk_size = _default_chunk_size(dev, frames.shape[-1])
    wants_planes = resolve_kernel(kernel, dev) == "fused"
    pin = dev.type == "cuda"
    chunks = [
        (start, _prep_chunk(frames[start : start + chunk_size], wants_planes, pin))
        for start in range(0, frames.shape[0], chunk_size)
    ]
    return PreparedBatch(
        frames.shape[0], frames.shape[-1], wire, wants_planes, chunks,
        time.perf_counter() - t0,
    )


def extract_batch(
    frames: "np.ndarray | PreparedBatch",
    *,
    chunk_size: int | None = None,
    normalize_scale: bool = True,
    gmax_mode: str = "matmul",
    kernel: str = "xla",
    wire: str = "f32",
    timings: dict | None = None,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Extract features for a host batch ``(B, N)`` complex -> ``(B, 18)``
    float32 on the host.

    A prep thread splits/packs chunk k+1 while chunk k is copied and
    computed; every chunk's features land in one device buffer, fetched
    once at the end. A :class:`PreparedBatch` skips the host phase.

    ``timings`` — optional dict, filled with the phase split of the host
    path: ``host_prep_s`` (time BLOCKED on prep), ``prep_total_s`` (all
    prep, overlapped or not), ``h2d_s`` (enqueueing the copies and
    kernels), ``wait_s`` (waiting for the device at the end: compute plus
    any copy backlog), ``bytes_h2d`` and ``wire``.
    """
    dev = resolve_device(device)
    t_prep = prep_total = 0.0
    prep_exec: cf.ThreadPoolExecutor | None = None
    if isinstance(frames, PreparedBatch):
        prepared = frames
        b = prepared.b
        wire = prepared.wire
        wants_planes = prepared.wants_planes
        prep_total = prepared.prep_s

        def chunk_stream():
            yield from prepared.chunks
    else:
        frames = np.asarray(frames)
        b = frames.shape[0]
        wire = resolve_wire_format(wire)
        if chunk_size is None:
            chunk_size = _default_chunk_size(dev, frames.shape[-1])
        wants_planes = resolve_kernel(kernel, dev) == "fused"
        starts = list(range(0, b, chunk_size))
        prep_exec = cf.ThreadPoolExecutor(1)
        pin = dev.type == "cuda"

        def _prep(start):
            t0 = time.perf_counter()
            payload = _prep_chunk(
                frames[start : start + chunk_size], wants_planes, pin
            )
            return start, payload, time.perf_counter() - t0

        def chunk_stream():
            # prefetch depth 1: chunk k+1 preps on the worker while chunk
            # k is copied — host residency stays at two chunks
            nonlocal t_prep, prep_total
            fut = prep_exec.submit(_prep, starts[0]) if starts else None
            for k in range(len(starts)):
                t0 = time.perf_counter()
                start, payload, dt = fut.result()
                t_prep += time.perf_counter() - t0  # BLOCKED time only
                prep_total += dt
                if k + 1 < len(starts):
                    fut = prep_exec.submit(_prep, starts[k + 1])
                yield start, payload

    kern, wants_k = _kernel_fn(kernel, normalize_scale, gmax_mode, dev)
    if wants_k != wants_planes:
        raise ValueError(
            "prepared batch routing does not match this kernel: prepare "
            "and extract with the same kernel and device"
        )
    out_dev = torch.empty((b, NUM_FEATURES), dtype=torch.float32, device=dev)
    t_h2d = 0.0
    bytes_h2d = 0
    try:
        for start, payload in chunk_stream():
            t1 = time.perf_counter()
            arrs = [t.to(dev, non_blocking=True) for t in payload]
            bytes_h2d += sum(t.numel() * t.element_size() for t in payload)
            feats = kern(*arrs)
            out_dev[start : start + feats.shape[0]] = feats
            t_h2d += time.perf_counter() - t1
        t3 = time.perf_counter()
        out = out_dev.cpu().numpy()
        t_wait = time.perf_counter() - t3
    finally:
        if prep_exec is not None:
            prep_exec.shutdown(wait=True)
    if timings is not None:
        timings["host_prep_s"] = timings.get("host_prep_s", 0.0) + t_prep
        timings["prep_total_s"] = timings.get("prep_total_s", 0.0) + prep_total
        timings["h2d_s"] = timings.get("h2d_s", 0.0) + t_h2d
        timings["wait_s"] = timings.get("wait_s", 0.0) + t_wait
        timings["bytes_h2d"] = timings.get("bytes_h2d", 0) + bytes_h2d
        timings["wire"] = wire
    return out


def run_extraction(
    cfg: Config,
    *,
    force: bool = False,
    logger: MetricsLogger | None = None,
    device: "str | torch.device | None" = None,
) -> dict[str, np.ndarray]:
    """Extract features for every modulation in the dataset.

    Returns ``{modulation: (num_snr, num_frames, 18) float32}`` and writes
    the per-modulation ``{MOD}_features.mat`` artifacts.
    """
    dev = resolve_device(device)
    resolve_wire_format(cfg.compute.wire_format)
    cfg.paths.ensure_dirs()
    if logger is None:
        logger = MetricsLogger(cfg.paths.metrics / "run.jsonl")

    results: dict[str, np.ndarray] = {}
    todo: list[str] = []
    for mod in cfg.signals.modulations_with_noise:
        out_path = cfg.paths.calculated_features / f"{mod}_features.mat"
        if out_path.exists() and not force:
            try:
                results[mod] = io_mat.load_features(cfg, mod)
                logger.log("extract_skip", modulation=mod, path=str(out_path))
                continue
            except Exception as exc:  # corrupt artifact: recompute
                logger.log(
                    "extract_corrupt_artifact", modulation=mod, error=repr(exc)
                )
                print(f"[{mod}] corrupt artifact, recomputing: {exc}")
        todo.append(mod)

    # a loader thread reads and prepares modulation k+1 while k is on the
    # device
    def _load_prepared(mod: str):
        raw = io_mat.load_modulation(cfg, mod)  # (S, F, N)
        return raw.shape, prepare_frames(
            raw.reshape(-1, raw.shape[-1]), kernel=cfg.compute.kernel,
            wire=cfg.compute.wire_format, device=dev,
        )

    loader = cf.ThreadPoolExecutor(1)
    try:
        fut = loader.submit(_load_prepared, todo[0]) if todo else None
        for k, mod in enumerate(todo):
            (n_snr, n_frames, _), prepared = fut.result()
            fut = (
                loader.submit(_load_prepared, todo[k + 1])
                if k + 1 < len(todo) else None
            )
            with stage_timer(
                logger, "extract", device=dev, modulation=mod
            ) as rec:
                tim: dict = {}
                feats = extract_batch(
                    prepared,
                    normalize_scale=cfg.compute.normalize_scale,
                    gmax_mode=cfg.compute.gmax_mode,
                    kernel=cfg.compute.kernel,
                    timings=tim,
                    device=dev,
                )
                rec["frames"] = int(n_snr * n_frames)
                rec["kernel"] = resolve_kernel(cfg.compute.kernel, dev)
                rec.update(tim)
            fps = rec["frames"] / max(rec["wall_s"], 1e-9)
            print(
                f"[{mod}] {rec['frames']} frames in {rec['wall_s']:.2f}s "
                f"({fps:,.0f} frames/s) [h2d {tim['h2d_s']:.3f}s, prep "
                f"{tim['host_prep_s']:.3f}s, wait {tim['wait_s']:.3f}s]"
            )
            feats = feats.reshape(n_snr, n_frames, NUM_FEATURES)
            io_mat.save_features(cfg, mod, feats)
            results[mod] = feats
    finally:
        loader.shutdown(wait=True)
    return results
