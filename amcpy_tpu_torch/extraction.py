"""Extraction runtime: ``.mat`` dataset -> per-modulation feature artifacts.

Counterpart of ``amcpy_tpu/extraction.py`` on one device. Frames are
planarized on the host by a prefetch thread into pinned buffers, copied to
the device with ``non_blocking=True`` chunk by chunk, and run through the
extractor that :func:`resolve_kernel` picks; chunk k+1 is prepared while
chunk k is copied and computed. The per-modulation ``.mat`` artifacts keep
the reference layout, and a re-run skips modulations whose artifact
exists (``force=True`` overrides) and recomputes a corrupt one.

:func:`run_extraction` reads each modulation by ``data/io_mat.py``'s direct
route where the file allows it (an uncompressed MAT v5 variable): its loader
thread reads the raw I and Q planes, in the file's order, straight into
pinned buffers (:func:`prepare_file_planes`), and :func:`extract_batch`
copies each plane whole and reorders it into frames on the device before
the chunks run; no host pass touches the samples. Other files, and the
``int24``/``int16`` wire, take ``scipy.io.loadmat`` and :func:`prepare_frames`.

``wire_format`` ``int24`` or ``int16`` (``ops/wire.py``) applies, as in the
JAX package, only on the fused route (K1) with a factorizable N: the host
encodes each chunk's planes into block-float integers, they cross through
the same pinned buffers, and the device decodes them just before K1. Any
other route uploads float32, and ``timings["wire"]`` says which format ran.

:func:`run_extraction_synthetic` draws the frames on the device
(``data/synth.py``) and feeds them to the same per-chunk extractor, so no
raw IQ crosses the host boundary; only the features come back.
``run_extraction(profile_dir=...)`` records the extraction with
``torch.profiler`` (every thread, the loader's too) and writes a Chrome
trace. Its spans (``utils/metrics.py``): ``amc.extract.pass`` (the call),
``amc.extract.load_wait`` (waiting on the loader), the loader's
``amc.io.load_modulation`` (``direct`` 1 on the direct route, else 0) and
``amc.extract.prepare``, ``amc.extract`` (the stage on the device; its
record's ``mat_read`` names the route) and ``amc.io.save_features``.

With a process group up, :func:`run_extraction` takes the JAX package's
multi-device routes (``extraction.py:570-583``, ``:666-710``):

* round-robin, on a mesh whose ``seq`` axis is 1: modulation k goes to rank
  ``k % W`` and is extracted on that rank's own device (K1 on a card) with
  no collective; after a barrier each owner broadcasts the shape and then
  the features of its modulations, and a rank that lacks an artifact
  writes it, so every rank ends with all six on a filesystem of its own or
  a shared one;
* sequence-parallel, on a mesh whose ``seq`` axis is more than 1 (the
  counterpart of the JAX package's single-process ``(data, seq)`` mesh):
  every rank runs every modulation; each chunk is padded to a multiple of
  ``64 * n_data`` rows, each rank takes its (data, seq) block to
  :func:`~amcpy_tpu_torch.parallel.sp.extract_features_sp` and the data
  blocks' features are all-gathered; rank 0 writes the artifacts and the
  others write theirs where the file is absent.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data import io_mat
from amcpy_tpu_torch.ops.features import NUM_FEATURES, extract_features_planar
from amcpy_tpu_torch.ops.fft import best_factorization
from amcpy_tpu_torch.ops.wire import decode_planes, encode_planes, resolve_wire_format
from amcpy_tpu_torch.parallel.audit import all_gather, all_reduce, barrier, broadcast
from amcpy_tpu_torch.parallel.mesh import group_up, is_primary, make_mesh, pad_to_multiple
from amcpy_tpu_torch.utils.device import resolve_device
from amcpy_tpu_torch.utils.metrics import MetricsLogger, span, stage_timer

__all__ = [
    "extract_batch",
    "prepare_frames",
    "prepare_file_planes",
    "PreparedBatch",
    "resolve_kernel",
    "run_extraction",
    "run_extraction_synthetic",
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


def _settle_wire(kernel: str, wire: str, frame_size: int, device: torch.device) -> str:
    """The codec this call runs: ``wire`` only where the fused route (K1)
    takes the frames, which needs a factorizable N; else ``"f32"``."""
    wire = resolve_wire_format(wire)
    if (
        wire == "f32"
        or resolve_kernel(kernel, device) != "fused"
        or best_factorization(frame_size) is None
    ):
        return "f32"
    return wire


def _kernel_fn(
    kernel: str,
    normalize_scale: bool,
    gmax_mode: str,
    device: torch.device,
    wire: str = "f32",
) -> tuple[Callable[..., torch.Tensor], bool]:
    """The per-chunk extractor for ``kernel`` and whether it takes separate
    ``(B, N)`` I and Q planes (``wants_planes``) or packed ``(B, 2, N)``.
    With a settled ``wire`` codec (:func:`_settle_wire`) the fused route
    takes the encoded arrays and decodes them on the device first."""
    kernel = resolve_kernel(kernel, device)
    if kernel == "fused":
        from amcpy_tpu_torch.ops.fused import extract_features_fused_any

        def fused(i, q):
            return extract_features_fused_any(
                i, q, normalize_scale=normalize_scale, gmax_mode=gmax_mode
            )

        if wire != "f32":
            return (lambda *enc: fused(*decode_planes(*enc, fmt=wire))), True
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
    frames_slice: np.ndarray, wants_planes: bool, pin: bool, wire: str = "f32"
) -> tuple[torch.Tensor, ...]:
    """Host phase of one chunk: split into I/Q planes (encoded for the wire
    when ``wire`` is a codec) or pack to ``(B, 2, N)``, in page-locked
    memory when the device is a card (so the copy can run asynchronously).
    Pure host work, safe on a thread."""
    if wire != "f32":
        from amcpy_tpu_torch.ops.fused import split_planes

        enc = encode_planes(*split_planes(frames_slice), wire)
        return tuple(torch.from_numpy(e).pin_memory() if pin else torch.from_numpy(e)
                     for e in enc)
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
    :func:`prepare_frames` or :func:`prepare_file_planes`, typically on a
    loader thread)."""

    __slots__ = ("b", "frame_size", "wire", "wants_planes", "chunks", "prep_s",
                 "file_order", "rows")

    def __init__(self, b, frame_size, wire, wants_planes, chunks, prep_s,
                 file_order=None, rows=None):
        self.b = b
        self.frame_size = frame_size
        self.wire = wire
        self.wants_planes = wants_planes
        #: list of (start_row, payload_tensors)
        self.chunks = chunks
        self.prep_s = prep_s
        #: ``(S, F)`` where ``chunks`` is one payload of a ``.mat``
        #: variable's raw planes in the file's order, reordered on the
        #: device and run ``rows`` frames a chunk; None where each payload
        #: holds its chunk's frames
        self.file_order = file_order
        self.rows = rows


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
    wire = _settle_wire(kernel, wire, frames.shape[-1], dev)
    if chunk_size is None:
        chunk_size = _default_chunk_size(dev, frames.shape[-1])
    wants_planes = resolve_kernel(kernel, dev) == "fused"
    pin = dev.type == "cuda"
    chunks = [
        (start, _prep_chunk(frames[start : start + chunk_size], wants_planes, pin, wire))
        for start in range(0, frames.shape[0], chunk_size)
    ]
    return PreparedBatch(
        frames.shape[0], frames.shape[-1], wire, wants_planes, chunks,
        time.perf_counter() - t0,
    )


def prepare_file_planes(
    re: torch.Tensor,
    im: torch.Tensor,
    s: int,
    f: int,
    *,
    chunk_size: int | None = None,
    kernel: str = "xla",
    device: "str | torch.device | None" = None,
) -> PreparedBatch:
    """A :class:`PreparedBatch` of a ``.mat`` variable's raw planes as
    :func:`io_mat.read_planes <amcpy_tpu_torch.data.io_mat.read_planes>`
    gives them (``(n, F*S)`` each, the file's order, in pinned memory for a
    card): :func:`extract_batch` copies each whole, reorders it into ``S*F``
    frames on the device and runs chunks of ``chunk_size`` frames. There is
    no host phase. The caller passes the SAME ``kernel`` and ``device`` to
    ``extract_batch``."""
    dev = resolve_device(device)
    n = re.shape[0]
    return PreparedBatch(
        s * f, n, "f32", resolve_kernel(kernel, dev) == "fused", [(0, (re, im))], 0.0,
        file_order=(s, f), rows=chunk_size or _default_chunk_size(dev, n),
    )


def _file_order_chunks(planes: list, order, rows: int, wants_planes: bool):
    """(start_row, kernel arguments) of each chunk of ``rows`` frames of a
    file-order payload's planes, reordered on their device. It takes the
    list's planes out one at a time, so that each raw plane is freed once
    reordered: one plane more on the device than the frames alone."""
    i = io_mat.planes_to_frames(planes.pop(0), *order)
    q = io_mat.planes_to_frames(planes.pop(0), *order)
    for lo in range(0, i.shape[0], rows):
        ci, cq = i[lo : lo + rows], q[lo : lo + rows]
        yield lo, ((ci, cq) if wants_planes else (torch.stack((ci, cq), 1),))


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
    once at the end. A :class:`PreparedBatch` skips the host phase; one of
    :func:`prepare_file_planes` is copied whole and reordered into frames
    on the device.

    ``wire`` — ``int24`` or ``int16`` sends block-float integers that the
    device decodes before K1, on the fused route with a factorizable N;
    every other call sends float32 (``auto`` is float32).

    ``timings`` — optional dict, filled with the phase split of the host
    path: ``host_prep_s`` (time BLOCKED on prep), ``prep_total_s`` (all
    prep, overlapped or not), ``h2d_s`` (the copies: on a card the device
    seconds between a pair of timing events around each chunk's copies,
    read once the features are fetched, so no synchronization is added;
    an upper bound on the copy time, as it also holds the copy engine's
    start and any idle of the stream between the events, where a profiler
    trace's memcpy records give the copies alone; on the CPU the host
    seconds of the copy calls), ``wait_s`` (the host blocked on the final
    fetch: compute plus any copy backlog), ``bytes_h2d`` and ``wire``.
    The timing events are made only when ``timings`` is given.
    """
    dev = resolve_device(device)
    t_prep = prep_total = 0.0
    prep_exec: cf.ThreadPoolExecutor | None = None
    file_order = None
    if isinstance(frames, PreparedBatch):
        prepared = frames
        b = prepared.b
        wire = prepared.wire
        wants_planes = prepared.wants_planes
        prep_total = prepared.prep_s
        file_order = prepared.file_order

        def chunk_stream():
            yield from prepared.chunks
    else:
        frames = np.asarray(frames)
        b = frames.shape[0]
        wire = _settle_wire(kernel, wire, frames.shape[-1], dev)
        if chunk_size is None:
            chunk_size = _default_chunk_size(dev, frames.shape[-1])
        wants_planes = resolve_kernel(kernel, dev) == "fused"
        starts = list(range(0, b, chunk_size))
        prep_exec = cf.ThreadPoolExecutor(1)
        pin = dev.type == "cuda"

        def _prep(start):
            t0 = time.perf_counter()
            payload = _prep_chunk(
                frames[start : start + chunk_size], wants_planes, pin, wire
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

    kern, wants_k = _kernel_fn(kernel, normalize_scale, gmax_mode, dev, wire)
    if wants_k != wants_planes:
        raise ValueError(
            "prepared batch routing does not match this kernel: prepare "
            "and extract with the same kernel and device"
        )
    out_dev = torch.empty((b, NUM_FEATURES), dtype=torch.float32, device=dev)
    t_h2d = 0.0
    # timing events around each chunk's copies, on a card and when asked
    events = timings is not None and dev.type == "cuda"
    copies: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
    bytes_h2d = 0
    try:
        for start, payload in chunk_stream():
            if events:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t1 = time.perf_counter()
            arrs = [t.to(dev, non_blocking=True) for t in payload]
            t_h2d += time.perf_counter() - t1
            if events:
                ev[1].record()
                copies.append(ev)
            bytes_h2d += sum(t.numel() * t.element_size() for t in payload)
            parts = ([(start, arrs)] if file_order is None else
                     _file_order_chunks(arrs, file_order, prepared.rows, wants_planes))
            for lo, args in parts:
                feats = kern(*args)
                out_dev[lo : lo + feats.shape[0]] = feats
        t3 = time.perf_counter()
        out = out_dev.cpu().numpy()
        t_wait = time.perf_counter() - t3
        if copies:
            t_h2d = sum(e0.elapsed_time(e1) for e0, e1 in copies) / 1e3
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
    profile_dir: str | None = None,
    device: "str | torch.device | None" = None,
) -> dict[str, np.ndarray]:
    """Extract features for every modulation in the dataset.

    Returns ``{modulation: (num_snr, num_frames, 18) float32}`` and writes
    the per-modulation ``{MOD}_features.mat`` artifacts. ``profile_dir``:
    the extraction of every modulation runs under ``torch.profiler`` (host
    and, on a card, device activity) and its Chrome trace is written to
    ``profile_dir/extract_trace.json``. With a process group up, every rank
    calls it and every rank returns all six (the round-robin and
    sequence-parallel routes of the module docstring).
    """
    dev = resolve_device(device)
    resolve_wire_format(cfg.compute.wire_format)
    cfg.paths.ensure_dirs()
    if logger is None:
        logger = MetricsLogger(cfg.paths.metrics / "run.jsonl")
    all_mods = list(cfg.signals.modulations_with_noise)
    rank, world = 0, 1
    if group_up():
        mesh = make_mesh(cfg)
        if mesh.size(1) > 1:
            return _run_extraction_sp(cfg, mesh, force, logger, dev)
        rank, world = dist.get_rank(), dist.get_world_size()

    results: dict[str, np.ndarray] = {}
    todo: list[str] = []
    for mod in all_mods[rank::world]:
        loaded = _load_artifact(cfg, mod, force, logger)
        if loaded is None:
            todo.append(mod)
        else:
            results[mod] = loaded

    mat_path = cfg.paths.mat_data / cfg.paths.mat_filename
    kernel, wire, frame_size = cfg.compute.kernel, cfg.compute.wire_format, cfg.signals.frame_size

    # a loader thread reads and prepares modulation k+1 while k is on the
    # device; its spans are the pass's children. The direct route reads the
    # raw planes (reordered on the device), where the file and the wire allow
    def _load_prepared(mod: str, parent: int | None):
        with span("amc.io.load_modulation", parent=parent) as sp:
            layout = io_mat.locate_planes(mat_path, cfg.signals.mat_info[mod])
            if layout is not None and _settle_wire(
                kernel, wire, min(layout.dims[2], frame_size), dev
            ) == "f32":
                planes = io_mat.read_planes(mat_path, layout, frame_size,
                                            pin=dev.type == "cuda")
                shape, nbytes = (*layout.dims[:2], planes[0].shape[0]), 2 * planes[0].nbytes
            else:
                planes, raw = None, io_mat.load_modulation(cfg, mod)  # (S, F, N)
                shape, nbytes = raw.shape, raw.nbytes
            sp.set(bytes=nbytes, direct=int(planes is not None))
        with span("amc.extract.prepare", parent=parent, frames=shape[0] * shape[1],
                  bytes=nbytes):
            if planes is not None:
                return shape, prepare_file_planes(*planes, *shape[:2], kernel=kernel,
                                                  device=dev)
            return shape, prepare_frames(raw.reshape(-1, shape[-1]), kernel=kernel,
                                         wire=wire, device=dev)

    prof = _profiler(dev) if profile_dir else contextlib.nullcontext()
    loader = cf.ThreadPoolExecutor(1)
    try:
        with prof, span("amc.extract.pass") as pas:
            fut = loader.submit(_load_prepared, todo[0], pas.id) if todo else None
            for k, mod in enumerate(todo):
                with span("amc.extract.load_wait", wait=True):
                    (n_snr, n_frames, _), prepared = fut.result()
                fut = (
                    loader.submit(_load_prepared, todo[k + 1], pas.id)
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
                    rec["mat_read"] = "loadmat" if prepared.file_order is None else "direct"
                    rec.update(tim)
                fps = rec["frames"] / max(rec["wall_s"], 1e-9)
                print(
                    f"[{mod}] {rec['frames']} frames in {rec['wall_s']:.2f}s "
                    f"({fps:,.0f} frames/s) [h2d {tim['h2d_s']:.3f}s, prep "
                    f"{tim['host_prep_s']:.3f}s, wait {tim['wait_s']:.3f}s]"
                )
                feats = feats.reshape(n_snr, n_frames, NUM_FEATURES)
                with span("amc.io.save_features", bytes=feats.nbytes):
                    io_mat.save_features(cfg, mod, feats)
                results[mod] = feats
            pas.set(frames=sum(results[m][..., 0].size for m in todo))
    finally:
        loader.shutdown(wait=True)
    if profile_dir:
        out = Path(profile_dir) / "extract_trace.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
        print(f"Profiler trace -> {out}")
    if group_up():
        _share_round_robin(cfg, results, all_mods, world)
    return results


def _load_artifact(cfg: Config, mod: str, force: bool, logger: MetricsLogger):
    """``mod``'s features from its artifact, or None where it must be
    computed: absent, ``force``, or corrupt (logged and recomputed)."""
    out_path = cfg.paths.calculated_features / f"{mod}_features.mat"
    if not out_path.exists() or force:
        return None
    try:
        feats = io_mat.load_features(cfg, mod)
    except Exception as exc:  # corrupt artifact: recompute
        logger.log("extract_corrupt_artifact", modulation=mod, error=repr(exc))
        print(f"[{mod}] corrupt artifact, recomputing: {exc}")
        return None
    logger.log("extract_skip", modulation=mod, path=str(out_path))
    return feats


def _share_round_robin(cfg: Config, results: dict, all_mods: list[str], world: int) -> None:
    """After a barrier, modulation k's owner (rank ``k % world``) broadcasts
    its features' shape (int64[3]) and then the float32 features; a rank
    without them keeps them and writes the artifact where it is absent."""
    barrier()
    for k, mod in enumerate(all_mods):
        owner = k % world
        mine = results.get(mod)
        shape = torch.tensor(mine.shape if mine is not None else (0, 0, 0), dtype=torch.int64)
        shape = tuple(broadcast(shape, owner).tolist())
        src = (torch.from_numpy(np.ascontiguousarray(mine, np.float32)) if mine is not None
               else torch.zeros(shape, dtype=torch.float32))
        got = broadcast(src, owner).numpy()
        if mine is None:
            results[mod] = got
            if not (cfg.paths.calculated_features / f"{mod}_features.mat").exists():
                io_mat.save_features(cfg, mod, got)


def _run_extraction_sp(cfg: Config, mesh, force: bool, logger: MetricsLogger,
                       dev: torch.device) -> dict[str, np.ndarray]:
    """The sequence-parallel route of :func:`run_extraction`: every rank
    runs every modulation that any rank lacks, its (data, seq) block of
    each chunk through ``extract_features_sp``."""
    from amcpy_tpu_torch.parallel.sp import extract_features_sp

    n_data, n_seq = mesh.size(0), mesh.size(1)
    d_idx = mesh.get_local_rank(mesh.mesh_dim_names[0])
    s_idx = mesh.get_local_rank(mesh.mesh_dim_names[1])
    data_group = mesh.get_group(mesh.mesh_dim_names[0])
    n = cfg.signals.frame_size
    if n % n_seq:
        raise ValueError(f"frame size {n} does not split over {n_seq} ranks of the seq axis")
    all_mods = list(cfg.signals.modulations_with_noise)
    results = {m: _load_artifact(cfg, m, force, logger) for m in all_mods}
    # the ranks' collectives must pair up: a modulation any rank lacks is
    # computed by all
    lacking = all_reduce(torch.tensor([float(v is None) for v in results.values()]), "max")
    todo = [m for m, flag in zip(all_mods, lacking.tolist()) if flag]
    chunk = _default_chunk_size(dev, n)
    cols = slice(s_idx * (n // n_seq), (s_idx + 1) * (n // n_seq))
    for mod in todo:
        with stage_timer(logger, "extract", device=dev, modulation=mod) as rec:
            raw = io_mat.load_modulation(cfg, mod)  # (S, F, N)
            frames = raw.reshape(-1, raw.shape[-1])
            feats = np.empty((frames.shape[0], NUM_FEATURES), np.float32)
            for start in range(0, frames.shape[0], chunk):
                part, orig = pad_to_multiple(frames[start : start + chunk], 64 * n_data)
                rows = slice(d_idx * (len(part) // n_data), (d_idx + 1) * (len(part) // n_data))
                block = part[rows, cols]
                i = torch.from_numpy(np.ascontiguousarray(block.real, np.float32)).to(dev)
                q = torch.from_numpy(np.ascontiguousarray(block.imag, np.float32)).to(dev)
                local = extract_features_sp(i, q, mesh, normalize_scale=cfg.compute.normalize_scale,
                                            gmax_mode=cfg.compute.gmax_mode)
                feats[start : start + orig] = all_gather(local, data_group)[:orig].cpu().numpy()
            rec["frames"] = int(frames.shape[0])
            rec["kernel"] = "sp"
        print(f"[{mod}] {rec['frames']} frames in {rec['wall_s']:.2f}s "
              f"(sequence-parallel, mesh {n_data} x {n_seq})")
        results[mod] = feats.reshape(*raw.shape[:2], NUM_FEATURES)
        if is_primary():
            io_mat.save_features(cfg, mod, results[mod])
    barrier()
    for mod in todo:
        if not (cfg.paths.calculated_features / f"{mod}_features.mat").exists():
            io_mat.save_features(cfg, mod, results[mod])
    return results


def _profiler(dev: torch.device):
    """``torch.profiler`` over the host activity of every thread (the
    loader's too) and, on a card, the device's."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def run_extraction_synthetic(
    cfg: Config,
    seed: int = 0,
    *,
    logger: MetricsLogger | None = None,
    device: "str | torch.device | None" = None,
) -> dict[str, np.ndarray]:
    """Generate on the device and extract in one pass: each modulation's
    frames are drawn in device memory by ``synth.gen_planes`` (the frames
    ``synth.write_dataset(cfg, seed)`` writes on the same device) and fed
    to the extractor of ``cfg.compute.kernel`` in chunks of
    :func:`_default_chunk_size` rows; only the ``(num_snr, num_frames,
    18)`` features come back. Writes the ``{MOD}_features.mat`` artifacts
    and logs one ``extract_synthetic`` record a modulation.

    One modulation is resident at a time (at the default size, 262 MB of
    planes). The JAX package pads each chunk to a multiple of its mesh's
    data axis; on one device there is nothing to pad, and the last chunk
    is simply shorter.
    """
    from amcpy_tpu_torch.data import synth

    dev = resolve_device(device)
    cfg.paths.ensure_dirs()
    if logger is None:
        logger = MetricsLogger(cfg.paths.metrics / "run.jsonl")
    s = cfg.signals
    kern, wants_planes = _kernel_fn(
        cfg.compute.kernel, cfg.compute.normalize_scale, cfg.compute.gmax_mode, dev
    )
    chunk = _default_chunk_size(dev, s.frame_size)
    results: dict[str, np.ndarray] = {}
    for mi, mod in enumerate(s.modulations_with_noise):
        with stage_timer(logger, "extract_synthetic", device=dev, modulation=mod) as rec:
            i, q = synth.gen_planes(
                synth.seeded_generator(seed * 1000 + mi, dev), synth.points_of(mod),
                s.snr_db, s.num_frames, s.frame_size, True, dev,
            )
            feats = np.empty((i.shape[0], NUM_FEATURES), dtype=np.float32)
            # a chunk's features are read back only once the next chunk is
            # queued, so the host's wait overlaps the device's work
            pending = None
            for start in range(0, i.shape[0], chunk):
                ci, cq = i[start : start + chunk], q[start : start + chunk]
                part = kern(ci, cq) if wants_planes else kern(torch.stack((ci, cq), 1))
                if pending is not None:
                    feats[pending[0] : pending[0] + len(pending[1])] = pending[1].cpu().numpy()
                pending = (start, part)
            if pending is not None:
                feats[pending[0] : pending[0] + len(pending[1])] = pending[1].cpu().numpy()
            del i, q
            rec["frames"] = int(feats.shape[0])
            rec["kernel"] = resolve_kernel(cfg.compute.kernel, dev)
        fps = rec["frames"] / max(rec["wall_s"], 1e-9)
        print(
            f"[{mod}] {rec['frames']} frames in {rec['wall_s']:.2f}s "
            f"({fps:,.0f} frames/s, on-device synthesis)"
        )
        feats = feats.reshape(s.num_snr, s.num_frames, NUM_FEATURES)
        io_mat.save_features(cfg, mod, feats)
        results[mod] = feats
    return results
