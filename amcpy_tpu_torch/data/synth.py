"""Synthetic modulated-IQ dataset, drawn on the device.

Counterpart of ``amcpy_tpu/data/synth.py``: unit-power constellation
symbols, rotated by one uniform phase per frame, plus AWGN at each SNR
level, and unit-power complex white noise (the same at every level) as the
noise class, in the ``.mat`` layout of ``all_modulations.mat`` (variables
``signal_bpsk`` .. ``signal_noise``, each ``(num_snr, num_frames,
frame_size)`` complex64).

Every entry point draws through :func:`gen_planes`, from one explicit
``torch.Generator`` on the device, seeded ``seed * 1000 + mi`` for the
modulation at index ``mi``: symbol indices, then the per-frame phase
U[0, 2 pi), then the N(0, 1) noise of both planes. So a seed gives the
same frames on the same device whichever entry point draws them, and
:func:`amcpy_tpu_torch.extraction.run_extraction_synthetic` extracts
exactly the frames :func:`write_dataset` writes.

The frames are a function of (seed, device type): a CUDA generator
(Philox) and a CPU generator (mt19937) give different streams for one
seed, and neither matches ``jax.random``. The JAX package's frames and
these agree in distribution only; the tests hold them to each other on
statistics (noise power per SNR, constellation magnitudes, feature means).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.utils.device import resolve_device

__all__ = [
    "gen_planes",
    "seeded_generator",
    "generate_modulation",
    "generate_dataset",
    "write_dataset",
]


def _constellation(name: str) -> np.ndarray:
    """Unit-average-power constellation points."""
    if name == "BPSK":
        return np.array([1.0, -1.0], dtype=np.complex128)
    if name == "QPSK":
        return np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))
    if name == "8PSK":
        return np.exp(1j * (np.pi / 8 + np.pi / 4 * np.arange(8)))
    if name in ("16QAM", "QAM16"):
        lv = np.array([-3.0, -1.0, 1.0, 3.0])
        pts = (lv[:, None] + 1j * lv[None, :]).ravel()
        return pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    if name in ("64QAM", "QAM64"):
        lv = np.arange(-7.0, 8.0, 2.0)
        pts = (lv[:, None] + 1j * lv[None, :]).ravel()
        return pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    raise ValueError(f"unknown modulation {name!r}")


def points_of(name: str) -> np.ndarray | None:
    """The constellation of ``name``, or None for the noise class WGN."""
    return None if name == "WGN" else _constellation(name)


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def gen_planes(
    generator: torch.Generator,
    points: np.ndarray | None,
    snr_db: Sequence[float],
    num_frames: int,
    frame_size: int,
    random_phase: bool = True,
    device: "str | torch.device | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """I and Q planes ``(len(snr_db) * num_frames, frame_size)`` float32 on
    the device, rows ordered (SNR, frame).

    ``points`` (complex constellation) are drawn uniformly, each frame
    rotated by a phase from U[0, 2 pi) when ``random_phase`` (the phase is
    drawn either way, so the stream does not depend on the flag), plus
    N(0, 1) noise times ``sigma = sqrt(10^(-snr/10) / 2)`` per component.
    ``points=None`` is white noise, N(0, 1) / sqrt(2) per component,
    whatever the SNR. ``generator`` lives on the device and is advanced.
    """
    dev = resolve_device(device)
    snr = np.asarray(snr_db, dtype=np.float32)
    rows = len(snr) * num_frames
    shape = (rows, frame_size)
    if points is None:
        noise = torch.randn((2, *shape), generator=generator, device=dev)
        noise /= np.sqrt(2.0)
        return noise[0], noise[1]
    pts = np.asarray(points)
    table = torch.tensor(np.stack([pts.real, pts.imag]), dtype=torch.float32, device=dev)
    idx = torch.randint(0, len(pts), shape, generator=generator, device=dev)
    phase = torch.rand((rows, 1), generator=generator, device=dev) * (2.0 * np.pi)
    noise = torch.randn((2, *shape), generator=generator, device=dev)
    sym_re, sym_im = table[0][idx], table[1][idx]
    del idx
    if random_phase:
        c, s = torch.cos(phase), torch.sin(phase)
        sym_re, sym_im = sym_re * c - sym_im * s, sym_re * s + sym_im * c
    sigma = np.sqrt(10.0 ** (-snr / 10.0) / 2.0).astype(np.float32)
    sigma = torch.from_numpy(sigma).to(dev).repeat_interleave(num_frames)[:, None]
    i = noise[0].mul_(sigma).add_(sym_re)
    q = noise[1].mul_(sigma).add_(sym_im)
    return i, q


def generate_modulation(
    name: str,
    cfg: Config,
    seed: int,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """One modulation's frames: ``(num_snr, num_frames, frame_size)``
    complex64 on the host, fetched from the device one SNR level at a
    time."""
    dev = resolve_device(device)
    s = cfg.signals
    i, q = gen_planes(
        seeded_generator(seed, dev), points_of(name), s.snr_db, s.num_frames,
        s.frame_size, True, dev,
    )
    out = np.empty((s.num_snr, s.num_frames, s.frame_size), dtype=np.complex64)
    for si in range(s.num_snr):
        rows = slice(si * s.num_frames, (si + 1) * s.num_frames)
        out.real[si] = i[rows].cpu().numpy()
        out.imag[si] = q[rows].cpu().numpy()
    return out


def generate_dataset(
    cfg: Config, seed: int = 0, device: "str | torch.device | None" = None
) -> dict[str, np.ndarray]:
    """All modulations keyed by their ``.mat`` variable names."""
    return {
        cfg.signals.mat_info[mod]: generate_modulation(mod, cfg, seed * 1000 + mi, device)
        for mi, mod in enumerate(cfg.signals.modulations_with_noise)
    }


def write_dataset(
    cfg: Config, seed: int = 0, device: "str | torch.device | None" = None
) -> str:
    """Generate and write ``mat-data/all_modulations.mat``."""
    import scipy.io

    cfg.paths.ensure_dirs()
    path = cfg.paths.mat_data / cfg.paths.mat_filename
    scipy.io.savemat(str(path), generate_dataset(cfg, seed, device))
    return str(path)
