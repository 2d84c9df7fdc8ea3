"""The benchmark's traffic generator: seeded IQ frames of the signal set.

A copy of ``chip_smoke.py::make_dataset`` (unit-power constellation
symbols plus complex AWGN at each SNR; WGN is the noise alone), made
vectorized and chunked: frames are drawn in chunks of ``CHUNK`` from
``np.random.default_rng([seed, stream, chunk])``, so a seed and a stream
give the same frames on any machine and at any size of a later chunk.
Symbols are drawn as indices below 64 and reduced modulo each
constellation's size (every size divides 64, so each point stays equally
likely). Everything is complex64 on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["constellation", "make_frames", "make_pool", "make_dataset"]

MODS_POINTS = {
    "BPSK": np.array([-1, 1], np.complex128),
    "QPSK": np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))),
    "8PSK": np.exp(1j * np.pi / 4 * np.arange(8)),
    "16QAM": None,
    "64QAM": None,
}
#: frames drawn from one generator
CHUNK = 4096


def _qam(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    lv = np.arange(side) * 2.0 - (side - 1)
    pts = (lv[:, None] + 1j * lv[None, :]).reshape(-1)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def constellation(mod: str) -> np.ndarray | None:
    """Unit-power points of ``mod``; None for WGN (noise alone)."""
    if mod == "WGN":
        return None
    pts = MODS_POINTS.get(mod)
    if pts is None:
        pts = _qam(int(mod.removesuffix("QAM")))
    return pts


def _table(mods: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """(classes, 64) complex64 symbols by index modulo the constellation's
    size (zeros for WGN), and whether each class is WGN."""
    table = np.zeros((len(mods), 64), np.complex64)
    wgn = np.zeros(len(mods), bool)
    for c, mod in enumerate(mods):
        pts = constellation(mod)
        if pts is None:
            wgn[c] = True
        else:
            table[c] = pts[np.arange(64) % len(pts)]
    return table, wgn


def make_frames(seed: int, stream: int, classes: np.ndarray, snr_db: np.ndarray,
                n: int, mods: list[str]) -> np.ndarray:
    """``(len(classes), n)`` complex64 frames: frame k of class
    ``classes[k]`` at ``snr_db[k]``."""
    classes = np.asarray(classes)
    snr_db = np.asarray(snr_db, np.float64)
    table, wgn = _table(mods)
    out = np.empty((len(classes), n), np.complex64)
    for c, lo in enumerate(range(0, len(classes), CHUNK)):
        rng = np.random.default_rng([seed, stream, c])
        cls = classes[lo : lo + CHUNK]
        noise = rng.standard_normal((len(cls), n, 2), dtype=np.float32)
        noise *= np.float32(np.sqrt(0.5))
        idx = rng.integers(0, 64, (len(cls), n), dtype=np.uint8)
        sigma = np.where(wgn[cls], 1.0, np.sqrt(10 ** (-snr_db[lo : lo + CHUNK] / 10)))
        part = out[lo : lo + len(cls)]
        part.real = noise[..., 0]
        part.imag = noise[..., 1]
        part *= sigma.astype(np.float32)[:, None]
        part += table[cls[:, None], idx]
    return out


def make_pool(seed: int, frames: int, n: int, mods: list[str],
              snr_db: list[float]) -> tuple[np.ndarray, np.ndarray]:
    """A pool of distinct frames over every class and SNR: frame k of class
    ``k % len(mods)`` at SNR ``snr_db[(k // len(mods)) % len(snr_db)]``.
    Returns the frames and their classes."""
    k = np.arange(frames)
    classes = k % len(mods)
    snr = np.asarray(snr_db, np.float64)[(k // len(mods)) % len(snr_db)]
    return make_frames(seed, 0, classes, snr, n, mods), classes


def make_dataset(seed: int, frames_per: int, n: int, mods: list[str],
                 snr_db: list[float]) -> dict[str, np.ndarray]:
    """``{mod: (len(snr_db), frames_per, n) complex64}``, the layout of
    ``all_modulations.mat``; modulation m is stream ``m + 1``."""
    out = {}
    snr = np.repeat(np.asarray(snr_db, np.float64), frames_per)
    for m, mod in enumerate(mods):
        cls = np.full(len(snr), m)
        out[mod] = make_frames(seed, m + 1, cls, snr, n, mods).reshape(
            len(snr_db), frames_per, n)
    return out
