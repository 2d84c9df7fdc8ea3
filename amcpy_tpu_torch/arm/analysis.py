"""Embedded-deployment analysis: Python port of the reference's MATLAB
ARM tooling.

Counterpart of ``amcpy_tpu/arm/analysis.py``, in NumPy; matplotlib is
imported by the plotting functions only.

The reference analyzed microcontroller prediction dumps with four MATLAB
scripts (the original amcpy's ``arm-data/``): per-modulation accuracy counting
(``prediction.m:3-69``), per-SNR correct-prediction counting
(``embedded.m:9-29``), the SNR-accuracy plot with the 23.7% reference line
(``neural_networks_acc_plot.m:1-18``), and per-10-frame prediction binning
(``plot_predictions.m:1-52``). These functions provide the same analyses
natively (vectorized, any number of classes/SNRs) while still reading the
same ``.mat`` dumps the firmware produces.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from amcpy_tpu_torch.config import Config

__all__ = [
    "per_modulation_accuracy",
    "per_snr_counts",
    "bin_predictions",
    "plot_binned_predictions",
    "plot_embedded_accuracy",
    "load_prediction_dump",
]

#: Dashed "Reference" line of the embedded accuracy plot
#: (arm-data/neural_networks_acc_plot.m:10). Chance is 1/6 ~ 16.7%.
REFERENCE_ACCURACY_PERCENT = 23.7


def load_prediction_dump(path: str | Path, var: str = "Data") -> np.ndarray:
    """Read an MCU prediction dump ``.mat`` (cell array column 2 holds the
    predicted label ids, as consumed by ``prediction.m:3-14``)."""
    import scipy.io

    raw = scipy.io.loadmat(str(path))
    data = raw[var]
    if data.dtype == object:  # MATLAB cell array
        return np.array(
            [int(np.squeeze(c)) for c in data[:, 1, 0]], dtype=np.int64
        )
    return np.asarray(data).ravel().astype(np.int64)


def per_modulation_accuracy(
    predictions: dict[str, np.ndarray], cfg: Config | None = None
) -> dict[str, float]:
    """Percent of frames predicted as the modulation's true label.

    ``predictions`` maps modulation name -> 1-D array of predicted ids.
    Equivalent to the six counting loops of ``prediction.m:17-69`` (without
    reproducing its noise-accuracy denominator typo — noise accuracy there
    divides by the QAM64 frame count, ``prediction.m:67``).
    """
    cfg = cfg or Config()
    out = {}
    for label, mod in enumerate(cfg.signals.modulations_with_noise):
        if mod not in predictions:
            continue
        pred = np.asarray(predictions[mod])
        acc = 100.0 * np.count_nonzero(pred == label) / max(len(pred), 1)
        out[mod] = acc
        print(f"{mod} acc: {acc:.2f} % - {len(pred)} frames")
    return out


def per_snr_counts(
    predictions: dict[str, np.ndarray], cfg: Config | None = None
) -> np.ndarray:
    """Correct predictions per (modulation, SNR).

    ``predictions`` maps modulation -> ``(n_snr, frames_per_snr)`` arrays
    of predicted ids. Returns the correct-count matrix (``embedded.m:9-29``
    vectorized).
    """
    cfg = cfg or Config()
    mods = cfg.signals.modulations_with_noise
    n_snr = cfg.signals.num_snr
    counts = np.zeros((len(mods), n_snr), dtype=np.int64)
    for label, mod in enumerate(mods):
        if mod not in predictions:
            continue
        pred = np.asarray(predictions[mod])
        counts[label] = np.count_nonzero(pred == label, axis=-1)
    return counts


def bin_predictions(
    predictions: np.ndarray, n_bins: int = 16, target: int = 0
) -> np.ndarray:
    """Count ``target`` predictions per consecutive equal-size bin —
    the generalization of ``plot_predictions.m:1-52`` (which hard-coded
    160 predictions, 16 bins of 10, target class 0)."""
    pred = np.asarray(predictions).ravel()
    per = len(pred) // n_bins
    trimmed = pred[: per * n_bins].reshape(n_bins, per)
    return np.count_nonzero(trimmed == target, axis=-1)


def plot_binned_predictions(
    predictions: np.ndarray,
    cfg: Config | None = None,
    out_path: str | Path | None = None,
    *,
    n_bins: int = 16,
    target: int = 0,
    as_percent: bool = True,
):
    """Plot correct-prediction counts per consecutive bin — the rendering
    step of ``plot_predictions.m:17-52`` (hard-coded there: 160
    predictions, 16 bins of 10, target class 0; here the bins double as
    the SNR axis when ``n_bins`` matches the config's SNR count, which is
    how the MCU dumps are laid out)."""
    from amcpy_tpu_torch.graphics import pyplot

    plt = pyplot()

    cfg = cfg or Config()
    counts = bin_predictions(predictions, n_bins=n_bins, target=target)
    per_bin = len(np.asarray(predictions).ravel()) // n_bins
    y = 100.0 * counts / max(per_bin, 1) if as_percent else counts
    fig, ax = plt.subplots(figsize=(7, 4), dpi=150)
    if n_bins == cfg.signals.num_snr:
        x = np.asarray(cfg.signals.snr_db, dtype=float)
        ax.set_xlabel("SNR (dB)")
        ax.set_xticks(x)
    else:
        x = np.arange(1, n_bins + 1, dtype=float)
        ax.set_xlabel("Bin")
    mods = cfg.signals.modulations_with_noise
    name = mods[target] if target < len(mods) else str(target)
    ax.plot(x, y, "-o", color=COLORS_DEFAULT, linewidth=2)
    ax.set_ylabel(
        f"Correct predictions (%)" if as_percent else "Correct predictions"
    )
    ax.set_ylim(-2, 102 if as_percent else per_bin + 1)
    ax.set_title(f"Embedded predictions: {name}")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
        return Path(out_path)
    return fig


COLORS_DEFAULT = "#0066FF"


def plot_embedded_accuracy(
    acc_percent: np.ndarray,
    cfg: Config | None = None,
    out_path: str | Path | None = None,
    reference_line: float | None = REFERENCE_ACCURACY_PERCENT,
):
    """SNR-accuracy curves with the embedded reference line
    (``neural_networks_acc_plot.m:1-18``). ``acc_percent`` is
    ``(n_mods, n_snr)`` in percent."""
    from amcpy_tpu_torch.graphics import pyplot

    plt = pyplot()

    from amcpy_tpu_torch.graphics import COLORS

    cfg = cfg or Config()
    x = np.asarray(cfg.signals.snr_db, dtype=float)
    fig, ax = plt.subplots(figsize=(7, 4), dpi=150)
    for i, mod in enumerate(cfg.signals.modulations_with_noise):
        color = "k" if mod == "WGN" else COLORS[i % len(COLORS)]
        ax.plot(x, acc_percent[i], color=color, linewidth=2, label=mod)
    if reference_line is not None:
        ax.plot(
            x, np.full_like(x, reference_line), "k--", label="Reference"
        )
    ax.set_xlim(x[0], x[-1])
    ax.set_ylim(-2, 102)
    ax.set_xticks(x)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("Accuracy (%)")
    ax.legend(fontsize=9, loc="center left")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
        return Path(out_path)
    return fig
