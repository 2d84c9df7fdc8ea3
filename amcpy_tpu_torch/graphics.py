"""Visualisation: feature curves, training history, accuracy and confusion
matrices.

Counterpart of ``amcpy_tpu/graphics.py``: per-feature mean-vs-SNR PNGs,
mean ± std error bars, an all-features HTML page (plotly when present,
else matplotlib panels), training history, per-SNR accuracy, the
float-versus-int16 overlay and the confusion-matrix heatmap.

matplotlib is imported inside the functions that draw, never with this
module: a machine without it (the card's) still gets the numbers.
:func:`run_plots` always writes ``figures/features/feature_stats.mat``
(mean and std of the 18 features per modulation and SNR) and draws only
where matplotlib imports; :func:`have_matplotlib` says which.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from amcpy_tpu_torch.config import FEATURE_NAMES, Config

#: Fixed per-modulation colors (5 reference colors + one for WGN).
COLORS = ["#2F8000", "#DEAA0B", "#FF3300", "#AD00E6", "#0066FF", "#555555"]

__all__ = [
    "COLORS",
    "feature_stats",
    "have_matplotlib",
    "plot_means",
    "plot_errorbars",
    "generate_html_plot",
    "plot_history",
    "plot_accuracy_by_snr",
    "plot_quantization_comparison",
    "plot_confusion_matrix",
    "run_plots",
    "save_feature_stats",
]


def have_matplotlib() -> bool:
    """Whether matplotlib imports here (figures are drawn only then)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend (raises ImportError where
    matplotlib is absent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({"text.usetex": False, "mathtext.fontset": "dejavusans"})
    return plt


def feature_stats(
    features: dict[str, np.ndarray], cfg: Config
) -> tuple[np.ndarray, np.ndarray]:
    """Per-(mod, snr, used-feature) mean and std across frames, one
    vectorized reduction. Returns two ``(n_mods, n_snr, n_used)`` arrays."""
    cols = list(cfg.features.used_columns)
    data = np.stack(
        [features[m][:, :, cols] for m in cfg.signals.modulations_with_noise]
    )  # (M, S, F, U)
    return data.mean(axis=2), data.std(axis=2)


def save_feature_stats(
    features: dict[str, np.ndarray], cfg: Config, out_dir: Path | None = None
) -> Path:
    """Write ``feature_stats.mat``: ``mean`` and ``std`` across frames of
    all 18 features, ``(n_mods, n_snr, 18)``, with the modulations, the
    SNR levels, the feature names and the 0-based columns the plots and
    the classifier use."""
    import scipy.io

    data = np.stack([features[m] for m in cfg.signals.modulations_with_noise])
    out_dir = out_dir or cfg.paths.feature_figures
    out_dir.mkdir(parents=True, exist_ok=True)
    p = out_dir / "feature_stats.mat"
    scipy.io.savemat(str(p), {
        "mean": data.mean(axis=2), "std": data.std(axis=2),
        "modulations": list(cfg.signals.modulations_with_noise),
        "snr_db": np.asarray(cfg.signals.snr_db, dtype=float),
        "features": [FEATURE_NAMES[f] for f in range(1, data.shape[-1] + 1)],
        "used_columns": np.asarray(cfg.features.used_columns),
    })
    return p


def _snr_ticks(cfg: Config) -> tuple[np.ndarray, list[str]]:
    vals = np.asarray(cfg.signals.snr_db, dtype=float)
    return vals, [str(v) for v in cfg.signals.snr_db]


def plot_means(
    mean: np.ndarray, cfg: Config, out_dir: Path | None = None
) -> list[Path]:
    plt = pyplot()
    out_dir = out_dir or cfg.paths.feature_figures
    out_dir.mkdir(parents=True, exist_ok=True)
    x, ticks = _snr_ticks(cfg)
    mods = cfg.signals.modulations_with_noise
    paths = []
    for n in range(mean.shape[-1]):
        fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
        for i, mod in enumerate(mods):
            ax.plot(x, mean[i, :, n], COLORS[i % len(COLORS)], linewidth=1.0,
                    label=mod)
        ax.set_xlabel("SNR [dB]")
        ax.set_xticks(x, ticks)
        ax.set_ylabel(
            cfg.features.used_names[n], rotation=0, fontsize=15, labelpad=20
        )
        ax.legend()
        p = out_dir / f"ft{cfg.features.used[n]}_mean.png"
        fig.savefig(p, bbox_inches="tight", dpi=300)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_errorbars(
    mean: np.ndarray, std: np.ndarray, cfg: Config, out_dir: Path | None = None
) -> list[Path]:
    plt = pyplot()
    out_dir = out_dir or cfg.paths.feature_figures
    out_dir.mkdir(parents=True, exist_ok=True)
    x, ticks = _snr_ticks(cfg)
    mods = cfg.signals.modulations_with_noise
    paths = []
    for n in range(mean.shape[-1]):
        fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
        for i, mod in enumerate(mods):
            ax.errorbar(
                x, mean[i, :, n], yerr=std[i, :, n],
                color=COLORS[i % len(COLORS)], linewidth=1.0, label=mod,
            )
        ax.set_xlabel("SNR [dB]")
        ax.set_xticks(x, ticks)
        ax.set_ylabel(
            cfg.features.used_names[n], rotation=0, fontsize=15, labelpad=20
        )
        ax.legend()
        p = out_dir / f"ft{cfg.features.used[n]}_err.png"
        fig.savefig(p, bbox_inches="tight", dpi=300)
        plt.close(fig)
        paths.append(p)
    return paths


def generate_html_plot(
    mean: np.ndarray, cfg: Config, out_dir: Path | None = None
) -> Path:
    """All-features page: plotly when it imports, otherwise a
    self-contained HTML page embedding matplotlib panels."""
    out_dir = out_dir or cfg.paths.feature_figures
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "all_plots.html"
    mods = cfg.signals.modulations_with_noise
    x, _ = _snr_ticks(cfg)
    n_ft = mean.shape[-1]
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        rows = (n_ft + 4) // 5
        fig = make_subplots(
            rows=rows, cols=min(5, n_ft),
            subplot_titles=cfg.features.used_names,
        )
        for ft in range(n_ft):
            r, c = ft // 5 + 1, ft % 5 + 1
            for i, mod in enumerate(mods):
                fig.add_trace(
                    go.Scatter(
                        x=x, y=mean[i, :, ft], name=mod, legendgroup=mod,
                        showlegend=ft == 0,
                        line={"color": COLORS[i % len(COLORS)]},
                    ),
                    row=r, col=c,
                )
        fig.update_layout(width=1920, height=1080,
                          legend={"orientation": "h", "y": 1.05})
        fig.write_html(str(out_path))
        return out_path
    except ImportError:
        pass

    import base64
    import io

    plt = pyplot()
    panels = []
    for ft in range(n_ft):
        fig, ax = plt.subplots(figsize=(5, 3), dpi=100)
        for i, mod in enumerate(mods):
            ax.plot(x, mean[i, :, ft], COLORS[i % len(COLORS)], label=mod)
        ax.set_title(cfg.features.used_names[ft])
        ax.set_xlabel("SNR [dB]")
        if ft == 0:
            ax.legend(fontsize=7)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", bbox_inches="tight")
        plt.close(fig)
        panels.append(base64.b64encode(buf.getvalue()).decode())
    body = "\n".join(
        f'<img src="data:image/png;base64,{p}" style="width:32%">'
        for p in panels
    )
    out_path.write_text(
        f"<html><body><h1>AMC features vs SNR</h1>{body}</body></html>"
    )
    return out_path


def plot_history(
    history: dict[str, list[float]], model_id: str, cfg: Config
) -> Path:
    plt = pyplot()
    cfg.paths.ensure_dirs()
    epochs = range(1, len(history["loss"]) + 1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(epochs, history["accuracy"], label="Train")
    ax1.plot(epochs, history["val_accuracy"], label="Test")
    ax1.set(title="Model accuracy", xlabel="Epoch", ylabel="Accuracy")
    ax1.legend(loc="best")
    ax2.plot(epochs, history["loss"], label="Train")
    ax2.plot(epochs, history["val_loss"], label="Test")
    ax2.set(title="Model loss", xlabel="Epoch", ylabel="Loss")
    ax2.legend(loc="best")
    fig.tight_layout()
    p = cfg.paths.figures / f"history-{model_id}.png"
    fig.savefig(p, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return p


def plot_accuracy_by_snr(acc: np.ndarray, model_id: str, cfg: Config) -> Path:
    plt = pyplot()
    cfg.paths.ensure_dirs()
    fig, ax = plt.subplots(figsize=(6, 3), dpi=150)
    x, ticks = _snr_ticks(cfg)
    for i, mod in enumerate(cfg.signals.modulations_with_noise):
        ax.plot(x, acc[i] * 100, label=mod, color=COLORS[i % len(COLORS)])
    ax.set_ylabel("Accuracy (%)")
    ax.set_xlabel("SNR [dB]")
    ax.set_xticks(x, ticks)
    ax.legend(loc="best")
    p = cfg.paths.figures / f"accuracy-{model_id}.png"
    fig.savefig(p, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return p


def plot_quantization_comparison(
    acc_float: np.ndarray, acc_q: np.ndarray, model_id: str, cfg: Config
) -> Path:
    """Float32 against int16 fixed-point per-SNR accuracy on one figure
    (``quantize --compare``): float solid, int16 dashed, one color per
    modulation."""
    plt = pyplot()
    cfg.paths.ensure_dirs()
    fig, ax = plt.subplots(figsize=(6, 3), dpi=150)
    x, ticks = _snr_ticks(cfg)
    for i, mod in enumerate(cfg.signals.modulations_with_noise):
        c = COLORS[i % len(COLORS)]
        ax.plot(x, acc_float[i] * 100, color=c, label=mod)
        ax.plot(x, acc_q[i] * 100, color=c, linestyle="--", alpha=0.8)
    ax.plot([], [], color="k", label="float32")
    ax.plot([], [], color="k", linestyle="--", label="int16 Q-format")
    ax.set_ylabel("Accuracy (%)")
    ax.set_xlabel("SNR [dB]")
    ax.set_xticks(x, ticks)
    ax.legend(loc="best", fontsize=7, ncol=2)
    p = cfg.paths.figures / f"quant-accuracy-{model_id}.png"
    fig.savefig(p, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return p


def plot_confusion_matrix(
    cm: np.ndarray, model_id: str, cfg: Config, *, tag: str = "cm"
) -> Path:
    plt = pyplot()
    cfg.paths.ensure_dirs()
    labels = cfg.signals.modulations_with_noise
    fig, ax = plt.subplots(figsize=(8, 4), dpi=150)
    try:
        import pandas as pd
        import seaborn as sns

        sns.heatmap(
            pd.DataFrame(cm, index=labels, columns=labels),
            annot=True, cmap=plt.get_cmap("Blues", 6), ax=ax,
        )
    except ImportError:
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(labels)), labels)
        ax.set_yticks(range(len(labels)), labels)
        for r in range(cm.shape[0]):
            for c in range(cm.shape[1]):
                ax.text(c, r, f"{cm[r, c]:.2f}", ha="center", va="center")
        fig.colorbar(im)
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    ax.set_title("Confusion Matrix")
    p = cfg.paths.figures / f"{tag}-{model_id}.png"
    fig.savefig(p, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return p


def run_plots(cfg: Config, features: dict[str, np.ndarray] | None = None) -> Path:
    """Every feature visualisation (the reference's ``run_plots``): writes
    the statistics, then draws the PNGs and ``all_plots.html`` where
    matplotlib imports. Returns the statistics' path."""
    from amcpy_tpu_torch.data import io_mat

    cfg.paths.ensure_dirs()
    if features is None:
        features = {
            m: io_mat.load_features(cfg, m)
            for m in cfg.signals.modulations_with_noise
        }
    path = save_feature_stats(features, cfg)
    if have_matplotlib():
        mean, std = feature_stats(features, cfg)
        plot_means(mean, cfg)
        plot_errorbars(mean, std, cfg)
        generate_html_plot(mean, cfg)
        print(f"All plots generated! (numbers -> {path})")
    else:
        print(f"matplotlib is absent: feature statistics written as numbers -> {path}")
    return path
