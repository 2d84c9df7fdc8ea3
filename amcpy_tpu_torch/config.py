"""Immutable configuration tree of the PyTorch/CUDA port.

A field-for-field copy of the JAX package's ``amcpy_tpu/config.py`` (which
the port may not import), so one YAML file drives both packages. Fields
that only the JAX package reads (the mesh layout) are kept for that
reason. How the port reads the compute fields:

* ``kernel``: ``"auto"`` resolves to ``"fused"`` (the hand-written CUDA
  kernel ``csrc/features.cu``) on a CUDA device and to ``"xla"`` (the
  plain PyTorch extractor) on the CPU; ``"pallas"`` selects the
  statistics-only CUDA kernel plus a PyTorch gamma_max epilogue.
* ``wire_format``: ``"auto"`` and ``"f32"`` mean raw float32 planes;
  the integer codecs are not ported yet and raise.

Everything is a frozen dataclass: no global mutable state.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Paths:
    """Filesystem layout. Directory names match the reference on-disk layout
    (``config.py:34-43`` of the reference) so `.mat` artifacts interop with
    the MATLAB analysis scripts downstream."""

    root: str = field(default_factory=os.getcwd)

    @property
    def root_path(self) -> Path:
        return Path(self.root)

    @property
    def mat_data(self) -> Path:
        return self.root_path / "mat-data"

    @property
    def calculated_features(self) -> Path:
        return self.root_path / "calculated-features"

    @property
    def arm_data(self) -> Path:
        return self.root_path / "arm-data"

    @property
    def trained_ann(self) -> Path:
        return self.root_path / "ann"

    @property
    def figures(self) -> Path:
        return self.root_path / "figures"

    @property
    def feature_figures(self) -> Path:
        return self.root_path / "figures" / "features"

    @property
    def metrics(self) -> Path:
        return self.root_path / "metrics"

    mat_filename: str = "all_modulations.mat"

    def ensure_dirs(self) -> None:
        for p in (
            self.mat_data,
            self.calculated_features,
            self.arm_data,
            self.trained_ann,
            self.figures,
            self.feature_figures,
            self.metrics,
        ):
            p.mkdir(parents=True, exist_ok=True)


# ---------------------------------------------------------------------------
# Signals
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SignalConfig:
    """Modulation metadata. Mirrors the reference signal set
    (``config.py:60-110``): 5 modulations + WGN, 16 SNR levels (-10..20 dB
    in 2 dB steps), 1000 frames x 2048 complex samples each."""

    modulations: tuple[str, ...] = ("BPSK", "QPSK", "8PSK", "16QAM", "64QAM")
    modulations_with_noise: tuple[str, ...] = (
        "BPSK",
        "QPSK",
        "8PSK",
        "16QAM",
        "64QAM",
        "WGN",
    )
    labels: tuple[int, ...] = (0, 1, 2, 3, 4, 5)

    # SNR levels in dB, index == SNR level id used everywhere.
    snr_db: tuple[int, ...] = tuple(range(-10, 22, 2))  # 16 levels

    frame_size: int = 2048
    num_frames: int = 1000

    # .mat variable name per modulation (byte-compatible with the reference
    # artifact layout, ``config.py:101-110``).
    @property
    def mat_info(self) -> dict[str, str]:
        return {
            "BPSK": "signal_bpsk",
            "QPSK": "signal_qpsk",
            "8PSK": "signal_8psk",
            "16QAM": "signal_qam16",
            "64QAM": "signal_qam64",
            "WGN": "signal_noise",
        }

    @property
    def num_snr(self) -> int:
        return len(self.snr_db)

    def snr_label(self, snr_idx: int) -> str:
        return str(self.snr_db[snr_idx])


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

#: Display names (mathtext) for all 18 features, keyed by 1-based feature id.
FEATURE_NAMES: dict[int, str] = {
    1: r"$\gamma_{max}$",
    2: r"$\sigma_{ap}$",
    3: r"$\sigma_{dp}$",
    4: r"$\sigma_{aa}$",
    5: r"$\sigma_{af}$",
    6: r"$X$",
    7: r"$X_2$",
    8: r"$\mu_{42}^{a}$",
    9: r"$\mu_{42}^{f}$",
    10: r"$C_{20}$",
    11: r"$C_{21}$",
    12: r"$C_{40}$",
    13: r"$C_{41}$",
    14: r"$C_{42}$",
    15: r"$C_{60}$",
    16: r"$C_{61}$",
    17: r"$C_{62}$",
    18: r"$C_{63}$",
}


@dataclass(frozen=True)
class FeatureConfig:
    """Feature selection with an EXPLICIT id -> column map.

    Column ``j`` of an extracted feature matrix holds feature id ``j + 1``.
    ``used`` holds 1-based feature IDS. The reference instead indexed
    columns directly with the ids (off-by-one, SURVEY.md section 3 defect 2),
    so it actually consumed features 3,5,7,9,13,15 while labeling them
    2,4,6,8,12,14. Set ``reference_parity_columns=True`` to reproduce the
    reference's *actual* column choice for A/B comparisons.
    """

    all_features: tuple[int, ...] = tuple(range(1, 19))
    used: tuple[int, ...] = (2, 4, 6, 8, 12, 14)
    reference_parity_columns: bool = False

    @property
    def used_columns(self) -> tuple[int, ...]:
        """0-based column indices into the (frames, 18) feature matrix."""
        if self.reference_parity_columns:
            # the reference's off-by-one behaviour: ids used as columns
            return tuple(self.used)
        return tuple(f - 1 for f in self.used)

    @property
    def used_names(self) -> list[str]:
        if self.reference_parity_columns:
            return [FEATURE_NAMES[c + 1] for c in self.used_columns]
        return [FEATURE_NAMES[f] for f in self.used]

    @property
    def num_used(self) -> int:
        return len(self.used)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainingConfig:
    """NN training hyperparameters (defaults match the reference W&B-tuned
    values, ``config.py:151-176``)."""

    training_snr: tuple[int, ...] = (10, 11, 12, 13, 14, 15)  # 10..20 dB
    all_snr: tuple[int, ...] = tuple(range(16))

    test_size: float = 0.2
    seed: int = 42

    activation: str = "relu"
    batch_size: int = 128
    dropout: float = 0.4
    epochs: int = 21
    learning_rate: float = 0.001418378071933655
    optimizer: str = "rmsprop"
    hidden_sizes: tuple[int, ...] = (26, 29, 30)


# ---------------------------------------------------------------------------
# Compute policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComputeConfig:
    """Device layout and numeric policy.

    ``data_axis``, ``seq_axis`` and ``mesh_shape`` lay out the JAX
    package's device mesh; the port runs on one device and keeps them only
    so that one YAML file reads the same in both packages.
    """

    data_axis: str = "data"
    seq_axis: str = "seq"
    mesh_shape: tuple[int, ...] = ()
    compute_dtype: str = "float32"
    # Per-frame magnitude normalization before moment accumulation: exact
    # (features are homogeneous in scale) and keeps x^6 terms well inside
    # float32 range.
    normalize_scale: bool = True
    # gamma_max of the plain and "pallas" routes: "matmul" = four-step
    # N1 x N2 DFT, "fft" = torch.fft. The fused kernel always runs the
    # four-step DFT.
    gmax_mode: str = "matmul"
    # Feature-extraction route: "xla" = plain PyTorch extractor,
    # "fused" = the full-fusion CUDA kernel (statistics + gamma_max; frame
    # sizes with no N1 x N2 factorization go to "xla"), "pallas" = the
    # statistics-only CUDA kernel plus a PyTorch gamma_max epilogue.
    # "auto" = "fused" on a CUDA device, "xla" on the CPU.
    kernel: str = "auto"
    # Host->device codec for raw IQ frames: "auto" and "f32" ship raw
    # float32 planes; "int24"/"int16" are not ported yet and raise.
    wire_format: str = "auto"


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    paths: Paths = field(default_factory=Paths)
    signals: SignalConfig = field(default_factory=SignalConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)

    # ------------------------------------------------------------------
    # Functional updates & (de)serialization
    # ------------------------------------------------------------------

    def replace(self, **kwargs: Any) -> "Config":
        """Nested functional update: ``cfg.replace(training={'epochs': 5})``
        or with ready dataclasses: ``cfg.replace(training=new_training)``.

        Unlike the reference CLI (whose --epochs/--lr/... flags never reached
        training, SURVEY.md section 3 defect 6), this is the single override
        path used by the CLI so every flag actually takes effect.
        """
        updates: dict[str, Any] = {}
        for key, value in kwargs.items():
            current = getattr(self, key)
            if isinstance(value, Mapping):
                value = dataclasses.replace(current, **dict(value))
            updates[key] = value
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        def _mk(tp, sub):
            if sub is None:
                return tp()
            fields = {f.name: f.type for f in dataclasses.fields(tp)}
            clean = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                clean[k] = v
            return tp(**clean)

        return cls(
            paths=_mk(Paths, d.get("paths")),
            signals=_mk(SignalConfig, d.get("signals")),
            features=_mk(FeatureConfig, d.get("features")),
            training=_mk(TrainingConfig, d.get("training")),
            compute=_mk(ComputeConfig, d.get("compute")),
        )

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})
