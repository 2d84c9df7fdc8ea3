"""MLP classifier over the standardized feature vector.

Counterpart of ``amcpy_tpu/models/classifier.py`` (flax): one
Linear -> BatchNorm -> activation -> Dropout block per hidden size, then a
final Linear to logits. flax's ``nn.gelu`` is the tanh approximation by
default, so ``"gelu"`` maps to ``nn.GELU(approximate="tanh")``, not to
PyTorch's exact default. An unknown activation name falls back to ReLU, as
in flax.

Training follows flax (``models/layers.py``): flax's default
initialization, BatchNorm with flax's batch statistics, momentum 0.9 and
the biased running variance (eps 1e-5), and dropout drawn from the
generator the forward is given.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from amcpy_tpu_torch.models.layers import FlaxBatchNorm1d, dropout, init_flax_defaults

__all__ = ["AMCClassifier"]

_ACTIVATIONS = {
    "relu": nn.ReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
    "gelu": lambda: nn.GELU(approximate="tanh"),
}


class AMCClassifier(nn.Module):
    """MLP over per-frame feature vectors ``(B, in_features)``. Returns
    logits ``(B, n_classes)``.

    Parameter names (``dense.k``, ``norm.k``, ``out``) mirror flax's
    ``Dense_k``/``BatchNorm_k``; see
    :func:`amcpy_tpu_torch.train.checkpoint.params_from_flax`.
    """

    #: the sidecar's ``model.family``
    family = "mlp"
    #: takes the standardized features, not raw I/Q frames
    takes_iq = False

    def __init__(
        self,
        n_classes: int,
        hidden_sizes: Sequence[int] = (26, 29, 30),
        dropout: float = 0.4,
        activation: str = "relu",
        in_features: int = 6,
    ):
        super().__init__()
        act = _ACTIVATIONS.get(activation, nn.ReLU)
        widths = [in_features, *hidden_sizes]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        self.norm = nn.ModuleList(FlaxBatchNorm1d(h) for h in hidden_sizes)
        self.act = act()
        self.dropout = dropout
        self.out = nn.Linear(widths[-1], n_classes)
        init_flax_defaults(self)

    def sidecar(self, cfg) -> dict:
        """The sidecar's ``model`` block: the family alone (the widths are
        the config's)."""
        return {"family": self.family}

    @classmethod
    def from_sidecar(cls, meta: dict) -> "AMCClassifier":
        """The model a sidecar describes: ``config.training``'s hidden
        sizes, dropout and activation over its used columns."""
        c = meta["config"]
        t = c["training"]
        return cls(n_classes=c["n_classes"], hidden_sizes=tuple(t["hidden_sizes"]),
                   dropout=t["dropout"], activation=t["activation"],
                   in_features=len(c["features"]["used_columns"]))

    def forward(
        self, x: torch.Tensor, *, generator: torch.Generator | None = None, shard=None
    ) -> torch.Tensor:
        """Logits; in training, dropout draws from ``generator``. With a
        :class:`~amcpy_tpu_torch.parallel.mesh.DataShard`, ``x`` is this
        rank's block of a global batch (``models/layers.py``)."""
        for dense, norm in zip(self.dense, self.norm):
            x = dropout(self.act(norm(dense(x), shard)), self.dropout, self.training,
                        generator, shard)
        return self.out(x)
