"""MLP classifier over the standardized feature vector.

Counterpart of ``amcpy_tpu/models/classifier.py`` (flax): one
Linear -> BatchNorm1d -> activation -> Dropout block per hidden size, then
a final Linear to logits. BatchNorm uses eps 1e-5 and momentum 0.1 (flax's
0.9). flax's ``nn.gelu`` is the tanh approximation by default, so
``"gelu"`` maps to ``nn.GELU(approximate="tanh")``, not to PyTorch's exact
default. An unknown activation name falls back to ReLU, as in flax.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

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
        self.norm = nn.ModuleList(
            nn.BatchNorm1d(h, eps=1e-5, momentum=0.1) for h in hidden_sizes
        )
        self.act = act()
        self.drop = nn.Dropout(dropout)
        self.out = nn.Linear(widths[-1], n_classes)

    def forward(self, x):
        for dense, norm in zip(self.dense, self.norm):
            x = self.drop(self.act(norm(dense(x))))
        return self.out(x)
