"""amcpy_tpu_torch — the PyTorch/CUDA port of amcpy_tpu for NVIDIA Hopper.

It runs the extraction and serving paths on one CUDA device: raw IQ -> 18
features -> standardize -> MLP logits, with the feature extractor in
hand-written CUDA kernels (``csrc/features.cu``), and raw IQ -> the raw-IQ
CNN's trunk (``csrc/cnn_trunk.cu``) -> its dense head; and the evaluation
of both families' checkpoints. Every kernel has a plain PyTorch version
for CPU tensors. It imports nothing of JAX or of
the ``amcpy_tpu`` package; ``tests/test_torch_*.py`` hold it against them.

Entry points take ``device=None``, meaning the CUDA card, and raise when
there is none; pass ``device="cpu"`` for the plain PyTorch path.
"""

from amcpy_tpu_torch.config import Config

__all__ = ["Config"]
__version__ = "0.1.0"
