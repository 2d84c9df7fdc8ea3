"""amcpy_tpu_torch — the PyTorch/CUDA port of amcpy_tpu for NVIDIA Hopper.

It runs the serving and extraction path (raw IQ -> 18 features ->
standardize -> MLP logits) on one CUDA device, with the feature extractor
in hand-written CUDA kernels (``csrc/features.cu``) and a plain PyTorch
version of each kernel for CPU tensors. It imports nothing of JAX or of
the ``amcpy_tpu`` package; ``tests/test_torch_*.py`` hold it against them.

Entry points take ``device=None``, meaning the CUDA card, and raise when
there is none; pass ``device="cpu"`` for the plain PyTorch path.
"""

from amcpy_tpu_torch.config import Config

__all__ = ["Config"]
__version__ = "0.1.0"
