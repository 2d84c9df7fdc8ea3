"""amcpy_tpu_torch — the PyTorch/CUDA port of amcpy_tpu for NVIDIA Hopper.

It runs the original flow on a CUDA device, or over ranks of
``torch.distributed`` (``parallel/``, one rank a device): a ``.mat``
dataset -> 18 features per frame (hand-written CUDA kernels, ``csrc/features.cu``) ->
standardize and split -> training of the feature MLP or of the raw-IQ CNN
-> per-SNR evaluation -> Q-format int16 export with a C header; and serves
both families (the CNN's trunk in ``csrc/cnn_trunk.cu``). ``python -m
amcpy_tpu_torch`` is its command line. Every kernel has a plain PyTorch
version for CPU tensors. It imports nothing of JAX or of the ``amcpy_tpu``
package; ``tests/test_torch_*.py`` hold it against them.

Entry points take ``device=None``, meaning the CUDA card, and raise when
there is none; pass ``device="cpu"`` for the plain PyTorch path.
"""

from amcpy_tpu_torch.config import Config

__all__ = ["Config"]
__version__ = "0.1.0"
