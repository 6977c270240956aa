"""elektronn3_tpu_torch: the PyTorch/CUDA port of elektronn3_tpu.

The JAX package ``elektronn3_tpu`` stays the reference; this package
does the same work in PyTorch, with every Pallas kernel of its path
rewritten by hand for NVIDIA Hopper (``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use). It imports neither JAX nor ``elektronn3_tpu``.

Subpackages mirror the JAX package:

- ``models``: the U-Net (inference forward) and the flax->torch
  parameter converter
- ``modules``: activations, normalization, batch-norm prologues
- ``ops``: the fused level ops and their kernels' loader
- ``inference``: tiled prediction (``Predictor``)
"""

from elektronn3_tpu_torch.logger import logger

__all__ = ["logger"]
__version__ = "0.1.0"
