"""elektronn3_tpu_torch: the PyTorch/CUDA port of elektronn3_tpu.

The JAX package ``elektronn3_tpu`` stays the reference; this package
does the same work in PyTorch, with every Pallas kernel of its path
rewritten by hand for NVIDIA Hopper (``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use). It imports neither JAX nor ``elektronn3_tpu``.

Subpackages mirror the JAX package:

- ``models``: the U-Net (training and inference forward), the model zoo
  and the converter between flax variables and the port's state_dict
- ``modules``: activations, normalization, batch-norm prologues, losses,
  the graph layers
- ``ops``: the fused level ops (autograd functions) and their kernels'
  loader
- ``training``: the train step, the ``Trainer`` loop and its
  Noise2Void, triplet and gradient-accumulation forms, the GNN trainers
- ``config``: serializable run configuration (JAX's JSON layout)
- ``utils``: device-memory debugging and timing helpers
- ``inference``: tiled prediction (``Predictor``)
- ``data``: data sources, coordinate warping (host C++ kernels of
  ``native/warp_kernels.cpp``), transforms, ``PatchCreator``, the loader
  and ``DeviceWarpPatchLoader`` with its warp on the card, the KNOSSOS
  datasets
- ``parallel``: meshes over ``torch.distributed`` ranks, collectives,
  halo exchange
"""

from elektronn3_tpu_torch.logger import logger

__all__ = ["logger"]
__version__ = "0.1.0"
