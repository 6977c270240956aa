"""The ``'batchp'`` batch norm module.

PyTorch counterpart of the JAX package's ``modules/pallas_norm.py``
(``PallasBatchNorm``). ``PallasBatchNorm3d`` and ``PallasBatchNorm2d``
are ``nn.BatchNorm3d`` / ``nn.BatchNorm2d`` (eps 1e-5, torch momentum 0.1,
which is flax's 0.9; the same state_dict keys) whose forward takes a
contiguous channels-last tensor through :mod:`~elektronn3_tpu_torch.ops.
pallas_bn`: in training ``batch_norm_train`` (kernels K8-K11), whose
clamped batch variance is also what the running update takes, as
``PallasBatchNorm`` does (a kernel level's ``FlatBNStats`` takes the
unclamped one, ``flat_norm.bn_train_prologue``); in eval
``batch_norm_inference`` (K9) on the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from elektronn3_tpu_torch.ops.pallas_bn import (
    batch_norm_inference, batch_norm_train)


class PallasBatchNorm:
    """The forward of both ranks (mixed into the torch batch norms)."""

    def forward(self, x: torch.Tensor, reference: bool = False
                ) -> torch.Tensor:
        """Normalize channels-last ``x`` (N, [D,] H, W, C), in ``x``'s
        dtype; ``reference`` runs the kernels' plain versions."""
        if not self.training:
            return batch_norm_inference(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, reference=reference)
        return batch_norm_train(
            x, self.weight, self.bias, self.eps, reference=reference,
            running=(self.running_mean, self.running_var, self.momentum))[0]


class PallasBatchNorm3d(PallasBatchNorm, nn.BatchNorm3d):
    pass


class PallasBatchNorm2d(PallasBatchNorm, nn.BatchNorm2d):
    pass
