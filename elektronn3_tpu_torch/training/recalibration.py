"""Batch-norm recalibration on a data loader (reference
elektronn3/training/recalibration.py:16-73; the JAX package's
``training/recalibration.py``): the running statistics recomputed from
data, after SWA or under a domain shift."""

from __future__ import annotations

import copy
from typing import Optional

from torch import nn

from elektronn3_tpu_torch.training.optim import bn_update


def recalibrate_bn(model: nn.Module, loader,
                   max_batches: Optional[int] = 100,
                   mesh=None) -> nn.Module:
    """A copy of ``model`` whose batch norms hold the cumulative mean of
    the statistics of ``loader``'s batches (dicts with a channels-last
    'inp'; see :func:`~elektronn3_tpu_torch.training.optim.bn_update`).
    ``model`` itself is not changed; a model without batch norm comes
    back as a plain copy. ``mesh``: the statistics summed over its
    first axis, every rank on its rows of each batch (``bn_update``)."""
    return bn_update(loader, copy.deepcopy(model), max_batches=max_batches,
                     mesh=mesh)
