"""Volumetric (3D) FCN-32s/16s/8s: a VGG-style encoder whose scores are
upsampled and fused by trilinear resizes.

Counterpart of the JAX package's ``models/fcn.py`` (reference
elektronn3/models/fcn.py:17-351), channels-last. ``red_fac`` divides
every VGG channel count. Scores are fused by resizing to a common
spatial shape with ``jax.image.resize``'s 'linear' method (the port's
:func:`~.layers.resize_linear`). Module names are flax's
(``_VGGBlock_{i}.Conv_0``, ``_Classifier_0``, ``Conv_0`` for the pool4
score, ``Conv_1`` for pool3's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    Conv, check_input, max_pool_cl, named_child, resize_linear,
    resolve_device)

_STAGES = [(64, 1), (128, 1), (256, 1), (512, 1), (512, 1)]


class _VGGBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, n_convs: int,
                 dtype, device):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            named_child(self, f"Conv_{i}", Conv(
                in_channels if i == 0 else features, features, (3, 3, 3),
                dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return max_pool_cl(x, (2, 2, 2))


class _Classifier(nn.Module):
    """3^3 conv to ``hidden``, relu, dropout 0.5, 1^3 conv to the
    classes."""

    def __init__(self, in_channels: int, n_classes: int, hidden: int,
                 dtype, device):
        super().__init__()
        self.Conv_0 = Conv(in_channels, hidden, (3, 3, 3), dtype=dtype,
                           device=device)
        self.dropout = nn.Dropout(0.5)
        self.Conv_1 = Conv(hidden, n_classes, (1, 1, 1), dtype=dtype,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(self.dropout(F.relu(self.Conv_0(x))))


class _FCN3d(nn.Module):
    """The encoder, classifier and the ``n_fuse`` fused pool scores
    (0: fcn32s, 1: fcn16s, 2: fcn8s)."""

    n_fuse = 0

    def __init__(self, n_classes: int = 2, red_fac: int = 16,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device, type(self).__name__)
        self.n_classes = n_classes
        self.out_channels = n_classes
        self.red_fac = red_fac
        self.in_channels = in_channels
        self.dtype = dtype
        self.dim = 3
        c = in_channels
        widths = []
        for i, (f, n) in enumerate(_STAGES):
            named_child(self, f"_VGGBlock_{i}", _VGGBlock(
                c, f // red_fac, n, dtype, device))
            c = f // red_fac
            widths.append(c)
        self._Classifier_0 = _Classifier(c, n_classes, 4096 // red_fac,
                                         dtype, device)
        # Conv_0 scores pool4 (stage 3), Conv_1 pool3 (stage 2).
        for j in range(self.n_fuse):
            named_child(self, f"Conv_{j}", Conv(
                widths[3 - j], n_classes, (1, 1, 1), dtype=dtype,
                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input(type(self).__name__, x, 3, self.in_channels)
        spatial = x.shape[1:-1]
        feats = []
        for i in range(len(_STAGES)):
            x = getattr(self, f"_VGGBlock_{i}")(x)
            feats.append(x)
        score = self._Classifier_0(x)
        for j in range(self.n_fuse):
            pool_score = getattr(self, f"Conv_{j}")(feats[3 - j])
            score = resize_linear(score, pool_score.shape[1:-1]) + pool_score
        return resize_linear(score, spatial).float()


class fcn32s(_FCN3d):
    """FCN-32s: one score, resized to the input (reference
    fcn.py:17-126)."""

    n_fuse = 0


class fcn16s(_FCN3d):
    """FCN-16s: the score fused with pool4's (reference fcn.py:126-240)."""

    n_fuse = 1


class fcn8s(_FCN3d):
    """FCN-8s: the score fused with pool4's, then pool3's (reference
    fcn.py:240-351)."""

    n_fuse = 2
