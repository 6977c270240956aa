"""L1-norm batch and group normalization (sqrt(pi / 2)-scaled), for
low-precision stability.

Counterpart of the JAX package's ``modules/l1batchnorm.py`` (reference
elektronn3/modules/l1batchnorm.py:14-121, arXiv:1802.09769): the L1
deviation ``mean(|x - mean|) * sqrt(pi / 2)`` estimates the standard
deviation without squaring. Channels-last; computed in float32 and
rounded to the input's dtype once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_SQRT_HALF_PI = math.sqrt(math.pi / 2)


class L1BatchNorm(nn.Module):
    """L1 batch normalization over the last (channel) axis (the JAX
    package's ``L1BatchNorm``): in training the batch's mean and L1
    deviation over every other axis, which update the buffers ``mean``
    and ``dev`` (each keeps ``momentum`` of its old value); in eval the
    buffers. ``(x - mean) / (dev + eps) * gamma + beta``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device: Optional[torch.device] = None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(num_features, device=device))
        self.beta = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("dev", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            dev = (xf - mean).abs().mean(axes) * _SQRT_HALF_PI
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.dev.copy_(m * self.dev + (1 - m) * dev.detach())
        else:
            mean, dev = self.mean, self.dev
        xhat = (xf - mean) / (dev + self.eps)
        return (xhat * self.gamma + self.beta).to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}"


def l1_group_norm(x: torch.Tensor, groups: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Functional L1 group norm (JAX's ``l1_group_norm``): per sample and
    group of C / ``groups`` channels, ``(x - mean) / (dev + eps)``."""
    n, *spatial, c = x.shape
    xg = x.reshape((n,) + tuple(spatial) + (groups, c // groups))
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(axes, keepdim=True)
    dev = (xg - mean).abs().mean(axes, keepdim=True) * _SQRT_HALF_PI
    return ((xg - mean) / (dev + eps)).reshape(x.shape)


class L1GroupNorm(nn.Module):
    """L1 group normalization with (C,) ``gamma`` and ``beta`` (the JAX
    package's ``L1GroupNorm``)."""

    def __init__(self, num_channels: int, groups: int = 8,
                 eps: float = 1e-5, device: Optional[torch.device] = None):
        super().__init__()
        self.num_channels = num_channels
        self.groups = groups
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(num_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xhat = l1_group_norm(x.float(), self.groups, self.eps)
        return (xhat * self.gamma + self.beta).to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_channels}, groups={self.groups}"
