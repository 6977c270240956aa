"""EvoNorm B0 / S0 normalization-activation layers (arXiv:2004.02967).

Counterpart of the JAX package's ``modules/evonorm.py`` (reference
elektronn3/modules/evonorm.py:8-101). Channels-last, any spatial rank;
computed in float32 and rounded to the input's dtype once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def instance_std(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per (sample, channel) standard deviation over the spatial axes,
    ``sqrt(var + eps)`` with the biased variance (JAX's
    ``instance_std``)."""
    spatial = tuple(range(1, x.dim() - 1))
    return torch.sqrt(x.var(spatial, unbiased=False, keepdim=True) + eps)


def group_std(x: torch.Tensor, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """Per (sample, group) standard deviation over the spatial axes and
    the group's channels, broadcast back to ``x``'s shape (JAX's
    ``group_std``; ``min(groups, C)`` groups)."""
    n, *spatial, c = x.shape
    groups = min(groups, c)
    xg = x.reshape((n,) + tuple(spatial) + (groups, c // groups))
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    std = torch.sqrt(xg.var(axes, unbiased=False, keepdim=True) + eps)
    return std.expand(xg.shape).reshape(x.shape)


class EvoNorm(nn.Module):
    """EvoNorm layer over ``num_channels`` channels; ``version`` 'B0' or
    'S0' (the JAX package's ``EvoNorm``).

    - S0: ``x * sigmoid(v * x) / group_std(x)`` (per sample, no state).
    - B0: ``x / max(sqrt(var + eps), v * x + instance_std(x))`` with the
      batch's biased variance over (N, *spatial) in training, which
      updates ``running_var`` (the buffer keeps ``momentum`` of its old
      value), and ``running_var`` in eval.

    ``gamma``, ``beta``, ``v`` and ``running_var`` are (C,); flax's are
    (1, ..., C) of the input's rank, which ``convert.py`` reshapes.
    """

    def __init__(self, num_channels: int, version: str = "S0",
                 momentum: float = 0.9, eps: float = 1e-5, groups: int = 32,
                 non_linear: bool = True,
                 device: Optional[torch.device] = None):
        super().__init__()
        if version not in ("B0", "S0"):
            raise ValueError(f"Unknown EvoNorm version {version!r}")
        self.num_channels = num_channels
        self.version = version
        self.momentum = momentum
        self.eps = eps
        self.groups = groups
        self.non_linear = non_linear
        self.gamma = nn.Parameter(torch.ones(num_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(num_channels, device=device))
        self.v = nn.Parameter(torch.ones(num_channels, device=device)) \
            if non_linear else None
        if version == "B0":
            self.register_buffer("running_var",
                                 torch.ones(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.version == "S0":
            if self.non_linear:
                num = xf * torch.sigmoid(self.v * xf)
                xf = num / group_std(xf, self.groups, self.eps)
        else:
            if self.training:
                var = xf.var(tuple(range(x.dim() - 1)), unbiased=False)
                with torch.no_grad():
                    self.running_var.copy_(
                        self.momentum * self.running_var
                        + (1 - self.momentum) * var.detach())
            else:
                var = self.running_var
            if self.non_linear:
                den = torch.maximum(torch.sqrt(var + self.eps),
                                    self.v * xf + instance_std(xf, self.eps))
                xf = xf / den
            else:
                xf = xf / torch.sqrt(var + self.eps)
        return (xf * self.gamma + self.beta).to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_channels}, version={self.version!r}"
