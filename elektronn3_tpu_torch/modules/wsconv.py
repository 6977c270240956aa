"""Weight-standardized (scaled) convolutions, NFNet-style.

Counterpart of the JAX package's ``modules/wsconv.py`` (reference
elektronn3/modules/wsconv.py:14-489, arXiv:2101.08692): the kernel is
standardized over its fan-in to zero mean and unit variance, scaled by
``1 / sqrt(fan_in)`` and a learned per-filter ``gain``, in float32, then
cast to the compute dtype. Channels-last; the spatial rank follows
``kernel_size``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from elektronn3_tpu_torch.modules.layers import Conv, ConvTranspose


def _standardize(weight: torch.Tensor, gain: torch.Tensor,
                 axes: Tuple[int, ...], eps: float = 1e-4) -> torch.Tensor:
    """``(w - mean) / sqrt(max(var * fan_in, eps)) * gain`` over
    ``axes`` (all but the output axis; the biased variance), fan_in the
    number of elements they hold: JAX's ``_standardize`` (wsconv.py:25-37)
    on the torch layout."""
    mean = weight.mean(axes, keepdim=True)
    var = weight.var(axes, unbiased=False, keepdim=True)
    fan_in = float(math.prod(weight.shape[a] for a in axes))
    scale = torch.rsqrt(torch.clamp_min(var * fan_in, eps))
    return (weight - mean) * scale * gain


class WSConv(Conv):
    """Channels-last weight-standardized convolution (any spatial rank):
    the JAX package's ``WSConv``. The weight (O, I / groups, *k) is
    standardized over axes 1 and up; ``gain`` is (O, 1, ...), flax's
    (1, ..., O). Arguments as :class:`~.layers.Conv`'s, and ``ws_eps``."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], *args, ws_eps: float = 1e-4,
                 **kwargs):
        super().__init__(in_channels, features, kernel_size, *args, **kwargs)
        self.ws_eps = ws_eps
        self.gain = nn.Parameter(torch.ones(
            (features,) + (1,) * (self.weight.dim() - 1),
            device=self.weight.device))

    def kernel(self) -> torch.Tensor:
        return _standardize(self.weight, self.gain,
                            tuple(range(1, self.weight.dim())), self.ws_eps)


class WSConvTranspose(ConvTranspose):
    """Weight-standardized transposed convolution (channels-last): the
    JAX package's ``WSConvTranspose``. The weight (I, O, *k) is
    standardized over axis 0 and the spatial axes (flax's (*k, I), the
    flip does not change their statistics); ``gain`` is (1, O, 1, ...),
    flax's (1, ..., O). Arguments as :class:`~.layers.ConvTranspose`'s,
    and ``ws_eps``."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], *args, ws_eps: float = 1e-4,
                 **kwargs):
        super().__init__(in_channels, features, kernel_size, *args, **kwargs)
        self.ws_eps = ws_eps
        self.gain = nn.Parameter(torch.ones(
            (1, features) + (1,) * (self.weight.dim() - 2),
            device=self.weight.device))

    def kernel(self) -> torch.Tensor:
        axes = (0,) + tuple(range(2, self.weight.dim()))
        return _standardize(self.weight, self.gain, axes, self.ws_eps)
