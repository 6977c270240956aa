"""UNet3dLite: the fixed-shape valid-conv U-Net ported from ELEKTRONN2.

Counterpart of the JAX package's ``models/unet3d_lite.py`` (reference
elektronn3/models/unet3d_lite.py:11-116), channels-last: input (N, 22,
140, 140, C) gives (N, 10, 52, 52, 2) logits, the output shrunk by the
offset (6, 44, 44) on each side. Module names are flax's (``conv0``,
``upconv0``, ``mconv0``, ``conv_final``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    Conv, ConvTranspose, check_input, max_pool_cl, resolve_device)


class PoolingError(Exception):
    """A pool's window does not divide its input's spatial shape."""


def _autocrop(from_down: torch.Tensor, from_up: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Center-crop the encoder features to the decoder's spatial shape
    (reference unet3d_lite.py:51-62)."""
    ds = from_down.shape[1:-1]
    us = from_up.shape[1:-1]
    return from_down[(slice(None),) + tuple(
        slice((d - u) // 2, (d + u) // 2) for d, u in zip(ds, us))], from_up


def _down(x: torch.Tensor, ks: Sequence[int] = (1, 2, 2)) -> torch.Tensor:
    """Max pool by ``ks``, raising :class:`PoolingError` where it does
    not divide the spatial shape (reference unet3d_lite.py:63-74)."""
    sh = tuple(x.shape[1:-1])
    if any(s % k for s, k in zip(sh, ks)):
        raise PoolingError(f"Can't pool {sh} input by a {tuple(ks)} kernel. "
                           "Please adjust the input shape.")
    return max_pool_cl(x, ks)


# (name, in, out, kernel) of the valid convs, in the forward's order.
_CONVS = [("conv0", None, 32, (1, 3, 3)), ("conv1", 32, 32, (1, 3, 3)),
          ("conv2", 32, 64, (1, 3, 3)), ("conv3", 64, 64, (1, 3, 3)),
          ("conv4", 64, 128, (1, 3, 3)), ("conv5", 128, 128, (1, 3, 3)),
          ("conv6", 128, 256, (3, 3, 3)), ("conv7", 256, 128, (3, 3, 3)),
          ("mconv0", 128 + 512, 256, (1, 3, 3)),
          ("mconv1", 256, 64, (1, 3, 3)),
          ("mconv2", 64 + 256, 128, (3, 3, 3)),
          ("mconv3", 128, 32, (3, 3, 3)),
          ("mconv4", 32 + 128, 64, (3, 3, 3)),
          ("mconv5", 64, 64, (3, 3, 3))]
_UPCONVS = [("upconv0", 128, 512), ("upconv1", 64, 256),
            ("upconv2", 32, 128)]


class UNet3dLite(nn.Module):
    """Input (N, 22, 140, 140, in_channels) -> output (N, 10, 52, 52, 2)
    float32 logits (the JAX package's ``UNet3dLite``)."""

    offset = (6, 44, 44)

    def __init__(self, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "UNet3dLite")
        self.in_channels = in_channels
        self.out_channels = 2
        self.dtype = dtype
        self.dim = 3
        for name, cin, cout, k in _CONVS:
            self.add_module(name, Conv(cin or in_channels, cout, k,
                                       padding="VALID", dtype=dtype,
                                       device=device))
        for name, cin, cout in _UPCONVS:
            self.add_module(name, ConvTranspose(
                cin, cout, (1, 2, 2), strides=(1, 2, 2), dtype=dtype,
                device=device))
        self.conv_final = Conv(64, 2, (1, 1, 1), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("UNet3dLite", x, 3, self.in_channels)
        relu = F.relu
        conv0 = relu(self.conv0(x))
        conv1 = relu(self.conv1(conv0))
        conv2 = relu(self.conv2(_down(conv1)))
        conv3 = relu(self.conv3(conv2))
        conv4 = relu(self.conv4(_down(conv3)))
        conv5 = relu(self.conv5(conv4))
        conv6 = relu(self.conv6(_down(conv5)))
        m = relu(self.conv7(conv6))
        for i, skip in enumerate((conv5, conv3, conv1)):
            up = relu(getattr(self, f"upconv{i}")(m))
            d, u = _autocrop(skip, up)
            m = torch.cat([d, u], dim=-1)
            m = relu(getattr(self, f"mconv{2 * i}")(m))
            m = relu(getattr(self, f"mconv{2 * i + 1}")(m))
        return self.conv_final(m).float()
