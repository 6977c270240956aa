"""Mixed-Scale Dense Network (MSDNet, PNAS 2018) for 2D and 3D.

Counterpart of the JAX package's ``models/msdnet.py`` (reference
elektronn3/models/msdnet.py:19-100), channels-last: each layer is one
dilated 3^d conv (dilation cycling 1..10, 'SAME') to one channel over
the concatenation of every earlier layer's output, then flax's batch
norm (momentum 0.99) and relu; the final 1^d conv sees every layer and
the input, then a batch norm. Module names are flax's (``first_conv``,
``layer_{i}_bn``, ``final_conv``, ``final_bn``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    BatchNorm, Conv, check_input, resolve_device)


class MSDNet(nn.Module):
    """Channels-last 2D (``volumetric=False``) or 3D MSDNet (reference
    msdnet.py:33-91)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 num_layers: int = 40, volumetric: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "MSDNet")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.volumetric = volumetric
        self.dtype = dtype
        self.dim = 3 if volumetric else 2
        k = (3,) * self.dim

        def conv_bn(name, cin, cout, dilate):
            self.add_module(f"{name}_conv", Conv(
                cin, cout, k, kernel_dilation=dilate, dtype=dtype,
                device=device))
            self.add_module(f"{name}_bn", BatchNorm(cout, device=device))

        conv_bn("first", in_channels, 1, 1)
        for i in range(num_layers):
            conv_bn(f"layer_{i}", i + 1, 1, i % 10 + 1)
        self.final_conv = Conv(num_layers + 1 + in_channels, out_channels,
                               (1,) * self.dim, dtype=dtype, device=device)
        self.final_bn = BatchNorm(out_channels, device=device)

    def _conv_bn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("MSDNet", x, self.dim, self.in_channels)
        h = F.relu(self._conv_bn("first", x))
        prev = [h]
        feat = h
        for i in range(self.num_layers):
            prev.append(F.relu(self._conv_bn(f"layer_{i}", feat)))
            feat = torch.cat(prev, dim=-1)
        out = self.final_conv(torch.cat(prev + [x.to(h.dtype)], dim=-1))
        return self.final_bn(out).float()
