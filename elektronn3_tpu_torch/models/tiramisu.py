"""FC-DenseNet "Tiramisu" (arXiv:1611.09326) for 2D segmentation.

Counterpart of the JAX package's ``models/tiramisu.py`` (reference
elektronn3/models/tiramisu_2d.py:16-211), channels-last; raw logits
out. Batch norms are flax's (momentum 0.99), dropout 0.2 where JAX has
it (each dense layer and transition down). A transition up is flax's
stride-2 3x3 transposed conv with its default 'SAME' padding
(:func:`~.layers.conv_transpose_cl`), center-cropped to the skip.
Module names are flax's (``firstconv``, ``dense_down_{i}.DenseLayer_
{j}.BatchNorm_0``, ``trans_down_{i}``, ``bottleneck``, ``trans_up_{i}.
ConvTranspose_0``, ``dense_up_{i}``, ``finalConv``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    BatchNorm, Conv, ConvTranspose, check_input, max_pool_cl, named_child,
    resolve_device)


class DenseLayer(nn.Module):
    """BN -> relu -> 3x3 conv -> dropout (reference
    tiramisu_2d.py:131-142)."""

    def __init__(self, in_channels: int, growth_rate: int, dtype, device):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_channels, device=device)
        self.Conv_0 = Conv(in_channels, growth_rate, (3, 3), dtype=dtype,
                           device=device)
        self.dropout = nn.Dropout(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.Conv_0(F.relu(self.BatchNorm_0(x))))


class DenseBlock(nn.Module):
    """``n_layers`` dense layers, each over the concatenation so far;
    ``upsample=True`` returns only the new features (reference
    tiramisu_2d.py:144-166)."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int,
                 upsample: bool, dtype, device):
        super().__init__()
        self.n_layers = n_layers
        self.upsample = upsample
        for i in range(n_layers):
            named_child(self, f"DenseLayer_{i}", DenseLayer(
                in_channels + i * growth_rate, growth_rate, dtype, device))
        self.out_channels = n_layers * growth_rate + (
            0 if upsample else in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        new = []
        for i in range(self.n_layers):
            out = getattr(self, f"DenseLayer_{i}")(x)
            x = torch.cat([x, out], dim=-1)
            new.append(out)
        return torch.cat(new, dim=-1) if self.upsample else x


class TransitionDown(nn.Module):
    """BN -> relu -> 1x1 conv -> dropout -> 2x2 max pool (reference
    tiramisu_2d.py:169-182)."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, device=device)
        self.Conv_0 = Conv(channels, channels, (1, 1), dtype=dtype,
                           device=device)
        self.dropout = nn.Dropout(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(self.Conv_0(F.relu(self.BatchNorm_0(x))))
        return max_pool_cl(y, (2, 2))


class TransitionUp(nn.Module):
    """Stride-2 3x3 transposed conv ('SAME'), center-cropped to the
    skip, concatenated with it (reference tiramisu_2d.py:185-196)."""

    def __init__(self, in_channels: int, out_channels: int, dtype, device):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(
            in_channels, out_channels, (3, 3), strides=(2, 2), dtype=dtype,
            device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = self.ConvTranspose_0(x)
        h, w = y.shape[1], y.shape[2]
        th, tw = skip.shape[1], skip.shape[2]
        y = y[:, (h - th) // 2:(h - th) // 2 + th,
              (w - tw) // 2:(w - tw) // 2 + tw]
        return torch.cat([y, skip.to(y.dtype)], dim=-1)


class FCDenseNet(nn.Module):
    """Fully-convolutional DenseNet (reference tiramisu_2d.py:16-107)."""

    def __init__(self, in_channels: int = 3,
                 down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48, n_classes: int = 12,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "FCDenseNet")
        self.in_channels = in_channels
        self.down_blocks = tuple(down_blocks)
        self.up_blocks = tuple(up_blocks)
        self.bottleneck_layers = bottleneck_layers
        self.growth_rate = growth_rate
        self.out_chans_first_conv = out_chans_first_conv
        self.n_classes = n_classes
        self.out_channels = n_classes
        self.dtype = dtype
        self.dim = 2
        kw = dict(dtype=dtype, device=device)
        self.firstconv = Conv(in_channels, out_chans_first_conv, (3, 3),
                              **kw)
        c = out_chans_first_conv
        skips = []
        for i, n in enumerate(self.down_blocks):
            block = named_child(self, f"dense_down_{i}", DenseBlock(
                c, growth_rate, n, False, **kw))
            c = block.out_channels
            skips.append(c)
            named_child(self, f"trans_down_{i}", TransitionDown(c, **kw))
        c = named_child(self, "bottleneck", DenseBlock(
            c, growth_rate, bottleneck_layers, True, **kw)).out_channels
        for i, n in enumerate(self.up_blocks):
            named_child(self, f"trans_up_{i}", TransitionUp(c, c, **kw))
            c += skips.pop()
            c = named_child(self, f"dense_up_{i}", DenseBlock(
                c, growth_rate, n, i < len(self.up_blocks) - 1,
                **kw)).out_channels
        self.finalConv = Conv(c, n_classes, (1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("FCDenseNet", x, 2, self.in_channels)
        out = self.firstconv(x)
        skips = []
        for i in range(len(self.down_blocks)):
            out = getattr(self, f"dense_down_{i}")(out)
            skips.append(out)
            out = getattr(self, f"trans_down_{i}")(out)
        out = self.bottleneck(out)
        for i in range(len(self.up_blocks)):
            out = getattr(self, f"trans_up_{i}")(out, skips.pop())
            out = getattr(self, f"dense_up_{i}")(out)
        return self.finalConv(out).float()


def FCDenseNet57(n_classes: int, in_channels: int = 3, **kw) -> FCDenseNet:
    return FCDenseNet(in_channels=in_channels, down_blocks=(4,) * 5,
                      up_blocks=(4,) * 5, bottleneck_layers=4,
                      growth_rate=12, out_chans_first_conv=48,
                      n_classes=n_classes, **kw)


def FCDenseNet67(n_classes: int, in_channels: int = 3, **kw) -> FCDenseNet:
    return FCDenseNet(in_channels=in_channels, down_blocks=(5,) * 5,
                      up_blocks=(5,) * 5, bottleneck_layers=5,
                      growth_rate=16, out_chans_first_conv=48,
                      n_classes=n_classes, **kw)


def FCDenseNet103(n_classes: int, in_channels: int = 3, **kw) -> FCDenseNet:
    return FCDenseNet(in_channels=in_channels, down_blocks=(4, 5, 7, 10, 12),
                      up_blocks=(12, 10, 7, 5, 4), bottleneck_layers=15,
                      growth_rate=16, out_chans_first_conv=48,
                      n_classes=n_classes, **kw)
