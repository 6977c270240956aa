"""2D FCN family (FCN32s/16s/8s/FCNs) on a VGG backbone.

Counterpart of the JAX package's ``models/fcn_2d.py`` (reference
elektronn3/models/fcn_2d.py:45-251), channels-last: the VGG feature
extractor (``VGG_CFG``) and decoders of stride-2 3x3 transposed convs
with flax's 'SAME' padding (:func:`~.layers.conv_transpose_cl`: each
doubles the size), relu and a batch norm that always uses its running
statistics (flax ``use_running_average=True``), in training too, so its
buffers never change. Module names are flax's (``VGGNet_0.Conv_{k}``,
``_Deconv_{i}.ConvTranspose_0``, ``_Deconv_{i}.BatchNorm_0``,
``Conv_0``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    BatchNorm, Conv, ConvTranspose, check_input, max_pool_cl, named_child,
    resolve_device)

VGG_CFG: Dict[str, List] = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512,
              512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGGNet(nn.Module):
    """VGG feature extractor returning each pooling stage's output as
    ``{'x1': ..., 'x5': ...}`` (reference fcn_2d.py:196-238)."""

    def __init__(self, model: str = "vgg16", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if model not in VGG_CFG:
            raise ValueError(f"Unknown VGG backbone {model!r}; one of "
                             f"{sorted(VGG_CFG)}")
        self.model = model
        c, k = in_channels, 0
        for v in VGG_CFG[model]:
            if v != "M":
                named_child(self, f"Conv_{k}", Conv(c, v, (3, 3),
                                                    dtype=dtype,
                                                    device=device))
                c, k = v, k + 1

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs, stage, k = {}, 1, 0
        for v in VGG_CFG[self.model]:
            if v == "M":
                x = max_pool_cl(x, (2, 2))
                outputs[f"x{stage}"] = x
                stage += 1
            else:
                x = F.relu(getattr(self, f"Conv_{k}")(x))
                k += 1
        return outputs


class _Deconv(nn.Module):
    def __init__(self, in_channels: int, features: int, dtype, device):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(
            in_channels, features, (3, 3), strides=(2, 2), padding="SAME",
            dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, use_running_average=True,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(F.relu(self.ConvTranspose_0(x)))


class _FCN2d(nn.Module):
    """The backbone, five ``_Deconv`` stages (512, 256, 128, 64, 32
    channels) and a 1x1 head; ``skips`` are the backbone stages added
    after the first ``len(skips)`` deconvs."""

    skips = ()

    def __init__(self, n_class: int = 2, backbone: str = "vgg16",
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device, type(self).__name__)
        self.n_class = n_class
        self.out_channels = n_class
        self.backbone = backbone
        self.in_channels = in_channels
        self.dtype = dtype
        self.dim = 2
        self.VGGNet_0 = VGGNet(backbone, in_channels, dtype, device)
        c = 512
        for i, f in enumerate([512, 256, 128, 64, 32]):
            named_child(self, f"_Deconv_{i}", _Deconv(c, f, dtype, device))
            c = f
        self.Conv_0 = Conv(32, n_class, (1, 1), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input(type(self).__name__, x, 2, self.in_channels)
        feats = self.VGGNet_0(x)
        y = feats["x5"]
        for i in range(5):
            y = getattr(self, f"_Deconv_{i}")(y)
            if i < len(self.skips):
                y = y + feats[self.skips[i]]
        return self.Conv_0(y).float()


class FCN32s(_FCN2d):
    """Reference fcn_2d.py:45-75."""

    skips = ()


class FCN16s(_FCN2d):
    """Reference fcn_2d.py:78-110."""

    skips = ("x4",)


class FCN8s(_FCN2d):
    """Reference fcn_2d.py:113-147."""

    skips = ("x4", "x3")


class FCNs(_FCN2d):
    """All-skip FCN (reference fcn_2d.py:150-193)."""

    skips = ("x4", "x3", "x2", "x1")
