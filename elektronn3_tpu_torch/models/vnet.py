"""V-Net (arXiv:1606.04797) for 3D volumetric segmentation.

Counterpart of the JAX package's ``models/vnet.py`` (reference
elektronn3/models/vnet.py:22-172), channels-last, with its quirks:

- ``ContBN``: a batch norm that always normalizes by the batch's
  statistics (flax ``BatchNorm(use_running_average=False,
  momentum=0.9)``). In training it updates its running statistics; in
  eval (``model.eval()``, the Predictor) it leaves them as they are, so
  a request never changes the model, and a tile's output depends on the
  tiles of its batch.
- The channel reduction factor ``fac`` (16 // fac ... 256 // fac
  channels; ``fac=1`` is the paper's widths).
- PReLU (one learned slope, the port's :class:`~.layers.PReLU`) when
  ``relu=False``.
- Dropout (0.5) where JAX's is: after the third and fourth down
  transitions' down convs, on every up transition's skip and on the
  first two up transitions' inputs.

Module names are flax's (``DownTransition_1.LUConv_0.ContBN_0.
BatchNorm_0``, ``_Act_0.PReLU_0``). The input's spatial axes must be
divisible by 16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    BatchNorm, Conv, ConvTranspose, PReLU, check_input, named_child,
    resolve_device)


class ContBN(nn.Module):
    """Batch norm by the batch's statistics in training and eval,
    momentum 0.9, eps 1e-5 (reference vnet.py:22-32)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, momentum=0.9, eps=1e-5,
                                     use_running_average=False,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class _Act(nn.Module):
    def __init__(self, relu: bool, device=None):
        super().__init__()
        self.PReLU_0 = None if relu else PReLU(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x) if self.PReLU_0 is None else self.PReLU_0(x)


class _ConvBNAct(nn.Module):
    """conv -> ContBN -> act: ``LUConv`` (5^3 'SAME'),
    ``InputTransition`` and ``OutputTransition`` (1^3 to 2 channels)."""

    def __init__(self, in_chans: int, out_chans: int, kernel, relu: bool,
                 dtype, device):
        super().__init__()
        self.Conv_0 = Conv(in_chans, out_chans, kernel, dtype=dtype,
                           device=device)
        self.ContBN_0 = ContBN(out_chans, device)
        self._Act_0 = _Act(relu, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._Act_0(self.ContBN_0(self.Conv_0(x)))


class DownTransition(nn.Module):
    """Stride-2 2^3 down conv ('SAME') + ContBN + act, ``n_convs``
    LUConvs, residual add, act (reference vnet.py:67-86)."""

    def __init__(self, in_chans: int, n_convs: int, relu: bool = True,
                 dropout: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        out = 2 * in_chans
        self.n_convs = n_convs
        self.Conv_0 = Conv(in_chans, out, (2, 2, 2), strides=(2, 2, 2),
                           dtype=dtype, device=device)
        self.ContBN_0 = ContBN(out, device)
        self._Act_0 = _Act(relu, device)
        self.dropout = nn.Dropout(0.5) if dropout else None
        for i in range(n_convs):
            named_child(self, f"LUConv_{i}", _ConvBNAct(
                out, out, (5, 5, 5), relu, dtype, device))
        self._Act_1 = _Act(relu, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down = self._Act_0(self.ContBN_0(self.Conv_0(x)))
        y = self.dropout(down) if self.dropout is not None else down
        for i in range(self.n_convs):
            y = getattr(self, f"LUConv_{i}")(y)
        return self._Act_1(y + down)


class UpTransition(nn.Module):
    """Stride-2 2^3 transposed conv to ``out_chans // 2`` + ContBN +
    act, concat with the skip, ``n_convs`` LUConvs, residual add, act
    (reference vnet.py:89-110)."""

    def __init__(self, in_chans: int, out_chans: int, n_convs: int,
                 relu: bool = True, dropout: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_convs = n_convs
        self.dropout = nn.Dropout(0.5) if dropout else None
        self.skip_dropout = nn.Dropout(0.5)
        self.ConvTranspose_0 = ConvTranspose(
            in_chans, out_chans // 2, (2, 2, 2), strides=(2, 2, 2),
            dtype=dtype, device=device)
        self.ContBN_0 = ContBN(out_chans // 2, device)
        self._Act_0 = _Act(relu, device)
        for i in range(n_convs):
            named_child(self, f"LUConv_{i}", _ConvBNAct(
                out_chans, out_chans, (5, 5, 5), relu, dtype, device))
        self._Act_1 = _Act(relu, device)

    def forward(self, x: torch.Tensor, skipx: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout(x)
        skipx = self.skip_dropout(skipx)
        up = self._Act_0(self.ContBN_0(self.ConvTranspose_0(x)))
        xcat = torch.cat([up, skipx], dim=-1)
        y = xcat
        for i in range(self.n_convs):
            y = getattr(self, f"LUConv_{i}")(y)
        return self._Act_1(y + xcat)


class VNet(nn.Module):
    """V-Net with channel reduction factor ``fac`` (reference
    vnet.py:124-172). Input (N, D, H, W, in_channels), spatial axes
    divisible by 16; output (N, D, H, W, 2) float32 (the activated
    output transition, as in JAX; ``nll`` is kept for the reference's
    signature)."""

    def __init__(self, relu: bool = True, nll: bool = True, fac: int = 4,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device, "VNet")
        self.relu = relu
        self.nll = nll
        self.fac = fac
        self.in_channels = in_channels
        self.out_channels = 2
        self.dtype = dtype
        self.dim = 3
        f = fac
        kw = dict(dtype=dtype, device=device)
        self.InputTransition_0 = _ConvBNAct(in_channels, 16 // f, (5, 5, 5),
                                            relu, **kw)
        self.DownTransition_0 = DownTransition(16 // f, 1, relu, **kw)
        self.DownTransition_1 = DownTransition(32 // f, 2, relu, **kw)
        self.DownTransition_2 = DownTransition(64 // f, 3, relu, True, **kw)
        self.DownTransition_3 = DownTransition(128 // f, 2, relu, True, **kw)
        self.UpTransition_0 = UpTransition(256 // f, 256 // f, 2, relu, True,
                                           **kw)
        self.UpTransition_1 = UpTransition(256 // f, 128 // f, 2, relu, True,
                                           **kw)
        self.UpTransition_2 = UpTransition(128 // f, 64 // f, 1, relu, **kw)
        self.UpTransition_3 = UpTransition(64 // f, 32 // f, 1, relu, **kw)
        self.OutputTransition_0 = _ConvBNAct(32 // f, 2, (1, 1, 1), relu,
                                             **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("VNet", x, 3, self.in_channels)
        if any(s % 16 for s in x.shape[1:-1]):
            raise ValueError(f"VNet: spatial shape {tuple(x.shape[1:-1])} "
                             "is not divisible by 16.")
        out16 = self.InputTransition_0(x)
        out32 = self.DownTransition_0(out16)
        out64 = self.DownTransition_1(out32)
        out128 = self.DownTransition_2(out64)
        out256 = self.DownTransition_3(out128)
        out = self.UpTransition_0(out256, out128)
        out = self.UpTransition_1(out, out64)
        out = self.UpTransition_2(out, out32)
        out = self.UpTransition_3(out, out16)
        return self.OutputTransition_0(out).float()
