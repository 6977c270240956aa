"""Simple test CNNs and image-to-scalar classifiers.

Counterpart of the JAX package's ``models/simple.py`` (reference
elektronn3/models/simple.py:8-167), channels-last. Module names are
flax's (``Conv_0``, ``Conv3DLayer_2``, ``Dense_1``), so ``convert.py``
maps the state_dict onto the flax tree by path. Every model takes
``device`` (the card by default; ``RuntimeError`` without one) and
``dtype`` (the compute dtype; parameters and norm statistics stay
float32) and returns float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import (
    BatchNorm, Conv, Dense, check_input, max_pool_cl, named_child,
    resize_nearest_to, resolve_device)


def _convs(parent: nn.Module, in_channels: int, specs, dtype, device,
           start: int = 0) -> int:
    """Register ``Conv_{start + i}`` for each (features, kernel,
    padding) of ``specs``; returns the last one's channel count."""
    c = in_channels
    for i, (f, k, pad) in enumerate(specs, start=start):
        named_child(parent, f"Conv_{i}", Conv(c, f, k, padding=pad,
                                              dtype=dtype, device=device))
        c = f
    return c


class Simple3DNet(nn.Module):
    """Three convs (reference simple.py:8-21)."""

    def __init__(self, n_out_channels: int = 2, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "Simple3DNet")
        self.n_out_channels = n_out_channels
        self.out_channels = n_out_channels
        self.in_channels = in_channels
        self.dtype = dtype
        self.dim = 3
        _convs(self, in_channels, [(10, (3, 3, 3), "SAME"),
                                   (10, (3, 3, 3), "SAME"),
                                   (n_out_channels, (1, 1, 1), "SAME")],
               dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("Simple3DNet", x, 3, self.in_channels)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x).float()


class Extended3DNet(nn.Module):
    """Deeper net with a pool and a nearest-neighbour resize back to the
    input's size (reference simple.py:23-42)."""

    def __init__(self, n_out_channels: int = 2, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "Extended3DNet")
        self.n_out_channels = n_out_channels
        self.out_channels = n_out_channels
        self.in_channels = in_channels
        self.dtype = dtype
        self.dim = 3
        _convs(self, in_channels, [
            (64, (5, 5, 5), "SAME"), (64, (5, 5, 5), "SAME"),
            (64, (3, 3, 3), 2), (64, (3, 3, 3), "SAME"),
            (64, (3, 3, 3), "VALID"), (n_out_channels, (1, 1, 1), "SAME")],
            dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("Extended3DNet", x, 3, self.in_channels)
        spatial = x.shape[1:-1]
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = max_pool_cl(x, (2, 2, 2))
        for i in (2, 3, 4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return resize_nearest_to(self.Conv_5(x), spatial).float()


_N3D_SPECS = [(20, (1, 5, 5)), (30, (1, 5, 5)), (40, (1, 5, 5)),
              (80, (3, 3, 3)), (100, (3, 3, 3)), (150, (1, 3, 3)),
              (50, (1, 1, 1))]


class N3DNet(nn.Module):
    """Anisotropic conv stack with a pool and a nearest-neighbour resize
    back (reference simple.py:44-65)."""

    def __init__(self, n_out_channels: int = 2, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, "N3DNet")
        self.n_out_channels = n_out_channels
        self.out_channels = n_out_channels
        self.in_channels = in_channels
        self.dtype = dtype
        self.dim = 3
        _convs(self, in_channels,
               [(f, k, "SAME") for f, k in _N3D_SPECS]
               + [(n_out_channels, (1, 1, 1), "SAME")], dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_input("N3DNet", x, 3, self.in_channels)
        spatial = x.shape[1:-1]
        for i in range(len(_N3D_SPECS)):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            if i == 1:
                x = max_pool_cl(x, (2, 2, 2))
        x = getattr(self, f"Conv_{len(_N3D_SPECS)}")(x)
        return resize_nearest_to(x, spatial).float()


def _act(name: str):
    return F.relu if name == "relu" else F.leaky_relu


class Conv3DLayer(nn.Module):
    """'VALID' conv, batch norm (flax's, momentum 0.99), relu or leaky
    relu (slope 0.01), max pool, dropout (reference simple.py:67-86)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], batch_norm: bool = True,
                 pooling: Optional[Sequence[int]] = None,
                 dropout_rate: Optional[float] = None, act: str = "relu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pooling = None if pooling is None else tuple(pooling)
        self.act = act
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size,
                           padding="VALID", dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device) \
            if batch_norm else None
        self.dropout = nn.Dropout(dropout_rate) \
            if dropout_rate is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        x = _act(self.act)(x)
        if self.pooling is not None:
            x = max_pool_cl(x, self.pooling)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


_STACK_SPECS = [(20, (1, 5, 5), (1, 2, 2)), (30, (1, 5, 5), (1, 2, 2)),
                (40, (1, 4, 4), (1, 2, 2)), (50, (1, 4, 4), (1, 2, 2)),
                (60, (1, 2, 2), (1, 2, 2)), (70, (1, 1, 1), (1, 2, 2)),
                (70, (1, 1, 1), None)]


class StackedConv2Scalar(nn.Module):
    """Image-to-scalar classifier (reference simple.py:88-126): seven
    :class:`Conv3DLayer` (``Conv3DLayer_{i}``), the channels-last
    activation flattened in its (D, H, W, C) order, average-pooled to
    100 features in torch's adaptive bins (JAX's
    ``_adaptive_avg_pool_1d``), three ``Dense`` layers. Returns (N,
    n_classes) float32 logits."""

    n_scalar = 0

    def __init__(self, in_channels: int, n_classes: int,
                 dropout_rate: float = 0.05, act: str = "relu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, type(self).__name__)
        self.in_channels = in_channels
        self.n_classes = n_classes
        self.out_channels = n_classes
        self.dropout_rate = dropout_rate
        self.act = act
        self.dtype = dtype
        self.dim = 3
        c = in_channels
        for i, (f, k, p) in enumerate(_STACK_SPECS):
            named_child(self, f"Conv3DLayer_{i}", Conv3DLayer(
                c, f, k, pooling=p, dropout_rate=dropout_rate, act=act,
                dtype=dtype, device=device))
            c = f
        self.Dense_0 = Dense(100 + self.n_scalar, 50, dtype=dtype,
                             device=device)
        self.Dense_1 = Dense(50, 30, dtype=dtype, device=device)
        self.Dense_2 = Dense(30, n_classes, dtype=dtype, device=device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        check_input(type(self).__name__, x, 3, self.in_channels)
        for i in range(len(_STACK_SPECS)):
            x = getattr(self, f"Conv3DLayer_{i}")(x)
        x = x.reshape(x.shape[0], 1, -1)
        if x.shape[-1] != 100:
            x = F.adaptive_avg_pool1d(x, 100)
        return x[:, 0]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        act = _act(self.act)
        x = act(self.Dense_0(x))
        x = act(self.Dense_1(x))
        return self.Dense_2(x).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._head(self._features(x))


class StackedConv2ScalarWithLatentAdd(StackedConv2Scalar):
    """:class:`StackedConv2Scalar` with ``n_scalar`` scalar features
    ``scal`` (N, n_scalar) joined to the pooled features before the
    first ``Dense`` (reference simple.py:128-167): ``forward(x, scal)``."""

    def __init__(self, in_channels: int, n_classes: int,
                 dropout_rate: float = 0.05, act: str = "relu",
                 n_scalar: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        self.n_scalar = n_scalar
        super().__init__(in_channels, n_classes, dropout_rate, act, dtype,
                         device)

    def forward(self, x: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
        feats = self._features(x)
        if scal.dim() != 2 or scal.shape != (x.shape[0], self.n_scalar):
            raise ValueError(f"StackedConv2ScalarWithLatentAdd: scal shape "
                             f"{tuple(scal.shape)}, expected "
                             f"({x.shape[0]}, {self.n_scalar}).")
        return self._head(torch.cat([feats, scal.to(feats.dtype)], dim=-1))
