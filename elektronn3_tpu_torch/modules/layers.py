"""Core building blocks: activations, normalization, kernel helpers.

Counterpart of the JAX package's ``modules/layers.py`` (reference
elektronn3/models/unet.py:77-199). Tensors are channels-last NDHWC (NHWC
in 2D), as in the JAX package; a block that needs PyTorch's
channels-first convention views them with ``movedim`` and no copy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.flat_norm import (
    bn_eval_prologue, norm_kind, update_running_stats)
from elektronn3_tpu_torch.modules.pallas_norm import (
    PallasBatchNorm, PallasBatchNorm2d, PallasBatchNorm3d)


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's 'gelu' (flax ``nn.gelu``, i.e. ``jax.nn.gelu``
    with its default ``approximate=True``): the tanh form, not the
    exact erf form of ``F.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "leaky": leaky_relu01,
    "lrelu": leaky_relu01,
    "gelu": gelu_tanh,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "lin": lambda x: x,
    "none": lambda x: x,
}


def get_activation(activation: Union[str, Callable]) -> Callable:
    """Resolve an activation name (or callable) to a callable.
    'prelu' and 'rrelu' (learned or random slopes) are not ported yet."""
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation.lower()]
    except KeyError:
        raise ValueError(f"Unknown activation: {activation!r}") from None


class GroupNorm(nn.Module):
    """Group norm over a channels-last tensor, flax ``nn.GroupNorm``'s
    (the JAX package's 'group', 'group<G>' and 'instance'): per sample
    and group of C / ``num_groups`` channels, float32 statistics over
    the spatial positions and the group's channels, ``mean = E[x]`` and
    ``var = max(E[x^2] - mean^2, 0)`` (flax's ``use_fast_variance``),
    then ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
    rounded to ``x``'s dtype once. ``weight`` and ``bias`` are (C,), as
    flax's ``scale`` and ``bias``; there is no running state, so train
    and eval are the same. eps is flax's default, 1e-6. A channel count
    that ``num_groups`` does not divide raises at the call, as flax
    does."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-6, device: Optional[torch.device] = None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, g = x.shape[-1], self.num_groups
        if g <= 0 or c % g:
            raise ValueError(f"Number of groups ({g}) does not divide the "
                             f"number of channels ({c}).")
        xf = x.float()
        b = x.shape[0]
        xg = xf.reshape(b, -1, g, c // g)
        mean = xg.mean(dim=(1, 3))                               # (B, g)
        var = torch.clamp_min((xg * xg).mean(dim=(1, 3)) - mean * mean, 0.0)
        gs = c // g
        view = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(gs, dim=1).view(view)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(gs, dim=1) \
            .view(view) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_groups}, {self.num_channels}, eps={self.eps}"


def get_normalization(norm: Optional[str], channels: int,
                      device: Optional[torch.device] = None, dim: int = 3,
                      ) -> Optional[nn.Module]:
    """Build a normalization layer by name: 'batch' gives
    ``nn.BatchNorm3d`` (``nn.BatchNorm2d`` for ``dim=2``; eps 1e-5;
    torch momentum 0.1 is flax's 0.9), 'batchp' the same with the
    hand-written kernels of ``ops/pallas_bn.py`` as its forward
    (``PallasBatchNorm3d``/``2d``), 'group' (8 groups), 'group<G>' and
    'instance' (one group per channel) a :class:`GroupNorm` (eps 1e-6,
    flax's), 'none'/None gives None. The prologue vectors of
    ``flat_norm`` use only a module's buffers and affine parameters."""
    if norm is None or norm == "none":
        return None
    if norm == "batch":
        cls = nn.BatchNorm2d if dim == 2 else nn.BatchNorm3d
    elif norm == "batchp":
        cls = PallasBatchNorm2d if dim == 2 else PallasBatchNorm3d
    else:
        return GroupNorm(norm_kind(norm, channels)[1], channels,
                         device=device)
    return cls(channels, eps=1e-5, momentum=0.1, device=device)


def apply_norm(norm_layer: Optional[nn.Module], x: torch.Tensor,
               reference: bool = False) -> torch.Tensor:
    """Apply a norm layer to an NDHWC tensor, computing in float32 and
    rounding to ``x``'s dtype once. A :class:`GroupNorm` runs as it is.

    A ``PallasBatchNorm`` ('batchp') runs its op (``ops/pallas_bn.py``;
    ``reference`` selects the plain versions of its kernels). An
    ``nn.BatchNorm`` ('batch') runs here in plain torch. Eval: the
    running statistics. Training: flax ``BatchNorm``'s statistics of the
    batch, ``mean = E[x]`` and the biased ``var = max(E[x^2] - mean^2,
    0)``, normalized as ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` and differentiable through the statistics; the running
    statistics get flax's momentum update (see ``update_running_stats``).
    ``F.batch_norm(training=True)`` would update ``running_var`` with
    the unbiased variance instead."""
    if norm_layer is None:
        return x
    if isinstance(norm_layer, GroupNorm):
        return norm_layer(x)
    if isinstance(norm_layer, PallasBatchNorm):
        return norm_layer(x.contiguous(), reference)
    if not norm_layer.training:
        inv, shift = bn_eval_prologue(norm_layer)
        return (x.float() * inv + shift).to(x.dtype)
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
    update_running_stats(norm_layer, mean, var)
    mul = torch.rsqrt(var + norm_layer.eps) * norm_layer.weight.float()
    return ((xf - mean) * mul + norm_layer.bias.float()).to(x.dtype)


def ceil_maxpool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pool of a channels-last (N, *spatial, C) tensor, 2 or 3
    spatial dims, stride = window, with ceil_mode=True semantics (the
    reference DownConv's MaxPool(ceil_mode=True)): no input element is
    dropped at odd sizes."""
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    y = pool(x.movedim(-1, 1), tuple(window), tuple(window), ceil_mode=True)
    return y.movedim(1, -1)


def conv_kernel(kernel_size: Union[int, Sequence[int]], dim: int,
                planar: bool) -> Tuple[int, ...]:
    ks = _to_tuple(kernel_size, dim)
    if planar and dim == 3:
        ks = (1,) + ks[1:]
    return ks


def pool_window(dim: int, planar: bool, size: int = 2) -> Tuple[int, ...]:
    if dim == 2:
        return (size, size)
    if planar:
        return (1, size, size)
    return (size, size, size)


def _to_tuple(x, n: int) -> Tuple[int, ...]:
    if isinstance(x, int):
        return (x,) * n
    t = tuple(x)
    if len(t) != n:
        raise ValueError(f"expected {n} sizes, got {t}")
    return t
