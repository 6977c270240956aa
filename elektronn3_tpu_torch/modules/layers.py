"""Core building blocks: activations, normalization, kernel helpers.

Counterpart of the JAX package's ``modules/layers.py`` (reference
elektronn3/models/unet.py:77-199). Tensors are channels-last NDHWC, as
in the JAX package; a block that needs PyTorch's NCDHW convention views
them with ``permute`` and no copy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.flat_norm import (
    bn_eval_prologue, update_running_stats)


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


_ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "leaky": leaky_relu01,
    "lrelu": leaky_relu01,
    "gelu": F.gelu,
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


def get_normalization(norm: Optional[str], channels: int,
                      device: Optional[torch.device] = None,
                      ) -> Optional[nn.Module]:
    """Build a normalization layer by name: 'batch' gives
    ``nn.BatchNorm3d`` (eps 1e-5; torch momentum 0.1 is flax's 0.9),
    'none'/None gives None. Group and instance norm are not ported
    yet."""
    if norm is None or norm == "none":
        return None
    if norm == "batch":
        return nn.BatchNorm3d(channels, eps=1e-5, momentum=0.1,
                              device=device)
    raise NotImplementedError(
        f"normalization {norm!r} is not ported yet (batch and none are)")


def apply_norm(norm_layer: Optional[nn.Module],
               x: torch.Tensor) -> torch.Tensor:
    """Apply a batch norm layer to an NDHWC tensor, computing in float32
    and rounding to ``x``'s dtype once.

    Eval: the running statistics. Training: flax ``BatchNorm``'s
    statistics of the batch, ``mean = E[x]`` and the biased
    ``var = max(E[x^2] - mean^2, 0)``, normalized as ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` and differentiable through the
    statistics; the running statistics get flax's momentum update (see
    ``update_running_stats``). ``F.batch_norm(training=True)`` would
    update ``running_var`` with the unbiased variance instead."""
    if norm_layer is None:
        return x
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
