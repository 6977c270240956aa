"""Core building blocks: activations, normalization, kernel helpers,
resizing and the grid attention gate.

Counterpart of the JAX package's ``modules/layers.py`` (reference
elektronn3/models/unet.py:77-199, :452-547). Tensors are channels-last
NDHWC (NHWC in 2D), as in the JAX package; a block that needs PyTorch's
channels-first convention views them with ``movedim`` and no copy.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.flat_norm import (
    bn_eval_prologue, norm_kind, update_running_stats)
from elektronn3_tpu_torch.modules.pallas_norm import (
    PallasBatchNorm, PallasBatchNorm2d, PallasBatchNorm3d)
from elektronn3_tpu_torch.parallel.collectives import (
    current_stats_group, psum)


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


class PReLU(nn.Module):
    """Parametric ReLU with one learned slope (a 0-d ``weight``, 0.25 at
    first), the JAX package's ``PReLU``: ``where(x >= 0, x, slope * x)``,
    the slope rounded to ``x``'s dtype."""

    def __init__(self, init_slope: float = 0.25,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((), init_slope,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class RReLU(nn.Module):
    """Randomized leaky ReLU, the JAX package's ``RReLU``: in training a
    slope per element drawn uniformly from [lower, upper] by torch's
    generator of ``x``'s device (which ``torch.utils.checkpoint``
    replays in a recompute), in eval the mean slope (lower + upper) / 2."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.where(x >= 0, x,
                               (self.lower + self.upper) / 2 * x)
        slope = torch.empty_like(x).uniform_(self.lower, self.upper)
        return torch.where(x >= 0, x, slope * x)


def get_activation(activation: Union[str, Callable],
                   device: Optional[torch.device] = None) -> Callable:
    """Resolve an activation name (or callable) to a callable. 'prelu'
    and 'rrelu' give a new module (a learned slope, random slopes) that
    the caller owns, as the JAX package's ``get_activation`` does."""
    if callable(activation):
        return activation
    name = activation.lower()
    if name == "prelu":
        return PReLU(device=device)
    if name == "rrelu":
        return RReLU()
    try:
        return _ACTIVATIONS[name]
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
    the unbiased variance instead.

    Inside a :class:`~elektronn3_tpu_torch.parallel.collectives.
    stats_group` the training statistics are the global batch's: the
    per-rank ``E[x]`` and ``E[x^2]`` averaged over its ranks before the
    variance (flax's ``nn.BatchNorm(axis_name=...)``, a ``pmean``); the
    rounding points and the running update stay as above. A 'batchp'
    norm there raises ``ValueError`` when the group has more than one
    rank: its kernels reduce one rank's rows (JAX's 'batchp' takes no
    ``axis_name`` and so normalizes each shard by itself under
    ``shard_map``, which the port does not copy)."""
    if norm_layer is None:
        return x
    if isinstance(norm_layer, GroupNorm):
        return norm_layer(x)
    axis = current_stats_group() if norm_layer.training else None
    if isinstance(norm_layer, PallasBatchNorm):
        if axis is not None and axis.size > 1:
            raise ValueError(
                "normalization='batchp' takes no statistics across ranks; "
                f"its batch norm cannot train over the {axis.size} ranks of "
                f"axis {axis.name!r} (use normalization='batch')")
        return norm_layer(x.contiguous(), reference)
    return batch_norm(norm_layer, x, norm_layer.training)


def batch_norm(norm_layer: nn.Module, x: torch.Tensor, batch_stats: bool,
               update: Optional[bool] = None) -> torch.Tensor:
    """flax ``BatchNorm`` of a channels-last tensor by a module holding
    ``weight``, ``bias``, ``running_mean``, ``running_var``, ``eps`` and
    a torch-style ``momentum`` (the weight of the batch value: flax's
    momentum 0.99 is 0.01), in float32, rounded to ``x``'s dtype once.
    ``batch_stats``: normalize by the batch's mean and biased variance
    (summed over the ranks of an active statistics group), else by the
    running statistics. ``update`` (default: ``batch_stats``): give the
    running statistics the batch's, without autograd."""
    if not batch_stats:
        inv, shift = bn_eval_prologue(norm_layer)
        return (x.float() * inv + shift).to(x.dtype)
    axis = current_stats_group()
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    meansq = (xf * xf).mean(dims)
    if axis is not None:
        mean, meansq = (psum(torch.stack([mean, meansq]), axis)
                        / axis.size).unbind(0)
    var = torch.clamp_min(meansq - mean * mean, 0.0)
    if update is None or update:
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


def resize_nearest(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour upsampling of a channels-last tensor's spatial
    axes by integer factors (each voxel repeated), the JAX package's
    ``resize_nearest``."""
    for axis, f in enumerate(factor, start=1):
        if f != 1:
            x = torch.repeat_interleave(x, f, dim=axis)
    return x


def _linear_weights(n_in: int, n_out: int,
                    device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s 'linear'
    method along one axis (``compute_weight_mat`` with the triangle
    kernel, antialiased: widened by n_in / n_out when shrinking), half-
    pixel centres, each column normalized to sum 1."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = torch.clamp_min(1.0 - dist / max(inv, 1.0), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(Bi-/tri-)linear resize of a channels-last tensor's spatial axes
    to ``size``: ``jax.image.resize(method='linear')`` (antialiased when
    shrinking), the JAX package's ``resize_linear`` and its attention
    gate's resizes. Computed in float32, rounded to ``x``'s dtype once;
    an axis whose size does not change is left as it is."""
    y = x.float()
    for axis, n_out in enumerate(size, start=1):
        n_in = y.shape[axis]
        if n_in != n_out:
            w = _linear_weights(n_in, n_out, y.device)
            y = torch.tensordot(y, w, dims=([axis], [0])).movedim(-1, axis)
    return y.to(x.dtype)


def same_pads(shape: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int], dilation: Sequence[int] = None,
              ) -> List[Tuple[int, int]]:
    """flax's (XLA's) 'SAME' padding per spatial axis: output ceil(n /
    stride), an odd padding's extra voxel at the high end."""
    dilation = dilation or (1,) * len(kernel)
    pads = []
    for n, k, s, d in zip(shape, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pads(padding, shape, kernel, stride, dilation) -> List[Tuple[int, int]]:
    """flax's ``padding`` ('SAME', 'VALID', an int, or one int or (lo,
    hi) pair per axis) as (lo, hi) pairs."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(shape, kernel, stride, dilation)
        if padding.upper() == "VALID":
            return [(0, 0)] * len(shape)
        raise ValueError(f"Unknown padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * len(shape)
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def conv_cl(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], stride: Sequence[int] = None,
            padding="SAME", dilation: Sequence[int] = None,
            groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` of a channels-last tensor (2 or 3 spatial axes)
    by a torch-layout weight (O, I / groups, *k), with flax's
    ``padding``."""
    dim = x.dim() - 2
    k = tuple(weight.shape[2:])
    stride = tuple(stride or (1,) * dim)
    dilation = tuple(dilation or (1,) * dim)
    pads = _pads(padding, x.shape[1:-1], k, stride, dilation)
    xc = F.pad(x.movedim(-1, 1), [p for lo_hi in reversed(pads)
                                  for p in lo_hi])
    conv = F.conv2d if dim == 2 else F.conv3d
    return conv(xc, weight, bias, stride=stride, dilation=dilation,
                groups=groups).movedim(1, -1)


def conv_transpose_cl(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      stride: Sequence[int], padding="SAME") -> torch.Tensor:
    """flax ``nn.ConvTranspose`` (``lax.conv_transpose``, no kernel
    transpose) of a channels-last tensor by a torch-layout weight (I, O,
    *k) whose taps are flax's flipped (``convert.py``'s layout).

    flax pads the stride-dilated input by (lo, hi) per axis
    (``lax._conv_transpose_padding``: 'SAME' gives lo = k - 1 where
    stride > k - 1, else ceil((k + s - 2) / 2), and hi = k + s - 2 - lo;
    'VALID' lo = k - 1 and hi = k - 1 + max(s - k, 0)). torch's
    ``conv_transpose`` with padding 0 pads k - 1 on both sides, so its
    output is cropped (a negative ``F.pad``) or extended by zeros to
    flax's, and the bias is added after. For k = 3, s = 2 and 'SAME'
    that is torch's 2n + 1 outputs cut to the first 2n, not torch's
    ``padding=1, output_padding=1``."""
    dim = x.dim() - 2
    k = tuple(weight.shape[2:])
    stride = tuple(stride)
    if isinstance(padding, str):
        pads = []
        for kk, s in zip(k, stride):
            if padding.upper() == "SAME":
                total = kk + s - 2
                lo = kk - 1 if s > kk - 1 else -(-total // 2)
            elif padding.upper() == "VALID":
                total = kk + s - 2 + max(kk - s, 0)
                lo = kk - 1
            else:
                raise ValueError(f"Unknown padding {padding!r}")
            pads.append((lo, total - lo))
    else:
        pads = _pads(padding, x.shape[1:-1], k, stride, None)
    convt = F.conv_transpose2d if dim == 2 else F.conv_transpose3d
    y = convt(x.movedim(-1, 1), weight, None, stride=stride)
    adjust = [a for (lo, hi), kk in zip(reversed(pads), reversed(k))
              for a in (lo - (kk - 1), hi - (kk - 1))]
    if any(adjust):
        y = F.pad(y, adjust)
    y = y.movedim(1, -1)
    return y if bias is None else y + bias


def resize_nearest_to(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(method='nearest')`` of a channels-last
    tensor's spatial axes to ``size``: half-pixel centres, source index
    floor((i + 0.5) * n_in / n_out), which is torch's 'nearest-exact'
    (not its 'nearest')."""
    if tuple(x.shape[1:-1]) == tuple(size):
        return x
    y = F.interpolate(x.movedim(-1, 1), size=tuple(size),
                      mode="nearest-exact")
    return y.movedim(1, -1)


def resolve_device(device, name: str) -> torch.device:
    """``device``, or the CUDA card when it is None: a model runs on the
    card unless the caller asks for the CPU, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: no CUDA device, and the model runs on the card by "
                "default; pass device='cpu' to build it on the CPU.")
        return torch.device("cuda")
    return torch.device(device)


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init (``lecun_normal``): a normal truncated
    at two standard deviations, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


class Conv(nn.Module):
    """flax ``nn.Conv`` on channels-last tensors (2 or 3 spatial axes,
    by ``kernel_size``): weight (O, I / groups, *k) in float32 (flax's
    kernel (*k, I / groups, O) through ``convert.py``), bias (O,), both
    cast to ``dtype`` at use, flax's ``padding`` ('SAME' by default),
    ``strides``, ``kernel_dilation`` and ``feature_group_count``;
    lecun-normal weights and zero biases, as flax's."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides=None, padding="SAME",
                 kernel_dilation=None, feature_group_count: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        k = tuple(kernel_size)
        dim = len(k)
        self.strides = _to_tuple(strides or 1, dim)
        self.padding = padding
        self.kernel_dilation = _to_tuple(kernel_dilation or 1, dim)
        self.feature_group_count = feature_group_count
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels // feature_group_count) + k,
            device=device))
        lecun_normal_(self.weight, math.prod(self.weight.shape[1:]))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def kernel(self) -> torch.Tensor:
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv_cl(x.to(self.dtype), self.kernel().to(self.dtype), bias,
                       self.strides, self.padding, self.kernel_dilation,
                       self.feature_group_count)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` on channels-last tensors: weight (I, O,
    *k) with flax's taps flipped (``convert.py``), bias (O,), cast to
    ``dtype`` at use, ``padding`` 'SAME' (flax's default) or 'VALID'
    (:func:`conv_transpose_cl`); lecun-normal weights (flax's fan-in
    over (*k, I)) and zero biases."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides=None, padding="SAME",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        k = tuple(kernel_size)
        self.strides = _to_tuple(strides or 1, len(k))
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((in_channels, features) + k,
                                               device=device))
        lecun_normal_(self.weight, in_channels * math.prod(k))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def kernel(self) -> torch.Tensor:
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv_transpose_cl(x.to(self.dtype),
                                 self.kernel().to(self.dtype), bias,
                                 self.strides, self.padding)


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``nn.Linear`` with weight (O, I) (flax's
    kernel (I, O) transposed), cast to ``dtype`` at use; lecun-normal
    weights and zero biases."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__(in_features, features, bias=use_bias, device=device)
        self.dtype = dtype
        lecun_normal_(self.weight, in_features)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (channel) axis
    (:func:`batch_norm`): ``weight``/``bias`` are flax's
    ``scale``/``bias``, ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``. ``momentum`` is flax's (0.99 by
    default; the buffers keep that share of their old value).
    ``use_running_average`` is flax's: None follows the module's mode
    (batch statistics and the running update in training, the running
    statistics in eval), False always takes the batch's (updating the
    buffers in training only), True always the running ones."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5,
                 use_running_average: Optional[bool] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_features = num_features
        self.flax_momentum = momentum
        self.momentum = 1.0 - momentum     # torch's convention
        self.eps = eps
        self.use_running_average = use_running_average
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_average is None:
            return batch_norm(self, x, self.training)
        return batch_norm(self, x, not self.use_running_average,
                          update=self.training)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.flax_momentum}, "
                f"eps={self.eps}, "
                f"use_running_average={self.use_running_average}")


def named_child(parent: nn.Module, name: str, module: nn.Module
                ) -> nn.Module:
    """Register ``module`` under the flax name ``name`` (``Conv_0``,
    ``DenseLayer_3``), so the state_dict key's module path is the flax
    path (``convert.py``'s rule for the model zoo); returns it."""
    parent.add_module(name, module)
    return module


class GridAttention(nn.Module):
    """Additive grid attention gate for a U-Net decoder level, the JAX
    package's ``GridAttention`` (reference unet.py:452-547,
    arXiv:1804.03999): ``theta`` (a stride-2 2x2(x2) conv of the skip,
    no bias, 'SAME' padding), ``phi`` (1x1 of the gating signal, resized
    linearly to theta's shape where it differs), ``psi`` (1x1 to one
    channel) of ``relu(theta + phi)``, its sigmoid resized linearly to
    the skip's shape as the attention map, and ``out_proj`` (1x1) of the
    gated skip; ``in_channels // 2`` channels in between (JAX's
    defaults). Convs compute in ``dtype``; returns (out, attention)."""

    def __init__(self, in_channels: int, gating_channels: int, dim: int = 3,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        conv = nn.Conv2d if dim == 2 else nn.Conv3d
        inter = max(1, in_channels // 2)
        self.dim = dim
        self.dtype = dtype
        self.sub = (2,) * dim
        self.theta = conv(in_channels, inter, self.sub, stride=self.sub,
                          bias=False, device=device)
        self.phi = conv(gating_channels, inter, 1, device=device)
        self.psi = conv(inter, 1, 1, device=device)
        self.out_proj = conv(in_channels, in_channels, 1, device=device)

    def _conv1x1(self, x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
        return conv_cl(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        theta = conv_cl(x, self.theta.weight.to(self.dtype), None, self.sub)
        phi = self._conv1x1(g.to(self.dtype), self.phi)
        if phi.shape[1:-1] != theta.shape[1:-1]:
            phi = resize_linear(phi, theta.shape[1:-1])
        psi = self._conv1x1(F.relu(theta + phi), self.psi)
        att = resize_linear(torch.sigmoid(psi), x.shape[1:-1])
        return self._conv1x1(x * att, self.out_proj), att


class GatherExcite(nn.Module):
    """Gather-Excite attention over a channels-last feature map (the JAX
    package's ``GatherExcite``, reference modules/layers.py:15-96,
    arXiv:1810.12348): ``x * sigmoid(excite(gather(x)))``, the map
    resized linearly (:func:`resize_linear`) to ``x``'s spatial shape
    where the gather shrank it.

    Gather: ``extent == 0`` the global mean, after (``param_gather``)
    stride-2 depthwise 3^d convs with flax's 'SAME' padding that halve
    the map until an axis reaches 1; ``extent > 0`` an average pool of
    window and stride ``extent``, or (``param_gather``) log2(extent)
    such convs. Excite (``param_excite``): a 1^d conv with bias. The
    convs are ``Conv_0`` ... in flax's order. JAX creates the global
    gather's convs at its first call, as many as the input's shape
    needs; here ``spatial_shape`` (the input's spatial shape, required
    for ``extent == 0`` with ``param_gather``) fixes their number, and
    an input that needs another number raises ``ValueError``."""

    def __init__(self, channels: int, extent: int = 0,
                 param_gather: bool = False, param_excite: bool = True,
                 spatial_dim: int = 2, dtype: torch.dtype = torch.float32,
                 spatial_shape: Optional[Sequence[int]] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.channels = channels
        self.extent = extent
        self.param_gather = param_gather
        self.param_excite = param_excite
        self.spatial_dim = spatial_dim
        self.dtype = dtype
        self.spatial_shape = None if spatial_shape is None \
            else tuple(spatial_shape)
        n_gather = 0
        if param_gather:
            if extent == 0:
                if self.spatial_shape is None:
                    raise ValueError(
                        "GatherExcite(extent=0, param_gather=True) needs "
                        "spatial_shape: its number of convs follows it")
                n_gather = self._halvings(self.spatial_shape)
            else:
                n_gather = int(math.log2(extent))
        self.n_gather = n_gather
        for i in range(n_gather):
            named_child(self, f"Conv_{i}", Conv(
                channels, channels, (3,) * spatial_dim,
                strides=(2,) * spatial_dim, padding="SAME",
                feature_group_count=channels, dtype=dtype, device=device))
        if param_excite:
            named_child(self, f"Conv_{n_gather}", Conv(
                channels, channels, (1,) * spatial_dim, dtype=dtype,
                device=device))

    @staticmethod
    def _halvings(spatial: Sequence[int]) -> int:
        n, shape = 0, list(spatial)
        while min(shape) > 1:
            shape = [-(-s // 2) for s in shape]
            n += 1
        return n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(x.shape[1:-1])
        axes = tuple(range(1, x.dim() - 1))
        x = x.to(self.dtype)
        if self.param_gather:
            if self.extent == 0 and self._halvings(spatial) != self.n_gather:
                raise ValueError(
                    f"GatherExcite: input spatial shape {spatial} needs "
                    f"{self._halvings(spatial)} gather convs, built with "
                    f"{self.n_gather} for {self.spatial_shape}")
            g = x
            for i in range(self.n_gather):
                g = getattr(self, f"Conv_{i}")(g)
            gathered = g.mean(axes, keepdim=True) if self.extent == 0 else g
        elif self.extent == 0:
            gathered = x.mean(axes, keepdim=True)
        else:
            pool = F.avg_pool2d if self.spatial_dim == 2 else F.avg_pool3d
            gathered = pool(x.movedim(-1, 1), self.extent,
                            self.extent).movedim(1, -1)
        e = getattr(self, f"Conv_{self.n_gather}")(gathered) \
            if self.param_excite else gathered
        att = torch.sigmoid(e)
        if tuple(att.shape[1:-1]) != spatial:
            att = resize_linear(att, spatial)
        return x * att


class Identity(nn.Module):
    """The identity (the JAX package's ``Identity``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def max_pool_cl(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """flax ``nn.max_pool`` of a channels-last tensor with stride =
    window and 'VALID' padding (a ragged end is dropped)."""
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(x.movedim(-1, 1), tuple(window)).movedim(1, -1)


def check_input(name: str, x: torch.Tensor, dim: int,
                in_channels: Optional[int]) -> None:
    """``ValueError`` unless ``x`` is a channels-last batch of ``dim``
    spatial axes (and ``in_channels`` channels, where given)."""
    if x.dim() != dim + 2 or (in_channels is not None
                              and x.shape[-1] != in_channels):
        layout = "N, D, H, W" if dim == 3 else "N, H, W"
        want = in_channels if in_channels is not None else "C"
        raise ValueError(f"{name}: input shape {tuple(x.shape)}: expected "
                         f"channels-last ({layout}, {want}).")
