"""Core building blocks: activations, normalization, kernel helpers,
resizing and the grid attention gate.

Counterpart of the JAX package's ``modules/layers.py`` (reference
elektronn3/models/unet.py:77-199, :452-547). Tensors are channels-last
NDHWC (NHWC in 2D), as in the JAX package; a block that needs PyTorch's
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
    if not norm_layer.training:
        inv, shift = bn_eval_prologue(norm_layer)
        return (x.float() * inv + shift).to(x.dtype)
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    meansq = (xf * xf).mean(dims)
    if axis is not None:
        mean, meansq = (psum(torch.stack([mean, meansq]), axis)
                        / axis.size).unbind(0)
    var = torch.clamp_min(meansq - mean * mean, 0.0)
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


def _same_pad_conv(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: Sequence[int],
                   ) -> torch.Tensor:
    """A strided conv of a channels-last tensor with flax's 'SAME'
    padding (output ceil(n / stride); an odd padding's extra voxel at
    the high end)."""
    dim = x.dim() - 2
    pads = []
    for n, k, s in zip(reversed(x.shape[1:-1]), reversed(weight.shape[2:]),
                       reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    xc = F.pad(x.movedim(-1, 1), pads)
    conv = F.conv2d if dim == 2 else F.conv3d
    return conv(xc, weight, bias, stride=tuple(stride)).movedim(1, -1)


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
        return _same_pad_conv(x, conv.weight.to(self.dtype),
                              conv.bias.to(self.dtype), (1,) * self.dim)

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        theta = _same_pad_conv(x, self.theta.weight.to(self.dtype), None,
                               self.sub)
        phi = self._conv1x1(g.to(self.dtype), self.phi)
        if phi.shape[1:-1] != theta.shape[1:-1]:
            phi = resize_linear(phi, theta.shape[1:-1])
        psi = self._conv1x1(F.relu(theta + phi), self.psi)
        att = resize_linear(torch.sigmoid(psi), x.shape[1:-1])
        return self._conv1x1(x * att, self.out_proj), att
