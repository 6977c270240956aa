"""The configurable 3D U-Net, training and inference forward, on NDHWC
tensors.

Counterpart of the JAX package's ``models/unet.py`` (reference
elektronn3/models/unet.py:550-935). The public layout is the JAX
package's: ``UNet.forward`` takes and returns channels-last
``(N, D, H, W, C)``. Module names are the reference's torch names
(``down_convs.{i}.conv1``, ``.norm0``, ``up_convs.{i}.upconv``,
``conv_final``), so ``state_dict()`` maps onto the flax tree through
``elektronn3_tpu/models/torch_import.py`` unchanged
(:mod:`elektronn3_tpu_torch.models.convert` goes the other way).

Level plan, decided from level structure alone:

- a planar C=32 level runs the kernels of the JAX C=32 executor: conv1
  and conv2 through :func:`~elektronn3_tpu_torch.ops.fused.conv_bnact`
  with kd=1, the pool through ``pool_bnact`` (1, 2, 2);
- a C=64 level runs the C=64 executor's: kd=3 and a (2, 2, 2) pool, or
  kd=1 and (1, 2, 2) if planar;
- the decoder level of such a level runs ``upconv_bnact`` and the merge
  conv over [upconv output, skip] without building the concat;
- C >= 128 levels, the bottom level and the 1x1 head run plain torch,
  as those run in XLA in the JAX headline plan.

A level whose structure the kernels do not take (odd H or W, an odd
depth under a (2, 2, 2) pool, an activation without a kernel prologue)
runs plain torch, and the reason is logged once per input shape. This is
a plan declared from shapes, not a fallback on failure.

In training (``model.train()``) the kernel levels take their batch
statistics from the convs' side outputs (``want_stats``) and build each
consumer's prologue from them (``bn_train_prologue``, as
``_want_stats``/``_stats_prologue`` do in JAX); the plain levels use
``apply_norm``'s batch statistics. Gradients come from the ops'
backward kernels and, elsewhere, from autograd. In eval the batch norms
use running statistics and the forward builds no autograd graph.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.flat_norm import (
    bn_eval_prologue, bn_train_prologue, identity_prologue, norm_kind)
from elektronn3_tpu_torch.modules.layers import (
    apply_norm, conv_kernel, get_activation, get_normalization, pool_window)
from elektronn3_tpu_torch.ops import fused
from elektronn3_tpu_torch.ops.fused import FusedActs

logger = logging.getLogger("elektronn3_tpu_torch")

_KERNEL_ACTS = {"relu": "relu", "leaky": "leaky", "lrelu": "leaky"}


def _ceil_maxpool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pool with ceil_mode=True semantics (the reference DownConv's
    MaxPool(ceil_mode=True)): no input element is dropped at odd
    sizes."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(window), tuple(window),
                     ceil_mode=True)
    return y.permute(0, 2, 3, 4, 1)


def autocrop(from_down: torch.Tensor, from_up: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop encoder/decoder features so they can be merged (reference
    unet.py:256-325): crop the upsampled tensor by 1 where the size
    difference is odd (ceil-mode pooling), then center-crop the encoder
    tensor to the decoder's size."""
    ds = from_down.shape[1:-1]
    us = from_up.shape[1:-1]
    if ds == us:
        return from_down, from_up
    upcrop = [u - ((u - d) % 2) for d, u in zip(ds, us)]
    from_up = from_up[(slice(None),)
                      + tuple(slice(0, c) for c in upcrop)]
    us = from_up.shape[1:-1]
    if any(d < u for d, u in zip(ds, us)):
        raise ValueError(f"Encoder feature smaller than decoder: {tuple(ds)}"
                         f" vs {tuple(us)}")
    from_down = from_down[(slice(None),) + tuple(
        slice((d - u) // 2, (d + u) // 2) for d, u in zip(ds, us))]
    return from_down, from_up


def _xavier_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Xavier/Glorot normal (reference unet.py:883-892): std =
    sqrt(2 / (fan_in + fan_out)), the same for conv and transposed-conv
    weights."""
    rf = math.prod(w.shape[2:])
    std = math.sqrt(2.0 / ((w.shape[0] + w.shape[1]) * rf))
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen) * std)


def _init_conv(conv: nn.Module, gen: torch.Generator) -> None:
    _xavier_(conv.weight, gen)
    with torch.no_grad():
        conv.bias.zero_()


def _plain_conv(x: torch.Tensor, conv: nn.Conv3d,
                dtype: torch.dtype) -> torch.Tensor:
    """Library conv on an NDHWC tensor (channels_last_3d view)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight.to(dtype),
                 conv.bias.to(dtype), padding=conv.padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _kernel_params(conv: nn.Conv3d, dtype: torch.dtype,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 3x3 conv's (weight, bias) as the JAX executors pass them: the
    C=32 executor rounds both to the model dtype (flat_fused.py
    conv_bnact_flat), so their gradients come back through that cast;
    the C=64 executor takes the float32 parameters."""
    if conv.out_channels == 32:
        return conv.weight.to(dtype), conv.bias.to(dtype)
    return conv.weight, conv.bias


def _norm_pro(norm: Optional[nn.BatchNorm3d], out) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """The (inv, shift) prologue of a kernel op's output ``out``: (y, s,
    q) in training, where the norm takes the batch statistics (s, q),
    else the output alone, whose norm takes the running statistics."""
    y = out[0] if isinstance(out, tuple) else out
    if norm is None:
        return identity_prologue(y.shape[-1], y.device)
    if isinstance(out, tuple):
        return bn_train_prologue(norm, out[1], out[2], y.numel() // y.shape[-1])
    return bn_eval_prologue(norm)


def _raw(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def _stats(norm: Optional[nn.BatchNorm3d]) -> bool:
    """Whether a conv feeding ``norm`` returns its batch statistics:
    batch norm in training (``_want_stats`` of the JAX UNet)."""
    return norm is not None and norm.training


class DownConv(nn.Module):
    """Two convolutions + optional max pool (reference unet.py:202-253):
    conv -> norm -> act -> conv -> norm -> act -> pool."""

    def __init__(self, in_channels: int, out_channels: int,
                 pooling: bool = True, planar: bool = False,
                 activation: str = "relu", normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        ks = conv_kernel(3, 3, planar)
        pad = tuple(k // 2 for k in ks)
        self.pooling = pooling
        self.planar = planar
        self.activation = activation
        self.dtype = dtype
        self.conv1 = nn.Conv3d(in_channels, out_channels, ks, padding=pad,
                               device=device)
        self.conv2 = nn.Conv3d(out_channels, out_channels, ks, padding=pad,
                               device=device)
        self.norm0 = get_normalization(normalization, out_channels, device)
        self.norm1 = get_normalization(normalization, out_channels, device)

    def forward(self, x: torch.Tensor, kernels: bool = False,
                reference: bool = False):
        """Returns (output, skip). On the kernel plan the output is the
        pooled tensor and the skip is :class:`FusedActs` of conv2's raw
        output; otherwise both are plain tensors."""
        window = pool_window(3, self.planar)
        if kernels:
            act = _KERNEL_ACTS[self.activation]
            # conv1 takes the float32 weight and bias in both JAX
            # executors (the C=32 one through conv1_bnstats_flat); its
            # input is the network input (or the pool), which gets no
            # input gradient kernel unless it requires one.
            out1 = fused.conv_bnact([x], None, None, self.conv1.weight,
                                    self.conv1.bias, "linear",
                                    want_stats=_stats(self.norm0),
                                    reference=reference)
            inv1, shift1 = _norm_pro(self.norm0, out1)
            w2, b2 = _kernel_params(self.conv2, self.dtype)
            out2 = fused.conv_bnact([_raw(out1)], inv1, shift1, w2, b2, act,
                                    want_stats=_stats(self.norm1),
                                    reference=reference)
            inv2, shift2 = _norm_pro(self.norm1, out2)
            y2 = _raw(out2)
            skip = FusedActs(y2, inv2, shift2)
            return (fused.pool_bnact(y2, inv2, shift2, act, window,
                                     reference=reference), skip)
        act = get_activation(self.activation)
        y = act(apply_norm(self.norm0, _plain_conv(x, self.conv1,
                                                   self.dtype)))
        y = act(apply_norm(self.norm1, _plain_conv(y, self.conv2,
                                                   self.dtype)))
        if self.pooling:
            return _ceil_maxpool(y, window), y
        return y, y


class UpConv(nn.Module):
    """Transposed-conv upsampling, concat merge with the skip, two
    convolutions (reference unet.py:328-409): upconv -> norm -> act ->
    concat -> conv -> norm -> act -> conv -> norm -> act."""

    def __init__(self, in_channels: int, out_channels: int,
                 planar: bool = False, activation: str = "relu",
                 normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        ks = conv_kernel(3, 3, planar)
        pad = tuple(k // 2 for k in ks)
        win = pool_window(3, planar)
        self.planar = planar
        self.activation = activation
        self.dtype = dtype
        self.upconv = nn.ConvTranspose3d(in_channels, out_channels, win,
                                         stride=win, device=device)
        self.conv1 = nn.Conv3d(2 * out_channels, out_channels, ks,
                               padding=pad, device=device)
        self.conv2 = nn.Conv3d(out_channels, out_channels, ks, padding=pad,
                               device=device)
        self.norm0 = get_normalization(normalization, out_channels, device)
        self.norm1 = get_normalization(normalization, out_channels, device)
        self.norm2 = get_normalization(normalization, out_channels, device)

    def forward(self, enc, dec, kernels: bool = False,
                reference: bool = False):
        """``enc`` is the skip of the same level, ``dec`` the deeper
        level's output (a tensor, or :class:`FusedActs` from a kernel
        decoder level). Returns :class:`FusedActs` on the kernel plan,
        a tensor otherwise."""
        if kernels:
            act = _KERNEL_ACTS[self.activation]
            # The upconv takes the float32 weight and bias in both JAX
            # upconv kernels (upconv222_bn_flat64, upconv122_from_flat64).
            if isinstance(dec, FusedActs):
                outu = fused.upconv_bnact(
                    dec.raw, dec.inv, dec.shift, self.upconv.weight,
                    self.upconv.bias, act, want_stats=_stats(self.norm0),
                    reference=reference)
            else:
                outu = fused.upconv_bnact(
                    dec, None, None, self.upconv.weight, self.upconv.bias,
                    "linear", want_stats=_stats(self.norm0),
                    reference=reference)
            invu, shiftu = _norm_pro(self.norm0, outu)
            w1, b1 = _kernel_params(self.conv1, self.dtype)
            out1 = fused.conv_bnact(
                [_raw(outu), enc.raw], torch.cat([invu, enc.inv]),
                torch.cat([shiftu, enc.shift]), w1, b1, act,
                want_stats=_stats(self.norm1), reference=reference)
            inv1, shift1 = _norm_pro(self.norm1, out1)
            w2, b2 = _kernel_params(self.conv2, self.dtype)
            out2 = fused.conv_bnact([_raw(out1)], inv1, shift1, w2, b2, act,
                                    want_stats=_stats(self.norm2),
                                    reference=reference)
            inv2, shift2 = _norm_pro(self.norm2, out2)
            return FusedActs(_raw(out2), inv2, shift2)
        act = get_activation(self.activation)
        if isinstance(dec, FusedActs):
            dec = fused.materialize(dec, _KERNEL_ACTS[self.activation])
        up = F.conv_transpose3d(
            dec.permute(0, 4, 1, 2, 3), self.upconv.weight.to(self.dtype),
            self.upconv.bias.to(self.dtype), stride=self.upconv.stride)
        up = up.permute(0, 2, 3, 4, 1)
        enc, up = autocrop(enc, up)
        up = act(apply_norm(self.norm0, up))
        y = torch.cat([up, enc], dim=-1)
        y = act(apply_norm(self.norm1, _plain_conv(y, self.conv1,
                                                   self.dtype)))
        return act(apply_norm(self.norm2, _plain_conv(y, self.conv2,
                                                      self.dtype)))


class UNet(nn.Module):
    """Configurable 3D U-Net for dense prediction.

    Input: channels-last ``(N, D, H, W, in_channels)``. Output: logits
    ``(N, D, H, W, out_channels)``, bfloat16 for a bfloat16 model,
    float32 otherwise.

    Parameters are float32; ``dtype`` is the activation (compute)
    dtype, to which weights are cast at use, as the JAX package's
    ``param_dtype``/``dtype`` split does. Weights are xavier-normal and
    biases zero, drawn from ``generator`` (a fresh one seeded 0 if
    None) on the CPU and moved to ``device``.

    Ported configuration surface: the JAX UNet's defaults ``dim=3``,
    ``up_mode='transpose'``, ``merge_mode='concat'``, ``conv_mode='same'``,
    ``full_norm=True``, ``logit_dtype=None``, with normalization 'batch'
    or 'none'.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 n_blocks: int = 3, start_filts: int = 32,
                 planar_blocks: Sequence[int] = (),
                 activation: str = "relu", normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_blocks < 1:
            raise ValueError("n_blocks must be > 0")
        if planar_blocks and (max(planar_blocks) >= n_blocks
                              or min(planar_blocks) < 0):
            raise ValueError("planar_blocks has invalid value range")
        norm_kind(normalization, start_filts)   # validates the name
        get_activation(activation)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_blocks = n_blocks
        self.start_filts = start_filts
        self.planar_blocks = tuple(planar_blocks)
        self.activation = activation
        self.normalization = normalization
        self.dtype = dtype
        self._plans: Dict[Tuple[int, ...], List[bool]] = {}

        common = dict(activation=activation, normalization=normalization,
                      dtype=dtype, device=device)
        self.down_convs = nn.ModuleList()
        outs = in_channels
        for i in range(n_blocks):
            ins = outs
            outs = start_filts * 2 ** i
            self.down_convs.append(DownConv(
                ins, outs, pooling=i < n_blocks - 1,
                planar=i in self.planar_blocks, **common))
        self.up_convs = nn.ModuleList()
        for i in range(n_blocks - 1):
            ins = outs
            outs = ins // 2
            level = n_blocks - 2 - i
            self.up_convs.append(UpConv(
                ins, outs, planar=level in self.planar_blocks, **common))
        self.conv_final = nn.Conv3d(outs, out_channels, 1, device=device)

        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                _init_conv(m, gen)

    def _logit_dtype(self) -> torch.dtype:
        """bf16 logits for a bf16 model (they halve the logit volume's
        traffic; the Predictor upcasts before softmax), float32
        otherwise."""
        return torch.bfloat16 if self.dtype == torch.bfloat16 \
            else torch.float32

    def _kernel_decline_reason(self, i: int, D: int, H: int,
                               W: int) -> Optional[str]:
        """None if encoder level ``i`` (and its decoder level) runs the
        kernels at level shape (D, H, W), else the reason it does not."""
        ch = self.start_filts * 2 ** i
        planar = i in self.planar_blocks
        if self.activation not in _KERNEL_ACTS:
            return f"activation {self.activation!r} has no kernel prologue"
        if i == self.n_blocks - 1:
            return "bottom level runs plain torch"
        if ch not in (32, 64):
            return f"C={ch} runs plain torch (kernels cover C=32 and 64)"
        if ch == 32 and not planar:
            return "C=32 kernels are planar-only"
        if H % 2 or W % 2:
            return f"odd level shape H={H}, W={W}"
        if not planar and D % 2:
            return f"odd depth D={D} with (2,2,2) pooling"
        return None

    def plan(self, shape: Sequence[int]) -> List[bool]:
        """Per-level kernel plan for an input of ``shape`` (N, D, H, W,
        C); each level's decline reason is logged once per shape."""
        key = tuple(shape[1:4])
        if key in self._plans:
            return self._plans[key]
        D, H, W = key
        kernels = []
        for i in range(self.n_blocks):
            reason = self._kernel_decline_reason(i, D, H, W)
            kernels.append(reason is None)
            if reason is not None:
                logger.info("UNet level %d (C=%d, %dx%dx%d): %s.", i,
                            self.start_filts * 2 ** i, D, H, W, reason)
            if i < self.n_blocks - 1:
                H, W = -(-H // 2), -(-W // 2)
                if i not in self.planar_blocks:
                    D = -(-D // 2)
        self._plans[key] = kernels
        return kernels

    def forward(self, x: torch.Tensor, *,
                reference: bool = False) -> torch.Tensor:
        """Forward of a channels-last batch: with batch statistics and an
        autograd graph in training, with running statistics and no graph
        in eval. ``reference=True`` runs every kernel's plain PyTorch
        version instead, on any device (to hold the kernels against it
        on the card)."""
        if self.training:
            return self._forward(x, reference)
        with torch.no_grad():
            return self._forward(x, reference)

    def _forward(self, x: torch.Tensor, reference: bool) -> torch.Tensor:
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(
                f"Input shape {tuple(x.shape)}: expected channels-last "
                f"(N, D, H, W, {self.in_channels}).")
        kernels = self.plan(x.shape)
        x = x.to(self.dtype).contiguous()
        skips = []
        for i, down in enumerate(self.down_convs):
            x, skip = down(x, kernels[i], reference)
            skips.append(skip)
        x = skips.pop()   # the bottom level does not pool
        for i, up in enumerate(self.up_convs):
            level = self.n_blocks - 2 - i
            x = up(skips[level], x, kernels[level], reference)
        if isinstance(x, FusedActs):
            # The C=32 head rounds its weight and bias to the model
            # dtype before the float32 GEMM (head_bnact_from_flat).
            return fused.head_bnact(
                x, _KERNEL_ACTS[self.activation],
                self.conv_final.weight.to(self.dtype),
                self.conv_final.bias.to(self.dtype), self._logit_dtype())
        return _plain_conv(x, self.conv_final,
                           self.dtype).to(self._logit_dtype())
