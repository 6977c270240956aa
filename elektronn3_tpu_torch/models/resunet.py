"""Residual U-Net (ResUNet): the U-Net with residual ConvBlock stacks in
its encoder and decoder levels.

Counterpart of the JAX package's ``models/resunet.py`` (reference
elektronn3/models/resunet.py: ConvBlock :212-262, DownBlock :264-384,
UpBlock :386-457, UNet :598-988), channels-last, with the UNet's whole
configuration surface plus ``enc_res_blocks`` and ``dec_res_blocks``.

- With no residual blocks and ``full_norm`` (the defaults) every level
  is one non-residual ConvBlock, which is the UNet's DownConv/UpConv:
  :class:`ResUNet` then *is* the port's :class:`~.unet.UNet`, with its
  planner (the kernel, flat and library levels, ``pallas_flat``, the
  C=128 gate, ``vup``, ``input_grad``), its parameter layout
  (``down_convs.{i}.conv1``) and its numbers, as JAX's ResUNet runs its
  UNet forward there (``resunet.py:221-225``).
- Otherwise (residual stacks, or ``full_norm=False``, which the
  reference's ConvBlock ignores: it norms conv1 always) the levels are
  :class:`DownBlock` and :class:`UpBlock` on the library ops, every
  level planned 'library', as JAX runs them on XLA and declines its
  executors (``resunet.py:226-235``): the shortcut add between conv2 and
  norm2 is outside the kernels' conv -> statistics -> prologue contract.
  The parameters are the reference's ConvBlock stacks:
  ``down_convs.{i}.convs.{j}.{conv1,norm0,conv2,norm1,proj}``,
  ``up_convs.{i}.{upconv,norm0,attention}`` and
  ``up_convs.{i}.convs.{j}...`` (flax ``down_{i}/conv_{j}/...``).
  Checkpointing recomputes whole blocks, ``'policy'`` too: JAX's
  ResUNet remats its blocks without a policy (``resunet.py:241-244``).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from elektronn3_tpu_torch.models.unet import (
    _CONV, _CONVT, _CONVT_FN, ResizeConv, UNet, _act_module, _checkpointed,
    _conv_pad, _plain_conv, autocrop)
from elektronn3_tpu_torch.modules.layers import (
    GridAttention, apply_norm, ceil_maxpool, conv_kernel, get_activation,
    get_normalization, pool_window)

logger = logging.getLogger("elektronn3_tpu_torch")


class ConvBlock(nn.Module):
    """conv1 -> norm0 -> act -> conv2 [+ shortcut] -> norm1 -> act
    (reference resunet.py:212-262). The shortcut is the block's input,
    center-cropped to conv2's output under ``conv_mode='valid'`` and
    passed through a 1x1 ``proj`` where the channel counts differ."""

    def __init__(self, in_channels: int, out_channels: int,
                 planar: bool = False, activation: str = "relu",
                 normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, dim: int = 3,
                 conv_mode: str = "same", residual: bool = False):
        super().__init__()
        ks = conv_kernel(3, dim, planar)
        pad = _conv_pad(ks, conv_mode)
        self.activation = activation
        self.dtype = dtype
        self.dim = dim
        self.conv_mode = conv_mode
        self.residual = residual
        self.conv1 = _CONV[dim](in_channels, out_channels, ks, padding=pad,
                                device=device)
        self.norm0 = get_normalization(normalization, out_channels, device,
                                       dim)
        self.conv2 = _CONV[dim](out_channels, out_channels, ks, padding=pad,
                                device=device)
        self.proj = _CONV[dim](in_channels, out_channels, 1, device=device) \
            if residual and in_channels != out_channels else None
        self.norm1 = get_normalization(normalization, out_channels, device,
                                       dim)
        self.act = _act_module(activation, device)

    def forward(self, x: torch.Tensor, reference: bool = False
                ) -> torch.Tensor:
        act = self.act if self.act is not None \
            else get_activation(self.activation)
        y = act(apply_norm(self.norm0, _plain_conv(x, self.conv1, self.dtype,
                                                   self.dim), reference))
        y = _plain_conv(y, self.conv2, self.dtype, self.dim)
        if self.residual:
            shortcut = x
            if self.conv_mode == "valid":
                shortcut, y = autocrop(shortcut, y)
            if self.proj is not None:
                shortcut = _plain_conv(shortcut, self.proj, self.dtype,
                                       self.dim)
            y = y + shortcut
        return act(apply_norm(self.norm1, y, reference))


class DownBlock(nn.Module):
    """``max(res_blocks, 1)`` ConvBlocks (``convs``), residual when
    ``res_blocks >= 1`` but for the first of the first level
    (``skip_first_residual``: the raw image has no shortcut), then the
    ceil-mode max pool (reference resunet.py:264-384). Returns (output,
    skip)."""

    def __init__(self, in_channels: int, out_channels: int,
                 pooling: bool = True, planar: bool = False,
                 activation: str = "relu", normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, dim: int = 3,
                 conv_mode: str = "same", res_blocks: int = 0,
                 skip_first_residual: bool = False):
        super().__init__()
        self.pooling = pooling
        self.window = pool_window(dim, planar)
        self.convs = nn.ModuleList(
            ConvBlock(in_channels if b == 0 else out_channels, out_channels,
                      planar, activation, normalization, dtype, device, dim,
                      conv_mode, residual=res_blocks >= 1 and not (
                          b == 0 and skip_first_residual))
            for b in range(max(res_blocks, 1)))

    def forward(self, x: torch.Tensor, reference: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for block in self.convs:
            x = block(x, reference)
        if self.pooling:
            return ceil_maxpool(x, self.window), x
        return x, x


class UpBlock(nn.Module):
    """Upsampling (a transposed conv, or :class:`~.unet.ResizeConv` for
    the resizeconv ``up_mode``\\ s), the skip center-cropped (and gated by
    :class:`GridAttention` with ``attention``), norm0 and the activation
    of the upsampled tensor (always, whatever ``full_norm``), the merge
    ('concat' or 'add'), then ``max(res_blocks, 1)`` ConvBlocks, all
    residual when ``res_blocks >= 1`` (reference resunet.py:386-457)."""

    def __init__(self, in_channels: int, out_channels: int,
                 planar: bool = False, activation: str = "relu",
                 normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, dim: int = 3,
                 conv_mode: str = "same", up_mode: str = "transpose",
                 merge_mode: str = "concat", attention: bool = False,
                 res_blocks: int = 0):
        super().__init__()
        win = pool_window(dim, planar)
        self.activation = activation
        self.dtype = dtype
        self.dim = dim
        self.merge_mode = merge_mode
        if up_mode == "transpose":
            self.upconv = _CONVT[dim](in_channels, out_channels, win,
                                      stride=win, device=device)
        else:
            self.upconv = ResizeConv(
                in_channels, out_channels, 1 if up_mode.endswith("1") else 3,
                planar, dim, "nearest" if "nearest" in up_mode else "linear",
                dtype, device)
        self.attention = GridAttention(out_channels, in_channels, dim,
                                       dtype=dtype, device=device) \
            if attention else None
        self.norm0 = get_normalization(normalization, out_channels, device,
                                       dim)
        self.act = _act_module(activation, device)
        merged = 2 * out_channels if merge_mode == "concat" else out_channels
        self.convs = nn.ModuleList(
            ConvBlock(merged if b == 0 else out_channels, out_channels,
                      planar, activation, normalization, dtype, device, dim,
                      conv_mode, residual=res_blocks >= 1)
            for b in range(max(res_blocks, 1)))

    def forward(self, enc: torch.Tensor, dec: torch.Tensor,
                reference: bool = False) -> torch.Tensor:
        act = self.act if self.act is not None \
            else get_activation(self.activation)
        if isinstance(self.upconv, ResizeConv):
            up = self.upconv(dec)
        else:
            up = _CONVT_FN[self.dim](
                dec.movedim(-1, 1), self.upconv.weight.to(self.dtype),
                self.upconv.bias.to(self.dtype), stride=self.upconv.stride
            ).movedim(1, -1)
        enc, up = autocrop(enc, up)
        if self.attention is not None:
            enc, _ = self.attention(enc, dec)
        up = act(apply_norm(self.norm0, up, reference))
        x = torch.cat([up, enc], dim=-1) if self.merge_mode == "concat" \
            else up + enc
        for block in self.convs:
            x = block(x, reference)
        return x


class ResUNet(UNet):
    """The U-Net with residual ConvBlock stacks (reference resunet.py
    UNet, :598-988): :class:`~.unet.UNet`'s arguments and
    ``enc_res_blocks``/``dec_res_blocks`` (residual ConvBlocks per
    encoder/decoder level; 0, the default, is one plain ConvBlock). See
    the module docstring for the two forms: with no residual blocks and
    ``full_norm`` the model is the UNet (same parameters, plan and
    bits); otherwise every level runs the library ops."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 n_blocks: int = 3, start_filts: int = 32,
                 planar_blocks: Sequence[int] = (),
                 activation: str = "relu", normalization: str = "batch",
                 dim: int = 3, dtype: torch.dtype = torch.float32,
                 device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 pallas_flat: Union[bool, str] = "auto",
                 vup: bool = False, input_grad: bool = False,
                 up_mode: str = "transpose", merge_mode: str = "concat",
                 conv_mode: str = "same", attention: bool = False,
                 full_norm: bool = True,
                 checkpointing: Union[bool, str] = False,
                 logit_dtype: Optional[torch.dtype] = None,
                 enc_res_blocks: int = 0, dec_res_blocks: int = 0):
        if enc_res_blocks < 0 or dec_res_blocks < 0:
            raise ValueError("enc_res_blocks and dec_res_blocks must be "
                             ">= 0")
        # Read by _levels, which UNet.__init__ calls.
        self.enc_res_blocks = enc_res_blocks
        self.dec_res_blocks = dec_res_blocks
        super().__init__(
            in_channels=in_channels, out_channels=out_channels,
            n_blocks=n_blocks, start_filts=start_filts,
            planar_blocks=planar_blocks, activation=activation,
            normalization=normalization, dim=dim, dtype=dtype, device=device,
            generator=generator, pallas_flat=pallas_flat, vup=vup,
            input_grad=input_grad, up_mode=up_mode, merge_mode=merge_mode,
            conv_mode=conv_mode, attention=attention, full_norm=full_norm,
            checkpointing=checkpointing, logit_dtype=logit_dtype)

    @property
    def is_unet(self) -> bool:
        """Whether the model is the UNet (no residual blocks and
        ``full_norm``), else the ConvBlock stacks on the library ops."""
        return self.enc_res_blocks == 0 and self.dec_res_blocks == 0 \
            and self.full_norm

    def _levels(self, device) -> Tuple[nn.ModuleList, nn.ModuleList]:
        if self.is_unet:
            return super()._levels(device)
        common = dict(activation=self.activation,
                      normalization=self.normalization, dtype=self.dtype,
                      device=device, dim=self.dim, conv_mode=self.conv_mode)
        down_convs = nn.ModuleList()
        outs = self.in_channels
        for i in range(self.n_blocks):
            ins = outs
            outs = self.start_filts * 2 ** i
            down_convs.append(DownBlock(
                ins, outs, pooling=i < self.n_blocks - 1,
                planar=i in self.planar_blocks,
                res_blocks=self.enc_res_blocks,
                skip_first_residual=i == 0, **common))
        up_convs = nn.ModuleList()
        for i in range(self.n_blocks - 1):
            ins = outs
            outs = ins // 2
            up_convs.append(UpBlock(
                ins, outs, planar=(self.n_blocks - 2 - i)
                in self.planar_blocks, up_mode=self.up_mode,
                merge_mode=self.merge_mode, attention=self.attention,
                res_blocks=self.dec_res_blocks, **common))
        return down_convs, up_convs

    def level_kinds(self, shape: Sequence[int]) -> List[str]:
        """The UNet's plan, or every level 'library' for the ConvBlock
        stacks (logged once per shape unless ``pallas_flat=False``, as
        JAX logs its decline)."""
        if self.is_unet:
            return super().level_kinds(shape)
        key = (tuple(shape[1:-1]), "resunet")
        if key not in self._plans:
            if self.pallas_flat is not False:
                logger.info(
                    "ResUNet with residual ConvBlock stacks (enc=%d, dec=%d"
                    ", full_norm=%s) runs every level on the library ops: "
                    "the shortcut add between conv2 and norm2 is outside "
                    "the kernels' contract.", self.enc_res_blocks,
                    self.dec_res_blocks, self.full_norm)
            self._plans[key] = ["library"] * self.n_blocks
        return self._plans[key]

    def _conv1_input_grad(self, shape: Sequence[int]) -> bool:
        # JAX's fused conv1 runs only on the UNet path.
        return super()._conv1_input_grad(shape) if self.is_unet else True

    def _forward(self, x: torch.Tensor, reference: bool) -> torch.Tensor:
        if self.is_unet:
            return super()._forward(x, reference)
        self._check_input(x)
        x = x.to(self.dtype).contiguous()
        ckpt = self.checkpointing and self.training \
            and torch.is_grad_enabled()
        skips = []
        for down in self.down_convs:
            x, skip = _checkpointed(down, False, x, reference) if ckpt \
                else down(x, reference)
            skips.append(skip)
        x = skips.pop()   # the bottom level does not pool
        for i, up in enumerate(self.up_convs):
            enc = skips[self.n_blocks - 2 - i]
            x = _checkpointed(up, False, enc, x, reference) if ckpt \
                else up(enc, x, reference)
        return _plain_conv(x, self.conv_final, self.dtype,
                           self.dim).to(self._logit_dtype())
