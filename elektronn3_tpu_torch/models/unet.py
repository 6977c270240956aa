"""The configurable U-Net (3D or 2D), training and inference forward,
on channels-last tensors.

Counterpart of the JAX package's ``models/unet.py`` (reference
elektronn3/models/unet.py:550-935). The public layout is the JAX
package's: ``UNet.forward`` takes and returns channels-last
``(N, D, H, W, C)`` (``(N, H, W, C)`` for ``dim=2``). Module names are
the reference's torch names (``down_convs.{i}.conv1``, ``.norm0``,
``up_convs.{i}.upconv``, ``conv_final``), so ``state_dict()`` maps onto
the flax tree through ``elektronn3_tpu/models/torch_import.py``
unchanged (:mod:`elektronn3_tpu_torch.models.convert` goes the other
way).

Level plan, decided from level shapes alone (``UNet.plan``), as the
JAX UNet's ``pallas_flat`` plans its executors:

- a planar C=32 level runs the kernels of the JAX C=32 executor: conv1
  and conv2 through :func:`~elektronn3_tpu_torch.ops.fused.conv_bnact`
  with kd=1, the pool through ``pool_bnact`` (1, 2, 2);
- a C=64 or C=128 level runs the C=64 executor's (which JAX also runs
  at C=128): kd=3 and a (2, 2, 2) pool, or kd=1 and (1, 2, 2) if
  planar;
- the decoder level of such a level runs ``upconv_bnact`` and the merge
  conv over [upconv output, skip] without building the concat. Its
  upconv takes the deeper level's output as it comes: a plain tensor
  from a library level, or the carried activation (:class:`FusedActs`)
  of a kernel decoder level, whose prologue the upconv applies on load
  (JAX's ``upconv222_f64in``/``upconv122_f64in`` at C_in=128 and
  ``upconv122_from_flat64`` at 64);
- with ``vup=True`` (JAX's opt-in vup path, ``E3TPU_VUP=1`` there), a
  planar C=32 kernel decoder level whose deeper level is a kernel
  decoder level (a carried C=64 activation) takes no upconv output:
  :func:`~elektronn3_tpu_torch.ops.vup.conv_vup` recomputes the
  (1, 2, 2) upconv of the carry as the merge conv reads it, and
  :func:`~elektronn3_tpu_torch.ops.vup.upconv_stats` gives its batch
  statistics in training, or its per-sample statistics under a group
  norm in training and eval (rows 1's vup mode, 9, 22 and 23). The same
  parameters and batch-statistics slots as the materializing path;
- under ``pallas_flat=True``, a planar 3D level of C=32 or 64 whose
  activation has no kernel prologue (silu, swish, gelu, tanh) runs
  JAX's semi-fused flat executor (``_flat_level_ok``), and so does its
  decoder level: conv2, the decoder's merge conv over [upconv output,
  skip] and its conv2 through
  :func:`~elektronn3_tpu_torch.ops.flat_conv.flat_conv3` (K1 with the
  identity prologue; backward K4/K5), conv1, the upconv and the head on
  the library ops (XLA in JAX), each batch norm as JAX's
  ``FlatBatchNorm`` (:func:`~elektronn3_tpu_torch.modules.flat_norm.
  flat_batch_norm`) followed by the activation, and the pool through
  ``pool_flat``; the skip is the activated tensor;
- C >= 256 levels, the bottom level and the 1x1 head run plain torch,
  as those run in XLA in JAX (a bottom level that is flat runs the flat
  executor's encoder without its pool). Under
  ``normalization='batchp'`` the batch norms of every level on the
  library ops run the hand-written kernels of ``ops/pallas_bn.py``
  (K8-K11), as they run ``PallasBatchNorm`` in JAX, while a kernel
  level takes its statistics from its convs as under ``'batch'``.

The configuration surface follows JAX's structural declines: under
``conv_mode='valid'`` or ``attention=True`` every level runs the library
ops; a resizeconv ``up_mode`` runs its decoder levels on the library
(:meth:`UNet.decoder_kinds`; a kernel encoder level's skip is then
materialized); ``merge_mode='add'`` keeps the plan, its kernel merge
convs running K1 over [upconv output, skip] with the weight doubled
along C_in.

``pallas_flat`` is the JAX argument: False runs every level on the
library ops; True every level the kernels take by structure, and the
flat levels; ``'auto'`` (the default) the kernel levels alone, except
that a C=128 level of fewer than :data:`FUSED128_MIN_VOX` voxels runs
the library ops (JAX's C=128 voxel gate, with JAX's value).
:meth:`UNet.level_kinds` gives each level's kind, :meth:`UNet.plan`
whether it runs the kernels.

A 2D model (``dim=2``) holds 2D parameters (``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``) and carries 4-D tensors.
Every 2D level counts as planar: a kernel level runs the same ops as a
planar 3D level on the D=1 view (the input ``x.unsqueeze(1)``, conv
weights ``w.unsqueeze(2)`` with kd=1, upconv weights ``w.unsqueeze(2)``
as a (1, 2, 2) kernel, the (1, 2, 2) pool window; the views carry the
gradient back to the 2D parameters), as the JAX package's
``_lift2d``/``_k2d``/``_drop2d`` do. A plain 2D level runs the library
2D ops.

A level whose structure the kernels do not take (odd H or W, an odd
depth under a (2, 2, 2) pool, an activation without a kernel prologue)
and that is not flat runs plain torch, and the reason is logged once
per input shape, as is each flat level. This is a plan declared from
shapes, not a fallback on failure.

In training (``model.train()``) the kernel levels take their batch
statistics from the convs' side outputs (``want_stats``) and build each
consumer's prologue from them (``bn_train_prologue``, as
``_want_stats``/``_stats_prologue`` do in JAX); the plain levels use
``apply_norm``'s batch statistics. Gradients come from the ops'
backward kernels and, elsewhere, from autograd. In eval the batch norms
use running statistics and the forward builds no autograd graph.

Group and instance norm (``'group'``, ``'group<G>'``, ``'instance'``)
have no running state: a kernel level takes per-sample statistics from
every conv, in training and in eval (``want_stats='per_sample'``), and
its consumers apply (N, C) prologue vectors (``gn_prologue``, JAX's
``FlatGNStats``); a library level runs :class:`GroupNorm` (flax
``nn.GroupNorm``, as XLA does in JAX). Serving and training both run
the kernels in that mode: the backward kernels take the (N, C)
statistics cotangents that autograd carries back through
``gn_prologue`` and give (N, C) prologue gradients, as JAX's
``per_sample`` backward kernels do. So do the vup path's five entries
(``vup=True``) and a 2D model's kernel levels (the same ops on the D=1
view).
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from elektronn3_tpu_torch.modules.flat_norm import (
    bn_eval_prologue, bn_train_prologue, flat_batch_norm, gn_prologue,
    identity_prologue, norm_kind)
from elektronn3_tpu_torch.modules.layers import (
    GridAttention, GroupNorm, apply_norm, ceil_maxpool, conv_kernel,
    get_activation, get_normalization, pool_window, resize_linear,
    resize_nearest, resolve_device)
from elektronn3_tpu_torch.ops import fused, vup
from elektronn3_tpu_torch.ops.flat_conv import flat_conv3, pool_flat
from elektronn3_tpu_torch.ops.fused import FusedActs
from elektronn3_tpu_torch.parallel.collectives import (
    current_stats_group, stats_group)
from elektronn3_tpu_torch.parallel.mesh import active_mesh

logger = logging.getLogger("elektronn3_tpu_torch")

_KERNEL_ACTS = {"relu": "relu", "leaky": "leaky", "lrelu": "leaky"}
# The flat executor's activations: JAX's _FLAT_SAFE_ACTS
# (elektronn3_tpu/models/unet.py:72-73) without those that have a
# kernel prologue (their levels run the kernels) and without 'prelu'
# (its levels run the library ops).
_FLAT_ACTS = ("silu", "swish", "gelu", "tanh")
# Under pallas_flat='auto', a C=128 level of fewer voxels (D * H * W)
# than this runs the library ops: JAX's _FUSED128_MIN_VOX
# (elektronn3_tpu/models/unet.py:79), the same value. The planner reads
# it when it plans a shape.
FUSED128_MIN_VOX = 60_000
# JAX's bound on the rows of a fused C=32 level's flat chunk in training
# (_FUSED_ROWS_TRAIN, elektronn3_tpu/models/unet.py:92, the same value),
# which with the C=32 executor's other gates decides where JAX runs its
# fused conv1 and so where the network input's gradient is zero under
# input_grad=False (UNet._conv1_input_grad).
_JAX_FUSED_ROWS_TRAIN = 3000
# Every 2D-or-3D choice is made from the model's ``dim`` through these
# tables and the helpers below, never from a tensor's rank.
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONVT = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}
_CONVT_FN = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
# The JAX UNet's option values (elektronn3_tpu/models/unet.py:117-120).
UP_MODES = ("transpose", "resizeconv_nearest", "resizeconv_linear",
            "resizeconv_nearest1", "resizeconv_linear1")
MERGE_MODES = ("concat", "add")
CONV_MODES = ("same", "valid")
# The ops whose outputs checkpointing='policy' keeps (JAX's
# save_only_these_names("conv_out"): the convs' outputs).
_SAVED_OPS = (torch.ops.aten.convolution.default,)


def _lift(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A ``dim``-D model's activation as the kernels' 5-D form: a 2D
    (N, H, W, C) tensor as the (N, 1, H, W, C) view, a 3D one
    unchanged."""
    return x.unsqueeze(1) if dim == 2 else x


def _drop(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`_lift`."""
    return x.squeeze(1) if dim == 2 else x


def _jax_row_groups(W: int, jg: int, w_off: int) -> int:
    """Row groups per image row of JAX's flat layouts at width ``W``:
    ``pad_width(W) // JG`` (elektronn3_tpu/ops/flat_conv.py:97-113; jg 4,
    w_off 4 for C=32) or ``pad_width64(W) // JG64`` (flat_fused64.py:98-109;
    jg 2, w_off 2 for C=64 and 128)."""
    wp_min = -(-(W + w_off + 1) // jg) * jg
    wp_aligned = -(-wp_min // (8 * jg)) * (8 * jg)
    return (wp_aligned if wp_aligned <= wp_min * 1.125 else wp_min) // jg


class _ZeroGrad(torch.autograd.Function):
    """The identity, whose gradient is a zero tensor: the network input
    of a model whose first level runs the library ops where JAX runs its
    fused conv1 without ``input_grad``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _w5(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A ``dim``-D model's weight in the kernels' 5-D form: a 2D conv
    weight (O, I, 3, 3) or transposed-conv weight (I, O, 2, 2) as the
    kd=1 (O, I, 1, 3, 3) or (I, O, 1, 2, 2); a 3D weight unchanged."""
    return w.unsqueeze(2) if dim == 2 else w


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
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()


def _plain_conv(x: torch.Tensor, conv: nn.Module, dtype: torch.dtype,
                dim: int) -> torch.Tensor:
    """Library conv of a ``dim``-D model on a channels-last tensor (a
    channels_last view)."""
    y = _CONV_FN[dim](x.movedim(-1, 1), conv.weight.to(dtype),
                      conv.bias.to(dtype), padding=conv.padding)
    return y.movedim(1, -1).contiguous()


def _kernel_params(conv: nn.Module, dtype: torch.dtype, dim: int,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 3x3 conv's (weight, bias) as the JAX executors pass them, the
    weight in the kernels' 5-D form: the C=32 executor rounds both to
    the model dtype (flat_fused.py conv_bnact_flat), so their gradients
    come back through that cast; the C=64 executor takes the float32
    parameters."""
    if conv.out_channels == 32:
        return _w5(conv.weight.to(dtype), dim), conv.bias.to(dtype)
    return _w5(conv.weight, dim), conv.bias


def _norm_pro(norm: Optional[nn.Module], out,
              batch: Optional[int] = None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The (inv, shift) prologue of a kernel op's output ``out``: (y, s,
    q) in training, where the norm takes the batch statistics (s, q),
    else the output alone, whose norm takes the running statistics; a
    group norm's output is (y, s, q) with per-sample (N, C) statistics
    always, and its prologue is per sample (``gn_prologue``). Without a
    norm (``'none'``, or a position ``full_norm=False`` leaves bare) the
    identity, per sample with ``batch`` (a level whose other prologues
    are per sample)."""
    y = out[0] if isinstance(out, tuple) else out
    if norm is None:
        return identity_prologue(y.shape[-1], y.device, batch)
    if isinstance(norm, GroupNorm):
        return gn_prologue(norm, out[1], out[2], y[0, ..., 0].numel(),
                           norm.num_groups)
    if isinstance(out, tuple):
        return bn_train_prologue(norm, out[1], out[2], y.numel() // y.shape[-1])
    return bn_eval_prologue(norm)


def _raw(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def _stats(norm: Optional[nn.Module]):
    """The statistics a conv feeding ``norm`` returns (``_want_stats`` of
    the JAX UNet): a batch norm's in training (True), a group norm's per
    sample in training and eval (``'per_sample'``), else none."""
    if isinstance(norm, GroupNorm):
        return fused.PER_SAMPLE
    return norm is not None and norm.training


def _side_stats(out) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The (s, q) statistics of a kernel op's output, None without."""
    return out[1:] if isinstance(out, tuple) else None


def _ps_batch(norm: Optional[nn.Module], n: int) -> Optional[int]:
    """The batch of a level's per-sample prologues (``n`` under a group
    norm, whose prologues are (N, C)), else None."""
    return n if isinstance(norm, GroupNorm) else None


def _act_module(activation: str, device) -> Optional[nn.Module]:
    """A block's own activation module: 'prelu' (a learned slope shared
    by the block's activations, as flax's one ``PReLU_0`` a block) or
    'rrelu'; None for the stateless activations."""
    act = get_activation(activation, device)
    return act if isinstance(act, nn.Module) else None


def _norm_or_none(on: bool, normalization: str, channels: int, device,
                  dim: int) -> Optional[nn.Module]:
    """A norm where ``on`` (``full_norm`` for the positions it governs),
    else None: the reference's bare positions, whose ``norm{k}`` names
    then leave a gap."""
    return get_normalization(normalization, channels, device, dim) \
        if on else None


def _checkpointed(block: nn.Module, policy: bool, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward, all of them, or
    with ``policy`` all but the convs' outputs (JAX's
    ``checkpointing='policy'``). The recompute leaves the block's
    buffers (running statistics) as the forward left them, and its
    kernel ops normalise with the statistics the forward computed
    (:class:`~elektronn3_tpu_torch.ops.fused.StatsTape`): a batch norm's
    atomic sums would come out in another order."""
    first = [True]
    tape = fused.StatsTape()
    # The recompute runs in the backward, outside the forward's
    # statistics group: it re-enters the one the forward ran in.
    axis = current_stats_group()

    def run(*a):
        recompute = not first[0]
        first[0] = False
        tape.replay = recompute
        bufs = list(block.buffers())
        kept = [b.clone() for b in bufs]
        try:
            with fused.taping(tape), stats_group(axis):
                return block(*a)
        finally:
            # The recompute (cut short once it has what the backward
            # needs) restores the buffers; the forward copies the other
            # way, so that both passes run the same ops (the selective
            # checkpoint replays the forward's op by op).
            with torch.no_grad():
                for b, k in zip(bufs, kept):
                    if recompute:
                        b.copy_(k)
                    else:
                        k.copy_(b)

    kw = {}
    if policy:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            lambda ctx, op, *a, **k: CheckpointPolicy.MUST_SAVE
            if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE)
    return checkpoint(run, *args, use_reentrant=False, **kw)


def _conv_pad(ks: Sequence[int], conv_mode: str):
    return tuple(k // 2 for k in ks) if conv_mode == "same" else 0


class DownConv(nn.Module):
    """Two convolutions + optional max pool (reference unet.py:202-253):
    conv -> norm -> act -> conv -> norm -> act -> pool. Without
    ``full_norm`` conv1's norm (``norm0``) is left out; ``conv_mode=
    'valid'`` convolves without padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 pooling: bool = True, planar: bool = False,
                 activation: str = "relu", normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, dim: int = 3,
                 full_norm: bool = True, conv_mode: str = "same"):
        super().__init__()
        ks = conv_kernel(3, dim, planar)
        pad = _conv_pad(ks, conv_mode)
        self.pooling = pooling
        self.planar = planar
        self.activation = activation
        self.dtype = dtype
        self.dim = dim
        self.conv1 = _CONV[dim](in_channels, out_channels, ks, padding=pad,
                                device=device)
        self.conv2 = _CONV[dim](out_channels, out_channels, ks, padding=pad,
                                device=device)
        self.norm0 = _norm_or_none(full_norm, normalization, out_channels,
                                   device, dim)
        self.norm1 = get_normalization(normalization, out_channels, device,
                                       dim)
        self.act = _act_module(activation, device)

    def forward(self, x: torch.Tensor, kind: str = "library",
                reference: bool = False, input_grad: bool = True):
        """Returns (output, skip); ``kind`` is the level's
        (:meth:`UNet.level_kinds`). On 'kernels' the output is the
        pooled tensor and the skip is :class:`FusedActs` of conv2's raw
        output (5-D, the D=1 view for a 2D model); otherwise both are
        plain tensors. ``input_grad`` False gives ``x`` a zero gradient
        (the network input where JAX runs its fused conv1 without
        ``input_grad``)."""
        if kind == "kernels":
            act = _KERNEL_ACTS[self.activation]
            # conv1 takes the float32 weight and bias in both JAX
            # executors (the C=32 one through conv1_bnstats_flat); its
            # input is the network input (or the pool), whose gradient
            # (row 13's kernel at C_in <= 4, K4 else) runs only when it
            # requires one.
            out1 = fused.conv_bnact([_lift(x, self.dim)], None, None,
                                    _w5(self.conv1.weight, self.dim),
                                    self.conv1.bias,
                                    "linear", want_stats=_stats(self.norm0),
                                    reference=reference,
                                    input_grad=input_grad)
            inv1, shift1 = _norm_pro(self.norm0, out1,
                                     _ps_batch(self.norm1, x.shape[0]))
            w2, b2 = _kernel_params(self.conv2, self.dtype, self.dim)
            out2 = fused.conv_bnact([_raw(out1)], inv1, shift1, w2, b2, act,
                                    want_stats=_stats(self.norm1),
                                    reference=reference)
            inv2, shift2 = _norm_pro(self.norm1, out2)
            # The skip is the pool's second output (conv2's raw output,
            # not copied), so the decoder's gradient of it reaches K6,
            # which adds it into dx (JAX's pool_bnact_flat_skip).
            pooled, y2 = fused.pool_bnact(
                _raw(out2), inv2, shift2, act,
                pool_window(3, self.planar or self.dim == 2),
                reference=reference)
            return _drop(pooled, self.dim), FusedActs(y2, inv2, shift2)
        act = self.act if self.act is not None \
            else get_activation(self.activation)
        if not input_grad and x.requires_grad:
            x = _ZeroGrad.apply(x)
        y = _plain_conv(x, self.conv1, self.dtype, self.dim)
        if kind == "flat":
            # JAX's flat DownConv (elektronn3_tpu/models/unet.py:960-993):
            # conv1 on the library (XLA there), FlatBatchNorm, conv2
            # through flat_conv3 (row 26), FlatBatchNorm, the pool.
            y = act(flat_batch_norm(self.norm0, y))
            out2 = flat_conv3([y], self.conv2.weight, self.conv2.bias,
                              want_stats=_stats(self.norm1),
                              reference=reference)
            y = act(flat_batch_norm(self.norm1, _raw(out2),
                                    _side_stats(out2)))
            return (pool_flat(y) if self.pooling else y), y
        y = act(apply_norm(self.norm0, y, reference))
        y = act(apply_norm(self.norm1, _plain_conv(y, self.conv2, self.dtype,
                                                   self.dim), reference))
        if self.pooling:
            return ceil_maxpool(y, pool_window(self.dim, self.planar)), y
        return y, y


class ResizeConv(nn.Module):
    """Upsampling by a 2x resize (nearest or linear) and a conv, the JAX
    package's ``ResizeConv`` (reference unet.py:411-449): the conv is
    3x3(x3) ('same' padding, planar on a planar level) or 1x1(x1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, planar: bool = False, dim: int = 3,
                 mode: str = "nearest", dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size={kernel_size} not supported. "
                             "Choose 1 or 3.")
        ks = conv_kernel(3, dim, planar) if kernel_size == 3 else (1,) * dim
        self.factor = pool_window(dim, planar)
        self.mode = mode
        self.dtype = dtype
        self.dim = dim
        self.conv = _CONV[dim](in_channels, out_channels, ks,
                               padding=tuple(k // 2 for k in ks),
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "nearest":
            up = resize_nearest(x, self.factor)
        else:
            up = resize_linear(x, [s * f for s, f in
                                   zip(x.shape[1:-1], self.factor)])
        return _plain_conv(up, self.conv, self.dtype, self.dim)


class UpConv(nn.Module):
    """Upsampling, merge with the skip, two convolutions (reference
    unet.py:328-409): upconv -> norm -> act -> merge -> conv -> norm ->
    act -> conv -> norm -> act. ``up_mode`` 'transpose' upsamples by a
    transposed conv, the resizeconv modes by :class:`ResizeConv`;
    ``merge_mode`` 'concat' concatenates [upsampled, skip], 'add' adds
    them (conv1 then takes C input channels, not 2 C); with
    ``attention`` the skip passes :class:`GridAttention` gated by the
    deeper level's output first; without ``full_norm`` the upconv's and
    conv1's norms (``norm0``, ``norm1``) are left out."""

    def __init__(self, in_channels: int, out_channels: int,
                 planar: bool = False, activation: str = "relu",
                 normalization: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, dim: int = 3,
                 full_norm: bool = True, conv_mode: str = "same",
                 up_mode: str = "transpose", merge_mode: str = "concat",
                 attention: bool = False):
        super().__init__()
        ks = conv_kernel(3, dim, planar)
        pad = _conv_pad(ks, conv_mode)
        win = pool_window(dim, planar)
        self.planar = planar
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
        merged = 2 * out_channels if merge_mode == "concat" else out_channels
        self.conv1 = _CONV[dim](merged, out_channels, ks, padding=pad,
                                device=device)
        self.conv2 = _CONV[dim](out_channels, out_channels, ks, padding=pad,
                                device=device)
        self.norm0 = _norm_or_none(full_norm, normalization, out_channels,
                                   device, dim)
        self.norm1 = _norm_or_none(full_norm, normalization, out_channels,
                                   device, dim)
        self.norm2 = get_normalization(normalization, out_channels, device,
                                       dim)
        self.attention = GridAttention(out_channels, in_channels, dim,
                                       dtype=dtype, device=device) \
            if attention else None
        self.act = _act_module(activation, device)

    def _vup_ok(self, dec) -> bool:
        """Whether this 'kernels' level takes the vup branch (JAX's
        ``vup_ok``, its TPU tiling and lane gates aside): an in-plane
        (kd=1) level of 32 channels whose deeper input is the carried
        activation of a 64-channel kernel decoder level."""
        return (self.merge_mode == "concat"
                and self.upconv.out_channels == 32
                and (self.planar or self.dim == 2)
                and isinstance(dec, FusedActs) and dec.raw.shape[-1] == 64)

    def _vup_upconv_prologue(self, dec: FusedActs, wu: torch.Tensor,
                             act: str, reference: bool):
        """(inv, shift) of the never-stored upconv output's norm: a batch
        norm's from the statistics pass in training (JAX's
        ``_VupUpconv.stats``) and its running statistics in eval (JAX
        runs no pass there); a group norm's, (N, C) per sample, from the
        pass's per-sample statistics in training and in eval, as JAX runs
        it wherever ``_want_stats`` asks (elektronn3_tpu/models/unet.py:
        1191), over u's voxels of a sample, four a carry voxel."""
        norm = self.norm0
        if norm is None:
            return identity_prologue(self.upconv.out_channels, dec.raw.device,
                                     _ps_batch(self.norm2,
                                               dec.raw.shape[0]))
        if isinstance(norm, GroupNorm):
            s, q = vup.upconv_stats(dec.raw, dec.inv, dec.shift, wu,
                                    self.upconv.bias, act,
                                    want_stats=fused.PER_SAMPLE,
                                    reference=reference)
            return gn_prologue(norm, s, q, 4 * dec.raw[0, ..., 0].numel(),
                               norm.num_groups)
        if not norm.training:
            return bn_eval_prologue(norm)
        s, q = vup.upconv_stats(dec.raw, dec.inv, dec.shift, wu,
                                self.upconv.bias, act, reference=reference)
        return bn_train_prologue(norm, s, q, 4 * dec.raw[..., 0].numel())

    def _kernel_tail(self, out1, act: str, reference: bool) -> FusedActs:
        """A kernel decoder level after its merge conv: conv2 on the
        merge's carried output, and the level's carry."""
        inv1, shift1 = _norm_pro(self.norm1, out1, _ps_batch(
            self.norm2, _raw(out1).shape[0]))
        w2, b2 = _kernel_params(self.conv2, self.dtype, self.dim)
        out2 = fused.conv_bnact([_raw(out1)], inv1, shift1, w2, b2, act,
                                want_stats=_stats(self.norm2),
                                reference=reference)
        inv2, shift2 = _norm_pro(self.norm2, out2)
        return FusedActs(_raw(out2), inv2, shift2)

    def forward(self, enc, dec, kind: str = "library",
                reference: bool = False, vup_on: bool = False):
        """``enc`` is the skip of the same level, ``dec`` the deeper
        level's output (a tensor, or :class:`FusedActs` from a kernel
        decoder level); ``kind`` is the level's
        (:meth:`UNet.level_kinds`); ``vup_on`` the model's ``vup``.
        Returns :class:`FusedActs` (5-D) on 'kernels', a tensor
        otherwise. A 'library' level takes a skip of :class:`FusedActs`
        (its encoder level on the kernels, as a resizeconv decoder's)
        materialized."""
        if kind == "kernels":
            act = _KERNEL_ACTS[self.activation]
            # The upconv takes the float32 weight and bias in every JAX
            # upconv kernel of this plan (upconv222_bn_flat64,
            # upconv122_bn_flat64, upconv122_from_flat64).
            wu = _w5(self.upconv.weight, self.dim)
            w1, b1 = _kernel_params(self.conv1, self.dtype, self.dim)
            if self.merge_mode == "add":
                # JAX's dup_weights: conv(u + e) as the conv of [u, e]
                # with the weight twice along C_in; autograd of the
                # concat sums the two halves of K5's dW.
                w1 = torch.cat([w1, w1], dim=1)
            if vup_on and self._vup_ok(dec):
                # JAX's batch-statistics slot order (unet.py:1182-1207):
                # the upconv's norm, then conv1's, then conv2's.
                invu, shiftu = self._vup_upconv_prologue(dec, wu, act,
                                                         reference)
                out1 = vup.conv_vup(
                    dec.raw, dec.inv, dec.shift, wu, self.upconv.bias,
                    enc.raw, torch.cat([invu, enc.inv], dim=-1),
                    torch.cat([shiftu, enc.shift], dim=-1), w1, b1, act, act,
                    want_stats=_stats(self.norm1), reference=reference)
                return self._kernel_tail(out1, act, reference)
            if isinstance(dec, FusedActs):
                outu = fused.upconv_bnact(
                    dec.raw, dec.inv, dec.shift, wu, self.upconv.bias, act,
                    want_stats=_stats(self.norm0), reference=reference)
            else:
                outu = fused.upconv_bnact(
                    _lift(dec, self.dim), None, None, wu, self.upconv.bias,
                    "linear", want_stats=_stats(self.norm0),
                    reference=reference)
            invu, shiftu = _norm_pro(self.norm0, outu, _ps_batch(
                self.norm2, enc.raw.shape[0]))
            # The merge conv's prologue is the concat of the upconv
            # output's and the skip's, (C,) or per sample (N, C).
            out1 = fused.conv_bnact(
                [_raw(outu), enc.raw], torch.cat([invu, enc.inv], dim=-1),
                torch.cat([shiftu, enc.shift], dim=-1), w1, b1, act,
                want_stats=_stats(self.norm1), reference=reference)
            return self._kernel_tail(out1, act, reference)
        act = self.act if self.act is not None \
            else get_activation(self.activation)
        if isinstance(dec, FusedActs):
            dec = _drop(fused.materialize(dec, _KERNEL_ACTS[self.activation]),
                        self.dim)
        if isinstance(enc, FusedActs):
            enc = _drop(fused.materialize(enc, _KERNEL_ACTS[self.activation]),
                        self.dim)
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
        if kind == "flat":
            # JAX's flat UpConv (elektronn3_tpu/models/unet.py:1245-1278):
            # the upconv on the library (XLA there), FlatBatchNorm, the
            # merge conv over [up, enc] and conv2 through flat_conv3.
            up = act(flat_batch_norm(self.norm0, up))
            merged = [up, enc] if self.merge_mode == "concat" else [up + enc]
            out1 = flat_conv3(merged, self.conv1.weight, self.conv1.bias,
                              want_stats=_stats(self.norm1),
                              reference=reference)
            y = act(flat_batch_norm(self.norm1, _raw(out1),
                                    _side_stats(out1)))
            out2 = flat_conv3([y], self.conv2.weight, self.conv2.bias,
                              want_stats=_stats(self.norm2),
                              reference=reference)
            return act(flat_batch_norm(self.norm2, _raw(out2),
                                       _side_stats(out2)))
        up = act(apply_norm(self.norm0, up, reference))
        y = torch.cat([up, enc], dim=-1) if self.merge_mode == "concat" \
            else up + enc
        y = act(apply_norm(self.norm1, _plain_conv(y, self.conv1, self.dtype,
                                                   self.dim), reference))
        return act(apply_norm(self.norm2, _plain_conv(y, self.conv2,
                                                      self.dtype, self.dim),
                              reference))


class UNet(nn.Module):
    """Configurable 3D or 2D U-Net for dense prediction.

    Input: channels-last ``(N, D, H, W, in_channels)``, or ``(N, H, W,
    in_channels)`` for ``dim=2``. Output: logits in the same layout with
    ``out_channels``, bfloat16 for a bfloat16 model, float32 otherwise.

    Parameters are float32; ``dtype`` is the activation (compute)
    dtype, to which weights are cast at use, as the JAX package's
    ``param_dtype``/``dtype`` split does. Weights are xavier-normal and
    biases zero, drawn from ``generator`` (a fresh one seeded 0 if
    None) on the CPU and moved to ``device``.

    ``device`` defaults to the CUDA card (``torch.device("cuda")``);
    without one, construction raises unless the caller asks for the CPU
    (``device="cpu"``), so a model never runs on the CPU unasked. The
    ``Predictor`` and the ``Trainer`` follow the model's device.

    Ported configuration surface: ``up_mode`` 'transpose' (the default)
    and the four resizeconv modes (:class:`ResizeConv`; their decoder
    levels run the library ops, as JAX's fused decoders take only
    'transpose', while the encoder levels keep their kind:
    :meth:`decoder_kinds`), ``merge_mode`` 'concat' (the default) or
    'add' (a kernel decoder level runs its merge conv as K1 over [up,
    skip] with the weight doubled along C_in, JAX's ``dup_weights``;
    ``vup`` is off for such levels, as in JAX), ``conv_mode`` 'same'
    (the default) or 'valid' (every level on the library ops, as JAX
    declines its executors; :func:`autocrop` center-crops the skips),
    ``attention`` (:class:`GridAttention` on each decoder level's skip;
    every level on the library ops, as in JAX), ``full_norm`` (False:
    only the norm after each block's last conv), ``checkpointing``
    (True: each block's activations recomputed in the backward through
    ``torch.utils.checkpoint``; 'policy': all but the convs' outputs;
    the same numbers, less memory), ``logit_dtype`` (None: bfloat16 for
    a bfloat16 model, float32 otherwise), with ``dim`` 3 or 2,
    normalization 'batch', 'batchp' or 'none' ('batchp' plans its kernel
    levels as 'batch' does; as in JAX, no 'batchp' level is flat), and
    'group' (8 groups), 'group<G>' and 'instance' (:class:`GroupNorm`,
    eps 1e-6: a kernel level serves and trains on the kernels'
    per-sample mode, with ``vup`` and in 2D too),
    activations 'relu', 'leaky' (kernel levels), 'silu', 'swish',
    'gelu', 'tanh' (flat levels under ``pallas_flat=True``) and the
    rest of ``get_activation`` (library levels; 'prelu' with one learned
    slope a block, JAX's ``PReLU_0``, also where JAX's
    ``pallas_flat=True`` runs its flat executor, whose numbers the
    library ops give too; 'rrelu' with random slopes in training),
    ``pallas_flat``
    True, False or 'auto' (see the module docstring;
    :meth:`level_kinds` gives the levels), and ``vup`` True or False
    (default False, as JAX's ``E3TPU_VUP``; the port reads no
    environment variable, and anything but a bool, ``'auto'`` included,
    raises: JAX's ``'auto'`` turns the path on). ``vup`` changes no
    level kind, parameter or batch-statistics slot, only how a planar
    C=32 kernel decoder level over a C=64 carry computes (see the
    module docstring).

    ``axis_name`` (default None) is JAX's ``UNet.axis_name``
    (elektronn3_tpu/models/unet.py:1367-1375): the mesh axis over which
    a training forward sums the batch-norm statistics of every level,
    kernel, flat and library alike (see :meth:`forward`); the
    ``Trainer`` under a mesh does so whatever it is.

    ``input_grad`` (default False, only a bool: anything else raises
    ``ValueError``) is JAX's ``UNet.input_grad``
    (elektronn3_tpu/models/unet.py:1389-1396): where JAX runs its fused
    first conv (``_Conv1FusedFlat``, a one-channel input of width <= 128
    on its C=32 executor; :meth:`_conv1_input_grad` writes the predicate
    down) and ``input_grad`` is False, the network input's gradient is a
    zero tensor, as ``jax.grad`` gives, and no input gradient is
    computed; everywhere else it is the real one (row 13's kernel on a
    kernel level). A level plan, parameter or forward never depends on
    it.

    JAX gates of ``pallas_flat`` that the port does not carry over,
    because they model the TPU, not the function: 'auto''s test of the
    backend and of bf16; the scoped-VMEM estimates
    (``conv64_vmem_bytes``, ``bwd_ki_split``) and the per-chunk row
    bounds ``_FUSED_ROWS_*``; the C=32 executor's ``W % 8``; the decoder
    carry's ``(W // 2) % 2``; the 2D H-tiling; and, on the vup path, the
    ``W1 % 2`` assert of the upconv's 128-lane rows (flat_fused.py:893):
    the port's vup takes every even H and W its kernel levels take.
    Where JAX declines for one of these, the port runs the kernels, and
    its result is still JAX's (tests/test_torch_headline_rows.py holds
    one shape for each, tests/test_torch_vup.py the vup one). Likewise
    JAX's C=64 fused decoder takes only ``merge_mode='concat'``, a limit
    of its executor, so under 'add' JAX runs those decoder levels on XLA
    while the port runs them on the kernels with the doubled weight
    (tests/test_torch_unet_surface.py holds the result against JAX's).
    """

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
                 axis_name: Optional[str] = None):
        super().__init__()
        if n_blocks < 1:
            raise ValueError("n_blocks must be > 0")
        if up_mode not in UP_MODES:
            raise ValueError(f'"{up_mode}" is not a valid mode for '
                             "upsampling")
        if merge_mode not in MERGE_MODES:
            raise ValueError(f'"{merge_mode}" is not a valid mode for '
                             "merging")
        if conv_mode not in CONV_MODES:
            raise ValueError(f'"{conv_mode}" is not a valid conv_mode')
        if not (checkpointing is True or checkpointing is False
                or checkpointing == "policy"):
            raise ValueError(f"checkpointing must be True, False or "
                             f"'policy', got {checkpointing!r}")
        if vup is not True and vup is not False:
            raise ValueError(f"vup must be True or False, got {vup!r}")
        if input_grad is not True and input_grad is not False:
            raise ValueError(f"input_grad must be True or False, got "
                             f"{input_grad!r}")
        if not (pallas_flat is True or pallas_flat is False
                or pallas_flat == "auto"):
            raise ValueError(f"pallas_flat must be True, False or 'auto', "
                             f"got {pallas_flat!r}")
        if dim not in (2, 3):
            raise ValueError("dim has to be 2 or 3")
        if planar_blocks and (max(planar_blocks) >= n_blocks
                              or min(planar_blocks) < 0):
            raise ValueError("planar_blocks has invalid value range")
        # The names raise here, before any weight exists.
        norm_kind(normalization, start_filts)
        get_activation(activation)
        device = resolve_device(device, "UNet")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_blocks = n_blocks
        self.start_filts = start_filts
        self.planar_blocks = tuple(planar_blocks)
        self.activation = activation
        self.normalization = normalization
        self.dim = dim
        self.dtype = dtype
        self.pallas_flat = pallas_flat
        self.vup = vup
        self.input_grad = input_grad
        self.up_mode = up_mode
        self.merge_mode = merge_mode
        self.conv_mode = conv_mode
        self.attention = attention
        self.full_norm = full_norm
        self.checkpointing = checkpointing
        self.logit_dtype = logit_dtype
        self.axis_name = axis_name
        self._plans: Dict[tuple, List[str]] = {}

        self.down_convs, self.up_convs = self._levels(device)
        self.conv_final = _CONV[dim](start_filts, out_channels, 1,
                                     device=device)

        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (_CONV[dim], _CONVT[dim])):
                _init_conv(m, gen)

    def _levels(self, device) -> Tuple[nn.ModuleList, nn.ModuleList]:
        """The encoder levels (``DownConv``) and decoder levels
        (``UpConv``, deepest first)."""
        common = dict(activation=self.activation,
                      normalization=self.normalization, dtype=self.dtype,
                      device=device, dim=self.dim, full_norm=self.full_norm,
                      conv_mode=self.conv_mode)
        down_convs = nn.ModuleList()
        outs = self.in_channels
        for i in range(self.n_blocks):
            ins = outs
            outs = self.start_filts * 2 ** i
            down_convs.append(DownConv(
                ins, outs, pooling=i < self.n_blocks - 1,
                planar=i in self.planar_blocks, **common))
        up_convs = nn.ModuleList()
        for i in range(self.n_blocks - 1):
            ins = outs
            outs = ins // 2
            level = self.n_blocks - 2 - i
            up_convs.append(UpConv(
                ins, outs, planar=level in self.planar_blocks,
                up_mode=self.up_mode, merge_mode=self.merge_mode,
                attention=self.attention, **common))
        return down_convs, up_convs

    def _logit_dtype(self) -> torch.dtype:
        """``logit_dtype`` if given, else bf16 logits for a bf16 model
        (they halve the logit volume's traffic; the Predictor upcasts
        before softmax) and float32 otherwise (JAX's ``_logit_dtype``)."""
        if self.logit_dtype is not None:
            return self.logit_dtype
        return torch.bfloat16 if self.dtype == torch.bfloat16 \
            else torch.float32

    def _planar(self, i: int) -> bool:
        """Level ``i`` pools and convolves in-plane only: a planar block,
        or any level of a 2D model (the D=1 view)."""
        return self.dim == 2 or i in self.planar_blocks

    def _kernel_decline_reason(self, i: int, D: int, H: int,
                               W: int) -> Optional[str]:
        """None if encoder level ``i`` (and its decoder level) runs the
        kernels at level shape (D, H, W), else the reason it does not
        (JAX's ``_fused_decline_reason``, TPU gates aside)."""
        ch = self.start_filts * 2 ** i
        planar = self._planar(i)
        if self.pallas_flat is False:
            return "pallas_flat=False runs the library ops"
        if self.conv_mode != "same":
            # JAX: its executors share one geometry between a conv's
            # input and output; valid convs shrink every level.
            return f"conv_mode={self.conv_mode!r} runs the library ops"
        if self.attention:
            return "attention=True runs the library ops"
        kind, groups = norm_kind(self.normalization, ch)
        if kind == "group" and ch % groups:
            # JAX's _norm_fused_ok: the library level's GroupNorm raises
            # flax's error.
            return (f"normalization {self.normalization!r}: C={ch} not "
                    f"divisible by its {groups} groups")
        if self.activation not in _KERNEL_ACTS:
            return f"activation {self.activation!r} has no kernel prologue"
        if i == self.n_blocks - 1:
            return "bottom level runs plain torch"
        if ch not in (32, 64, 128):
            return (f"C={ch} runs plain torch (kernels cover C=32, 64 and "
                    "128)")
        if ch == 32 and not planar:
            return "C=32 kernels are planar-only"
        if H % 2 or W % 2:
            return f"odd level shape H={H}, W={W}"
        if self.pallas_flat == "auto" and ch == 128 \
                and D * H * W < FUSED128_MIN_VOX:
            return (f"C=128 level too small for the kernels ({D * H * W} "
                    f"vox < {FUSED128_MIN_VOX}; pallas_flat=True forces)")
        if not planar and D % 2:
            return f"odd depth D={D} with (2,2,2) pooling"
        return None

    def _flat_level(self, i: int, H: int, W: int) -> bool:
        """Whether encoder level ``i`` (and its decoder level) at level
        shape (., H, W) runs the semi-fused flat executor, where the
        kernels decline it: JAX's ``_flat_level_ok``
        (elektronn3_tpu/models/unet.py:1404-1419) with its TPU gates
        dropped. ``pallas_flat=True`` only (never 'auto', as in JAX), a
        planar 3D level of C=32 or 64, 'batch' or 'none' norm, an
        activation of ``_FLAT_ACTS``, even H and W."""
        return (self.pallas_flat is True and self.dim == 3
                and self.conv_mode == "same" and not self.attention
                and i in self.planar_blocks
                and self.start_filts * 2 ** i in (32, 64)
                and self.normalization in ("batch", "none")
                and self.activation in _FLAT_ACTS
                and H % 2 == 0 and W % 2 == 0)

    def _jax_tiles_2d(self, H: int, W: int) -> bool:
        """Whether JAX's 2D H-tiling cuts a training input of (H, W) into
        slabs: its ``_plan_tile2d`` (elektronn3_tpu/models/unet.py:1541-1575)
        with the training row bound, a slab height below H."""
        def fits(t: int) -> bool:
            w, tt = W, t
            for i in range(self.n_blocks):
                ch = self.start_filts * 2 ** i
                if tt < 2 or w < 4 or w % 2:
                    return True
                if ch == 32:
                    g = _jax_row_groups(w, 4, 4)
                elif ch in (64, 128):
                    g = _jax_row_groups(w, 2, 2)
                else:
                    return True
                if tt * g > _JAX_FUSED_ROWS_TRAIN:
                    return False
                w, tt = w // 2, tt // 2
            return True

        if fits(H):
            return False
        t = (H - 1) & ~3
        while t >= 4:
            if H % t == 0 and fits(t):
                return True
            t -= 4
        return False

    def _conv1_input_grad(self, shape: Sequence[int]) -> bool:
        """Whether the network input of ``shape`` gets its gradient:
        True unless ``input_grad`` is False and JAX runs its fused conv1
        there (``_Conv1FusedFlat``, elektronn3_tpu/models/unet.py:896-899),
        where that gradient is zero. JAX does so on its C=32 executor's
        first level (``_flat_fused_ok`` :1421-1456: ``pallas_flat`` True,
        or 'auto' for bf16 as on a TPU; a planar level of C=32 with a
        kernel activation; even H, W % 8 == 0 and at most
        ``_JAX_FUSED_ROWS_TRAIN`` flat rows) for a one-channel input of
        W <= 128 that its 2D H-tiling leaves whole."""
        if self.input_grad or self.in_channels != 1 \
                or self.start_filts != 32 or self.conv_mode != "same" \
                or self.attention:
            return True
        auto_bf16 = self.pallas_flat == "auto" \
            and self.dtype == torch.bfloat16
        if not (self.pallas_flat is True or auto_bf16):
            return True
        if self.activation not in _KERNEL_ACTS or not self._planar(0):
            return True
        H, W = shape[-3], shape[-2]
        if H % 2 or W % 8 or W > 128 \
                or H * ((W + 4) // 4) > _JAX_FUSED_ROWS_TRAIN:
            return True
        return self.dim == 2 and self._jax_tiles_2d(H, W)

    def level_kinds(self, shape: Sequence[int]) -> List[str]:
        """Per-level executor for an input of ``shape`` ((N, D, H, W, C),
        or (N, H, W, C) for a 2D model, whose levels have D = 1):
        'kernels' (K1-K7 with the fused prologues), 'flat' (the
        semi-fused flat executor, :meth:`_flat_level`) or 'library'.
        Each flat level, and each other level's decline reason, is
        logged once per shape (no reason under ``pallas_flat=False``, as
        in JAX). Kinds are kept per shape, ``pallas_flat`` and
        :data:`FUSED128_MIN_VOX`: a change of either applies from the
        next call on, to every shape."""
        key = (tuple(shape[1:-1]), self.pallas_flat, FUSED128_MIN_VOX)
        if key in self._plans:
            return self._plans[key]
        D, H, W = key[0] if self.dim == 3 else (1,) + key[0]
        kinds = []
        for i in range(self.n_blocks):
            ch = self.start_filts * 2 ** i
            reason = self._kernel_decline_reason(i, D, H, W)
            if reason is None:
                kinds.append("kernels")
            elif self._flat_level(i, H, W):
                kinds.append("flat")
                logger.info("UNet level %d (C=%d, %dx%dx%d): the flat "
                            "executor, K1 for its 3x3 convs after conv1 "
                            "(the fused kernels decline: %s).", i, ch, D,
                            H, W, reason)
            else:
                kinds.append("library")
                if self.pallas_flat is not False:
                    logger.info("UNet level %d (C=%d, %dx%dx%d): %s.", i,
                                ch, D, H, W, reason)
            if i < self.n_blocks - 1:
                H, W = -(-H // 2), -(-W // 2)
                if not self._planar(i):
                    D = -(-D // 2)
        self._plans[key] = kinds
        return kinds

    def decoder_kinds(self, shape: Sequence[int]) -> List[str]:
        """The kind of each decoder level (index = encoder level, the
        bottom level has none) for an input of ``shape``: its encoder
        level's (:meth:`level_kinds`) under ``up_mode='transpose'``, else
        'library' (JAX fuses no resizeconv decoder; a kernel encoder
        level's skip is then materialized)."""
        kinds = self.level_kinds(shape)[:-1]
        if self.up_mode == "transpose":
            return kinds
        return ["library"] * len(kinds)

    def plan(self, shape: Sequence[int]) -> List[bool]:
        """Per-level kernel plan for an input of ``shape``: True where
        :meth:`level_kinds` says 'kernels'."""
        return [k == "kernels" for k in self.level_kinds(shape)]

    def forward(self, x: torch.Tensor, *,
                reference: bool = False) -> torch.Tensor:
        """Forward of a channels-last batch: with batch statistics and an
        autograd graph in training, with running statistics and no graph
        in eval. ``reference=True`` runs every kernel's plain PyTorch
        version instead, on any device (to hold the kernels against it
        on the card).

        In training with ``axis_name`` set and a mesh active (``with
        mesh:``), every batch norm sums its statistics over that mesh
        axis (:class:`~elektronn3_tpu_torch.parallel.collectives.
        stats_group`): ``x`` is this rank's shard of the batch and the
        statistics are the global batch's, JAX's ``axis_name`` under
        ``shard_map``. Without an active mesh the name binds nothing and
        the statistics are this process's."""
        if self.training:
            mesh = active_mesh() if self.axis_name is not None else None
            if mesh is not None:
                with stats_group(mesh.axis(self.axis_name)):
                    return self._forward(x, reference)
            return self._forward(x, reference)
        with torch.no_grad():
            return self._forward(x, reference)

    def _block(self, block: nn.Module, *args):
        """A block's forward, checkpointed in a training forward that
        builds a graph when ``checkpointing`` asks (JAX remats each
        block the same way)."""
        if self.checkpointing and self.training and torch.is_grad_enabled():
            return _checkpointed(block, self.checkpointing == "policy", *args)
        return block(*args)

    def _check_input(self, x: torch.Tensor) -> None:
        if x.dim() != self.dim + 2 or x.shape[-1] != self.in_channels:
            layout = "N, D, H, W" if self.dim == 3 else "N, H, W"
            raise ValueError(
                f"Input shape {tuple(x.shape)}: expected channels-last "
                f"({layout}, {self.in_channels}).")

    def _forward(self, x: torch.Tensor, reference: bool) -> torch.Tensor:
        self._check_input(x)
        kinds = self.level_kinds(x.shape)
        dec_kinds = self.decoder_kinds(x.shape)
        input_grad = self._conv1_input_grad(x.shape)
        x = x.to(self.dtype).contiguous()
        skips = []
        for i, down in enumerate(self.down_convs):
            x, skip = self._block(down, x, kinds[i], reference,
                                  input_grad or i > 0)
            skips.append(skip)
        x = skips.pop()   # the bottom level does not pool
        for i, up in enumerate(self.up_convs):
            level = self.n_blocks - 2 - i
            x = self._block(up, skips[level], x, dec_kinds[level], reference,
                            self.vup)
        if isinstance(x, FusedActs):
            # Both JAX heads round the weight and bias to the model
            # dtype before the float32 GEMM (head_bnact_from_flat at
            # C=32, head_bnact_from_flat64 at C=64, unet.py:763-764).
            return fused.head_bnact(
                x._replace(raw=_drop(x.raw, self.dim)),
                _KERNEL_ACTS[self.activation],
                self.conv_final.weight.to(self.dtype),
                self.conv_final.bias.to(self.dtype), self._logit_dtype())
        return _plain_conv(x, self.conv_final, self.dtype,
                           self.dim).to(self._logit_dtype())
