"""Batch- and group-norm prologue vectors for the fused ops, and the
flat executor's batch norm.

Counterpart of the JAX package's ``modules/flat_norm.py``. There a
``FlatBNStats`` module turns kernel statistics side outputs (training)
or the running statistics (eval) into the per-lane (inv, shift) vectors
its consumer kernel applies on load, and ``FlatBatchNorm`` normalizes
the semi-fused flat executor's activations. The port keeps its
batch-norm state in ``nn.BatchNorm3d`` (``nn.BatchNorm2d`` for a 2D
model) modules (the reference's ``norm{k}`` names) and implements both
here (:func:`flat_batch_norm`); the vectors are per channel, with no
lane tiling.

Training follows ``FlatBNStats`` and flax's ``BatchNorm``: the biased
batch variance, and the running update ``ra = 0.9 * ra + 0.1 * batch``
(flax momentum 0.9, i.e. the module's torch-style ``momentum`` of 0.1
as the weight of the batch value), written into the module's buffers
outside autograd.

Group and instance norm (``FlatGNStats``) take per-sample statistics,
(B, C) sums from the kernels' ``want_stats='per_sample'``, in training
and in eval alike (there is no running state), and give (B, C)
prologue vectors (:func:`gn_prologue`). They take no collective under a
mesh: each sample's statistics are its own (``FlatGNStats`` has no
``axis_name``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from elektronn3_tpu_torch.ops.fused import channel_stats
from elektronn3_tpu_torch.ops.pallas_bn import update_running
from elektronn3_tpu_torch.parallel.collectives import (
    current_stats_group, psum)


def bn_eval_prologue(norm: nn.Module) -> Tuple[torch.Tensor,
                                              torch.Tensor]:
    """(inv, shift) float32 per channel from running statistics:
    ``inv = scale * rsqrt(max(var, 0) + eps)``, ``shift = bias - mean *
    inv`` (``FlatBNStats`` with ``use_running_average=True``). The clamp
    guards against a slightly negative variance from sum/sumsq
    cancellation, as in JAX."""
    var = torch.clamp_min(norm.running_var.float(), 0.0)
    inv = torch.rsqrt(var + norm.eps) * norm.weight.float()
    shift = norm.bias.float() - norm.running_mean.float() * inv
    return inv, shift


def update_running_stats(norm: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """``ra = (1 - m) * ra + m * batch`` for the running mean and
    variance, m = ``norm.momentum`` (0.1: flax's momentum 0.9), in
    float32 and without autograd."""
    update_running((norm.running_mean, norm.running_var, norm.momentum),
                   mean, var)


def bn_train_prologue(norm: nn.Module, s: torch.Tensor,
                      q: torch.Tensor, count: int,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift) from a kernel's statistics side outputs, the
    per-channel float32 sum ``s`` and sum of squares ``q`` of the stored
    output over ``count`` voxels (``FlatBNStats`` in training):
    ``mean = s / count``, biased ``var = q / count - mean ** 2``. The
    running statistics take the unclamped variance, as in JAX; the
    prologue clamps it at 0 against cancellation. Differentiable in
    ``s``, ``q`` and the affine parameters, which is how the statistics
    cotangents reach the kernels.

    Inside a :class:`~elektronn3_tpu_torch.parallel.collectives.
    stats_group` the sums are summed over its ranks (``psum``, whose
    backward sums the statistics cotangents) and ``count`` is multiplied
    by its size before the mean: the global batch's statistics, JAX's
    ``FlatBNStats``/``FlatBatchNorm`` under an ``axis_name``."""
    axis = current_stats_group()
    if axis is not None:
        s, q = psum(torch.stack([s, q]), axis).unbind(0)
        count = count * axis.size
    mean = s / count
    var = q / count - mean * mean
    update_running_stats(norm, mean, var)
    inv = torch.rsqrt(torch.clamp_min(var, 0.0) + norm.eps) \
        * norm.weight.float()
    shift = norm.bias.float() - mean * inv
    return inv, shift


def gn_prologue(norm: nn.Module, s: torch.Tensor, q: torch.Tensor,
                spatial: int, groups: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift), each (B, C) float32, of a group norm from a kernel's
    per-sample statistics, the (B, C) float32 sum ``s`` and sum of
    squares ``q`` of the stored output over ``spatial`` voxels a sample
    (JAX's ``FlatGNStats``): per (sample, group) of C / ``groups``
    channels, ``mean = sum / (spatial * C / groups)``, ``var = sumsq /
    (spatial * C / groups) - mean ** 2`` clamped at 0 before the rsqrt
    (eps ``norm.eps``), ``inv = rsqrt(var + eps) * scale`` and ``shift =
    bias - mean * inv`` per channel. Differentiable in ``s``, ``q`` and
    the affine parameters, like :func:`bn_train_prologue`."""
    b, c = s.shape
    gs = c // groups
    denom = spatial * gs
    mean_g = s.reshape(b, groups, gs).sum(-1) / denom
    var_g = q.reshape(b, groups, gs).sum(-1) / denom - mean_g * mean_g
    rstd = torch.rsqrt(torch.clamp_min(var_g, 0.0) + norm.eps)
    inv = rstd.repeat_interleave(gs, dim=1) * norm.weight.float()
    shift = norm.bias.float() - mean_g.repeat_interleave(gs, dim=1) * inv
    return inv, shift


def identity_prologue(channels: int, device: Optional[torch.device] = None,
                      batch: Optional[int] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift) of a no-norm prologue: ones and zeros, (channels,),
    or with ``batch`` the per-sample (batch, channels) form (JAX's
    ``identity_prologue(n, batch)``, for a level whose sibling
    prologues are per sample)."""
    shape = (channels,) if batch is None else (batch, channels)
    return (torch.ones(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def norm_kind(norm: Optional[str], channels: int) -> Tuple[str, int]:
    """Classify a normalization name: (kind, num_groups) with kind in
    {'batch', 'none', 'group'}; 'instance' is one group per channel and
    plain 'group' means 8 groups, as in ``get_normalization``."""
    if norm is None or norm == "none":
        return "none", 0
    if norm in ("batch", "batchp"):
        return "batch", 0
    if norm == "instance":
        return "group", channels
    if norm.startswith("group"):
        g = int(norm[len("group"):]) if len(norm) > len("group") else 8
        return "group", g
    raise ValueError(f"Unknown normalization: {norm!r}")


def flat_batch_norm(norm: Optional[nn.Module], x: torch.Tensor,
                    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> torch.Tensor:
    """JAX's ``FlatBatchNorm`` (modules/flat_norm.py:33-110) on an NDHWC
    tensor: in training the per-channel float32 sum and sum of squares
    of the stored, dtype-rounded ``x`` (``stats``, when the conv that
    produced ``x`` returned them, else a plain reduction here) through
    :func:`bn_train_prologue`; in eval the running statistics
    (:func:`bn_eval_prologue`). The output is ``x * inv + shift`` in
    float32, rounded to ``x``'s dtype once (not ``apply_norm``'s ``(x -
    mean) * mul + bias``). ``norm`` None is the identity ('none')."""
    if norm is None:
        return x
    if not norm.training:
        inv, shift = bn_eval_prologue(norm)
    else:
        inv, shift = bn_train_prologue(
            norm, *(channel_stats(x) if stats is None else stats),
            x.numel() // x.shape[-1])
    return (x.float() * inv + shift).to(x.dtype)
