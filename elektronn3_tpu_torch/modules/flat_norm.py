"""Batch-norm prologue vectors for the fused ops.

Counterpart of the JAX package's ``modules/flat_norm.py``. There a
``FlatBNStats`` module turns kernel statistics side outputs (training)
or the running statistics (eval) into the per-lane (inv, shift) vectors
its consumer kernel applies on load. The port keeps its batch-norm
state in ``nn.BatchNorm3d`` modules (the reference's ``norm{k}`` names)
and implements both branches here; the vectors are per channel, with
no lane tiling.

Training follows ``FlatBNStats`` and flax's ``BatchNorm``: the biased
batch variance, and the running update ``ra = 0.9 * ra + 0.1 * batch``
(flax momentum 0.9, i.e. the module's torch-style ``momentum`` of 0.1
as the weight of the batch value), written into the module's buffers
outside autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def bn_eval_prologue(norm: nn.BatchNorm3d) -> Tuple[torch.Tensor,
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


def update_running_stats(norm: nn.BatchNorm3d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """``ra = (1 - m) * ra + m * batch`` for the running mean and
    variance, m = ``norm.momentum`` (0.1: flax's momentum 0.9), in
    float32 and without autograd."""
    m = norm.momentum
    with torch.no_grad():
        for buf, val in ((norm.running_mean, mean), (norm.running_var, var)):
            buf.copy_((1.0 - m) * buf.float() + m * val.detach().float())


def bn_train_prologue(norm: nn.BatchNorm3d, s: torch.Tensor,
                      q: torch.Tensor, count: int,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift) from a kernel's statistics side outputs, the
    per-channel float32 sum ``s`` and sum of squares ``q`` of the stored
    output over ``count`` voxels (``FlatBNStats`` in training):
    ``mean = s / count``, biased ``var = q / count - mean ** 2``. The
    running statistics take the unclamped variance, as in JAX; the
    prologue clamps it at 0 against cancellation. Differentiable in
    ``s``, ``q`` and the affine parameters, which is how the statistics
    cotangents reach the kernels."""
    mean = s / count
    var = q / count - mean * mean
    update_running_stats(norm, mean, var)
    inv = torch.rsqrt(torch.clamp_min(var, 0.0) + norm.eps) \
        * norm.weight.float()
    shift = norm.bias.float() - mean * inv
    return inv, shift


def identity_prologue(channels: int, device: Optional[torch.device] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift) of a no-norm prologue: ones and zeros."""
    return (torch.ones(channels, dtype=torch.float32, device=device),
            torch.zeros(channels, dtype=torch.float32, device=device))


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
