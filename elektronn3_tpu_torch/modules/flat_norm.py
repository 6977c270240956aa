"""Batch-norm prologue vectors for the fused ops.

Counterpart of the JAX package's ``modules/flat_norm.py``. There a
``FlatBNStats`` module turns kernel statistics side outputs (training)
or the running statistics (eval) into the per-lane (inv, shift) vectors
its consumer kernel applies on load. The port keeps its batch-norm
state in ``nn.BatchNorm3d`` modules (the reference's ``norm{k}`` names)
and implements the eval branch here; the vectors are per channel, with
no lane tiling.
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
