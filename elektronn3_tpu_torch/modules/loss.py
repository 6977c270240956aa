"""Losses for dense prediction on channels-last logits.

Counterpart of the JAX package's ``modules/loss.py`` (reference
elektronn3/modules/loss.py), for the losses the training path uses:

- ``output``: raw logits ``(N, *spatial, C)``, any float dtype; every
  loss computes in float32 (bf16 logits are upcast on load);
- ``target``: dense integer class ids ``(N, *spatial)`` or a one-hot /
  float tensor ``(N, *spatial, C)`` (the shape decides, as in the
  reference's ``dice_loss`` dispatch).

Every loss is a callable ``loss(output, target) -> scalar`` tensor.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _as_onehot(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Dense int targets -> one-hot in ``output``'s shape and dtype; a
    target of ``output``'s shape is cast."""
    if target.shape == output.shape:
        return target.to(output.dtype)
    if target.shape == output.shape[:-1]:
        return F.one_hot(target.long(), output.shape[-1]).to(output.dtype)
    raise ValueError(f"Target shape {tuple(target.shape)} is not compatible "
                     f"with output shape {tuple(output.shape)}.")


def _channelwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the channel (last) one."""
    return x.sum(tuple(range(x.dim() - 1)))


def cross_entropy(output: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: Optional[int] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross entropy over the last (channel) axis, with class
    weights (the weighted mean over voxels) and ``ignore_index`` for
    dense targets."""
    num_classes = output.shape[-1]
    output = output.float()
    logp = torch.log_softmax(output, dim=-1)
    onehot = _as_onehot(output, target)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    nll = -(onehot * logp).sum(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=output.dtype, device=output.device)
        pix_w = (onehot * w).sum(-1)
    else:
        pix_w = torch.ones_like(nll)
    if ignore_index is not None and target.shape == output.shape[:-1]:
        keep = target != ignore_index
        pix_w = torch.where(keep, pix_w, 0.0)
        nll = torch.where(keep, nll, 0.0)
    return (nll * pix_w).sum() / torch.clamp_min(pix_w.sum(), 1e-12)


class CrossEntropyLoss:
    def __init__(self, weight=None, ignore_index: Optional[int] = None,
                 label_smoothing: float = 0.0):
        self.weight = None if weight is None else torch.as_tensor(weight)
        self.ignore_index = ignore_index
        self.label_smoothing = label_smoothing

    def __call__(self, output, target):
        return cross_entropy(output, target, self.weight, self.ignore_index,
                             self.label_smoothing)


def dice_loss(probs: torch.Tensor, target: torch.Tensor, weight=1.0,
              eps: float = 1e-4, smooth: float = 0.0) -> torch.Tensor:
    """Generalized Dice loss on probabilities: per channel
    ``1 - (2 sum(p t) + smooth) / (sum(p + t) + smooth + eps)``, class
    weighted, mean over channels."""
    onehot = _as_onehot(probs, target)
    numerator = 2 * _channelwise_sum(probs * onehot) + smooth
    denominator = _channelwise_sum(probs + onehot) + smooth + eps
    w = torch.as_tensor(weight, dtype=probs.dtype, device=probs.device)
    return (w * (1 - numerator / denominator)).mean()


class DiceLoss:
    def __init__(self, apply_softmax: bool = True, weight=None,
                 smooth: float = 0.0):
        self.apply_softmax = apply_softmax
        self.weight = 1.0 if weight is None else torch.as_tensor(weight)
        self.smooth = smooth

    def __call__(self, output, target):
        output = output.float()
        probs = torch.softmax(output, -1) if self.apply_softmax else output
        return dice_loss(probs, target, weight=self.weight,
                         smooth=self.smooth)


class CEDiceLoss:
    """Weighted cross entropy + Dice sharing one float32 softmax over the
    channels-last logits; the same value as
    ``CombinedLoss([CrossEntropyLoss(), DiceLoss()], [ce_weight,
    dice_weight])`` (Dice eps 1e-4)."""

    def __init__(self, ce_weight: float = 0.5, dice_weight: float = 0.5,
                 class_weight=None, smooth: float = 0.0):
        self.ce_weight = ce_weight
        self.dice_weight = dice_weight
        self.class_weight = None if class_weight is None \
            else torch.as_tensor(class_weight)
        self.smooth = smooth

    def __call__(self, output, target):
        output = output.float()
        onehot = _as_onehot(output, target)
        logp = torch.log_softmax(output, dim=-1)
        probs = torch.exp(logp)
        nll = -(onehot * logp).sum(-1)
        cw = None if self.class_weight is None else \
            self.class_weight.to(output.device, output.dtype)
        if cw is not None:
            pix_w = (onehot * cw).sum(-1)
            ce = (nll * pix_w).sum() / torch.clamp_min(pix_w.sum(), 1e-12)
        else:
            ce = nll.mean()
        numerator = 2 * _channelwise_sum(probs * onehot) + self.smooth
        denominator = _channelwise_sum(probs + onehot) + self.smooth + 1e-4
        dice = ((1.0 if cw is None else cw)
                * (1 - numerator / denominator)).mean()
        return self.ce_weight * ce + self.dice_weight * dice


class CombinedLoss:
    """Weighted sum of loss criteria (reference loss.py:19-49)."""

    def __init__(self, criteria: Sequence[Callable],
                 weight: Optional[Sequence[float]] = None):
        self.criteria = list(criteria)
        if weight is None:
            weight = [1.0] * len(self.criteria)
        if len(weight) != len(self.criteria):
            raise ValueError("one weight per criterion")
        self.weight = [float(w) for w in weight]

    def __call__(self, *args):
        loss = 0.0
        for crit, w in zip(self.criteria, self.weight):
            loss = loss + w * crit(*args)
        return loss
