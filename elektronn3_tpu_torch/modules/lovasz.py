"""Lovász-Softmax and Lovász-hinge losses (Berman et al.,
arXiv:1705.08790), surrogates of the Jaccard index.

Counterpart of the JAX package's ``modules/lovasz.py`` (reference
elektronn3/modules/lovasz_losses.py:33-232), with its rule for ignored
pixels: they are not filtered out but get zero error and zero
foreground, which gives the same loss (a zero error sorts last, where
it adds nothing to the prefix sums) and the same gradient, since
``torch.argsort(..., stable=True)`` breaks ties by position as JAX's
``argsort`` does.

Channels-last: ``probas`` is ``(N, *spatial, C)``, ``labels`` is
``(N, *spatial)`` int.
"""

from __future__ import annotations

from typing import Optional

import torch


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the sorted
    errors (reference lovasz_losses.py:33-45)."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / torch.clamp_min(union, 1e-12)
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def _valid(labels: torch.Tensor, ignore: Optional[int],
           dtype: torch.dtype) -> torch.Tensor:
    if ignore is None:
        return torch.ones(labels.shape, dtype=dtype, device=labels.device)
    return (labels != ignore).to(dtype)


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor,
                         only_present: bool = False) -> torch.Tensor:
    """Lovász-Softmax on flat (P, C) probabilities and (P,) labels; an
    invalid pixel has zero error and zero foreground (reference
    lovasz_losses.py:185-203)."""
    losses, presents = [], []
    for c in range(probas.shape[1]):
        fg = (labels == c).to(probas.dtype) * valid
        errors = (fg - probas[:, c]).abs() * valid
        order = torch.argsort(-errors, stable=True)
        losses.append(torch.dot(errors[order], lovasz_grad(fg[order])))
        presents.append((fg.sum() > 0).to(probas.dtype))
    losses, presents = torch.stack(losses), torch.stack(presents)
    if only_present:
        return (losses * presents).sum() / torch.clamp_min(presents.sum(),
                                                           1e-12)
    return losses.mean()


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   only_present: bool = False, per_image: bool = False,
                   ignore: Optional[int] = None) -> torch.Tensor:
    """Multi-class Lovász-Softmax loss of ``probas`` (N, *spatial, C)
    against int ``labels`` (N, *spatial): over the whole batch, or the
    mean over images with ``per_image``; ``only_present`` averages over
    the classes present in the labels only; ``ignore`` is a void label
    (reference lovasz_losses.py:168-221)."""
    c = probas.shape[-1]
    if per_image:
        return torch.stack([
            _lovasz_softmax_flat(p.reshape(-1, c), lb.reshape(-1),
                                 _valid(lb.reshape(-1), ignore, p.dtype),
                                 only_present)
            for p, lb in zip(probas, labels)]).mean()
    lbf = labels.reshape(-1)
    return _lovasz_softmax_flat(probas.reshape(-1, c), lbf,
                                _valid(lbf, ignore, probas.dtype),
                                only_present)


def _lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Binary Lovász hinge on flat logits (reference
    lovasz_losses.py:109-126)."""
    errors = (1.0 - logits * (2.0 * labels - 1.0)) * valid
    order = torch.argsort(-errors, stable=True)
    return torch.dot(torch.relu(errors[order]),
                     lovasz_grad((labels * valid)[order]))


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 per_image: bool = True,
                 ignore: Optional[int] = None) -> torch.Tensor:
    """Binary Lovász hinge loss of raw scores ``logits`` (N, *spatial)
    against ``labels`` (N, *spatial) in {0, 1} (reference
    lovasz_losses.py:93-106)."""
    def flat(lg, lb):
        lbf = lb.reshape(-1)
        return _lovasz_hinge_flat(lg.reshape(-1), lbf.to(lg.dtype),
                                  _valid(lbf, ignore, lg.dtype))
    if per_image:
        return torch.stack([flat(lg, lb)
                            for lg, lb in zip(logits, labels)]).mean()
    return flat(logits, labels)


def binary_xloss(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: Optional[int] = None) -> torch.Tensor:
    """Numerically stable binary cross entropy on logits, the mean over
    the valid pixels (reference lovasz_losses.py:144-165). ``max(x, 0)``
    has no gradient at a logit of exactly 0, as JAX's ``clip`` there."""
    lbf = labels.to(logits.dtype)
    loss = torch.relu(logits) - logits * lbf \
        + torch.log1p(torch.exp(-logits.abs()))
    if ignore is None:
        return loss.mean()
    vld = (labels != ignore).to(logits.dtype)
    return (loss * vld).sum() / torch.clamp_min(vld.sum(), 1e-12)


def iou_binary(preds: torch.Tensor, labels: torch.Tensor,
               empty: float = 1.0, ignore: Optional[int] = None,
               per_image: bool = True) -> torch.Tensor:
    """Binary IoU in percent, an evaluation metric: the mean over images
    (``per_image``) or over the batch as one image, ``empty`` where the
    union is empty (reference lovasz_losses.py:48-65)."""
    preds, labels = torch.as_tensor(preds), torch.as_tensor(labels)
    if not per_image:
        preds, labels = preds[None], labels[None]
    ious = []
    for p, lb in zip(preds, labels):
        vld = _valid(lb, ignore, torch.float32)
        inter = (((p == 1) & (lb == 1)) * vld).sum()
        union = (((p == 1) | (lb == 1)) * vld).sum()
        ious.append(torch.where(union == 0, union.new_tensor(float(empty)),
                                inter / torch.clamp_min(union, 1e-12)))
    return 100.0 * torch.stack(ious).mean()
