"""Losses for dense prediction on channels-last logits.

Counterpart of the JAX package's ``modules/loss.py`` (reference
elektronn3/modules/loss.py), the whole zoo: cross entropy, Dice,
``CEDiceLoss``, ``CombinedLoss``, focal, softmax BCE, ``MixedCombinedLoss``,
masked and distance-weighted MSE, the GAP triplet margin loss, Lovász
(``lovasz.py``), the active-contour loss, the norpf Dice and the
FixMatch consistency loss:

- ``output``: raw logits ``(N, *spatial, C)``, any float dtype; every
  loss computes in float32 (bf16 logits are upcast on load);
- ``target``: dense integer class ids ``(N, *spatial)`` or a one-hot /
  float tensor ``(N, *spatial, C)`` (the shape decides, as in the
  reference's ``dice_loss`` dispatch).

Every loss is a callable ``loss(output, target) -> scalar`` tensor
(``MaskedMSELoss`` takes a mask, ``MixedCombinedLoss`` a mix,
``GAPTripletMarginLoss`` three embeddings, ``FixMatchSegLoss`` the
unlabeled input and the model).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.modules import lovasz


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


def _weighted_nll(nll: torch.Tensor, onehot: torch.Tensor,
                  target: torch.Tensor, output: torch.Tensor, weight,
                  ignore_index: Optional[int]) -> torch.Tensor:
    """The class-weighted mean of per-voxel losses ``nll``, voxels of
    ``ignore_index`` (dense targets) left out."""
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


def focal_loss(output: torch.Tensor, target: torch.Tensor,
               gamma: float = 2.0, weight=None,
               ignore_index: Optional[int] = None) -> torch.Tensor:
    """Focal loss (arXiv:1708.02002): the class-weighted mean of
    ``-(1 - p)^gamma log p`` of the target class (reference
    loss.py:52-65)."""
    output = output.float()
    logp = torch.log_softmax(output, dim=-1)
    onehot = _as_onehot(output, target)
    nll = -(onehot * ((1 - logp.exp()) ** gamma) * logp).sum(-1)
    return _weighted_nll(nll, onehot, target, output, weight, ignore_index)


class FocalLoss:
    def __init__(self, weight=None, gamma: float = 2.0,
                 ignore_index: Optional[int] = None):
        self.weight = None if weight is None else torch.as_tensor(weight)
        self.gamma = gamma
        self.ignore_index = ignore_index

    def __call__(self, output, target):
        return focal_loss(output, target, self.gamma, self.weight,
                          self.ignore_index)


class SoftmaxBCELoss:
    """Softmax, then binary cross entropy against the one-hot target,
    the probabilities clipped to [1e-7, 1 - 1e-7] (reference
    loss.py:68-74)."""

    def __call__(self, output, target):
        output = output.float()
        onehot = _as_onehot(output, target)
        probs = torch.clamp(torch.softmax(output, -1), 1e-7, 1 - 1e-7)
        return -(onehot * probs.log()
                 + (1 - onehot) * (1 - probs).log()).mean()


class MixedCombinedLoss:
    """``criterion_a`` and ``criterion_b`` mixed by the share of samples
    whose ``mix`` flag is set: ``(1 - m) a + m b`` (reference
    loss.py:608-637, used by the multi-target trainer)."""

    def __init__(self, criterion_a: Callable, criterion_b: Callable):
        self.criterion_a = criterion_a
        self.criterion_b = criterion_b

    def __call__(self, output, target, mix):
        mixf = torch.as_tensor(mix, device=output.device).float().mean()
        return (1 - mixf) * self.criterion_a(output, target) \
            + mixf * self.criterion_b(output, target)


def masked_mse_loss(out: torch.Tensor, target: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean squared error over the voxels of ``mask`` (all without
    one; reference loss.py:110-122, Noise2Void's blind-spot loss)."""
    out, target = out.float(), target.float()
    if mask is None:
        return ((out - target) ** 2).mean()
    mask = mask.to(out.dtype)
    return ((out - target) ** 2 * mask).sum() / torch.clamp_min(mask.sum(),
                                                               1e-12)


class MaskedMSELoss:
    def __call__(self, out, target, mask=None):
        return masked_mse_loss(out, target, mask)


class DistanceWeightedMSELoss:
    """The mean squared error with foreground voxels (``target <= 0``,
    the signed distance transform's inside) weighted ``fg_weight`` and,
    with ``mask_borders``, bands of that width on every spatial border
    left out (reference loss.py:125-155; the JAX package zeroes whole
    border bands where the reference zeroes two corner blocks, and so
    does the port). ``output`` and ``target`` are (N, *spatial, C)."""

    def __init__(self, fg_weight: float = 100.0,
                 mask_borders: Optional[int] = 40):
        self.fg_weight = fg_weight
        self.mask_borders = mask_borders

    def __call__(self, output, target):
        output, target = output.float(), target.float()
        weight = torch.where(target <= 0, self.fg_weight, 1.0)
        if self.mask_borders is not None:
            o = self.mask_borders
            for ax in range(1, target.dim() - 1):
                idx = torch.arange(target.shape[ax], device=target.device)
                keep = ~((idx < o) | (idx >= target.shape[ax] - o))
                shape = [1] * target.dim()
                shape[ax] = -1
                weight = weight * keep.to(weight.dtype).view(shape)
        return (weight * (output - target) ** 2).mean()


def global_average_pooling(inp: torch.Tensor) -> torch.Tensor:
    """The mean over the spatial axes of (N, *spatial, C): (N, C)
    (reference loss.py:88-94)."""
    return inp.mean(tuple(range(1, inp.dim() - 1)))


def triplet_margin_loss(anchor, positive, negative, margin: float = 1.0,
                        p: int = 2, eps: float = 1e-6) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss``'s value on (N, E) embeddings:
    ``mean(max(|a - p + eps| - |a - n + eps| + margin, 0))`` in the
    ``p``-norm."""
    d_ap = torch.linalg.vector_norm(anchor - positive + eps, ord=p, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative + eps, ord=p, dim=-1)
    return torch.clamp_min(d_ap - d_an + margin, 0.0).mean()


class GAPTripletMarginLoss:
    """The triplet margin loss of globally average-pooled dense
    embeddings (reference loss.py:97-107)."""

    def __init__(self, margin: float = 1.0, p: int = 2):
        self.margin = margin
        self.p = p

    def __call__(self, anchor, positive, negative):
        return triplet_margin_loss(
            global_average_pooling(anchor.float()),
            global_average_pooling(positive.float()),
            global_average_pooling(negative.float()),
            margin=self.margin, p=self.p)


class LovaszLoss:
    """The Lovász-Softmax loss of the logits' softmax (or of ``output``
    as probabilities without ``apply_softmax``) over the whole batch
    (reference loss.py:533-547)."""

    def __init__(self, apply_softmax: bool = True,
                 ignore_index: Optional[int] = None):
        self.apply_softmax = apply_softmax
        self.ignore_index = ignore_index

    def __call__(self, output, target):
        output = output.float()
        probs = torch.softmax(output, -1) if self.apply_softmax else output
        return lovasz.lovasz_softmax(probs, target, ignore=self.ignore_index)


class ACLoss:
    """Active-contour loss (Chen et al., CVPR 2019) of the foreground
    (channel 1) probability: the mean boundary length
    ``mean(sqrt(d^2 + 1e-8))`` of its differences along each spatial
    axis, plus ``lambda_region`` times the region terms
    ``mean(p (t - 1)^2) + mean((1 - p) t^2)`` (reference
    loss.py:550-605); 2D and 3D."""

    def __init__(self, apply_softmax: bool = True,
                 lambda_region: float = 1.0):
        self.apply_softmax = apply_softmax
        self.lambda_region = lambda_region

    def __call__(self, output, target):
        output = output.float()
        probs = torch.softmax(output, -1) if self.apply_softmax else output
        pred = probs[..., 1]
        tgt = _as_onehot(probs, target)[..., 1]
        length = 0.0
        for ax in range(1, pred.dim()):
            d = torch.diff(pred, dim=ax)
            length = length + torch.sqrt(d * d + 1e-8).mean()
        region = (pred * (tgt - 1.0) ** 2).mean() \
            + ((1 - pred) * tgt ** 2).mean()
        return length + self.lambda_region * region


def norpf_dice_loss(probs: torch.Tensor, target: torch.Tensor,
                    weight=1.0) -> torch.Tensor:
    """Dice over [background, the union of the foreground channels (their
    max), each foreground channel] (reference loss.py:394-495, the Dice
    for overlapping neurite-type labels). The max's gradient is shared
    among tied channels, as JAX's is."""
    onehot = _as_onehot(probs, target)
    probs2 = torch.cat([probs[..., :1],
                        probs[..., 1:].amax(-1, keepdim=True),
                        probs[..., 1:]], -1)
    target2 = torch.cat([onehot[..., :1],
                         onehot[..., 1:].amax(-1, keepdim=True),
                         onehot[..., 1:]], -1)
    numerator = 2 * _channelwise_sum(probs2 * target2)
    denominator = _channelwise_sum(probs2 + target2) + 1e-4
    w = torch.as_tensor(weight, dtype=probs.dtype, device=probs.device)
    return (w * (1 - numerator / denominator)).mean()


class NorpfDiceLoss:
    def __init__(self, apply_softmax: bool = True, weight=None):
        self.apply_softmax = apply_softmax
        self.weight = 1.0 if weight is None else torch.as_tensor(weight)

    def __call__(self, output, target):
        output = output.float()
        probs = torch.softmax(output, -1) if self.apply_softmax else output
        return norpf_dice_loss(probs, target, weight=self.weight)


class FixMatchSegLoss:
    """Semi-supervised consistency and pseudo-label loss for
    segmentation (reference loss.py:237-390): the unlabeled input goes
    through the model as it is and after a random reversible
    augmentation (a flip of each spatial axis with probability 1/2, then
    ``k_rot`` quarter turns in (H, W) where H == W); the augmented
    output, de-augmented, is held to the plain output's softmax (no
    gradient through it) by the mean squared error of the probabilities
    (``consistency='mse'``) or a cross entropy, plus, with
    ``enable_pseudo_label``, the cross entropy of the argmax where the
    plain output's confidence reaches ``confidence_threshold``.

    ``apply_fn(inp) -> logits`` is the model in training mode (the
    Trainer passes it at each call); each call moves its batch norms'
    running statistics, as JAX chains them through both passes. The
    draws come from ``rng``, a ``torch.Generator`` on the CPU (the
    Trainer passes its own), or the loss's own ``generator``: JAX draws
    from a key, which torch cannot repeat, so :meth:`draw` and the
    draw-free :meth:`loss` (with :meth:`augment` and :meth:`deaugment`)
    can be called apart."""

    def __init__(self, apply_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 enable_pseudo_label: bool = True,
                 confidence_threshold: float = 0.9,
                 consistency: str = "mse"):
        self.apply_fn = apply_fn
        self.generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.enable_pseudo_label = enable_pseudo_label
        self.confidence_threshold = confidence_threshold
        self.consistency = consistency

    @staticmethod
    def augment(inp: torch.Tensor, flips: Sequence[bool],
                k_rot: int) -> torch.Tensor:
        """Flip the spatial axes of (N, *spatial, C) where ``flips``
        says, then turn (H, W) ``k_rot`` quarter turns."""
        dims = [1 + i for i, f in enumerate(flips) if f]
        if dims:
            inp = inp.flip(dims)
        return torch.rot90(inp, k_rot, (inp.dim() - 3, inp.dim() - 2)) \
            if k_rot % 4 else inp

    @staticmethod
    def deaugment(out: torch.Tensor, flips: Sequence[bool],
                  k_rot: int) -> torch.Tensor:
        """The inverse of :meth:`augment`."""
        if k_rot % 4:
            out = torch.rot90(out, -k_rot, (out.dim() - 3, out.dim() - 2))
        dims = [1 + i for i, f in enumerate(flips) if f]
        return out.flip(dims) if dims else out

    def draw(self, inp: torch.Tensor,
             rng: Optional[torch.Generator] = None
             ) -> Tuple[List[bool], int]:
        """(flips, k_rot) for ``inp``: ``k_rot`` 0 unless H == W."""
        g = rng if rng is not None else self.generator
        flips = (torch.rand(inp.dim() - 2, generator=g) < 0.5).tolist()
        k_rot = int(torch.randint(0, 4, (), generator=g))
        return flips, k_rot if inp.shape[-2] == inp.shape[-3] else 0

    def loss(self, inp: torch.Tensor, flips: Sequence[bool], k_rot: int,
             apply_fn: Callable) -> torch.Tensor:
        """The loss for a given draw."""
        out_plain = apply_fn(inp).float()
        out_aug = self.deaugment(
            apply_fn(self.augment(inp, flips, k_rot)).float(), flips, k_rot)
        target_probs = torch.softmax(out_plain, -1).detach()
        logp = torch.log_softmax(out_aug, -1)
        if self.consistency == "mse":
            loss = ((torch.softmax(out_aug, -1) - target_probs) ** 2).mean()
        else:
            loss = (-target_probs * logp).mean()
        if self.enable_pseudo_label:
            conf, pseudo = target_probs.amax(-1), target_probs.argmax(-1)
            mask = (conf >= self.confidence_threshold).to(logp.dtype)
            nll = -logp.gather(-1, pseudo[..., None])[..., 0]
            loss = loss + (nll * mask).sum() / torch.clamp_min(mask.sum(),
                                                               1e-12)
        return loss

    def __call__(self, inp: torch.Tensor,
                 rng: Optional[torch.Generator] = None,
                 apply_fn: Optional[Callable] = None) -> torch.Tensor:
        if apply_fn is None:
            apply_fn = self.apply_fn
        if apply_fn is None:
            raise ValueError("FixMatchSegLoss needs an apply_fn (constructor "
                             "or call).")
        return self.loss(inp, *self.draw(inp, rng), apply_fn)
