"""Segmentation metrics from confusion-matrix counts.

Counterpart of the JAX package's ``training/metrics.py`` (reference
elektronn3/training/metrics.py):

- :func:`confusion_matrix` counts, per class, the binary (tp, tn, fp,
  fn) of a prediction against a target, on the tensors' device: one
  ``torch.bincount`` of ``target * (C + 1) + pred`` (labels outside
  ``[0, C)`` count as no class) gives the (C + 1, C + 1) table; only
  the (C, 4) result leaves the device, never the logits.
- precision, recall, accuracy, Dice and IoU from those counts, in
  percent, the mean over classes skipping classes absent from the
  target (NaN); the :class:`Evaluator` family wraps them as
  ``(target, logits) -> value`` callables, and the
  confusion-matrix-based ones stream (:attr:`Evaluator.supports_streaming`,
  :meth:`Evaluator.from_cm`).
- :func:`auroc` and :func:`average_precision` are the port's own, on
  tensors (a sort and cumulative sums), with ties handled as sklearn's
  ``roc_auc_score`` and ``average_precision_score`` handle them (the
  card's machine has no sklearn). The cluster evaluators (NMI, AMI,
  ARI, silhouette) import sklearn when called.

Model outputs are channels-last ``(N, *spatial, C)``, dense targets
``(N, *spatial)``; each function takes tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def confusion_matrix(target, pred, num_classes: int = 2,
                     nan_when_empty: bool = True,
                     ignore: Optional[int] = None) -> torch.Tensor:
    """Per-class binary confusion counts (tp, tn, fp, fn): a (C, 4)
    float64 tensor on the inputs' device; a class absent from the
    target gets NaNs with ``nan_when_empty``. Voxels whose target is
    ``ignore`` are left out. Reference metrics.py:49-118."""
    target = _as_tensor(target).reshape(-1)
    pred = _as_tensor(pred).to(target.device).reshape(-1)
    if ignore is not None:
        keep = target != ignore
        target, pred = target[keep], pred[keep]
    c = num_classes
    t = target.long()
    p = pred.long()
    t = torch.where((t >= 0) & (t < c), t, c)
    p = torch.where((p >= 0) & (p < c), p, c)
    table = torch.bincount(t * (c + 1) + p, minlength=(c + 1) ** 2)
    table = table.reshape(c + 1, c + 1)[:, :c].to(torch.float64)
    rows = torch.bincount(t, minlength=c + 1)[:c].to(torch.float64)
    tp = torch.diagonal(table[:c])
    fp = table.sum(0) - tp
    fn = rows - tp
    tn = float(t.numel()) - tp - fp - fn
    cm = torch.stack([tp, tn, fp, fn], 1)
    if nan_when_empty:
        cm = torch.where((rows == 0)[:, None],
                         torch.full_like(cm, float("nan")), cm)
    return cm


def _metric_from_cm(cm, fn: Callable, mean: bool):
    cm = _as_np(cm).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = fn(cm[:, 0], cm[:, 1], cm[:, 2], cm[:, 3])
    if mean:
        return np.nanmean(vals) * 100
    return vals * 100


def _precision(tp, tn, fp, fn):
    return tp / (tp + fp)


def _recall(tp, tn, fp, fn):
    return tp / (tp + fn)


def _accuracy(tp, tn, fp, fn):
    return (tp + tn) / (tp + tn + fp + fn)


def _dice(tp, tn, fp, fn):
    return 2 * tp / (2 * tp + fp + fn)


def _iou(tp, tn, fp, fn):
    return tp / (tp + fp + fn)


def precision(target, pred, num_classes=2, mean=True, ignore=None):
    """tp / (tp + fp). Reference metrics.py:121-131."""
    cm = confusion_matrix(target, pred, num_classes, ignore=ignore)
    return _metric_from_cm(cm, _precision, mean)


def recall(target, pred, num_classes=2, mean=True, ignore=None):
    """tp / (tp + fn). Reference metrics.py:134-143."""
    cm = confusion_matrix(target, pred, num_classes, ignore=ignore)
    return _metric_from_cm(cm, _recall, mean)


def accuracy(target, pred, num_classes=2, mean=True, ignore=None):
    """(tp + tn) / all. Reference metrics.py:146-155."""
    cm = confusion_matrix(target, pred, num_classes, ignore=ignore)
    return _metric_from_cm(cm, _accuracy, mean)


def dice_coefficient(target, pred, num_classes=2, mean=True, ignore=None):
    """2 tp / (2 tp + fp + fn). Reference metrics.py:158-166."""
    cm = confusion_matrix(target, pred, num_classes, ignore=ignore)
    return _metric_from_cm(cm, _dice, mean)


def iou(target, pred, num_classes=2, mean=True, ignore=None):
    """tp / (tp + fp + fn) (Jaccard). Reference metrics.py:169."""
    cm = confusion_matrix(target, pred, num_classes, ignore=ignore)
    return _metric_from_cm(cm, _iou, mean)


# metric function -> its value from (tp, tn, fp, fn): the streaming ones
_CM_LAMBDAS = {precision: _precision, recall: _recall, accuracy: _accuracy,
               dice_coefficient: _dice, iou: _iou}


def _class_curve(target: torch.Tensor, score: torch.Tensor):
    """(tps, fps) at each distinct score, from the highest down: the
    positives and negatives scoring at least that (sklearn's
    ``_binary_clf_curve``), float64."""
    score, order = torch.sort(score, descending=True, stable=True)
    y = target[order].to(torch.float64)
    n = score.numel()
    ends = torch.nonzero(score[1:] != score[:-1]).reshape(-1)
    ends = torch.cat([ends, ends.new_tensor([n - 1])])
    tps = torch.cumsum(y, 0)[ends]
    fps = (ends + 1).to(torch.float64) - tps
    return tps, fps


def _roc_auc(target: torch.Tensor, score: torch.Tensor) -> float:
    tps, fps = _class_curve(target, score)
    if tps[-1] == 0 or fps[-1] == 0:
        return float("nan")   # one class only: sklearn's NaN
    zero = tps.new_zeros(1)
    tpr = torch.cat([zero, tps]) / tps[-1]
    fpr = torch.cat([zero, fps]) / fps[-1]
    return float(((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2).sum())


def _average_precision(target: torch.Tensor, score: torch.Tensor) -> float:
    tps, fps = _class_curve(target, score)
    if tps[-1] == 0:
        return 0.0   # no positive: sklearn sets recall to 1, AP 0
    prec = tps / (tps + fps)
    rec = tps / tps[-1]
    rec_prev = torch.cat([rec.new_zeros(1), rec[:-1]])
    return float(((rec - rec_prev) * prec).sum())


def _per_class(fn, target, probs, mean):
    target = _as_tensor(target).reshape(-1)
    probs = _as_tensor(probs)
    num_classes = probs.shape[-1]
    probs = probs.reshape(-1, num_classes).to(target.device, torch.float64)
    vals = np.array([fn(target == c, probs[:, c])
                     for c in range(num_classes)]) * 100
    return np.nanmean(vals) if mean else vals


def auroc(target, probs, mean=True):
    """Area under the ROC curve of each class's probability (N, *sp, C)
    against its one-vs-rest target, in percent; NaN for a class that is
    always or never the target. Reference metrics.py:172-196."""
    return _per_class(_roc_auc, target, probs, mean)


def average_precision(target, probs, mean=True):
    """Average precision (the step-wise area under the precision-recall
    curve) of each class, in percent. Reference metrics.py:199-223."""
    return _per_class(_average_precision, target, probs, mean)


def channel_metric(metric, c: int, num_classes: int, argmax: bool = True):
    """A metric evaluated on channel ``c`` only. Reference
    metrics.py:237-260."""

    def evaluator(target, out):
        pred = torch.argmax(_as_tensor(out), -1) if argmax else out
        return metric(target, pred, num_classes=num_classes, mean=False)[c]

    return evaluator


# ---------------------------------------------------------------------------
# Evaluators (reference metrics.py:317-401): (target, logits) -> scalar,
# the Trainer's valid_metrics entries.
# ---------------------------------------------------------------------------

class Evaluator:
    name = "generic"

    def __init__(self, metric_fn: Callable, index: Optional[int] = None,
                 ignore: Optional[int] = None, self_supervised: bool = False):
        self.metric_fn = metric_fn
        self.index = index
        self.ignore = ignore
        self.self_supervised = self_supervised

    def __call__(self, target, out):
        out = _as_tensor(out)
        pred = torch.argmax(out, -1)
        m = self.metric_fn(target, pred, num_classes=out.shape[-1],
                           mean=self.index is None, ignore=self.ignore)
        if self.index is not None:
            m = m[self.index]
        return m

    @property
    def supports_streaming(self) -> bool:
        """Whether the metric follows from (C, 4) counts summed over
        batches, so validation need not keep the outputs."""
        return self.metric_fn in _CM_LAMBDAS

    def from_cm(self, counts) -> float:
        """The metric from raw counts (``confusion_matrix(...,
        nan_when_empty=False)`` summed over batches); a class absent
        from the targets (tp + fn == 0) becomes NaN, as with
        ``nan_when_empty``."""
        cm = _as_np(counts).astype(np.float64).copy()
        cm[(cm[:, 0] + cm[:, 3]) == 0] = np.nan
        m = _metric_from_cm(cm, _CM_LAMBDAS[self.metric_fn],
                            mean=self.index is None)
        if self.index is not None:
            m = m[self.index]
        return m


class Accuracy(Evaluator):
    name = "accuracy"

    def __init__(self, *args, **kwargs):
        super().__init__(accuracy, *args, **kwargs)


class Precision(Evaluator):
    name = "precision"

    def __init__(self, *args, **kwargs):
        super().__init__(precision, *args, **kwargs)


class Recall(Evaluator):
    name = "recall"

    def __init__(self, *args, **kwargs):
        super().__init__(recall, *args, **kwargs)


class DSC(Evaluator):
    name = "DSC"

    def __init__(self, *args, **kwargs):
        super().__init__(dice_coefficient, *args, **kwargs)


class IoU(Evaluator):
    name = "IoU"

    def __init__(self, *args, **kwargs):
        super().__init__(iou, *args, **kwargs)


class _ProbEvaluator:
    """A metric of the class probabilities: the softmax of the logits
    over the channel axis, in float32 as JAX's (the ranking metrics see
    its ties)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, target, out):
        out = _as_tensor(out).float()
        e = torch.exp(out - out.amax(-1, keepdim=True))
        return self.fn(target, e / e.sum(-1, keepdim=True))


class AUROC(_ProbEvaluator):
    name = "AUROC"

    def __init__(self):
        super().__init__(auroc)


class AveragePrecision(_ProbEvaluator):
    name = "AP"

    def __init__(self):
        super().__init__(average_precision)


class _ClusterEvaluator:
    """sklearn's clustering comparisons of the argmax against the target
    (reference metrics.py:377-401), imported when called."""
    fn_name = None

    def __call__(self, target, out):
        import sklearn.metrics as skm
        target = _as_np(target).reshape(-1)
        pred = _as_np(torch.argmax(_as_tensor(out), -1)).reshape(-1)
        return getattr(skm, self.fn_name)(target, pred) * 100


class NMI(_ClusterEvaluator):
    name = "NMI"
    fn_name = "normalized_mutual_info_score"


class AMI(_ClusterEvaluator):
    name = "AMI"
    fn_name = "adjusted_mutual_info_score"


class ARI(_ClusterEvaluator):
    name = "ARI"
    fn_name = "adjusted_rand_score"


class SilhouetteScore:
    name = "silhouette"

    def __call__(self, target, out):
        import sklearn.metrics as skm
        out = _as_np(out)
        feats = out.reshape(-1, out.shape[-1])
        labels = _as_np(target).reshape(-1)
        # a seeded subsample keeps dense outputs tractable
        if feats.shape[0] > 10000:
            idx = np.random.default_rng(0).choice(
                feats.shape[0], 10000, replace=False)
            feats, labels = feats[idx], labels[idx]
        if len(np.unique(labels)) < 2:
            return np.nan
        return skm.silhouette_score(feats, labels) * 100


def default_metrics(num_classes: int = 2):
    """The Trainer's usual ``valid_metrics``: the five streaming
    evaluators."""
    return {
        "val_accuracy": Accuracy(),
        "val_precision": Precision(),
        "val_recall": Recall(),
        "val_DSC": DSC(),
        "val_IoU": IoU(),
    }
