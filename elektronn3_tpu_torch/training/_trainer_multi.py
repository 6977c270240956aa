"""Trainer with per-cube loss weights, gradient accumulation and a loss
crop.

Counterpart of the JAX package's ``training/_trainer_multi.py``
(reference elektronn3/training/_trainer_multi.py:27-322, TrainerMulti):

- the gradients of ``optimizer_iterations`` micro-batches accumulate in
  the parameters' ``.grad`` (each backward adds to it) and their sum,
  divided by the count, is one optimizer step;
- the loss of a micro-batch is weighted by the finite mean of the
  batch's ``cube_meta`` (1 where there is none or no finite value);
- ``loss_crop`` leaves that many voxels of each spatial border out of
  the loss, on the output and on the target.

The scheduler and ``step`` move on an optimizer step only; a partial
accumulation left when an epoch ends is dropped, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from elektronn3_tpu_torch.parallel.collectives import sum_gradients
from elektronn3_tpu_torch.training.trainer import Trainer, _global_forward


def crop_loss_region(out: torch.Tensor, target: torch.Tensor,
                     loss_crop: Optional[Sequence[int]]):
    """(out, target) without ``loss_crop[i]`` voxels at each end of
    spatial axis i: ``out`` is channels-last (N, *spatial, C), ``target``
    (N, *spatial[, ...]) (JAX ``_trainer_multi.py:45-50``)."""
    if loss_crop is None:
        return out, target
    slc = (slice(None),) + tuple(
        slice(c, s - c) for c, s in zip(loss_crop, out.shape[1:-1]))
    return out[slc + (slice(None),)], target[slc]


def cube_weight(meta) -> float:
    """The loss weight of a batch: the mean of its ``cube_meta`` with
    every non-finite value read as 1; 1 without one."""
    if meta is None:
        return 1.0
    m = np.asarray(meta.cpu() if isinstance(meta, torch.Tensor) else meta,
                   np.float64)
    return float(np.where(np.isfinite(m), m, 1.0).mean())


class TrainerMulti(Trainer):
    """:class:`~.trainer.Trainer` with ``optimizer_iterations``
    micro-batches to a step, ``loss_crop`` and the ``cube_meta``
    weight (see the module's docstring)."""

    def __init__(self, *args, optimizer_iterations: int = 1,
                 loss_crop: Optional[Sequence[int]] = None, **kwargs):
        if optimizer_iterations < 1:
            raise ValueError("optimizer_iterations must be >= 1")
        self.optimizer_iterations = optimizer_iterations
        self.loss_crop = None if loss_crop is None else tuple(loss_crop)
        self._n_accum = 0
        super().__init__(*args, **kwargs)

    def _train(self, max_steps, max_runtime):
        # an accumulation left by the last epoch is dropped
        self._n_accum = 0
        self.optimizer.zero_grad(set_to_none=True)
        return super()._train(max_steps, max_runtime)

    def _train_batch(self, batch, unlabeled):
        inp, target = self._batch(batch)
        weight = cube_weight(batch.get("cube_meta"))
        self.model.train()
        with self._rank_rng():
            out = _global_forward(self.model, inp, self._dp)
            o, t = crop_loss_region(out, target, self.loss_crop)
            loss = self.criterion(o, t).float() * weight
            loss.backward()
        self._n_accum += 1
        self._last_sample = (inp, target, out.detach())
        if self._n_accum < self.optimizer_iterations:
            return loss.detach(), inp.numel(), False
        params = [p for p in self.model.parameters() if p.grad is not None]
        sum_gradients(params, self._dp)
        with torch.no_grad():
            for p in params:
                p.grad.div_(self._n_accum)
        self._set_lr()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self._n_accum = 0
        return loss.detach(), inp.numel(), True
