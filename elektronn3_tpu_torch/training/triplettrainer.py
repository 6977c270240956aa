"""Metric learning with the triplet margin loss.

Counterpart of the JAX package's ``training/triplettrainer.py``
(reference elektronn3/training/triplettrainer.py:12-113): three
training-mode forwards (anchor, positive, negative) and one backward of
the triplet margin loss of their globally average-pooled outputs. The
training set gives ``{"anchor", "pos", "neg"}`` (``data.TripletData2d``).

The batch norms' running statistics take three momentum updates a step,
one a forward, as JAX chains its ``batch_stats`` through the three
applies; each forward keeps its own autograd graph.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from elektronn3_tpu_torch.modules.loss import GAPTripletMarginLoss
from elektronn3_tpu_torch.parallel.collectives import sum_gradients
from elektronn3_tpu_torch.training.trainer import Trainer, _global_forward

KEYS = ("anchor", "pos", "neg")


class TripletTrainer(Trainer):
    """:class:`~.trainer.Trainer` over triplets; the criterion is
    ``(out_anchor, out_pos, out_neg) -> loss`` (default
    ``GAPTripletMarginLoss()``)."""

    def __init__(self, model, criterion=None, *args, **kwargs):
        super().__init__(model, criterion if criterion is not None
                         else GAPTripletMarginLoss(), *args, **kwargs)

    def _loader(self, **kwargs):
        return super()._loader(channels_last_keys=KEYS, **kwargs)

    def _train_batch(self, batch, unlabeled):
        xs = [self._inp(batch[k]) for k in KEYS]
        self._set_lr()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with self._rank_rng():
            outs = [_global_forward(self.model, x, self._dp) for x in xs]
            loss = self.criterion(*outs).float()
            loss.backward()
        sum_gradients(self.model.parameters(), self._dp)
        self.optimizer.step()
        self._last_sample = None
        return loss.detach(), 3 * xs[0].numel(), True

    def _validate(self) -> Dict[str, float]:
        """The mean loss of the validation triplets in eval mode."""
        loader = self._map_loader(self.valid_dataset, shuffle=False,
                                  seed=self.seed, drop_last=False,
                                  channels_last_keys=KEYS)
        losses = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in loader:
                    outs = [self.model(self._inp(batch[k])) for k in KEYS]
                    losses.append(self.criterion(*outs).float())
        finally:
            self.model.train(was_training)
        vals = torch.stack(losses).cpu().tolist() if losses else []
        return {"val_loss": float(np.mean(vals)) if vals else np.nan}
