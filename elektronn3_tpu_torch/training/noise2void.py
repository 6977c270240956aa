"""Noise2Void self-supervised denoising (arXiv:1811.10980).

Counterpart of the JAX package's ``training/noise2void.py`` (reference
elektronn3/training/noise2void.py:26-243). A stratified random subset of
the voxels of each input is replaced by random neighbours, and the model
is trained to give the original values at exactly those voxels (the
masked mean squared error), so it learns the structure and not the
voxel-wise independent noise.

The masking is numpy on the host, drawn from one
``np.random.default_rng(seed)`` in JAX's order (per sample, per channel:
the coordinates, then the shifts), so one seed gives JAX's masks.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from elektronn3_tpu_torch.modules.loss import masked_mse_loss
from elektronn3_tpu_torch.parallel.collectives import sum_gradients
from elektronn3_tpu_torch.training.trainer import Trainer, _global_forward


def get_stratified_coords(ratio: float, shape: Sequence[int],
                          rng: Optional[np.random.Generator] = None,
                          ) -> Tuple[np.ndarray, ...]:
    """One random coordinate in each box of a grid over ``shape``, the
    boxes sized so that about ``ratio`` of the voxels are drawn
    (reference noise2void.py:26-50)."""
    rng = rng or np.random.default_rng()
    ndim = len(shape)
    box_size = int(np.round(np.sqrt(100 / (ratio * 100)))) if ndim == 2 \
        else int(np.round((100 / (ratio * 100)) ** (1 / ndim)))
    box_size = max(box_size, 1)
    coords = [[] for _ in range(ndim)]
    for corner in itertools.product(*(range(0, s, box_size) for s in shape)):
        offset = rng.integers(0, box_size, ndim)
        for d, (c, o, s) in enumerate(zip(corner, offset, shape)):
            coords[d].append(min(c + o, s - 1))
    return tuple(np.array(c) for c in coords)


def prepare_sample(inp: np.ndarray, ratio: float = 0.002,
                   channels: Optional[Sequence[int]] = None,
                   rng: Optional[np.random.Generator] = None,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(masked input, target, mask) of one (C, *spatial) input: the
    stratified voxels of each channel take the value of a random voxel
    at most 2 away along each axis (clipped to the patch); the target is
    the input in float32, the mask 1 at the replaced voxels (reference
    noise2void.py:52-77)."""
    rng = rng or np.random.default_rng()
    masked = np.array(inp, copy=True)
    mask = np.zeros_like(inp, dtype=np.float32)
    spatial = inp.shape[1:]
    for c in (range(inp.shape[0]) if channels is None else channels):
        coords = get_stratified_coords(ratio, spatial, rng)
        repl = [np.clip(cs + rng.integers(-2, 3, len(cs)), 0, spatial[d] - 1)
                for d, cs in enumerate(coords)]
        masked[(c,) + tuple(coords)] = inp[(c,) + tuple(repl)]
        mask[(c,) + tuple(coords)] = 1.0
    return masked, np.asarray(inp, np.float32), mask


def mask_batch(raw: np.ndarray, ratio: float, rng: np.random.Generator,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`prepare_sample` on each sample of a channels-first batch,
    in order: (masked, target, mask), each (N, C, *spatial)."""
    masked = np.empty_like(raw)
    target = np.empty_like(raw)
    mask = np.empty_like(raw, dtype=np.float32)
    for n in range(raw.shape[0]):
        masked[n], target[n], mask[n] = prepare_sample(raw[n], ratio, rng=rng)
    return masked, target, mask


class _N2VCriterion:
    """The mean squared error over every voxel: the Trainer's criterion
    for the passes that have no mask (the masked loss is the step's)."""

    def __call__(self, out, target):
        return masked_mse_loss(out, target, None)


class Noise2VoidTrainer(Trainer):
    """:class:`~.trainer.Trainer` for Noise2Void: the training set gives
    ``{"inp": (C, *spatial)}``, each batch is masked here
    (``n2v_ratio`` of the voxels) and the step minimizes the masked
    mean squared error (reference noise2void.py:79-224)."""

    def __init__(self, model, criterion=None, *args,
                 n2v_ratio: float = 0.002, **kwargs):
        self.n2v_ratio = n2v_ratio
        super().__init__(model, criterion if criterion is not None
                         else _N2VCriterion(), *args, **kwargs)
        self._n2v_rng = np.random.default_rng(self.seed)

    def _loader(self, **kwargs):
        return super()._loader(channels_last=False, **kwargs)

    def _masked(self, raw, rng) -> Tuple[torch.Tensor, ...]:
        """(input, target, mask) of a masked channels-first batch, each
        channels-last on the device."""
        parts = mask_batch(np.asarray(raw), self.n2v_ratio, rng)
        inp, target, mask = (torch.from_numpy(np.moveaxis(a, 1, -1))
                             for a in parts)
        inp = self._inp(inp)
        return (inp, target.to(self.device, non_blocking=True),
                mask.to(self.device, non_blocking=True))

    def _train_batch(self, batch, unlabeled):
        inp, target, mask = self._masked(batch["inp"], self._n2v_rng)
        self._set_lr()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with self._rank_rng():
            out = _global_forward(self.model, inp, self._dp)
            loss = masked_mse_loss(out, target, mask).float()
            loss.backward()
        sum_gradients(self.model.parameters(), self._dp)
        self.optimizer.step()
        self._last_sample = (inp, None, out.detach())
        return loss.detach(), inp.numel(), True

    def _validate(self) -> Dict[str, float]:
        """The mean masked error over the validation set in eval mode,
        masked from its own ``default_rng(0)`` (reference
        noise2void.py:155-223)."""
        loader = self._map_loader(self.valid_dataset, shuffle=False,
                                  seed=self.seed, drop_last=False,
                                  channels_last=False)
        rng = np.random.default_rng(0)
        losses = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in loader:
                    inp, target, mask = self._masked(batch["inp"], rng)
                    losses.append(
                        masked_mse_loss(self.model(inp), target, mask))
        finally:
            self.model.train(was_training)
        vals = torch.stack(losses).cpu().tolist() if losses else []
        return {"val_loss": float(np.mean(vals)) if vals else np.nan}
