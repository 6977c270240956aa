"""Supervised training loop.

Counterpart of the core of the JAX package's ``training/trainer.py``
(reference elektronn3/training/trainer.py): the train step, the loop
with its batched NaN guard and throughput, and checkpoints.

- :func:`train_step` is the one training step, used by :class:`Trainer`
  and by any bench-style loop: the forward in training (the batch-norm
  running statistics update as the forward runs), the loss in float32,
  the backward and the optimizer step.
- The default optimizer matches the JAX Trainer's optax ``adamw`` at lr
  1e-3 with optax's weight decay of 1e-4 (``torch.optim.AdamW``'s own
  default, 0.01, is not that value).
- Batches come from ``torch.utils.data.DataLoader`` over a map-style
  dataset of dicts ``{"inp": (C, *spatial), "target": (*spatial)}``
  (shuffled under ``seed``, the last incomplete batch dropped); ``inp``
  is moved to channels-last, the layout of the models.
- Losses stay on the device and are fetched, and checked for NaN, every
  ``nan_check_interval`` steps in one stacked copy.
- Checkpoints are torch ``.pth`` files holding the model, the optimizer
  and the step (``state_dict{suffix}.pth``); :meth:`Trainer.load_state`
  resumes from one.

Not ported yet: validation and its metrics, TensorBoard, learning-rate
schedulers other than a constant rate, SWA and LR-minimum snapshots,
preview inference, the semi-supervised criteria, the per-run log file
and multi-device training.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from elektronn3_tpu_torch.logger import logger


class NaNException(RuntimeError):
    """The loss diverged to NaN (reference trainer.py:48-51)."""


def default_optimizer(model: nn.Module, lr: float = 1e-3,
                      ) -> torch.optim.Optimizer:
    """AdamW as the JAX Trainer's ``optax.adamw(lr)``: betas (0.9,
    0.999), eps 1e-8, decoupled weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_step(model: nn.Module, criterion: Callable,
               optimizer: torch.optim.Optimizer, inp: torch.Tensor,
               target: torch.Tensor, *,
               reference: bool = False) -> torch.Tensor:
    """One optimization step on a channels-last batch; returns the loss
    as a detached float32 device tensor (no host sync). ``reference``
    runs the model with ``reference=True`` (the UNet's plain versions of
    its kernels, to time or check the kernels against)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(inp, reference=True) if reference else model(inp)
    loss = criterion(out, target).float()
    loss.backward()
    optimizer.step()
    return loss.detach()


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class Trainer:
    """Training loop over a map-style dataset.

    Args:
        model: a channels-last model (``elektronn3_tpu_torch.models.UNet``),
            on the device to train on.
        criterion: ``(logits, target) -> scalar`` loss.
        optimizer: a torch optimizer over the model's parameters, or
            None for :func:`default_optimizer` at ``lr``.
        train_dataset: map-style dataset of dicts with ``"inp"``
            (C, *spatial) and ``"target"`` (*spatial) arrays.
        batch_size, num_workers: the DataLoader's.
        save_root, exp_name: checkpoints go to ``save_root/exp_name``,
            which must not exist or be empty.
        seed: seeds the shuffling of the batches.
        nan_check_interval: steps between the batched loss fetches and
            NaN checks (1 checks every step).
        lr: the learning rate of the default optimizer.
    """

    def __init__(self, model: nn.Module, criterion: Callable,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 train_dataset=None, batch_size: int = 1,
                 num_workers: int = 0, save_root: Optional[str] = None,
                 exp_name: Optional[str] = None, seed: int = 0,
                 nan_check_interval: int = 10, lr: float = 1e-3):
        if nan_check_interval < 1:
            raise ValueError("nan_check_interval must be >= 1")
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer if optimizer is not None \
            else default_optimizer(model, lr)
        self.train_dataset = train_dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.nan_check_interval = nan_check_interval
        self.device = _device_of(model)
        self.step = 0
        self.epoch = 0
        self.terminate = False
        self.last_stats: Dict = {}    # tr_loss of the last epoch
        self.last_misc: Dict = {}     # its tr_speed and tr_speed_vx

        if save_root is None:
            save_root = os.path.expanduser("~/e3tpu_training")
        if exp_name is None:
            exp_name = model.__class__.__name__ + "__" + \
                datetime.datetime.now().strftime("%y-%m-%d_%H-%M-%S")
        self.save_path = os.path.join(os.path.expanduser(save_root),
                                      exp_name)
        if os.path.isdir(self.save_path) and os.listdir(self.save_path):
            raise RuntimeError(f"{self.save_path} already exists and is not "
                               "empty. Please choose a different exp_name.")
        os.makedirs(self.save_path, exist_ok=True)
        logger.info(f"Writing files to {self.save_path}")

    def _loader(self) -> torch.utils.data.DataLoader:
        return torch.utils.data.DataLoader(
            self.train_dataset, batch_size=self.batch_size, shuffle=True,
            drop_last=True, num_workers=self.num_workers,
            generator=torch.Generator().manual_seed(self.seed + self.epoch),
            pin_memory=self.device.type == "cuda")

    def run(self, max_steps: int = 1,
            max_runtime: float = 3600 * 24 * 7) -> None:
        """Train until ``max_steps`` steps or ``max_runtime`` seconds,
        epoch by epoch; save a checkpoint at the start, after each epoch
        and at the end (reference Trainer.run)."""
        self._t_start = time.perf_counter()
        self._save_model(suffix="_initial")
        while not self.terminate:
            stats, misc = self._train(max_steps, max_runtime)
            self.last_stats, self.last_misc = stats, misc
            self.epoch += 1
            logger.info(
                f"step {self.step} epoch {self.epoch}: tr_loss "
                f"{stats['tr_loss_mean']:.4g}, {misc['tr_speed']:.2f} it/s, "
                f"{misc['tr_speed_vx']:.2f} MVx/s")
            self._save_model()
        self._save_model(suffix="_final")

    def _fetch(self, pending, stats) -> None:
        vals = torch.stack(pending).cpu().tolist()
        pending.clear()
        stats["tr_loss"].extend(vals)
        if any(np.isnan(v) for v in vals):
            raise NaNException("NaN loss detected! Aborting training.")

    def _train(self, max_steps: int, max_runtime: float):
        """One epoch over the loader (reference trainer.py:545-627)."""
        stats: Dict = {"tr_loss": []}
        misc: Dict = {}
        pending = []
        running_vx = 0
        t0 = time.perf_counter()
        loader = self._loader()
        if len(loader) == 0:
            raise ValueError("the training dataset holds fewer samples than "
                             "one batch")
        for batch in loader:
            inp = batch["inp"].to(self.device, non_blocking=True)
            inp = inp.movedim(1, -1).contiguous()
            target = batch["target"].to(self.device, non_blocking=True)
            pending.append(train_step(self.model, self.criterion,
                                      self.optimizer, inp, target))
            if len(pending) >= self.nan_check_interval:
                self._fetch(pending, stats)
            self.step += 1
            running_vx += inp.numel()
            if self.step >= max_steps:
                logger.info(f"max_steps ({max_steps}) reached. Terminating.")
                self.terminate = True
            if time.perf_counter() - self._t_start >= max_runtime:
                logger.info(f"max_runtime ({max_runtime} s) exceeded. "
                            "Terminating.")
                self.terminate = True
            if self.terminate:
                break
        if pending:
            self._fetch(pending, stats)
        t = time.perf_counter() - t0
        misc["tr_speed"] = max(len(stats["tr_loss"]), 1) / t
        misc["tr_speed_vx"] = running_vx / t / 1e6   # MVx/s
        stats["tr_loss_mean"] = float(np.mean(stats["tr_loss"]))
        return stats, misc

    def _save_model(self, suffix: str = "") -> str:
        """Write ``state_dict{suffix}.pth``: the model's and the
        optimizer's state dicts and the step; returns its path."""
        path = os.path.join(self.save_path, f"state_dict{suffix}.pth")
        torch.save({
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "info": {"step": self.step, "epoch": self.epoch,
                     "model_class": self.model.__class__.__name__},
        }, path)
        logger.debug(f"Saved state_dict as {path}")
        return path

    def load_state(self, path: str) -> None:
        """Resume the model, the optimizer and the step from a
        ``state_dict*.pth`` written by :meth:`_save_model`."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model_state_dict"])
        self.optimizer.load_state_dict(blob["optimizer_state_dict"])
        info = blob["info"]
        self.step = info["step"]
        self.epoch = info["epoch"]
        logger.info(f"Resumed training state from {path} (step {self.step}).")
