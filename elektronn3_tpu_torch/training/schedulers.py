"""Learning-rate schedulers with a torch-like ``step()``.

Counterpart of the JAX package's ``training/schedulers.py`` (reference
trainer.py:585,629-640, SGDR and CyclicLR): small host-side state
machines, bound to no optimizer. ``step()`` advances one training step
and returns the new rate; the :class:`~elektronn3_tpu_torch.training.
Trainer` reads ``get_lr()`` before each step and writes it into its
optimizer's ``param_groups``.
"""

from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.last_step = -1
        self._lr = base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.last_step += 1
        self._lr = self._compute_lr()
        return self._lr

    def get_lr(self) -> float:
        return self._lr

    def _compute_lr(self) -> float:  # pragma: no cover
        raise NotImplementedError

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)


class ConstantLR(LRScheduler):
    def _compute_lr(self):
        return self.base_lr


class StepLR(LRScheduler):
    """Multiply the rate by ``gamma`` every ``step_size`` steps (torch
    StepLR)."""

    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * self.gamma ** (self.last_step // self.step_size)


class ExponentialLR(LRScheduler):
    def __init__(self, base_lr: float, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * self.gamma ** self.last_step


class CosineAnnealingLR(LRScheduler):
    """Periodic like torch CosineAnnealingLR: past ``t_max`` the rate
    rises back toward ``base_lr`` (period 2 * ``t_max``)."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def _compute_lr(self):
        cos = math.cos(math.pi * self.last_step / self.t_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class CyclicLR(LRScheduler):
    """Triangular, triangular2 or exp-range cyclic rate (torch CyclicLR),
    as the reference's benchmark workload uses it
    (train_unet_neurodata.py:273-280)."""

    def __init__(self, base_lr: float, max_lr: float,
                 step_size_up: int = 2000,
                 step_size_down: Optional[int] = None,
                 mode: str = "triangular", gamma: float = 1.0,
                 cyclic_momentum: bool = False):
        super().__init__(base_lr)
        self.max_lr = max_lr
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.gamma = gamma

    def _compute_lr(self):
        cycle_len = self.step_size_up + self.step_size_down
        pos = self.last_step % cycle_len
        if pos < self.step_size_up:
            x = pos / self.step_size_up
        else:
            x = 1 - (pos - self.step_size_up) / self.step_size_down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** (self.last_step // cycle_len))
        elif self.mode == "exp_range":
            amp = amp * (self.gamma ** self.last_step)
        return self.base_lr + amp * x


class ReduceLROnPlateau(LRScheduler):
    """Multiply the rate by ``factor`` when the monitored metric stops
    improving.

    The Trainer gives it the training loss of every step as a device
    tensor, read here as a Python float: the one scheduler that costs a
    host sync each step (every other one ignores the loss)."""

    def __init__(self, base_lr: float, factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 mode: str = "min", threshold: float = 1e-4):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0
        self._cur = base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.last_step += 1
        if metric is not None:
            metric = float(metric)
            improved = (metric < self.best - self.threshold
                        if self.mode == "min"
                        else metric > self.best + self.threshold)
            if improved:
                self.best = metric
                self.num_bad = 0
            else:
                self.num_bad += 1
                if self.num_bad > self.patience:
                    self._cur = max(self._cur * self.factor, self.min_lr)
                    self.num_bad = 0
        self._lr = self._cur
        return self._lr

    def _compute_lr(self):
        return self._cur


class SGDR(CosineAnnealingLR):
    """Cosine annealing with warm restarts (arXiv:1608.03983)."""

    def __init__(self, base_lr: float, t_0: int, t_mult: int = 1,
                 eta_min: float = 0.0):
        super().__init__(base_lr, t_0, eta_min)
        self.t_0 = t_0
        self.t_mult = t_mult

    def _compute_lr(self):
        t = self.last_step
        t_i = self.t_0
        while t >= t_i:
            t -= t_i
            t_i *= self.t_mult
        cos = math.cos(math.pi * t / t_i)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2
