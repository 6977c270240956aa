"""Training of the port: the train step, the Trainer loop, its metrics,
schedulers, optimizers and handlers (the JAX package's
``elektronn3_tpu.training`` names for what is ported)."""

from elektronn3_tpu_torch.training.trainer import (
    Backup, NaNException, Trainer, default_optimizer, load_model,
    save_model, train_step)
from elektronn3_tpu_torch.training.optim import SWA, Padam, bn_update
from elektronn3_tpu_torch.training.recalibration import recalibrate_bn
from elektronn3_tpu_torch.training import metrics
from elektronn3_tpu_torch.training import schedulers
from elektronn3_tpu_torch.training.schedulers import (
    ConstantLR, CosineAnnealingLR, CyclicLR, ExponentialLR, LRScheduler,
    ReduceLROnPlateau, SGDR, StepLR)

__all__ = ["Backup", "ConstantLR", "CosineAnnealingLR", "CyclicLR",
           "ExponentialLR", "LRScheduler", "NaNException", "Padam",
           "ReduceLROnPlateau", "SGDR", "SWA", "StepLR", "Trainer",
           "bn_update", "default_optimizer", "load_model", "metrics",
           "recalibrate_bn", "save_model", "schedulers", "train_step"]
