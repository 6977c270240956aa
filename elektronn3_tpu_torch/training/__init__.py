"""Training of the port: the train step, the Trainer loop and its
Noise2Void, triplet and gradient-accumulation forms, its metrics,
schedulers, optimizers and handlers (the JAX package's
``elektronn3_tpu.training`` names). The GNN trainers are the modules
``trainer_gnn``, ``trainer_gnn_batch`` and ``trainer_gnn_minibatch``,
each with its own ``GNNTrainer``, as in JAX."""

from elektronn3_tpu_torch.training.trainer import (
    Backup, NaNException, Trainer, default_optimizer, load_model,
    save_model, train_step)
from elektronn3_tpu_torch.training._trainer_multi import TrainerMulti
from elektronn3_tpu_torch.training.noise2void import Noise2VoidTrainer
from elektronn3_tpu_torch.training.triplettrainer import TripletTrainer
from elektronn3_tpu_torch.training.optim import SWA, Padam, bn_update
from elektronn3_tpu_torch.training.recalibration import recalibrate_bn
from elektronn3_tpu_torch.training import metrics
from elektronn3_tpu_torch.training import schedulers
from elektronn3_tpu_torch.training.schedulers import (
    ConstantLR, CosineAnnealingLR, CyclicLR, ExponentialLR, LRScheduler,
    ReduceLROnPlateau, SGDR, StepLR)

__all__ = ["Backup", "ConstantLR", "CosineAnnealingLR", "CyclicLR",
           "ExponentialLR", "LRScheduler", "NaNException",
           "Noise2VoidTrainer", "Padam", "ReduceLROnPlateau", "SGDR", "SWA",
           "StepLR", "Trainer", "TrainerMulti", "TripletTrainer",
           "bn_update", "default_optimizer", "load_model", "metrics",
           "recalibrate_bn", "save_model", "schedulers", "train_step"]
