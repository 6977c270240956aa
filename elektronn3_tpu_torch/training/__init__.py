"""Training of the port: the train step and the Trainer loop."""

from elektronn3_tpu_torch.training.trainer import (
    NaNException, Trainer, default_optimizer, train_step)

__all__ = ["NaNException", "Trainer", "default_optimizer", "train_step"]
