"""Inference engine of the port: tiled prediction."""

from elektronn3_tpu_torch.inference.inference import (
    DEFAULT_AUGMENTATIONS_2D, DEFAULT_AUGMENTATIONS_3D, Predictor, tiled_apply)

__all__ = ["DEFAULT_AUGMENTATIONS_2D", "DEFAULT_AUGMENTATIONS_3D", "Predictor",
           "tiled_apply"]
