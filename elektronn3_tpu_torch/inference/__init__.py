"""Inference engine of the port: tiled prediction."""

from elektronn3_tpu_torch.inference.inference import Predictor, tiled_apply

__all__ = ["Predictor", "tiled_apply"]
