"""Legacy deployment path: InferenceModel.

Counterpart of the JAX package's ``models/base.py`` (reference
elektronn3/models/base.py:16-158): a thin wrapper that loads a saved
model and gives a batched ``predict_proba``, over the port's
:class:`~elektronn3_tpu_torch.inference.Predictor` (which the
reference's own docstring advises instead).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("elektronn3_tpu_torch")


class InferenceModel:
    """Inference wrapper around a trained model (reference
    base.py:16-60).

    Args:
        src: the path of a port model file (``save_model``'s
            ``model*.pt``), or a (model, state) tuple: an ``nn.Module``
            and weights for it (a port ``state_dict`` or a reference
            checkpoint, as the Predictor's ``state`` takes).
        disable_cuda: build a model file's model on the CPU.
        multi_gpu: kept for the reference's signature; sharded inference
            is the Predictor's ``mesh``.
        normalize_func: applied to each input before prediction.
    """

    def __init__(self, src, disable_cuda: bool = False,
                 multi_gpu: bool = True, normalize_func=None):
        from elektronn3_tpu_torch.inference import Predictor
        self.normalize_func = normalize_func
        device = "cpu" if disable_cuda else None
        if isinstance(src, tuple):
            model, state = src
            self.predictor = Predictor(model, state=state, device=device,
                                       apply_softmax=True)
        else:
            self.predictor = Predictor(src, device=device,
                                       apply_softmax=True)
        logger.info(f"Inference device: {self.predictor.device}")

    def predict_proba(self, inp: np.ndarray, bs: int = 10,
                      verbose: bool = False) -> np.ndarray:
        """Batched softmax prediction of a channels-first input
        (reference base.py:62-116)."""
        self.predictor.batch_size = bs
        self.predictor.verbose = verbose
        if self.normalize_func is not None:
            inp = self.normalize_func(inp)
        return self.predictor.predict(inp)


def load_model(src: str, disable_cuda: bool = False) -> InferenceModel:
    """Load a trained model for inference (reference base.py:118-158)."""
    return InferenceModel(src, disable_cuda=disable_cuda)
