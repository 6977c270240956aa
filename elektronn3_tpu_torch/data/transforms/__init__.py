"""Host-side transforms ``t(inp, target) -> (inp, target)``: the JAX
package's ``data/transforms`` names."""

from elektronn3_tpu_torch.data.transforms import random
from elektronn3_tpu_torch.data.transforms.transforms import (
    AdditiveGaussianNoise,
    AlbuSeg2d,
    Clahe2d,
    Compose,
    DistanceTransformTarget,
    DropIfTooMuchBG,
    ElasticTransform,
    Identity,
    Lambda,
    Normalize,
    RandomBlurring,
    RandomBrightnessContrast,
    RandomCrop,
    RandomFlip,
    RandomGammaCorrection,
    RandomGaussianBlur,
    RandomGrayAugment,
    RandomRotate2d,
    RandomSlicewiseTransform,
    RemapTargetIDs,
    SmoothOneHotTarget,
    SqueezeTarget,
    _DropSample,
)
