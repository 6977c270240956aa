"""NN building blocks (activations, normalization, batch-norm
prologues, the zoo's conv, norm and attention modules, losses) for the
port's models. Exports the JAX package's ``modules`` names."""

from elektronn3_tpu_torch.modules.loss import (
    CEDiceLoss,
    ACLoss,
    CombinedLoss,
    CrossEntropyLoss,
    DiceLoss,
    FixMatchSegLoss,
    FocalLoss,
    GAPTripletMarginLoss,
    LovaszLoss,
    MaskedMSELoss,
    MixedCombinedLoss,
    NorpfDiceLoss,
    SoftmaxBCELoss,
    DistanceWeightedMSELoss,
    cross_entropy,
    dice_loss,
    focal_loss,
)
from elektronn3_tpu_torch.modules import layers
from elektronn3_tpu_torch.modules import lovasz
from elektronn3_tpu_torch.modules.layers import (
    GatherExcite,
    GridAttention,
    PReLU,
    RReLU,
    get_activation,
    get_normalization,
)
from elektronn3_tpu_torch.modules.wsconv import WSConv, WSConvTranspose
from elektronn3_tpu_torch.modules.evonorm import EvoNorm
from elektronn3_tpu_torch.modules.l1batchnorm import L1BatchNorm, L1GroupNorm
from elektronn3_tpu_torch.modules.axial_attention import (
    AxialAttention,
    AxialImageTransformer,
    AxialPositionalEmbedding,
    ReversibleSequence,
    SelfAttention,
)
