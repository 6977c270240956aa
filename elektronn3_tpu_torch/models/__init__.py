"""Model zoo of the port. Ported so far: the U-Net (training and
inference forward), the residual U-Net, the converters from and to the
JAX package's flax variables and the importer of reference (PyTorch)
checkpoints."""

from elektronn3_tpu_torch.models.convert import (
    flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.models.resunet import ResUNet
from elektronn3_tpu_torch.models.torch_import import load_torch_state_dict
from elektronn3_tpu_torch.models.unet import UNet

__all__ = ["ResUNet", "UNet", "flax_from_state_dict",
           "load_torch_state_dict", "state_dict_from_flax"]
