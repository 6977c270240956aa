"""Model zoo of the port. Ported so far: the U-Net (inference forward)."""

from elektronn3_tpu_torch.models.convert import state_dict_from_flax
from elektronn3_tpu_torch.models.unet import UNet

__all__ = ["UNet", "state_dict_from_flax"]
