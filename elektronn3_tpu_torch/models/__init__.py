"""Model zoo of the port: the U-Net (training and inference forward),
the residual U-Net, VNet, the 3D and 2D FCNs, MSDNet, FC-DenseNet,
UNet3dLite and the simple nets, the converters from and to the JAX
package's flax variables and the importer of reference (PyTorch)
checkpoints. Exports the JAX package's ``models`` names (but
``init_unet``: a port model holds its weights from construction)."""

from elektronn3_tpu_torch.models.convert import (
    flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.models.resunet import ResUNet
from elektronn3_tpu_torch.models.torch_import import load_torch_state_dict
from elektronn3_tpu_torch.models.unet import UNet
from elektronn3_tpu_torch.models.vnet import VNet
from elektronn3_tpu_torch.models.fcn import fcn8s, fcn16s, fcn32s
from elektronn3_tpu_torch.models.fcn_2d import (
    FCN8s, FCN16s, FCN32s, FCNs, VGGNet)
from elektronn3_tpu_torch.models.msdnet import MSDNet
from elektronn3_tpu_torch.models.tiramisu import (
    FCDenseNet,
    FCDenseNet57,
    FCDenseNet67,
    FCDenseNet103,
)
from elektronn3_tpu_torch.models.unet3d_lite import UNet3dLite
from elektronn3_tpu_torch.models.simple import (
    Extended3DNet,
    N3DNet,
    Simple3DNet,
    StackedConv2Scalar,
    StackedConv2ScalarWithLatentAdd,
)
from elektronn3_tpu_torch.models import model_utils

__all__ = ["Extended3DNet", "FCDenseNet", "FCDenseNet57", "FCDenseNet67",
           "FCDenseNet103", "FCN8s", "FCN16s", "FCN32s", "FCNs", "MSDNet",
           "N3DNet", "ResUNet", "Simple3DNet", "StackedConv2Scalar",
           "StackedConv2ScalarWithLatentAdd", "UNet", "UNet3dLite", "VGGNet",
           "VNet", "fcn8s", "fcn16s", "fcn32s", "flax_from_state_dict",
           "load_torch_state_dict", "model_utils", "state_dict_from_flax"]
