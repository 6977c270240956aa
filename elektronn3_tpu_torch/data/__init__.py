"""Data pipeline: the JAX package's ``elektronn3_tpu.data`` names for
what is ported (reference elektronn3/data/__init__.py:1-3).

- ``sources``: ``ArrayDataSource``, ``HDF5DataSource``, ``slice_3d``
- ``coord_transforms``: random warp matrices and ``warp_slice`` on the
  host, in the C++ kernels of ``native`` (``native/warp_kernels.cpp``)
- ``transforms``: host-side ``t(inp, target)`` augmentations
- ``cnndata``: ``PatchCreator``, ``get_preview_batch`` and the 2D
  datasets ``SimpleNeuroData2d``, ``Segmentation2d``,
  ``Reconstruction2d`` and ``TripletData2d``
- ``pipeline``: ``DataLoader`` and ``prefetch_to_device``
- ``warp`` and ``device_pipeline``: ``DeviceWarpPatchLoader``, whose
  warp runs on the card
- ``knossos``: ``KnossosRawData`` and ``KnossosLabels`` (``knossos_utils``
  imported when one is made)
"""

from elektronn3_tpu_torch.data import transforms
from elektronn3_tpu_torch.data.cnndata import (
    PatchCreator,
    Reconstruction2d,
    Segmentation2d,
    SimpleNeuroData2d,
    TripletData2d,
    calculate_class_weights,
    get_preview_batch,
)
from elektronn3_tpu_torch.data.device_pipeline import DeviceWarpPatchLoader
from elektronn3_tpu_torch.data.knossos import KnossosLabels, KnossosRawData
from elektronn3_tpu_torch.data.pipeline import (
    DataLoader,
    default_collate,
    prefetch_to_device,
    to_channels_last,
)
from elektronn3_tpu_torch.data.sources import (
    ArrayDataSource,
    DataSource,
    HDF5DataSource,
    slice_3d,
)

__all__ = ["ArrayDataSource", "DataLoader", "DataSource",
           "DeviceWarpPatchLoader", "HDF5DataSource", "KnossosLabels",
           "KnossosRawData", "PatchCreator",
           "Reconstruction2d", "Segmentation2d", "SimpleNeuroData2d",
           "TripletData2d", "calculate_class_weights", "default_collate",
           "get_preview_batch", "prefetch_to_device", "slice_3d",
           "to_channels_last", "transforms"]
