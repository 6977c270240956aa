#!/usr/bin/env python3
"""Tiled inference on an HDF5 volume with a trained model, on the
PyTorch/CUDA port (elektronn3_tpu_torch).

The counterpart of ``inference_h5.py`` with the port's objects (reference
examples/inference_h5.py:55-133): the model a port ``model*.pt`` (the
``Trainer``'s, or ``save_model``'s), the neurodata normalization, tile
(64,128,128) / overlap (32,64,64), the foreground probability exported
as uint8. Runs on the CUDA card unless ``--device cpu``.

    python examples/inference_h5_torch.py model_final.pt raw.h5 --bf16
"""

import argparse
import os

import numpy as np

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("model_path", help="the port's model*.pt file")
parser.add_argument("input_path", help="input HDF5 file")
parser.add_argument("-k", "--key", default="raw")
parser.add_argument("-o", "--output", default=None)
parser.add_argument("--tile", type=int, nargs=3, default=(64, 128, 128))
parser.add_argument("--overlap", type=int, nargs=3, default=(32, 64, 64))
parser.add_argument("--batch-size", type=int, default=None,
                    help="tiles per model call")
parser.add_argument("--augmentations", type=int, default=0,
                    help="flip test-time augmentation: the first N of "
                         "the 8 default 3D flips (0: none)")
parser.add_argument("--bf16", action="store_true",
                    help="ship the input as bfloat16")
parser.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
args = parser.parse_args()

import h5py

from elektronn3_tpu_torch.data.transforms import Normalize
from elektronn3_tpu_torch.data.utils import save_to_h5
from elektronn3_tpu_torch.inference import Predictor

with h5py.File(os.path.expanduser(args.input_path), "r") as f:
    inp = f[args.key][()].astype(np.float32)
if inp.ndim == 3:
    inp = inp[None]  # (C, D, H, W)
inp = inp[None]  # (N, C, D, H, W)

predictor = Predictor(
    model=os.path.expanduser(args.model_path),
    device=args.device,
    batch_size=args.batch_size,
    tile_shape=tuple(args.tile),
    overlap_shape=tuple(args.overlap),
    transform=Normalize(mean=155.291411, std=41.812504),
    augmentations=args.augmentations or None,
    float16=args.bf16,
    out_dtype=np.float32,
    apply_softmax=True,
    verbose=True,
)
out = predictor.predict(inp)

# uint8 export of the foreground probability map (reference :124-133)
probmap = (out[0, 1] * 255).astype(np.uint8)
out_path = args.output or (
    os.path.splitext(os.path.expanduser(args.input_path))[0] + "_pred.h5")
save_to_h5(probmap, out_path, hdf5_names=["pred"], overwrite=True)
print(f"Saved prediction to {out_path}")
