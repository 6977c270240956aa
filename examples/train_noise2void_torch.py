#!/usr/bin/env python3
"""Noise2Void self-supervised 3D denoising, on the PyTorch/CUDA port
(elektronn3_tpu_torch).

``train_noise2void.py`` with the port's objects (reference
examples/train_noise2void.py:94-315): raw-only ``PatchCreator`` patches
of (32, 64, 64), the 3D UNet (n_blocks=3, start_filts=32, planar L0,
batch norm, one channel in and out), ``Noise2VoidTrainer`` at batch 4
with ``n2v_ratio=0.002`` and ``StepLR``. Runs on the CUDA card.

    python examples/train_noise2void_torch.py -d ~/neuro_data_cdhw --bf16

It reads ``raw_{0,1,2}.h5`` (key ``raw``) from ``--data-root``; the
first two train, the third validates.
``benchmark/make_synthetic_neurodata.py`` writes a synthetic stand-in.
"""

import argparse
import os

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("-n", "--exp-name", default=None)
parser.add_argument("-m", "--max-steps", type=int, default=100_000)
parser.add_argument("-s", "--seed", type=int, default=0)
parser.add_argument("-d", "--data-root", default="~/neuro_data_cdhw")
parser.add_argument("--lr", type=float, default=4e-4)
parser.add_argument("-j", "--num-workers", type=int, default=2)
parser.add_argument("--bf16", action="store_true",
                    help="bf16 compute (the kernels' bf16 bodies)")
parser.add_argument("--device", default=None,
                    help="where the model runs (the CUDA card by default; "
                         "'cpu' to ask for the CPU)")
args = parser.parse_args()

import torch

from elektronn3_tpu_torch.data import PatchCreator, transforms
from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.training import StepLR
from elektronn3_tpu_torch.training.noise2void import Noise2VoidTrainer

data_root = os.path.expanduser(args.data_root)
input_h5data = [(os.path.join(data_root, f"raw_{i}.h5"), "raw")
                for i in range(3)]

norm = transforms.Normalize(mean=155.291411, std=41.812504)
common = dict(patch_shape=(32, 64, 64), aniso_factor=2, transform=norm)
train_dataset = PatchCreator(input_sources=input_h5data[:2], train=True,
                             epoch_size=100, **common)
valid_dataset = PatchCreator(input_sources=input_h5data[2:], train=False,
                             epoch_size=10, **common)

model = UNet(in_channels=1, out_channels=1, n_blocks=3, start_filts=32,
             planar_blocks=(0,), activation="relu", normalization="batch",
             dim=3, dtype=torch.bfloat16 if args.bf16 else torch.float32,
             device=args.device)

trainer = Noise2VoidTrainer(
    model=model,
    criterion=None,  # the masked MSE of each step
    lr=args.lr,
    schedulers={"lr": StepLR(args.lr, step_size=2000, gamma=0.99)},
    train_dataset=train_dataset,
    valid_dataset=valid_dataset,
    batch_size=4,
    num_workers=args.num_workers,
    exp_name=args.exp_name,
    n2v_ratio=0.002,
    seed=args.seed,
)
trainer.run(max_steps=args.max_steps)
