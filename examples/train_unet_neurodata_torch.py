#!/usr/bin/env python3
"""Canonical 3D U-Net training on neuro_data_cdhw, on the PyTorch/CUDA
port (elektronn3_tpu_torch).

The driver of ``train_unet_neurodata.py`` with the port's objects
(reference examples/train_unet_neurodata.py: model :96-106, data
:138-224, optim/SWA :257-262, CyclicLR :273-280, losses :294-296,
Trainer :299-324): PatchCreator with coordinate warping, anisotropic 3D
UNet, CE+Dice combined loss, CyclicLR, SWA at LR minima, preview
inference. Runs on the CUDA card.

    python examples/train_unet_neurodata_torch.py -d ~/neuro_data_cdhw --bf16

``benchmark/make_synthetic_neurodata.py -n 3`` writes a synthetic
stand-in with the same files and keys.
"""

import argparse
import os

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("-n", "--exp-name", default=None)
parser.add_argument("-m", "--max-steps", type=int, default=500_000)
parser.add_argument("-t", "--max-runtime", type=int, default=3600 * 24 * 4)
parser.add_argument("-s", "--seed", type=int, default=0)
parser.add_argument("-d", "--data-root", default="~/neuro_data_cdhw")
parser.add_argument("-r", "--resume", default=None,
                    help="state_dict*.pth to resume from")
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("-j", "--num-workers", type=int, default=4)
parser.add_argument("--pallas-flat", default="auto",
                    choices=["auto", "off"],
                    help="the hand-written kernels (auto) or the library "
                         "ops (off): an A/B knob for kernel validation")
parser.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision compute")
args = parser.parse_args()

import torch

from elektronn3_tpu_torch.data import (PatchCreator, get_preview_batch,
                                      transforms)
from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules.loss import (CombinedLoss,
                                               CrossEntropyLoss, DiceLoss)
from elektronn3_tpu_torch.training import CyclicLR, Trainer, metrics

data_root = os.path.expanduser(args.data_root)

# Data setup (reference train_unet_neurodata.py:138-224)
input_h5data = [(os.path.join(data_root, f"raw_{i}.h5"), "raw")
                for i in range(3)]
target_h5data = [(os.path.join(data_root, f"barrier_int16_{i}.h5"), "lab")
                 for i in range(3)]
valid_indices = [2]

patch_shape = (44, 88, 88)
common_transforms = [
    transforms.SqueezeTarget(dim=0),
    transforms.Normalize(mean=155.291411, std=41.812504),
]
train_transform = transforms.Compose(common_transforms + [
    transforms.RandomGrayAugment(channels=[0], prob=0.3),
    transforms.RandomGammaCorrection(gamma_std=0.25, channels=[0],
                                     prob=0.3),
    transforms.AdditiveGaussianNoise(sigma=0.1, channels=[0], prob=0.3),
])
valid_transform = transforms.Compose(common_transforms)

aniso_factor = 2
common_data_kwargs = dict(
    aniso_factor=aniso_factor,
    patch_shape=patch_shape,
)
train_dataset = PatchCreator(
    input_sources=[d for i, d in enumerate(input_h5data)
                   if i not in valid_indices],
    target_sources=[d for i, d in enumerate(target_h5data)
                    if i not in valid_indices],
    train=True,
    epoch_size=100,
    warp_prob=0.2,
    warp_kwargs=dict(sample_aniso=aniso_factor != 1,
                     perspective=True, warp_amount=1.0),
    transform=train_transform,
    **common_data_kwargs)
valid_dataset = PatchCreator(
    input_sources=[input_h5data[i] for i in valid_indices],
    target_sources=[target_h5data[i] for i in valid_indices],
    train=False,
    epoch_size=10,
    warp_prob=0,
    warp_kwargs=dict(sample_aniso=aniso_factor != 1, warp_amount=0),
    transform=valid_transform,
    **common_data_kwargs)

preview_batch = get_preview_batch(
    h5data=input_h5data[valid_indices[0]],
    preview_shape=(32, 96, 96),
    transform=transforms.Compose(common_transforms[1:]))

# Model (reference :96-106)
model = UNet(
    in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
    planar_blocks=(0,), activation="relu", normalization="batch",
    dim=3, dtype=torch.bfloat16 if args.bf16 else torch.float32,
    pallas_flat=(False if args.pallas_flat == "off" else "auto"))

# Loss (reference :294-296)
crit = CombinedLoss([CrossEntropyLoss(), DiceLoss(apply_softmax=True)],
                    weight=[0.5, 0.5])

trainer = Trainer(
    model=model,
    criterion=crit,
    lr=args.lr,
    schedulers={"lr": CyclicLR(
        args.lr * 1e-1, args.lr, step_size_up=2000, mode="exp_range",
        gamma=0.99994)},
    train_dataset=train_dataset,
    valid_dataset=valid_dataset,
    valid_metrics={
        "val_accuracy": metrics.Accuracy(),
        "val_DSC": metrics.DSC(),
        "val_IoU": metrics.IoU(),
    },
    preview_batch=preview_batch,
    preview_interval=5,
    inference_kwargs=dict(tile_shape=(32, 64, 64),
                          overlap_shape=(16, 32, 32)),
    batch_size=8,
    num_workers=args.num_workers,
    exp_name=args.exp_name,
    out_channels=2,
    mixed_precision=args.bf16,
    seed=args.seed,
)
if args.resume:
    trainer.load_state(os.path.expanduser(args.resume))

trainer.run(max_steps=args.max_steps, max_runtime=args.max_runtime)
