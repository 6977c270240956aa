#!/usr/bin/env python3
"""2D U-Net training on neuro_data 2D slices, on the PyTorch/CUDA port
(elektronn3_tpu_torch).

The driver of ``train_simple2d.py`` with the port's objects (reference
examples/train_simple2d.py:72-156): SimpleNeuroData2d, the 2D UNet,
Normalize/RandomCrop/RandomFlip/noise, cross entropy, StepLR and the
validation metrics. Runs on the CUDA card.

    python examples/train_simple2d_torch.py -d ~/neuro_data_cdhw --bf16

It reads ``raw_0.h5`` (key ``raw``) and ``barrier_int16_0.h5`` (key
``lab``) from ``--data-root``; ``benchmark/make_synthetic_neurodata.py``
writes a synthetic stand-in with the same files and keys.
"""

import argparse
import os

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("-n", "--exp-name", default=None)
parser.add_argument("-m", "--max-steps", type=int, default=500_000)
parser.add_argument("-s", "--seed", type=int, default=0)
parser.add_argument("-d", "--data-root", default="~/neuro_data_cdhw")
parser.add_argument("--lr", type=float, default=5e-4)
parser.add_argument("-j", "--num-workers", type=int, default=2)
parser.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision compute")
parser.add_argument("--device", default=None,
                    help="where the model runs (the CUDA card by default; "
                         "'cpu' to ask for the CPU)")
args = parser.parse_args()

import torch

from elektronn3_tpu_torch.data import SimpleNeuroData2d, transforms
from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules.loss import CrossEntropyLoss
from elektronn3_tpu_torch.training import StepLR, Trainer, metrics

data_root = os.path.expanduser(args.data_root)
inp_path = os.path.join(data_root, "raw_0.h5")
target_path = os.path.join(data_root, "barrier_int16_0.h5")

common_transforms = [
    transforms.Normalize(mean=155.291411, std=41.812504),
]
train_transform = transforms.Compose(common_transforms + [
    transforms.RandomCrop((128, 128)),
    transforms.RandomFlip(ndim_spatial=2),
    transforms.AdditiveGaussianNoise(sigma=0.1, prob=0.3),
])
valid_transform = transforms.Compose(common_transforms + [
    transforms.RandomCrop((144, 144)),
])

train_dataset = SimpleNeuroData2d(
    inp_path, target_path, inp_key="raw", target_key="lab",
    train=True, transform=train_transform)
valid_dataset = SimpleNeuroData2d(
    inp_path, target_path, inp_key="raw", target_key="lab",
    train=False, transform=valid_transform)

model = UNet(
    in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
    activation="relu", normalization="batch", dim=2,
    dtype=torch.bfloat16 if args.bf16 else torch.float32,
    device=args.device)

trainer = Trainer(
    model=model,
    criterion=CrossEntropyLoss(),
    lr=args.lr,
    schedulers={"lr": StepLR(args.lr, step_size=1000, gamma=0.99)},
    train_dataset=train_dataset,
    valid_dataset=valid_dataset,
    valid_metrics={
        "val_accuracy": metrics.Accuracy(),
        "val_precision": metrics.Precision(),
        "val_recall": metrics.Recall(),
        "val_DSC": metrics.DSC(),
        "val_IoU": metrics.IoU(),
    },
    batch_size=8,
    num_workers=args.num_workers,
    exp_name=args.exp_name,
    out_channels=2,
    mixed_precision=args.bf16,
    seed=args.seed,
)
trainer.run(max_steps=args.max_steps)
