#!/usr/bin/env python3
"""Offline validation of a trained model over a PatchCreator dataset,
on the PyTorch/CUDA port (elektronn3_tpu_torch).

The counterpart of ``validate.py`` with the port's objects (reference
examples/validate.py:27-117): the neurodata validation cube(s)
raw_{i}.h5 / barrier_int16_{i}.h5 as (44, 88, 88) patches, the model a
port ``model*.pt`` (the ``Trainer``'s, or ``save_model``'s; the JAX
package's ``.e3tpu`` files are flax pickles, which load only with JAX),
and five metrics from confusion counts summed on the device: no batch's
logits leave it. The loader is seeded, so two runs print the same
numbers. Runs on the CUDA card unless ``--device cpu``.

    python examples/validate_torch.py model_best.pt -d ~/neuro_data_cdhw
"""

import argparse
import os
from typing import Dict

import torch

from elektronn3_tpu_torch.training import metrics

VALID_METRICS = {
    "val_accuracy": metrics.Accuracy,
    "val_precision": metrics.Precision,
    "val_recall": metrics.Recall,
    "val_DSC": metrics.DSC,
    "val_IoU": metrics.IoU,
}


def validate(model: torch.nn.Module, loader,
             device) -> Dict[str, float]:
    """The five metrics of ``model``'s eval forward over ``loader``'s
    batches (channels-last 'inp', dense 'target'), unrounded. Each
    batch's prediction is counted against its target on ``device`` (the
    Trainer's streaming validation); the (C, 4) counts are fetched once,
    at the end."""
    model.eval()
    counts = None
    with torch.inference_mode():
        for batch in loader:
            inp = torch.as_tensor(batch["inp"]).to(device)
            target = torch.as_tensor(batch["target"]).to(device)
            out = model(inp)
            cm = metrics.confusion_matrix(
                target, torch.argmax(out, -1), out.shape[-1],
                nan_when_empty=False)
            counts = cm if counts is None else counts + cm
    counts = counts.cpu()
    return {name: float(ev().from_cm(counts))
            for name, ev in VALID_METRICS.items()}


def valid_dataset(data_root: str, valid_indices, epoch_size: int):
    """The validation patches of raw_{i}.h5 ('raw') and
    barrier_int16_{i}.h5 ('lab') under ``data_root``, normalized as in
    training."""
    from elektronn3_tpu_torch.data import PatchCreator, transforms

    data_root = os.path.expanduser(data_root)
    return PatchCreator(
        input_sources=[(os.path.join(data_root, f"raw_{i}.h5"), "raw")
                       for i in valid_indices],
        target_sources=[(os.path.join(data_root, f"barrier_int16_{i}.h5"),
                         "lab") for i in valid_indices],
        patch_shape=(44, 88, 88),
        aniso_factor=2,
        train=False,
        epoch_size=epoch_size,
        transform=transforms.Compose([
            transforms.SqueezeTarget(dim=0),
            transforms.Normalize(mean=155.291411, std=41.812504),
        ]),
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_path", help=(
        "the port's model*.pt file (the JAX package's .e3tpu files are "
        "flax pickles, which load only with JAX)"))
    parser.add_argument("-d", "--data-root", default="~/neuro_data_cdhw")
    parser.add_argument("-i", "--valid-indices", type=int, nargs="+",
                        default=[2])
    parser.add_argument("-n", "--num-batches", type=int, default=10)
    parser.add_argument("-b", "--batch-size", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="where to run (default: the CUDA card)")
    args = parser.parse_args()

    from elektronn3_tpu_torch.data import DataLoader
    from elektronn3_tpu_torch.training import load_model

    dataset = valid_dataset(args.data_root, args.valid_indices,
                            args.num_batches * args.batch_size)
    model, _ = load_model(os.path.expanduser(args.model_path),
                          device=args.device)
    loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=2,
                        shuffle=False, seed=0)
    device = next(model.parameters()).device
    vals = validate(model, loader, device)
    print(f"Validated on {len(loader) * args.batch_size} patches:")
    for name, v in vals.items():
        print(f"  {name}: {v:.2f}")


if __name__ == "__main__":
    main()
