"""Model inspection utilities: parameter count, the first conv, swapping
its input channels, a per-layer summary and the receptive field.

Counterpart of the JAX package's ``models/model_utils.py`` (reference
elektronn3/models/_model_utils.py:16-238), on an ``nn.Module`` and its
``named_parameters``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


def num_params(model: nn.Module) -> int:
    """Total number of trainable parameters (reference
    _model_utils.py:113-116; JAX counts its 'params' collection, which
    holds the same tensors)."""
    return sum(p.numel() for p in model.parameters())


def find_first(model: nn.Module, cond: Callable[[str, torch.Tensor], bool]
               ) -> Optional[str]:
    """The name of the first parameter satisfying ``cond(name, tensor)``
    in the order JAX's ``find_first`` walks its params tree: the keys
    sorted at each level (reference _model_utils.py:76-94). For the
    model zoo, whose module names are flax's, this is JAX's leaf."""
    for name, p in sorted(model.named_parameters(),
                          key=lambda kv: kv[0].split(".")):
        if cond(name, p):
            return name
    return None


def find_first_conv(model: nn.Module) -> Optional[str]:
    """Name of the first conv weight (a weight of 3 or more axes) in
    :func:`find_first`'s order (reference _model_utils.py:85-94)."""
    return find_first(model, lambda name, p: name.endswith("weight")
                      and p.dim() >= 3)


def change_conv1_input_channels(model: nn.Module, old_in_channels: int,
                                new_in_channels: int) -> nn.Module:
    """Give :func:`find_first_conv`'s conv ``new_in_channels`` inputs,
    each the mean of its ``old_in_channels`` kernels (common pretrained-
    weight surgery; reference _model_utils.py:96-111), and set the
    model's ``in_channels``. In place; returns the model."""
    if hasattr(model, "in_channels"):
        model.in_channels = new_in_channels
    name = find_first_conv(model)
    if name is None:
        return model
    mod_name, leaf = name.rsplit(".", 1)
    mod = model.get_submodule(mod_name)
    w = getattr(mod, leaf)
    # The input axis: 1 in a conv's (O, I, *k), 0 in a transposed conv's.
    axis = 0 if "Transpose" in type(mod).__name__ else 1
    if w.shape[axis] == old_in_channels:
        with torch.no_grad():
            new = w.mean(axis, keepdim=True).repeat_interleave(
                new_in_channels, axis)
        setattr(mod, leaf, nn.Parameter(new))
    return model


def model_summary(model: nn.Module, input_shape: Sequence[int],
                  train: bool = False, depth: int = 2,
                  device=None) -> str:
    """Per-module summary (name, type, output shape, parameters) of one
    forward of zeros, torchsummary-style, down to ``depth`` levels of
    nesting (reference _model_utils.py:119-238)."""
    device = device or next(model.parameters()).device
    rows: List[tuple] = []
    hooks = []
    for name, mod in model.named_modules():
        if name.count(".") >= depth:
            continue

        def hook(m, args, out, name=name):
            shape = tuple(out.shape) if isinstance(out, torch.Tensor) \
                else type(out).__name__
            rows.append((name or "(model)", type(m).__name__, shape,
                         sum(p.numel() for p in m.parameters())))
        hooks.append(mod.register_forward_hook(hook))
    was_training = model.training
    model.train(train)
    try:
        with torch.no_grad():
            model(torch.zeros(tuple(input_shape), device=device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    lines = [f"{'module':40s} {'type':24s} {'output':28s} params"]
    lines += [f"{n:40s} {t:24s} {str(s):28s} {p}" for n, t, s, p in rows]
    lines.append(f"Total params: {num_params(model)}")
    return "\n".join(lines)


def visualize_receptive_field(model: nn.Module, input_shape: Sequence[int],
                              channel: int = 0) -> np.ndarray:
    """The effective receptive field: |d out[center] / d input| of the
    output voxel at the center, ``channel``, in eval mode, on a standard
    normal input from ``default_rng(0)`` (reference
    _model_utils.py:16-74; a random probe, since zeros and zero biases
    would stop every relu's gradient). Returns the spatial saliency."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=tuple(input_shape)), dtype=torch.float32, device=device)
    x.requires_grad_(True)
    was_training = model.training
    model.eval()
    try:
        with torch.enable_grad():
            out = model(x)
            idx = (0,) + tuple(s // 2 for s in out.shape[1:-1]) + (channel,)
            g, = torch.autograd.grad(out[idx], x)
    finally:
        model.train(was_training)
    return np.abs(g.detach().cpu().numpy())[0, ..., 0]
