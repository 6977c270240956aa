"""Load a reference (PyTorch elektronn3) checkpoint into the port's
models.

Counterpart of the JAX package's ``models/torch_import.py``
(``load_torch_state_dict``), which turns the same checkpoints into flax
variables. The port's models already carry the reference's module names
(``down_convs.{i}.conv1``, ``up_convs.{i}.upconv``, ``norm{k}``,
``conv_final``) and its tensor layouts (conv weights (O, I, *s),
transposed-conv weights (I, O, *s), taps unflipped), so here a
checkpoint is unwrapped and checked, and no tensor is transformed:

- a ``state_dict*.pth`` bundle (a dict with ``model_state_dict``, as the
  reference's and the port's ``Trainer`` write it), a bare state dict,
  a pickled module (``model*.pt``) or a TorchScript archive
  (``model*.pts``); or any of these already loaded;
- ``module.`` prefixes (DataParallel) are stripped and
  ``num_batches_tracked`` is dropped (the model keeps its own);
- a ResUNet checkpoint nests each level's ConvBlocks as ``convs.{j}``
  (``down_convs.{i}.convs.{j}.conv1``, a ``proj`` where the channels
  change), which the port's ResUNet with residual blocks keeps; a model
  without ``convs.{j}`` modules (the UNet, or a ResUNet without residual
  blocks) takes a checkpoint of one plain ConvBlock a level with its
  ``convs.0`` collapsed into the level (JAX's importer,
  ``elektronn3_tpu/models/torch_import.py:167-181``), the block's norms
  counted after the level's own (an ``UpBlock``'s ``norm0``);
- the ``norm{k}`` modules of each parent are matched to the model's in
  order of k, as JAX's importer matches them to its flax slots: a
  ``full_norm=False`` model leaves gaps in k;
- with ``strict`` a tensor the model does not have, one of another
  shape, or a tensor of the model missing from the checkpoint raises
  ``ValueError``; else each is logged and the model's own value kept.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import torch
from torch import nn

from elektronn3_tpu_torch.models.convert import (
    _TORCH_NORM_RE, _flax_module_path, torch_norm_names)

logger = logging.getLogger("elektronn3_tpu_torch")


def read_state_dict(src: Any) -> Dict[str, torch.Tensor]:
    """The flat {name: tensor} state dict of a checkpoint (a path, a
    module, a bundle or a state dict), ``module.`` stripped and
    ``num_batches_tracked`` dropped. A path is unpickled: a trusted
    file."""
    obj = src
    if isinstance(src, str):
        if src.endswith(".pts"):
            obj = torch.jit.load(src, map_location="cpu")
        else:
            try:
                obj = torch.load(src, map_location="cpu", weights_only=False)
            except RuntimeError:
                # A TorchScript archive saved under another name.
                obj = torch.jit.load(src, map_location="cpu")
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.rsplit(".", 1)[-1] == "num_batches_tracked":
            continue
        out[k] = v
    return out


def _collapse_single_blocks(sd: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """``sd`` with each ``{parent}.convs.0.`` collapsed into
    ``{parent}.``: a block's ``norm{k}`` becomes the parent's
    ``norm{k + n}``, n one more than the parent's own highest norm index
    (0 without one), so that its norms keep their order after the
    parent's own."""
    own: Dict[str, int] = {}
    for key in sd:
        parts = key.split(".")
        if len(parts) >= 3 and _TORCH_NORM_RE.match(parts[-2]) \
                and "convs" not in parts:
            parent = ".".join(parts[:-2])
            own[parent] = max(own.get(parent, -1), int(parts[-2][4:]))
    out = {}
    for key, val in sd.items():
        if ".convs.0." not in key:
            out[key] = val
            continue
        parent, rest = key.split(".convs.0.", 1)
        first, _, leaf = rest.partition(".")
        if _TORCH_NORM_RE.match(first) and leaf and "." not in leaf:
            rest = f"norm{int(first[4:]) + own.get(parent, -1) + 1}.{leaf}"
        out[f"{parent}.{rest}"] = val
    return out


def load_torch_state_dict(src: Any, model: nn.Module,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """A complete ``state_dict`` for ``model`` from the checkpoint
    ``src`` (see the module docstring), each tensor in the dtype of the
    model's; pass it to ``model.load_state_dict``."""
    sd = read_state_dict(src)
    target = model.state_dict()
    if not any(".convs." in k for k in target):
        sd = _collapse_single_blocks(sd)
    src_norms = torch_norm_names(sd)
    tgt_norms = torch_norm_names(target)
    out = {k: v.clone() for k, v in target.items()}
    seen = set()
    problems = []
    for key, val in sd.items():
        mod, _ = _flax_module_path(key)
        dest = key
        if mod and _TORCH_NORM_RE.match(mod[-1]):
            pos = src_norms[mod[:-1]].index(mod[-1])
            have = tgt_norms.get(mod[:-1], [])
            if pos >= len(have):
                problems.append(f"no norm slot for {key}")
                continue
            parts = key.split(".")
            dest = ".".join(parts[:-2] + [have[pos], parts[-1]])
        if dest not in target:
            problems.append(f"{key} -> {dest} not in the model")
            continue
        val = torch.as_tensor(val)
        if tuple(val.shape) != tuple(target[dest].shape):
            problems.append(f"{key}: shape {tuple(val.shape)} != the "
                            f"model's {dest} {tuple(target[dest].shape)}")
            continue
        out[dest] = val.detach().to("cpu", target[dest].dtype).clone()
        seen.add(dest)
    missing = [k for k in target if k not in seen
               and k.rsplit(".", 1)[-1] != "num_batches_tracked"]
    problems += [f"{k} missing from the checkpoint" for k in missing]
    if problems:
        msg = "torch checkpoint import issues:\n  " + "\n  ".join(problems)
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return out
