"""Convert between the JAX package's flax variables and the port's
state_dict, in both directions.

``state_dict_from_flax`` is the inverse of
``elektronn3_tpu/models/torch_import.py``:

- conv kernels (kd, kh, kw, I, O) become torch weights (O, I, kd, kh, kw),
  and a 2D model's (kh, kw, I, O) become (O, I, kh, kw);
- transposed-conv kernels become (I, O, kd, kh, kw), or (I, O, kh, kw)
  in 2D, with their spatial taps flipped (flax's ConvTranspose
  correlates with the flipped kernel relative to torch's);
- per-parent flax ``BatchNorm_<n>`` slots (``PallasBatchNorm_<n>`` for
  ``normalization='batchp'``: every level of the XLA executor, the
  library levels of the fused one) map, in order of n, onto the port's
  ``norm{k}`` modules in order of k (``full_norm=False`` leaves gaps in
  k, as in the reference, and none in n; JAX's importer matches them by
  order too): ``scale``/``bias`` params become
  ``weight``/``bias``, ``batch_stats`` ``mean``/``var`` become
  ``running_mean``/``running_var``; a group or instance norm's
  ``GroupNorm_<n>`` slots (params only: no batch statistics) map the
  same way, in the order both JAX executors create them (the fused one's
  ``_stats_prologue`` names them as the XLA one's flax auto-names);
- the ResUNet's ConvBlock stacks: the port's ``convs.{j}`` is flax's
  ``conv_{j}`` (``down_{i}/conv_{j}/conv1``, its ``proj`` a plain conv),
  and an ``UpBlock``'s own norm (flax ``up_{i}/BatchNorm_0``, the
  port's ``up_convs.{i}.norm0``) is matched apart from its blocks' norms
  (each block is a parent of its own);
- a block's ``PReLU_0`` ``slope`` (one learned slope a block,
  ``activation='prelu'``) is the port's ``act.weight``; the resizeconv
  ``upconv/conv``, the attention gate's ``attention/{theta,phi,psi,
  out_proj}`` and the other convs are plain convs.

``flax_from_state_dict`` goes back: it fills the tree of given flax
variables from torch tensors, so the port's running statistics after a
training step can be held against JAX's ``batch_stats``. A gradient maps
like the parameter it belongs to (every map above is a transpose or a
flip), so the same function turns the port's parameter grads into the
flax grad tree.

The JAX fused executors create a 2D model's parameters in the XLA
path's 2D shapes (``_p2d``), so one tree serves both executors.
Inputs are numpy arrays (or anything ``np.asarray`` takes); nothing here
imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_NORM_RE = re.compile(
    r"^(?:Batch|Group|Layer|Instance|PallasBatch)Norm_(\d+)$")
_TORCH_NORM_RE = re.compile(r"^norm(\d+)$")
_PRELU = "PReLU_0"


def conv_weight_from_flax(kernel) -> np.ndarray:
    """flax conv kernel (*spatial, I, O) -> torch weight (O, I, *spatial)."""
    k = np.asarray(kernel)
    nd = k.ndim
    return np.ascontiguousarray(
        np.transpose(k, (nd - 1, nd - 2) + tuple(range(nd - 2))))


def convtranspose_weight_from_flax(kernel) -> np.ndarray:
    """flax ConvTranspose kernel (*spatial, I, O) -> torch
    ConvTranspose weight (I, O, *spatial), spatial taps flipped."""
    k = np.asarray(kernel)
    nd = k.ndim
    w = np.transpose(k, (nd - 2, nd - 1) + tuple(range(nd - 2)))
    return np.ascontiguousarray(np.flip(w, axis=tuple(range(2, nd))))


def conv_weight_to_flax(weight) -> np.ndarray:
    """torch conv weight (O, I, *spatial) -> flax kernel (*spatial, I, O)."""
    w = np.asarray(weight)
    nd = w.ndim
    return np.ascontiguousarray(np.transpose(w, tuple(range(2, nd)) + (1, 0)))


def convtranspose_weight_to_flax(weight) -> np.ndarray:
    """torch ConvTranspose weight (I, O, *spatial) -> flax kernel
    (*spatial, I, O), spatial taps flipped."""
    w = np.flip(np.asarray(weight), axis=tuple(range(2, np.ndim(weight))))
    nd = w.ndim
    return np.ascontiguousarray(np.transpose(w, tuple(range(2, nd)) + (0, 1)))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _flax_module_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """torch state_dict key -> (flax module path, leaf name)."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in ("down_convs", "up_convs"):
            out.append(("down_" if p == "down_convs" else "up_")
                       + parts[i + 1])
            i += 2
        elif p == "convs":
            out.append("conv_" + parts[i + 1])
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out), parts[-1]


def _norm_slots(params: Mapping) -> Dict[Tuple[str, ...], list]:
    """Per parent module path, its flax norm slot names in order of n."""
    slots: Dict[Tuple[str, ...], list] = {}
    for path in params:
        for d in range(len(path) - 1):
            m = _NORM_RE.match(path[d])
            if m and path[d] not in slots.setdefault(path[:d], []):
                slots[path[:d]].append(path[d])
    for lst in slots.values():
        lst.sort(key=lambda n: int(_NORM_RE.match(n).group(1)))
    return slots


def torch_norm_names(keys) -> Dict[Tuple[str, ...], list]:
    """Per parent module path (in flax names), the ``norm{k}`` module
    names among the torch state_dict ``keys``, in order of k."""
    names: Dict[Tuple[str, ...], list] = {}
    for key in keys:
        mod, _ = _flax_module_path(key)
        if mod and _TORCH_NORM_RE.match(mod[-1]) \
                and mod[-1] not in names.setdefault(mod[:-1], []):
            names[mod[:-1]].append(mod[-1])
    for lst in names.values():
        lst.sort(key=lambda n: int(n[len("norm"):]))
    return names


def _torch_key(path: Tuple[str, ...], slots, norms) -> str:
    """flax leaf path (without the collection) -> torch state_dict key;
    the parent's n-th norm slot is its n-th torch norm of ``norms``."""
    out = []
    for d, p in enumerate(path[:-1]):
        m = re.fullmatch(r"(down|up)_(\d+)", p)
        if m:
            out += [m.group(1) + "_convs", m.group(2)]
        elif re.fullmatch(r"conv_\d+", p):
            out += ["convs", p[len("conv_"):]]
        elif _NORM_RE.match(p):
            pos = slots[path[:d]].index(p)
            have = norms.get(path[:d], [])
            out.append(have[pos] if pos < len(have) else f"norm{pos}")
        elif p == _PRELU:
            out.append("act")
        else:
            out.append(p)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var",
            "slope": "weight"}[path[-1]]
    return ".".join(out + [leaf])


def flax_from_state_dict(tensors: Mapping[str, Any],
                         variables: Mapping[str, Any],
                         collections: Sequence[str] = ("params",
                                                       "batch_stats"),
                         ) -> Dict[str, Dict]:
    """The flax collections of ``variables`` (their tree, with numpy
    leaves) filled from ``tensors``, a mapping of the port's state_dict
    keys to tensors: the parameters and running statistics of
    ``model.state_dict()``, or ``{name: p.grad for name, p in
    model.named_parameters()}`` with ``collections=("params",)`` for the
    flax grad tree. Raises on a missing key or a shape mismatch."""
    params = _flatten(variables["params"])
    slots = _norm_slots(params)
    norms = torch_norm_names(tensors)
    out: Dict[str, Dict] = {}
    for coll in collections:
        tree: Dict = {}
        for path, ref in _flatten(variables.get(coll, {})).items():
            key = _torch_key(path, slots, norms)
            if key not in tensors:
                raise KeyError(f"{'/'.join((coll,) + path)}: no tensor "
                               f"{key!r}")
            t = tensors[key]
            v = np.asarray(t.detach().float().cpu() if
                           isinstance(t, torch.Tensor) else t, np.float32)
            if path[-1] == "kernel":
                v = (convtranspose_weight_to_flax(v) if path[-2] == "upconv"
                     else conv_weight_to_flax(v))
            if path[-1] == "slope":
                v = v.reshape(np.shape(ref))
            if v.shape != np.shape(ref):
                raise ValueError(f"{key}: shape {v.shape} != flax "
                                 f"{np.shape(ref)}")
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        out[coll] = tree
    return out


def state_dict_from_flax(variables: Mapping[str, Any],
                         model: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` (the port's UNet) holding the
    parameters and batch statistics of flax ``variables`` (a dict with
    'params' and 'batch_stats' of numpy-convertible arrays) of the
    equivalent JAX model. ``num_batches_tracked`` keeps the model's
    value. Raises on a missing entry or a shape mismatch."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    slots = _norm_slots(params)
    target = model.state_dict()
    norms = torch_norm_names(target)

    out = {}
    for key, ref in target.items():
        mod, leaf = _flax_module_path(key)
        if leaf == "num_batches_tracked":
            out[key] = ref.clone()
            continue
        if mod and mod[-1] == "act":
            val = np.asarray(params[mod[:-1] + (_PRELU, "slope")])
        elif mod and _TORCH_NORM_RE.match(mod[-1]):
            parent = mod[:-1]
            k = norms[parent].index(mod[-1])
            if k >= len(slots.get(parent, [])):
                raise KeyError(f"{key}: no flax norm slot {k} under "
                               f"{'/'.join(parent)}")
            base = parent + (slots[parent][k],)
            src = {"weight": (params, "scale"), "bias": (params, "bias"),
                   "running_mean": (stats, "mean"),
                   "running_var": (stats, "var")}[leaf]
            val = np.asarray(src[0][base + (src[1],)])
        elif leaf == "weight":
            kernel = params[mod + ("kernel",)]
            val = (convtranspose_weight_from_flax(kernel)
                   if mod[-1] == "upconv" else conv_weight_from_flax(kernel))
        else:
            val = np.asarray(params[mod + (leaf,)])
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {tuple(val.shape)} != "
                             f"{tuple(ref.shape)}")
        out[key] = torch.as_tensor(np.array(val, dtype=np.float32),
                                   dtype=ref.dtype)
    return out
