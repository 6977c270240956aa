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

The model zoo and its modules (every model but the UNet and the
ResUNet: VNet, UNet3dLite, the FCNs, MSDNet, FC-DenseNet, the simple
nets, and WSConv, EvoNorm, the L1 norms, GatherExcite, the axial
attention modules on their own) take another rule: their torch modules
carry flax's module names (``DownTransition_1.LUConv_0.Conv_0``,
``dense_down_2.DenseLayer_3.BatchNorm_0``,
``ReversibleSequence_0.f_layers_0.mod.axial_1.to_q``), so a state_dict
key's module path, its dots read as flax's slashes, is the flax path,
and the leaf follows from the module's type (:func:`_zoo_rule`):

- ``Conv`` (and ``WSConv``): ``weight`` is ``kernel`` (*k, I / groups, O)
  -> (O, I / groups, *k); ``ConvTranspose`` (and ``WSConvTranspose``):
  ``kernel`` (*k, I, O) -> (I, O, *k), taps flipped; ``bias`` is
  ``bias``;
- ``nn.Linear`` (``Dense``): ``kernel`` (I, O) -> ``weight`` (O, I);
- WS ``gain``: flax's (1, ..., O) reshaped to (O, 1, ...) (``WSConv``)
  or (1, O, 1, ...) (``WSConvTranspose``);
- ``BatchNorm``: ``scale``/``bias`` -> ``weight``/``bias``,
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``PReLU``: ``slope`` -> ``weight``;
- every other parameter keeps its name in 'params' (EvoNorm's and the L1
  norms' ``gamma``, ``beta``, ``v``; ``emb_{i}``; Rezero's ``g``), every
  other buffer in 'batch_stats' (EvoNorm B0's ``running_var``,
  ``L1BatchNorm``'s ``mean`` and ``dev``), reshaped where flax's shape
  differs only by axes of size 1 (EvoNorm's (1, ..., C) against (C,)).

Both directions walk the whole tree: a torch tensor without its flax
leaf, or a flax leaf that no torch tensor takes, raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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
                         model: Optional[nn.Module] = None,
                         ) -> Dict[str, Dict]:
    """The flax collections of ``variables`` (their tree, with numpy
    leaves) filled from ``tensors``, a mapping of the port's state_dict
    keys to tensors: the parameters and running statistics of
    ``model.state_dict()``, or ``{name: p.grad for name, p in
    model.named_parameters()}`` with ``collections=("params",)`` for the
    flax grad tree. Raises on a missing key or a shape mismatch.

    ``model``: the port model the tensors belong to; needed for the
    model zoo's rule (see the module docstring), where every tensor of
    ``collections`` must find its flax leaf too."""
    if model is not None and _is_zoo(model):
        return _zoo_flax_from_state_dict(tensors, variables, collections,
                                         model)
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
    value. Raises on a missing entry or a shape mismatch. A model of the
    zoo takes its rule (see the module docstring)."""
    if _is_zoo(model):
        return _zoo_state_dict_from_flax(variables, model)
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


# ---------------------------------------------------------------------------
# The model zoo: torch module path = flax module path
# ---------------------------------------------------------------------------

def _is_zoo(model: nn.Module) -> bool:
    from elektronn3_tpu_torch.models.unet import UNet
    return not isinstance(model, UNet)


def _zoo_rule(module: nn.Module, name: str, is_buffer: bool
              ) -> Tuple[str, str, str]:
    """(collection, flax leaf, transform) of the tensor ``name`` held
    directly by ``module``; transform is 'conv', 'convT', 'dense' or
    'reshape'."""
    from elektronn3_tpu_torch.modules.layers import (
        BatchNorm, Conv, ConvTranspose, PReLU)
    if isinstance(module, (Conv, ConvTranspose, nn.Linear)) \
            and name == "weight":
        kind = "conv" if isinstance(module, Conv) else \
            "convT" if isinstance(module, ConvTranspose) else "dense"
        return "params", "kernel", kind
    if isinstance(module, BatchNorm):
        return {"weight": ("params", "scale", "reshape"),
                "bias": ("params", "bias", "reshape"),
                "running_mean": ("batch_stats", "mean", "reshape"),
                "running_var": ("batch_stats", "var", "reshape")}[name]
    if isinstance(module, PReLU) and name == "weight":
        return "params", "slope", "reshape"
    return ("batch_stats" if is_buffer else "params"), name, "reshape"


def _zoo_leaves(model: nn.Module
               ) -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
    """Per state_dict key of a zoo model, its (collection, flax path,
    transform)."""
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for is_buffer, named in ((False, mod.named_parameters(recurse=False)),
                                 (True, mod.named_buffers(recurse=False))):
            for name, _ in named:
                if name == "num_batches_tracked":
                    continue
                coll, leaf, kind = _zoo_rule(mod, name, is_buffer)
                out[".".join(prefix + (name,))] = (coll, prefix + (leaf,),
                                                   kind)
    return out


def _to_torch_layout(v: np.ndarray, kind: str, shape) -> np.ndarray:
    if kind == "conv":
        return conv_weight_from_flax(v)
    if kind == "convT":
        return convtranspose_weight_from_flax(v)
    if kind == "dense":
        return np.ascontiguousarray(np.asarray(v).T)
    return _reshape_ones(np.asarray(v), shape)


def _to_flax_layout(v: np.ndarray, kind: str, shape) -> np.ndarray:
    if kind == "conv":
        return conv_weight_to_flax(v)
    if kind == "convT":
        return convtranspose_weight_to_flax(v)
    if kind == "dense":
        return np.ascontiguousarray(v.T)
    return _reshape_ones(v, shape)


def _reshape_ones(v: np.ndarray, shape) -> np.ndarray:
    """``v`` in ``shape`` where the two differ only by axes of size 1."""
    shape = tuple(shape)
    if v.shape != shape and [d for d in v.shape if d != 1] \
            == [d for d in shape if d != 1]:
        return v.reshape(shape)
    return v


def _zoo_state_dict_from_flax(variables: Mapping[str, Any],
                              model: nn.Module) -> Dict[str, torch.Tensor]:
    flat = {coll: _flatten(variables.get(coll, {}))
            for coll in ("params", "batch_stats")}
    used = set()
    target = model.state_dict()
    leaves = _zoo_leaves(model)
    out = {}
    for key, ref in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = ref.clone()
            continue
        coll, path, kind = leaves[key]
        if path not in flat[coll]:
            raise KeyError(f"{key}: no flax leaf {coll}/{'/'.join(path)}")
        used.add((coll, path))
        val = _to_torch_layout(np.asarray(flat[coll][path], np.float32),
                               kind, ref.shape)
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {tuple(val.shape)} != "
                             f"{tuple(ref.shape)}")
        out[key] = torch.as_tensor(np.array(val, dtype=np.float32),
                                   dtype=ref.dtype)
    left = [f"{c}/{'/'.join(p)}" for c in flat for p in flat[c]
            if (c, p) not in used]
    if left:
        raise KeyError(f"flax leaves without a torch tensor: {left}")
    return out


def _zoo_flax_from_state_dict(tensors: Mapping[str, Any],
                              variables: Mapping[str, Any],
                              collections: Sequence[str],
                              model: nn.Module) -> Dict[str, Dict]:
    leaves = _zoo_leaves(model)
    by_path = {(coll, path): (key, kind)
               for key, (coll, path, kind) in leaves.items()}
    used = set()
    out: Dict[str, Dict] = {}
    for coll in collections:
        tree: Dict = {}
        for path, ref in _flatten(variables.get(coll, {})).items():
            if (coll, path) not in by_path:
                raise KeyError(f"{coll}/{'/'.join(path)}: no torch tensor")
            key, kind = by_path[(coll, path)]
            if key not in tensors:
                raise KeyError(f"{'/'.join((coll,) + path)}: no tensor "
                               f"{key!r}")
            used.add(key)
            t = tensors[key]
            # A copy: the tree must not alias the model's live buffers.
            v = np.array(t.detach().float().cpu() if
                         isinstance(t, torch.Tensor) else t, np.float32)
            v = _to_flax_layout(v, kind, np.shape(ref))
            if v.shape != np.shape(ref):
                raise ValueError(f"{key}: shape {v.shape} != flax "
                                 f"{np.shape(ref)}")
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        out[coll] = tree
    left = [k for k in tensors if k not in used and k in leaves
            and leaves[k][0] in collections]
    if left:
        raise KeyError(f"torch tensors without a flax leaf: {left}")
    return out
