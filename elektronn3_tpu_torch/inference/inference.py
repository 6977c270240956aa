"""Inference engine: tiled, batched prediction of large volumes.

Counterpart of the JAX package's ``inference/inference.py`` (reference
elektronn3/inference/inference.py). The public layout is the reference's:
``Predictor.predict`` takes and returns channels-first numpy arrays
``(N, C, D, H, W)``, or ``(N, C, H, W)`` for a 2D model; on the device
everything is channels-last.

- :func:`tiled_apply` cuts the (zero-padded) input into tiles of one
  shape, packs them along the batch axis and streams them through the
  model in batches of ``batch_size``. Each tile of a batch is a sample:
  a group or instance norm model takes each tile's own statistics (as in
  JAX), so a tile's output depends on the batch it rides in only through
  the summation order of library calls that follow the batch size.
- :class:`Predictor` runs the model under ``torch.inference_mode`` on its
  device. Logits are upcast to float32 before the softmax (and averaged
  over flip test-time augmentation in float32 before it); the tile crop
  and the cast to ``out_dtype`` happen on the device, before the
  device-to-host copy, so the copy ships only the core of each tile in
  the small output type (uint8 class ids, bfloat16 probabilities).
  A valid-conv model's ``offset`` (given, or probed by one zeros
  forward with ``offset='auto'``) makes the tiles' overlap the offset
  and the output smaller than the input by it on each side.

With a ``mesh`` (``parallel.make_mesh``) every rank of the mesh runs the
same request and returns the full output, as JAX's one controller does:
``shard_mode='tiles'`` splits each call's tile batch over the 'data'
axis (padded to equal parts with the last tile, gathered without the
padding), ``'spatial'`` splits a spatial axis over the 'space' axis with
halo exchange (``parallel.sharded_spatial_apply``).

A model may also come as ``export_program``'s deployment artifact
(``model*.pt2``, JAX's ``.stablehlo``): a program of one fixed input
shape, which each call gets whole (:class:`Program`). JAX's own
``.e3tpu`` and ``.stablehlo`` files do not load here: the port's are
``save_model``'s ``.pt`` and that ``.pt2``.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from elektronn3_tpu_torch.parallel.collectives import gather
from elektronn3_tpu_torch.parallel.halo import sharded_spatial_apply
from elektronn3_tpu_torch.parallel.mesh import shard_rows

logger = logging.getLogger("elektronn3_tpu_torch")

def _extend_nc(spatial_slice: Sequence[slice]) -> Tuple[slice, ...]:
    """Prefix a spatial slice tuple with (N, C) full slices."""
    return (slice(None), slice(None)) + tuple(spatial_slice)


def tiled_apply(
        func: Callable[..., np.ndarray],
        inp: np.ndarray,
        tile_shape: Sequence[int],
        overlap_shape: Sequence[int],
        offset: Optional[Sequence[int]],
        out_shape: Sequence[int],
        verbose: bool = False,
        phase_times: Optional[Dict[str, float]] = None,
        device_crop: bool = False,
        max_tiles_per_call: Optional[int] = None,
        out_dtype=np.float32,
) -> np.ndarray:
    """Apply ``func`` tile-wise over a large (N, C, *spatial) input.

    ``func`` maps an (N, C, *tile_in_spatial) array to
    (N, C_out, *tile_out_spatial). ``tile_shape`` is the *output* tile
    shape; each input tile extends it by ``overlap_shape`` on both sides.
    ``offset`` is the valid-conv shrinkage per side (None for 'same'
    models). With ``device_crop``, ``func`` takes ``crop_lo``/``crop_size``
    and returns the cropped tile cores itself. ``max_tiles_per_call``
    sets the tiles per call (default: about 64 MB of float32 input).
    ``verbose`` logs the progress after each call; ``phase_times``
    (a dict) accumulates the host's seconds stacking the tiles
    (``host_assemble``), in ``func`` (``device_call``) and scattering the
    results (``host_scatter``).
    """
    if np.any(np.mod(out_shape[2:], tile_shape)):
        raise ValueError(
            f"spatial out_shape {tuple(out_shape[2:])} has to be divisible "
            f"by tile_shape {tuple(tile_shape)}.")
    inp_shape = np.array(inp.shape)
    out_shape = np.array(out_shape)
    tile_shape = np.array(tile_shape)
    overlap_shape = np.array(overlap_shape)

    if np.array_equal(out_shape[2:], inp_shape[2:]):
        # Same-conv case: zero-pad by the overlap, crop it off the output.
        padded_shape = inp_shape.copy()
        padded_shape[2:] += 2 * overlap_shape
        inp_padded = np.zeros(padded_shape, dtype=inp.dtype)
        inp_padded[_extend_nc([slice(o, o + s) for o, s in
                               zip(overlap_shape, inp_shape[2:])])] = inp
        crop_low = overlap_shape.copy()
        if offset is not None:
            crop_low = overlap_shape - np.array(offset)
            if np.any(crop_low < 0):
                raise ValueError(
                    "overlap_shape must be >= offset in every dim")
    else:
        # Valid-conv case: the model eats the overlap itself.
        if offset is None or not np.array_equal(overlap_shape,
                                                np.array(offset)):
            raise ValueError(
                "With out_shape smaller than inp shape (valid-conv mode), "
                "overlap_shape must equal offset "
                f"(got overlap={tuple(overlap_shape)}, offset={offset}).")
        inp_padded = inp
        crop_low = np.zeros_like(tile_shape)
    del inp

    out = np.empty(out_shape, dtype=out_dtype)
    tiles = np.ceil(out_shape[2:] / tile_shape).astype(int)
    tile_positions = [np.array(p) for p in itertools.product(
        *[range(t) for t in tiles])]
    n = inp_padded.shape[0]
    t0 = time.perf_counter()

    in_tile_spatial = tile_shape + 2 * overlap_shape
    tile_bytes = n * inp_padded.shape[1] * int(np.prod(in_tile_spatial)) * 4
    max_batch_tiles = max(1, int(64e6 // max(tile_bytes, 1)))
    if max_tiles_per_call is not None:
        max_batch_tiles = max(1, int(max_tiles_per_call))
    crop_kw = {}
    if device_crop and np.any(crop_low > 0):
        crop_kw = dict(crop_lo=tuple(int(c) for c in crop_low),
                       crop_size=tuple(int(t) for t in tile_shape))

    tile_batch: list = []
    positions_batch: list = []

    def flush():
        if not tile_batch:
            return
        ta = time.perf_counter()
        stacked = np.concatenate(tile_batch)
        tb = time.perf_counter()
        res = np.asarray(func(stacked, **crop_kw))
        tc = time.perf_counter()
        if not crop_kw and np.any(crop_low > 0):
            res = res[_extend_nc(
                [slice(c, c + t) for c, t in zip(crop_low, tile_shape)])]
        for bi, pos in enumerate(positions_batch):
            lo = pos * tile_shape
            out[_extend_nc([slice(a, b) for a, b in
                            zip(lo, lo + tile_shape)])] = \
                res[bi * n:(bi + 1) * n]
        if phase_times is not None:
            td = time.perf_counter()
            for key, dt in (("host_assemble", tb - ta),
                            ("device_call", tc - tb),
                            ("host_scatter", td - tc)):
                phase_times[key] = phase_times.get(key, 0.0) + dt
        tile_batch.clear()
        positions_batch.clear()

    for i, tile_pos in enumerate(tile_positions):
        lo = tile_pos * tile_shape
        hi = lo + tile_shape + 2 * overlap_shape
        tile_batch.append(inp_padded[_extend_nc(
            [slice(a, b) for a, b in zip(lo, hi)])])
        positions_batch.append(tile_pos)
        if len(tile_batch) >= max_batch_tiles:
            flush()
            if verbose:
                logger.info(f"tiled_apply: {i + 1}/{len(tile_positions)} "
                            f"tiles ({time.perf_counter() - t0:.1f} s)")
    flush()
    return out




# Flip test-time augmentation: NC(D)HW axis ids of the flipped axes, the
# JAX package's defaults (an int N takes the first N).
DEFAULT_AUGMENTATIONS_3D = [
    (), (2,), (3,), (4,), (2, 3), (2, 4), (3, 4), (2, 3, 4)]
DEFAULT_AUGMENTATIONS_2D = [(), (2,), (3,), (2, 3)]

_TORCH_OUT = {np.dtype(np.uint8): torch.uint8,
              np.dtype(np.float32): torch.float32,
              np.dtype(np.float16): torch.float16}


class Program:
    """An exported program (``training.trainer.load_program``'s module)
    as a model: one fixed channels-last float32 input shape (N, *spatial,
    C), on the device it was exported on. A call takes any batch of that
    sample shape: the input is cast to float32 and run N samples at a
    time, the last part padded with zero samples whose outputs are
    dropped (each sample's output depends on that sample alone in eval),
    so the program always sees its own shape. Another sample shape raises
    ``ValueError`` naming both shapes."""

    def __init__(self, module: torch.nn.Module):
        nodes = module.graph.nodes
        x = next(n for n in nodes if n.op == "placeholder").meta["val"]
        out = next(n for n in nodes if n.op == "output")
        y = torch.utils._pytree.tree_leaves(out.args)[0].meta["val"]
        self.module = module
        self.shape = tuple(x.shape)
        self.device = x.device
        self.dim = len(self.shape) - 2
        self.out_channels = y.shape[-1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.shape[0]
        if tuple(x.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"the exported program takes inputs of shape {self.shape}, "
                f"got {tuple(x.shape)}: build the Predictor with its tile "
                "shape (tile_shape + 2 * overlap_shape = the program's "
                "spatial shape)")
        x = x.float()
        outs = []
        for i in range(0, x.shape[0], n):
            part = x[i:i + n]
            pad = n - part.shape[0]
            if pad:
                part = torch.cat([part,
                                  part.new_zeros((pad,) + self.shape[1:])])
            outs.append(self.module(part.contiguous())[:n - pad])
        return outs[0] if len(outs) == 1 else torch.cat(outs)


class Predictor:
    """Tiled, batched inference of a channels-last model on large inputs.

    Args (the JAX Predictor's, reference inference.py:246):
        model: an ``nn.Module`` mapping channels-last ``(N, *spatial,
            C)`` to ``(N, *spatial, C_out)`` logits (the port's UNet, 3D
            or 2D; put in eval mode), a plain callable on channels-last
            tensors on ``device``, or the path of a port model file
            (``training.trainer.save_model``'s ``model*.pt``, rebuilt by
            ``load_model`` on ``device``), or of an exported program
            (``export_program``'s ``model*.pt2``, JAX's ``.stablehlo``;
            loaded by ``load_program`` and run as a :class:`Program`
            only on the device it was exported on, ``ValueError`` for
            another ``device``: build the Predictor with the program's
            tile, and ``batch_size`` defaults to its batch). JAX's
            ``.e3tpu`` and
            ``.stablehlo`` files raise ``ValueError``.
        state: weights for an ``nn.Module`` ``model``, loaded into it: a
            port ``state_dict``, or a reference checkpoint (a path or
            object: ``state_dict*.pth``, a bare state dict, a pickled
            module, a TorchScript ``.pts``;
            :func:`~elektronn3_tpu_torch.models.torch_import.
            load_torch_state_dict`).
        device: where to run; default: the device of the model's
            parameters, the card for a callable.
        batch_size: tiles per model call.
        tile_shape: output tile shape; None predicts the whole input at
            once. Its length is the spatial rank of the inputs; without
            it the rank is ``out_shape``'s (less 2), else the model's
            ``dim`` (3 if it has none).
        overlap_shape: tile overlap on each side (a 'same' model).
        offset: a valid-conv model's output shrinkage per side, or
            'auto': probed by one zeros forward of an input's shape and
            kept per input rank (``offset`` itself stays as given). The
            output is smaller than the input by it on each side; tiled,
            the overlap is the offset.
        out_shape: the output's shape (N, C_out, *spatial); only its
            length is read, to give an unbatched input its leading axes.
        out_channels: the model's class count (default: the model's
            ``out_channels``, else probed).
        out_dtype: cast on the device before the copy to the host:
            ``np.uint8``, ``np.float16``, ``np.float32`` or 'bfloat16'.
            Default: uint8 with an argmax head, else 'bfloat16' under
            ``float16``, else float32. numpy has no bfloat16, so
            bfloat16 output ships as bfloat16 and is widened to float32
            on the host.
        float16: ship the input as bfloat16 (the JAX package maps the
            reference's fp16 mode to bfloat16), converted on the host,
            which halves the copy to the device; the model's own
            ``dtype`` sets its compute dtype.
        apply_softmax: append a softmax over classes (float32).
        transform: applied to each sample as ``transform(inp[n], None)``
            (the data pipeline's transforms), returning (input, _).
        augmentations: flip test-time augmentation: a list of NC(D)HW
            axis tuples to flip (``()`` the input as it is), or an int N
            for the first N of ``DEFAULT_AUGMENTATIONS_3D``/``_2D`` (by
            the input's rank). The model's logits on each flipped input,
            flipped back, are averaged in float32 on the device before
            the heads.
        argmax_with_threshold: append an argmax head; a float makes
            class 1 fire only above that probability (binary case).
        strict_shapes: if False, zero-pad shapes that tiles do not
            divide and crop the result back.
        verbose: log each request's MVox/s and the tiles' progress.
        collect_phase_times: fill ``last_phase_times`` on each request
            with the seconds spent in ``h2d`` (the copy to the device),
            ``compute`` (the model and heads, between two
            ``torch.cuda.synchronize``), ``d2h``, and in
            :func:`tiled_apply`'s ``host_assemble``, ``device_call`` and
            ``host_scatter``. The synchronizations cost the overlap of
            the host with the card: leave it off in production.
        mesh: a ``parallel.Mesh`` to shard each model call over; every
            rank of it must make the same requests, and each gets the
            full output.
        shard_mode: 'tiles': the tile batch of each call split over the
            mesh's 'data' axis (a tile count that the axis does not
            divide is padded with repeats of the last tile, which are
            dropped); 'spatial': the NC(D)HW axis ``shard_axis`` of each
            call's input split over the 'space' axis, each shard
            extended by ``halo`` slices of its neighbours' (zeros at the
            volume's ends), for a same-conv model whose receptive field's
            half width ``halo`` covers. ``ValueError`` for another mode,
            for 'spatial' without ``halo`` or with flip TTA (a flip
            across the sharded axis would stay on one rank).
    """

    def __init__(
            self,
            model: Union[nn.Module, Callable, str],
            state=None,
            device: Union[None, str, torch.device] = None,
            batch_size: Optional[int] = None,
            tile_shape: Optional[Sequence[int]] = None,
            overlap_shape: Optional[Sequence[int]] = None,
            offset: Union[None, str, Sequence[int]] = None,
            out_shape: Optional[Sequence[int]] = None,
            out_channels: Optional[int] = None,
            out_dtype=None,
            float16: bool = False,
            apply_softmax: bool = True,
            transform: Optional[Callable] = None,
            augmentations: Union[None, int, Sequence[Sequence[int]]] = None,
            argmax_with_threshold: Union[None, bool, float] = None,
            strict_shapes: bool = False,
            verbose: bool = False,
            collect_phase_times: bool = False,
            mesh=None,
            shard_mode: str = "spatial",
            shard_axis: int = 2,
            halo: Optional[int] = None,
    ):
        if isinstance(model, str):
            if model.endswith((".e3tpu", ".stablehlo")):
                raise ValueError(
                    f"{model}: a JAX model file; the port loads its own "
                    "save_model files (model*.pt) and export_program's "
                    "exported programs (model*.pt2).")
            if model.endswith(".pt2"):
                from elektronn3_tpu_torch.training.trainer import \
                    load_program
                model = Program(load_program(model))
            else:
                from elektronn3_tpu_torch.training.trainer import \
                    load_model
                model, _ = load_model(model, device=device)
        if isinstance(model, Program):
            if state is not None:
                raise ValueError("state needs an nn.Module model")
            if device is None:
                device = model.device
            else:
                device = torch.device(device)
                if device.type == model.device.type == "cuda" \
                        and device.index is None:
                    device = torch.device("cuda", torch.cuda.current_device())
                if device != model.device:
                    raise ValueError(
                        f"the exported program runs on {model.device}, "
                        f"where it was exported, not on {device}")
            if batch_size is None:
                batch_size = model.shape[0]
        elif isinstance(model, nn.Module):
            if state is not None:
                from elektronn3_tpu_torch.models.torch_import import \
                    load_torch_state_dict
                model.load_state_dict(load_torch_state_dict(state, model))
            model.eval()
            if device is None:
                device = next(model.parameters()).device
        elif callable(model):
            if state is not None:
                raise ValueError("state needs an nn.Module model")
            if device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "Predictor: no CUDA device for a callable model; "
                        "pass device='cpu' to run it on the CPU.")
                device = torch.device("cuda")
        else:
            raise TypeError(f"model must be an nn.Module, a callable or a "
                            f"path, got {type(model).__name__}")
        self.model = model
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.tile_shape = None if tile_shape is None else tuple(tile_shape)
        self.overlap_shape = None if overlap_shape is None \
            else tuple(overlap_shape)
        self.out_shape = None if out_shape is None else tuple(out_shape)
        if self.tile_shape:
            self.spatial_ndim = len(self.tile_shape)
        elif self.out_shape:
            self.spatial_ndim = len(self.out_shape) - 2
        else:
            self.spatial_ndim = getattr(model, "dim", 3)
        self.out_channels = out_channels if out_channels is not None \
            else getattr(model, "out_channels", None)
        self.float16 = float16
        self.apply_softmax = apply_softmax
        self.transform = transform
        self.augmentations = augmentations
        self.argmax_with_threshold = argmax_with_threshold
        self._argmax_on = argmax_with_threshold is not None \
            and argmax_with_threshold is not False
        if out_dtype is None:
            out_dtype = (np.uint8 if self._argmax_on
                         else "bfloat16" if float16 else np.float32)
        if isinstance(out_dtype, str) and out_dtype == "bfloat16":
            self.out_dtype = torch.bfloat16
            self.host_dtype = np.dtype(np.float32)
        else:
            self.host_dtype = np.dtype(out_dtype)
            if self.host_dtype not in _TORCH_OUT:
                raise ValueError(f"out_dtype {out_dtype!r} not supported")
            self.out_dtype = _TORCH_OUT[self.host_dtype]
        self.strict_shapes = strict_shapes
        self.verbose = verbose
        self.collect_phase_times = collect_phase_times
        self.last_phase_times: Optional[Dict[str, float]] = None
        self._auto_offset = isinstance(offset, str) and offset == "auto"
        self.offset = None if offset is None or self._auto_offset \
            else tuple(offset)
        # Probed offsets by input rank, written only after a probe ran.
        self._offset_by_rank: Dict[int, Tuple[int, ...]] = {}

        self.mesh = mesh
        self.shard_mode = shard_mode
        self.shard_axis = shard_axis
        self.halo = halo
        self._tiles = None      # the 'data' axis of 'tiles' sharding
        self._spatial = None    # the sharded forward of 'spatial'
        if mesh is not None and shard_mode == "spatial":
            if halo is None:
                raise ValueError("halo is required with spatial sharding")
            if self.augmentations:
                raise ValueError(
                    "flip-TTA is not supported with spatial mesh "
                    "sharding (flips across the sharded axis would be "
                    "device-local)")
            # shard_axis is in NC(D)HW terms; channels-last it is one less.
            self._spatial = sharded_spatial_apply(
                self._forward_cl, mesh, halo, spatial_axis=shard_axis - 1,
                axis_name="space")
        elif mesh is not None and shard_mode == "tiles":
            self._tiles = mesh.axis("data")
        elif mesh is not None:
            raise ValueError(f"shard_mode must be 'spatial' or 'tiles', "
                             f"got {shard_mode!r}")

    def _resolve_augmentations(self, ndim: int):
        """The flip spec for an input of ``ndim`` axes (N, C, *spatial):
        an int takes the first N defaults of its rank."""
        aug = self.augmentations
        if isinstance(aug, int):
            aug = (DEFAULT_AUGMENTATIONS_3D if ndim >= 5
                   else DEFAULT_AUGMENTATIONS_2D)[:aug]
        return aug or ()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, x_cl: torch.Tensor,
                 crop_lo: Optional[Tuple[int, ...]] = None,
                 crop_size: Optional[Tuple[int, ...]] = None
                 ) -> torch.Tensor:
        """Model (averaged over the flips) + heads + cast + crop, on the
        device, spatially sharded under 'spatial'; returns the
        channels-first result still on the device."""
        out = self._spatial(x_cl) if self._spatial is not None \
            else self._forward_cl(x_cl)
        if crop_lo is not None:
            out = out[(slice(None),) + tuple(
                slice(lo, lo + sz) for lo, sz in zip(crop_lo, crop_size))]
        return out.movedim(-1, 1).contiguous()

    def _forward_cl(self, x_cl: torch.Tensor) -> torch.Tensor:
        """Model (averaged over the flips) + heads + cast to the output
        dtype, channels-last."""
        out = self.model(x_cl).float()
        augmentations = self._resolve_augmentations(x_cl.dim())
        if augmentations:
            for axes in augmentations:
                if axes:
                    cl = tuple(a - 1 for a in axes)   # NCDHW -> NDHWC
                    out = out + torch.flip(
                        self.model(torch.flip(x_cl, cl)), cl).float()
            out = out / (1 + sum(1 for a in augmentations if a))
        if self.apply_softmax:
            out = torch.softmax(out, dim=-1)
        if self._argmax_on:
            if self.argmax_with_threshold is True:
                out = torch.argmax(out, dim=-1, keepdim=True)
            else:
                out = out[..., 1:2] > self.argmax_with_threshold
        return out.to(self.out_dtype)

    def _predict(self, inp_ncf: np.ndarray,
                 crop_lo: Optional[Tuple[int, ...]] = None,
                 crop_size: Optional[Tuple[int, ...]] = None) -> np.ndarray:
        """One device call on an (N, C, *spatial) numpy batch; under
        'tiles' on this rank's part of it, the parts gathered."""
        n = inp_ncf.shape[0]
        if self._tiles is not None:
            pad = -n % self._tiles.size
            if pad:
                inp_ncf = np.concatenate([inp_ncf] + [inp_ncf[-1:]] * pad)
            inp_ncf = shard_rows(inp_ncf, self._tiles)
        host = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(inp_ncf, 1, -1)))
        if self.float16:
            host = host.to(torch.bfloat16)
        pt = self.last_phase_times
        with torch.inference_mode():
            if pt is None:
                out = gather(self._forward(host.to(self.device), crop_lo,
                                           crop_size), self._tiles).cpu()
            else:
                t0 = time.perf_counter()
                x = host.to(self.device)
                self._sync()
                t1 = time.perf_counter()
                out = gather(self._forward(x, crop_lo, crop_size),
                             self._tiles)
                self._sync()
                t2 = time.perf_counter()
                out = out.cpu()
                t3 = time.perf_counter()
                for key, dt in (("h2d", t1 - t0), ("compute", t2 - t1),
                                ("d2h", t3 - t2)):
                    pt[key] = pt.get(key, 0.0) + dt
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out[:n].numpy()

    def predict(self, inp: np.ndarray) -> np.ndarray:
        """Predict on an (N, C, *spatial) / (C, *spatial) / (*spatial)
        numpy array; returns (N, C_out, *spatial_out) in the host dtype
        (uint8 class ids with an argmax head, probabilities or logits
        otherwise), spatial_out the input's less twice the offset."""
        start = time.perf_counter()
        self.last_phase_times = {} if self.collect_phase_times else None
        inp = np.asarray(inp, np.float32)
        while inp.ndim < self.spatial_ndim + 2:
            inp = inp[None]
        for axes in self._resolve_augmentations(inp.ndim):
            bad = [a for a in axes if not 2 <= a < inp.ndim]
            if bad:
                raise ValueError(
                    f"TTA augmentation axes {axes} contain non-spatial "
                    f"axis ids {bad} for a {inp.ndim}-d (N, C, *spatial) "
                    "input")
        if self.transform is not None:
            inp = np.stack([self.transform(inp[n], None)[0]
                            for n in range(inp.shape[0])])

        offset_spec = self.offset
        if self._auto_offset:
            offset_spec = self._offset_by_rank.get(inp.ndim)
            if offset_spec is None:
                pout = self._predict(np.zeros_like(inp[:1]))
                offset_spec = tuple(int(o) for o in (
                    np.array(inp.shape[2:]) - np.array(pout.shape[2:])) // 2)
                self._offset_by_rank[inp.ndim] = offset_spec
                logger.info(f"Auto-detected offset: {offset_spec}")
        out_channels = self.out_channels
        if out_channels is None:
            out_channels = self._predict(np.zeros_like(inp[:1])).shape[1]
            self.out_channels = out_channels
        if self._argmax_on and self.host_dtype == np.uint8 \
                and out_channels > 255:
            raise ValueError(
                f"out_channels = {out_channels}, but out_dtype uint8 "
                "can only hold class ids up to 255.")
        offset = np.zeros(inp.ndim - 2, np.int64) if offset_spec is None \
            else np.array(offset_spec)
        out_spatial = np.array(inp.shape[2:]) - 2 * offset
        out_shape = (inp.shape[0], 1 if self._argmax_on else out_channels)

        if self.tile_shape is None:
            out = self._splitbatch_predict(inp)
        else:
            tile_shape = np.array(self.tile_shape)
            if np.any(offset > 0):
                # The model eats the halo itself: the overlap is the
                # offset (reference :152-153).
                overlap = offset.copy()
            elif self.overlap_shape is None:
                overlap = np.zeros_like(tile_shape)
            else:
                overlap = np.array(self.overlap_shape)
            remainder = (-out_spatial) % tile_shape
            if np.any(remainder) and self.strict_shapes:
                raise ValueError(
                    f"Output spatial shape {tuple(out_spatial)} is not "
                    f"divisible by tile shape {tuple(tile_shape)}. Pass "
                    "strict_shapes=False to auto-pad.")
            if np.any(remainder):
                inp = np.pad(inp, [(0, 0), (0, 0)]
                             + [(0, int(r)) for r in remainder])
            out = tiled_apply(
                self._splitbatch_predict, inp, tile_shape, overlap, offset,
                out_shape + tuple(out_spatial + remainder),
                verbose=self.verbose, phase_times=self.last_phase_times,
                device_crop=True, max_tiles_per_call=self.batch_size,
                out_dtype=self.host_dtype)
            out = out[_extend_nc([slice(0, s) for s in out_spatial])]
        if self.verbose:
            dt = time.perf_counter() - start
            mvx = np.prod(out.shape[2:]) * out.shape[0] / dt / 1e6
            logger.info(f"Prediction done in {dt:.2f} s ({mvx:.2f} MVox/s)")
        return out

    def predict_proba(self, inp: np.ndarray) -> np.ndarray:
        """:meth:`predict` (the reference's name)."""
        return self.predict(inp)

    def _splitbatch_predict(self, inp: np.ndarray, **crop_kw) -> np.ndarray:
        """Split an over-long batch into ``batch_size`` calls; the last,
        ragged call is zero-padded so every call has one shape."""
        n = inp.shape[0]
        bs = self.batch_size or n
        if n <= bs:
            return self._predict(inp, **crop_kw)
        outs = []
        for i in range(0, n, bs):
            chunk = inp[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad > 0:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            res = self._predict(chunk, **crop_kw)
            outs.append(res[:res.shape[0] - pad] if pad > 0 else res)
        return np.concatenate(outs)
