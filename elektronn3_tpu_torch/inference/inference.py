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
  device. Logits are upcast to float32 before the softmax; the tile
  crop and the cast to ``out_dtype`` happen on the device, before the
  device-to-host copy, so the copy ships only the core of each tile in
  the small output type (uint8 class ids, bfloat16 probabilities).

Not ported yet: flip test-time augmentation, mesh sharding, valid-conv
offsets, loading a model from a file path, ``transform``, per-phase
timing and MVox/s logging.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
        res = np.asarray(func(np.concatenate(tile_batch), **crop_kw))
        if not crop_kw and np.any(crop_low > 0):
            res = res[_extend_nc(
                [slice(c, c + t) for c, t in zip(crop_low, tile_shape)])]
        for bi, pos in enumerate(positions_batch):
            lo = pos * tile_shape
            out[_extend_nc([slice(a, b) for a, b in
                            zip(lo, lo + tile_shape)])] = \
                res[bi * n:(bi + 1) * n]
        tile_batch.clear()
        positions_batch.clear()

    for tile_pos in tile_positions:
        lo = tile_pos * tile_shape
        hi = lo + tile_shape + 2 * overlap_shape
        tile_batch.append(inp_padded[_extend_nc(
            [slice(a, b) for a, b in zip(lo, hi)])])
        positions_batch.append(tile_pos)
        if len(tile_batch) >= max_batch_tiles:
            flush()
    flush()
    return out


_TORCH_OUT = {np.dtype(np.uint8): torch.uint8,
              np.dtype(np.float32): torch.float32,
              np.dtype(np.float16): torch.float16}


class Predictor:
    """Tiled, batched inference of a channels-last model on large inputs.

    Args (a subset of the JAX Predictor's, reference inference.py:246):
        model: an ``nn.Module`` mapping channels-last ``(N, *spatial,
            C)`` to ``(N, *spatial, C_out)`` logits (the port's UNet, 3D
            or 2D). It is put in eval mode.
        device: where to run; default: the device of the model's
            parameters (the card, unless the model was built on the
            CPU).
        batch_size: tiles per model call.
        tile_shape: output tile shape; None predicts the whole input at
            once. Its length is the spatial rank of the inputs; without
            it the rank is the model's ``dim`` (3 if it has none).
        overlap_shape: tile overlap on each side.
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
        argmax_with_threshold: append an argmax head; a float makes
            class 1 fire only above that probability (binary case).
        strict_shapes: if False, zero-pad shapes that tiles do not
            divide and crop the result back.
    """

    def __init__(
            self,
            model: torch.nn.Module,
            device: Union[None, str, torch.device] = None,
            batch_size: Optional[int] = None,
            tile_shape: Optional[Sequence[int]] = None,
            overlap_shape: Optional[Sequence[int]] = None,
            out_channels: Optional[int] = None,
            out_dtype=None,
            float16: bool = False,
            apply_softmax: bool = True,
            argmax_with_threshold: Union[None, bool, float] = None,
            strict_shapes: bool = False,
    ):
        if isinstance(model, str):
            raise NotImplementedError(
                "loading a model from a path is not ported yet")
        self.model = model.eval()
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.tile_shape = None if tile_shape is None else tuple(tile_shape)
        self.spatial_ndim = len(self.tile_shape) if self.tile_shape \
            else getattr(model, "dim", 3)
        self.overlap_shape = None if overlap_shape is None \
            else tuple(overlap_shape)
        self.out_channels = out_channels if out_channels is not None \
            else getattr(model, "out_channels", None)
        self.float16 = float16
        self.apply_softmax = apply_softmax
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

    def _forward(self, x_cl: torch.Tensor,
                 crop_lo: Optional[Tuple[int, ...]] = None,
                 crop_size: Optional[Tuple[int, ...]] = None
                 ) -> torch.Tensor:
        """Model + heads + crop + cast, on the device; returns the
        channels-first result still on the device."""
        out = self.model(x_cl).float()
        if self.apply_softmax:
            out = torch.softmax(out, dim=-1)
        if self._argmax_on:
            if self.argmax_with_threshold is True:
                out = torch.argmax(out, dim=-1, keepdim=True)
            else:
                out = out[..., 1:2] > self.argmax_with_threshold
        if crop_lo is not None:
            out = out[(slice(None),) + tuple(
                slice(lo, lo + sz) for lo, sz in zip(crop_lo, crop_size))]
        return out.to(self.out_dtype).movedim(-1, 1).contiguous()

    def _predict(self, inp_ncf: np.ndarray,
                 crop_lo: Optional[Tuple[int, ...]] = None,
                 crop_size: Optional[Tuple[int, ...]] = None) -> np.ndarray:
        """One device call on an (N, C, *spatial) numpy batch."""
        host = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(inp_ncf, 1, -1)))
        if self.float16:
            host = host.to(torch.bfloat16)
        with torch.inference_mode():
            x = host.to(self.device)
            out = self._forward(x, crop_lo, crop_size).cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.numpy()

    def predict(self, inp: np.ndarray) -> np.ndarray:
        """Predict on an (N, C, *spatial) / (C, *spatial) / (*spatial)
        numpy array; returns (N, C_out, *spatial) in the host dtype
        (uint8 class ids with an argmax head, probabilities or logits
        otherwise)."""
        inp = np.asarray(inp, np.float32)
        while inp.ndim < self.spatial_ndim + 2:
            inp = inp[None]
        out_channels = self.out_channels
        if out_channels is None:
            out_channels = self._predict(np.zeros_like(inp[:1])).shape[1]
            self.out_channels = out_channels
        if self._argmax_on and self.host_dtype == np.uint8 \
                and out_channels > 255:
            raise ValueError(
                f"out_channels = {out_channels}, but out_dtype uint8 "
                "can only hold class ids up to 255.")
        if self.tile_shape is None:
            return self._splitbatch_predict(inp)
        spatial = np.array(inp.shape[2:])
        tile_shape = np.array(self.tile_shape)
        overlap = np.zeros_like(tile_shape) if self.overlap_shape is None \
            else np.array(self.overlap_shape)
        out_shape = (inp.shape[0], 1 if self._argmax_on else out_channels)
        remainder = (-spatial) % tile_shape
        if np.any(remainder):
            if self.strict_shapes:
                raise ValueError(
                    f"Output spatial shape {tuple(spatial)} is not "
                    f"divisible by tile shape {tuple(tile_shape)}. Pass "
                    "strict_shapes=False to auto-pad.")
            inp = np.pad(inp, [(0, 0), (0, 0)]
                         + [(0, int(r)) for r in remainder])
        out = tiled_apply(
            self._splitbatch_predict, inp, tile_shape, overlap, None,
            out_shape + tuple(spatial + remainder), device_crop=True,
            max_tiles_per_call=self.batch_size, out_dtype=self.host_dtype)
        return out[_extend_nc([slice(0, s) for s in spatial])]

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
