"""Patch loader whose warp runs on the card.

Counterpart of the JAX package's ``data/device_pipeline.py``:

- HOST (cheap, control-flow heavy): random cube choice, random 4x4
  matrix, corner check with retry, the window read in the source's own
  dtype, padded to ONE static window shape.
- CARD (bandwidth heavy): one copy of the batch's windows from pinned
  host memory, the cast to float32, the per-voxel inverse transform and
  interpolation of the whole batch (``warp.warp_interpolate_batch``),
  normalization and the optional augmentation.

Compared with ``DataLoader`` over ``PatchCreator``, the
O(batch x patch voxels) interpolation leaves the host, which only reads
windows.

The window's bounds come from the patch corners after the homogeneous
divide, as ``warp_slice`` takes them. (The JAX loader takes them before
it, so under ``perspective=True`` the window it reads can miss voxels
that the warp samples, which its clamp then moves to the window's
edge.)
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from elektronn3_tpu_torch.data import coord_transforms as ct
from elektronn3_tpu_torch.data import warp as warp_ops
from elektronn3_tpu_torch.data.sources import DataSource, slice_3d


class DeviceWarpPatchLoader:
    """Batched patch loader with the warp interpolation on the card.

    Args:
        inputs / targets: lists of DataSources ((C?,) D, H, W).
        patch_shape: (D, H, W) output patch shape.
        batch_size: patches per batch.
        window_shape: static host-read window shape; it must hold the
            warped bounding boxes (a sample whose box exceeds it is
            retried, as an out-of-bounds one is). Defaults to
            ``ceil(1.5 * patch_shape) + 8``.
        warp_prob / warp_kwargs / aniso_factor: as in PatchCreator.
        cube_prios: relative sampling priority per input cube
            (normalized; default uniform).
        epoch_size: batches per epoch.
        augment_fn: optional augmentation on the card,
            ``fn(inp (N, pd, ph, pw, C), generator) -> inp``, applied
            after interpolation (see ``warp``'s photometric functions).
        normalize: optional (mean, std) applied on the card.
        seed: seeds the host's draws (``np.random.default_rng(seed)``)
            and the card's (``augment_fn``'s generator).
        device: where batches go; default the current CUDA device.

    Yields ``{"inp": (N, pd, ph, pw, C) float32, "target": (N, pd, ph,
    pw) int64}`` (the target (N, pd, ph, pw, C_t) for several target
    channels) on ``device``. ``n_failed`` counts the retried draws,
    ``n_ok`` the accepted ones.
    """

    def __init__(
            self,
            inputs: Sequence[DataSource],
            targets: Optional[Sequence[DataSource]],
            patch_shape: Tuple[int, int, int],
            batch_size: int = 8,
            window_shape: Optional[Tuple[int, int, int]] = None,
            warp_prob: float = 0.2,
            warp_kwargs: Optional[Dict] = None,
            aniso_factor: int = 2,
            cube_prios: Optional[Sequence[float]] = None,
            epoch_size: int = 100,
            augment_fn: Optional[Callable] = None,
            normalize: Optional[Tuple[float, float]] = None,
            seed: int = 0,
            device=None,
    ):
        self.inputs = list(inputs)
        self.targets = None if targets is None else list(targets)
        self.patch_shape = tuple(patch_shape)
        self.batch_size = batch_size
        if window_shape is None:
            window_shape = tuple(
                int(np.ceil(1.5 * s)) + 8 for s in patch_shape)
        self.window_shape = tuple(window_shape)
        self.warp_prob = warp_prob
        self.warp_kwargs = dict(warp_kwargs or {})
        self.aniso_factor = aniso_factor
        if cube_prios is None:
            self._prios = np.full(len(self.inputs), 1 / len(self.inputs))
        else:
            p_arr = np.asarray(cube_prios, np.float64)
            if len(p_arr) != len(self.inputs):
                raise ValueError("cube_prios needs one entry per input")
            self._prios = p_arr / p_arr.sum()
        self.epoch_size = epoch_size
        self.augment_fn = augment_fn
        self.normalize = normalize
        self.device = torch.device("cuda" if device is None else device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.n_failed = 0
        self.n_ok = 0
        # Labels that fit uint8 travel as uint8 (probed once, on sources
        # held in memory): the cast to float32 on the card is the same.
        self._targets_u8 = self.targets is not None and all(
            self._fits_uint8(t) for t in self.targets)

    @staticmethod
    def _fits_uint8(src) -> bool:
        if np.issubdtype(np.dtype(src.dtype), np.unsignedinteger) \
                and np.dtype(src.dtype).itemsize == 1:
            return True
        if not np.issubdtype(np.dtype(src.dtype), np.integer):
            return False
        arr = getattr(src, "_data", None)
        if arr is None or not isinstance(arr, np.ndarray) \
                or isinstance(arr, np.memmap):
            # not (fully) in memory: min()/max() would read the cube
            return False
        return bool(arr.min() >= 0 and arr.max() <= 255)

    def __len__(self):
        return self.epoch_size

    # -- host side -----------------------------------------------------

    def window_bounds(self, M_inv: np.ndarray, perspective: bool):
        """(lo, hi) of the window that holds every voxel the warp by
        ``M_inv`` samples: the patch corners mapped to the source and,
        for a ``perspective`` matrix, divided by their homogeneous
        coordinate; ``hi`` exclusive, one voxel past the trilinear
        neighbour."""
        corners = ct.make_dest_corners(self.patch_shape)
        src_corners = (M_inv @ corners.T).T
        if perspective:   # the homogeneous divide
            src_corners = src_corners / src_corners[:, 3:4]
        src_corners = src_corners[:, :3]
        lo = np.floor(src_corners.min(0)).astype(np.int64)
        hi = np.ceil(src_corners.max(0) + 1).astype(np.int64) + 1
        return lo, hi

    def _sample_one(self):
        """Pick cube and matrix, check the corners, read a window of the
        static shape. Returns (window, t_window, M_inv, lo)."""
        ws = np.array(self.window_shape)
        while True:
            i = self.rng.choice(len(self.inputs), p=self._prios)
            src = self.inputs[i]
            tsrc = None if self.targets is None else self.targets[i]
            wk = dict(self.warp_kwargs)
            if not (self.warp_prob and self.rng.random() < self.warp_prob):
                wk["warp_amount"] = 0
            M = ct.get_warped_coord_transform(
                inp_src_shape=src.shape,
                patch_shape=self.patch_shape,
                aniso_factor=self.aniso_factor,
                rng=self.rng, **wk)
            M_inv = np.linalg.inv(M.astype(np.float64)).astype(np.float32)
            lo, hi = self.window_bounds(M_inv, bool(np.any(M[3, :3] != 0)))
            shape3 = np.array(src.shape[-3:])
            if np.any(lo < 0) or np.any(hi > shape3) \
                    or np.any(hi - lo > ws):
                self.n_failed += 1
                continue
            self.n_ok += 1
            cut = slice_3d(src, lo, hi, dtype=None)
            if cut.ndim == 3:
                cut = cut[None]  # (C=1, d, h, w)
            pad = [(0, 0)] + [(0, int(w - s))
                              for w, s in zip(ws, cut.shape[1:])]
            window = np.pad(cut, pad)  # (C, *window_shape)
            t_window = None
            if tsrc is not None:
                tcut = slice_3d(tsrc, lo, hi, dtype=None)
                if tcut.ndim == 3:
                    tcut = tcut[None]
                t_window = np.pad(tcut, pad)
                if self._targets_u8:
                    t_window = t_window.astype(np.uint8)
            return window, t_window, M_inv, lo.astype(np.float32)

    def sample_batch(self):
        """One batch's host draws and window reads: (windows (N, C,
        *window), t_windows or None, M_invs (N, 4, 4), los (N, 3))."""
        ws, tws, ms, los = [], [], [], []
        for _ in range(self.batch_size):
            w, tw, m, lo = self._sample_one()
            ws.append(w)
            ms.append(m)
            los.append(lo)
            if tw is not None:
                tws.append(tw)
        return (np.stack(ws), np.stack(tws) if tws else None,
                np.stack(ms), np.stack(los))

    # -- card side -----------------------------------------------------

    def to_device(self, host):
        """Copy ``sample_batch``'s arrays to the card through pinned
        memory, in their own dtypes."""
        pin = self.device.type == "cuda"

        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(a)
            if pin:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        return tuple(put(a) for a in host)

    def process(self, windows, t_windows, M_invs, los):
        """The warp of a batch on the card: (N, C, *window) windows in
        their own dtype to the yielded batch dict. Nothing here waits for
        the card, so the host reads the next batch's windows while the
        card works."""
        N, C = windows.shape[:2]

        def per_channel(t, c):   # (N, ...) -> (N * c, ...), sample-major
            return t[:, None].expand((N, c) + t.shape[1:]).reshape(
                (N * c,) + t.shape[1:])

        wf = windows.reshape((N * C,) + windows.shape[2:])
        inp = warp_ops.warp_interpolate_batch(
            wf, per_channel(M_invs, C), per_channel(los, C),
            self.patch_shape, discrete=False)
        inp = inp.view((N, C) + self.patch_shape).movedim(1, -1)
        if self.normalize is not None:
            mean, std = self.normalize
            inp = (inp - mean) / std
        if self.augment_fn is not None:
            inp = self.augment_fn(inp, self.generator)
        out = {"inp": inp.contiguous()}
        if t_windows is not None:
            Ct = t_windows.shape[1]
            tf = t_windows.reshape((N * Ct,) + t_windows.shape[2:])
            tgt = warp_ops.warp_interpolate_batch(
                tf, per_channel(M_invs, Ct), per_channel(los, Ct),
                self.patch_shape, discrete=True).view(
                    (N, Ct) + self.patch_shape)
            tgt = tgt[:, 0] if Ct == 1 else tgt.movedim(1, -1)
            out["target"] = tgt.long().contiguous()
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for _ in range(self.epoch_size):
            yield self.process(*self.to_device(self.sample_batch()))
