"""Data sources: host-side arrays and HDF5 datasets.

Counterpart of the JAX package's ``data/sources.py`` (reference
elektronn3/data/sources.py:16-125):

- ``DataSource``: the protocol (``shape``, ``dtype``, ``ndim`` and
  numpy-style ``__getitem__``).
- ``ArrayDataSource``: a numpy array in memory.
- ``HDF5DataSource``: opens the file on every access unless
  ``in_memory``, so that no HDF5 handle is open when loader workers
  start. ``h5py`` is imported when such a source is made, not when
  this module is imported: nothing else here needs it.
- ``slice_3d``: a bounds-checked (C,)D,H,W window.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("h5py is required for HDF5DataSource") from None
    return h5py


class DataSource:
    """Protocol for 3D/4D array-like sources: expected properties are
    ``shape``, ``dtype``, ``ndim`` and numpy-style ``__getitem__``."""

    def __getitem__(self, idx) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class ArrayDataSource(DataSource):
    """In-memory numpy-backed source (for tests and synthetic data)."""

    def __init__(self, data: np.ndarray):
        self._data = np.asarray(data)

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.size

    def __getitem__(self, idx):
        return self._data[idx]


class HDF5DataSource(DataSource):
    """h5py.Dataset wrapper safe for multi-process loading: the file is
    opened for each access and closed at once (unless ``in_memory``).
    Reference sources.py:22-62."""

    def __init__(self, fname: str, key: str, in_memory: bool = False):
        h5py = _h5py()
        self.fname = os.path.expanduser(fname)
        self.key = key
        self.in_memory = in_memory
        if self.in_memory:
            with h5py.File(self.fname, "r") as f:
                self._data = f[self.key][()]

    def __getattr__(self, attr: str) -> Any:
        if attr.startswith("_"):
            raise AttributeError(attr)
        if self.in_memory:
            return getattr(self._data, attr)
        with _h5py().File(self.fname, "r") as f:
            return getattr(f[self.key], attr)

    def __getitem__(self, idx) -> np.ndarray:
        if self.in_memory:
            return self._data[idx]
        with _h5py().File(self.fname, "r") as f:
            return f[self.key][idx]


def slice_3d(
        src: DataSource,
        coords_lo: Sequence[int],
        coords_hi: Sequence[int],
        dtype: Optional[type] = np.float32,
        prepend_empty_axis: bool = False,
        check_bounds: bool = True,
) -> np.ndarray:
    """Slice a (C,)D,H,W window out of a data source with bounds checks.

    ``dtype=None`` keeps the source's own dtype (uint8 EM raw, int16
    labels): the device loader ships windows so and casts on the card.
    Reference sources.py:65-125.
    """
    if check_bounds:
        if np.any(np.array(coords_lo) < 0):
            raise RuntimeError(
                f"coords_lo={coords_lo} exceeds src shape {src.shape[-3:]}")
        if np.any(np.array(coords_hi) > np.array(src.shape[-3:])):
            raise RuntimeError(
                f"coords_hi={coords_hi} exceeds src shape {src.shape[-3:]}")
    if src.ndim == 4:
        cut = src[:, coords_lo[0]:coords_hi[0], coords_lo[1]:coords_hi[1],
                  coords_lo[2]:coords_hi[2]]
    elif src.ndim == 3:
        cut = src[coords_lo[0]:coords_hi[0], coords_lo[1]:coords_hi[1],
                  coords_lo[2]:coords_hi[2]]
    else:
        raise ValueError(
            f"Expected src.ndim to be 3 or 4, but got {src.ndim} instead.")
    if prepend_empty_axis:
        cut = cut[None]
    if dtype is None:
        return np.asarray(cut)
    return cut.astype(dtype, copy=False)
