"""KNOSSOS datasets (optional dependency: ``knossos_utils``).

Counterpart of the JAX package's ``data/knossos.py`` (reference
elektronn3/data/knossos.py:13-167, KnossosRawData: random patches in the
modes 'in_memory', 'caching' and 'disk', with a free-memory check; and
elektronn3/data/knossos_labels.py:14-178, KnossosLabels: raw and label
patches from .k.zip annotations, movement-area bounds, voxel-count
weights, the merge of several annotations of one area).

``knossos_utils`` is imported when a dataset is made, not with this
module (:func:`_require_knossos`); ``KnossosDataset`` may be set to any
class with its methods (``load_raw``, ``boundary``,
``get_movement_area``, ``from_kzip_to_matrix``), such as an in-memory
stand-in. Offsets come from numpy's global random state, which the
port's ``DataLoader`` seeds per sample.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from elektronn3_tpu_torch.data import transforms
from elektronn3_tpu_torch.data.cnndata import Dataset, floatX
from elektronn3_tpu_torch.logger import logger

KnossosDataset = None   # knossos_utils.KnossosDataset once imported


def _require_knossos():
    """The ``KnossosDataset`` class: the one set on this module, else
    ``knossos_utils``'s (ImportError without it)."""
    global KnossosDataset
    if KnossosDataset is None:
        try:
            from knossos_utils import KnossosDataset as kd
        except ImportError as e:
            raise ImportError(
                "knossos_utils is required for KNOSSOS dataset support "
                "(pip install knossos_utils).") from e
        KnossosDataset = kd
    return KnossosDataset


def available_memory() -> int:
    """Bytes of memory free for a new allocation (psutil, else
    ``/proc/meminfo``)."""
    try:
        import psutil
        return int(psutil.virtual_memory().available)
    except ImportError:
        with open("/proc/meminfo") as f:
            kv = dict(line.split(":", 1) for line in f)
        return int(kv["MemAvailable"].strip().split()[0]) * 1024


class KnossosRawData(Dataset):
    """Random raw patches ``{"inp": (1, *patch_shape)}`` of a KNOSSOS
    dataset, in float32 after ``transform``.

    Modes (reference knossos.py:70-89):
    - 'in_memory': the bounds are loaded once (refused, unless
      ``disable_memory_check``, where they exceed 90% of free memory);
    - 'caching': each cached patch is served ``cache_reuses`` times
      before it is loaded anew, up to ``cache_size`` patches;
    - 'disk': every patch is read.
    """

    def __init__(self, conf_path: str, patch_shape: Sequence[int],
                 transform: Callable = transforms.Identity(),
                 bounds: Optional[Tuple[Sequence[int], Sequence[int]]] = None,
                 mag: int = 1, epoch_size: int = 100,
                 disable_memory_check: bool = False,
                 mode: str = "disk", cache_size: int = 50,
                 cache_reuses: int = 10, raw_dtype=np.uint8):
        kd_cls = _require_knossos()
        if mode not in ("in_memory", "caching", "disk"):
            raise ValueError(f"mode must be 'in_memory', 'caching' or "
                             f"'disk', got {mode!r}")
        self.conf_path = os.path.expanduser(conf_path)
        self.patch_shape = np.array(patch_shape)  # zyx
        self.transform = transform
        self.mag = mag
        self.epoch_size = epoch_size
        self.mode = mode
        self.cache_size = cache_size
        self.cache_reuses = cache_reuses
        self._cache: List[np.ndarray] = []
        self._cache_uses: List[int] = []
        self.kd = kd_cls(self.conf_path, show_progress=False)
        if bounds is None:
            bounds = (np.zeros(3, np.int64),
                      np.array(self.kd.boundary) // mag)
        self.bounds = (np.array(bounds[0]), np.array(bounds[1]))
        self.shape = self.bounds[1] - self.bounds[0]
        self._inmem = None
        if mode == "in_memory":
            if not disable_memory_check:
                self.memory_check()
            self._inmem = np.asarray(self.kd.load_raw(
                offset=tuple(self.bounds[0]), size=tuple(self.shape),
                mag=self.mag)).astype(raw_dtype)

    def memory_check(self) -> None:
        """RuntimeError where the bounds' voxels (a byte each) exceed 90%
        of free memory (reference knossos.py:141-154)."""
        free = available_memory()
        need = int(np.prod(self.shape))
        if need > 0.9 * free:
            raise RuntimeError(
                f"Dataset ({need / 1e9:.1f} GB) exceeds available memory "
                f"({free / 1e9:.1f} GB). Use mode='caching' or 'disk'.")

    def _random_offset(self) -> np.ndarray:
        hi = self.shape - self.patch_shape
        return self.bounds[0] + np.array(
            [np.random.randint(0, max(h, 1)) for h in hi])

    def _load_patch(self) -> np.ndarray:
        off = self._random_offset()
        if self._inmem is not None:
            rel = off - self.bounds[0]
            return np.asarray(self._inmem[tuple(
                slice(r, r + p) for r, p in zip(rel, self.patch_shape))])
        return np.asarray(self.kd.load_raw(
            offset=tuple(off), size=tuple(self.patch_shape), mag=self.mag))

    def __getitem__(self, index: int):
        if self.mode != "caching":
            patch = self._load_patch()
        elif len(self._cache) < self.cache_size:
            patch = self._load_patch()
            self._cache.append(patch)
            self._cache_uses.append(1)
        else:
            i = np.random.randint(0, len(self._cache))
            if self._cache_uses[i] >= self.cache_reuses:
                self._cache[i] = self._load_patch()
                self._cache_uses[i] = 0
            patch = self._cache[i]
            self._cache_uses[i] += 1
        inp, _ = self.transform(patch[None].astype(floatX), None)
        return {"inp": np.ascontiguousarray(inp, floatX)}

    def __len__(self):
        return self.epoch_size


class KnossosLabels(Dataset):
    """Raw and label patches ``{"inp": (1, *patch), "target": patch}``
    from a raw KNOSSOS dataset and the .k.zip annotations in
    ``dir_path_label`` (reference knossos_labels.py:14-178).

    The annotations are grouped by movement area; a group is drawn with
    a weight of its voxel count, a patch inside it uniformly, and its
    annotations' labels are summed, with voxels labelled by more than
    one of them set to background. Labels then lose ``label_offset``
    and, with ``label_order``, label ``label_order[i]`` becomes ``i``
    (every other label 0)."""

    def __init__(self, conf_path_label: str, conf_path_raw_data: str,
                 dir_path_label: str, patch_shape: Sequence[int],
                 transform: Callable = transforms.Identity(),
                 mag: int = 1, epoch_size: int = 100,
                 label_offset: int = 0,
                 label_order: Optional[Sequence[int]] = None,
                 raw_mode: str = "disk"):
        kd_cls = _require_knossos()
        self.kd_label = kd_cls(os.path.expanduser(conf_path_label),
                               show_progress=False)
        self.kd_raw = kd_cls(os.path.expanduser(conf_path_raw_data),
                             show_progress=False)
        self.dir_path_label = os.path.expanduser(dir_path_label)
        self.patch_shape = np.array(patch_shape)
        self.transform = transform
        self.mag = mag
        self.epoch_size = epoch_size
        self.label_offset = label_offset
        self.label_order = label_order
        self.raw_mode = raw_mode
        self.kzip_paths = sorted(
            glob.glob(os.path.join(self.dir_path_label, "*.k.zip")))
        if not self.kzip_paths:
            raise FileNotFoundError(
                f"No .k.zip files found in {self.dir_path_label}")
        groups: dict = {}
        for p in self.kzip_paths:
            lo, hi = self._get_file_bounds(p)
            groups.setdefault((tuple(lo), tuple(hi)), []).append(p)
        self._bounds = [(np.array(lo), np.array(hi)) for lo, hi in groups]
        self._group_paths = list(groups.values())
        sizes = [float(np.prod(hi - lo)) for lo, hi in self._bounds]
        self._weights = np.array(sizes) / np.sum(sizes)

    def _get_file_bounds(self, kzip_path) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) of one annotation's movement area at ``mag``
        (reference knossos_labels.py:85-108)."""
        area_min, area_sz = self.kd_label.get_movement_area(kzip_path)
        lo = np.array(area_min) // self.mag
        return lo, lo + np.array(area_sz) // self.mag

    def _get_data(self, kzip_paths, lo, size):
        """(raw, merged labels) of the patch at ``lo`` (reference
        knossos_labels.py:110-133)."""
        label_sum = nonbg = None
        for kzip_path in kzip_paths:
            label = np.asarray(self.kd_label.from_kzip_to_matrix(
                kzip_path, size=tuple(size), offset=tuple(lo),
                mag=self.mag, verbose=False, show_progress=False))
            if label_sum is None:
                label_sum = label.copy()
                nonbg = (label != 0).astype(np.int32)
            else:
                label_sum = label_sum + label
                nonbg += label != 0
        conflicts = nonbg > 1
        n_conflicts = int(conflicts.sum())
        if n_conflicts:
            logger.warning(
                f"Detected {n_conflicts} overlapping/contradicting label "
                f"voxels across {len(kzip_paths)} annotation files at "
                f"offset {tuple(lo)}; setting them to background.")
            label_sum[conflicts] = 0
        raw = self.kd_raw.load_raw(offset=tuple(lo), size=tuple(size),
                                   mag=self.mag)
        return raw, label_sum

    def __getitem__(self, index: int):
        fi = np.random.choice(len(self._group_paths), p=self._weights)
        lo, hi = self._bounds[fi]
        span = hi - lo - self.patch_shape
        off = lo + np.array([np.random.randint(0, max(s, 1)) for s in span])
        raw, label = self._get_data(self._group_paths[fi], off,
                                    self.patch_shape)
        label = np.asarray(label, np.int64) - self.label_offset
        if self.label_order is not None:
            remapped = np.zeros_like(label)
            for new, old in enumerate(self.label_order):
                remapped[label == old] = new
            label = remapped
        inp, label = self.transform(np.asarray(raw, floatX)[None], label)
        return {"inp": np.ascontiguousarray(inp, floatX),
                "target": np.ascontiguousarray(label)}

    def __len__(self):
        return self.epoch_size
