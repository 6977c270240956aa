"""Datasets for 2D and 3D dense-prediction training.

Counterpart of the JAX package's ``data/cnndata.py`` (reference
elektronn3/data/cnndata.py):

- PatchCreator        (:34-455)  the main 3D training dataset
- get_preview_batch   (:457-497)
- SimpleNeuroData2d   (:499-570)  z-slices of an HDF5 volume pair
- Segmentation2d      (:573-681)  image files and their label files
- Reconstruction2d    (:684-732)  image files, the target the input
- TripletData2d       (:735-813)  anchor, positive and negative views

``h5py`` and ``imageio`` are imported when a 2D dataset is made, not
with this module.

The datasets yield numpy dicts with channels-first arrays, as the
host-side transforms take them; the loader (``data/pipeline.py`` or
the ``Trainer``'s) batches them and moves them to channels-last.

Every random draw of a sample comes from the process's numpy random
state, the warp matrix's too (``coord_transforms._rng``; the JAX
``PatchCreator`` draws it from a fresh, unseeded generator), so a
loader that seeds that state per sample gets the same samples again.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from elektronn3_tpu_torch.data import coord_transforms
from elektronn3_tpu_torch.data import transforms
from elektronn3_tpu_torch.data.sources import (
    DataSource,
    HDF5DataSource,
    slice_3d,
)
from elektronn3_tpu_torch.logger import logger

floatX = np.float32


class _DefaultCubeMeta:
    """Infinite default meta (reference cnndata.py:30-31)."""

    def __getitem__(self, *args, **kwargs):
        return np.inf

    def __iter__(self):
        while True:
            yield np.inf


class Dataset:
    """Minimal map-style dataset protocol (``__getitem__`` +
    ``__len__``), compatible with the prefetch loader."""

    def __getitem__(self, index):  # pragma: no cover
        raise NotImplementedError

    def __len__(self):  # pragma: no cover
        raise NotImplementedError


class PatchCreator(Dataset):
    """3D training dataset: random-cube choice with priorities,
    coordinate-warped patch extraction with retry-on-OOB, transform
    pipeline, infinite random sampling with virtual ``epoch_size``.

    Full arg/behavior parity with the reference PatchCreator
    (cnndata.py:34-455). Samples are dicts with 'inp' (C, D, H, W)
    float32, optionally 'target' (target_dtype), 'cube_meta', 'fname'.
    """

    def __init__(
            self,
            input_sources: List[Tuple[str, str]],
            patch_shape: Sequence[int],
            target_sources: Optional[List[Tuple[str, str]]] = None,
            offset: Sequence[int] = (0, 0, 0),
            cube_prios: Optional[Sequence[float]] = None,
            aniso_factor: int = 2,
            target_discrete_ix: Optional[List[int]] = None,
            input_discrete_ix: Optional[List[int]] = None,
            target_dtype: np.dtype = np.int64,
            train: bool = True,
            warp_prob: Union[bool, float] = False,
            warp_kwargs: Optional[Dict[str, Any]] = None,
            epoch_size: int = 100,
            transform: Callable = transforms.Identity(),
            in_memory: bool = False,
            cube_meta=_DefaultCubeMeta(),
    ):
        if target_sources is not None and \
                len(input_sources) != len(target_sources):
            raise ValueError(
                "If target_sources is not None, input_sources and "
                "target_sources must be lists of same length.")
        if not train and warp_prob:
            logger.warning(
                "Augmentations should not be used on validation data.")

        self.train = train
        self.warp_prob = warp_prob
        self.warp_kwargs = warp_kwargs if warp_kwargs is not None else {}
        self.input_sources = input_sources
        self.target_sources = target_sources
        self.cube_meta = cube_meta
        self.cube_prios = cube_prios
        self.aniso_factor = aniso_factor
        self.target_discrete_ix = target_discrete_ix
        self.input_discrete_ix = input_discrete_ix
        self.epoch_size = epoch_size
        self._orig_epoch_size = epoch_size
        self.in_memory = in_memory

        self.patch_shape = np.array(patch_shape, dtype=np.int64)
        self.ndim = self.patch_shape.ndim
        self.offset = np.array(offset)
        self.target_patch_shape = self.patch_shape - self.offset * 2
        self._target_dtype = target_dtype
        self.transform = transform

        self.n_labelled_pixels = 0
        self.inputs: List[DataSource] = []
        self.targets: Optional[List[DataSource]] = []
        self.load_data()

        self.n_successful_warp = 0
        self.n_failed_warp = 0
        self._failed_warp_warned = False

    def __getitem__(self, index: int) -> Dict[str, Any]:
        # The index is ignored; samples are always random
        # (reference cnndata.py:212-214).
        return self._get_random_sample()

    def _get_random_sample(self) -> Dict[str, Any]:
        input_src, target_src, i = self._getcube()
        warp_prob = self.warp_prob
        while True:
            try:
                inp, target = self.warp_cut(
                    input_src, target_src, warp_prob, self.warp_kwargs)
                if target is not None:
                    target = target.astype(self._target_dtype)
            except coord_transforms.WarpingOOBError as e:
                # Keep warping on the retry so warp_prob stays honest
                # (reference cnndata.py:224-239).
                warp_prob = 1 if warp_prob else 0
                self.n_failed_warp += 1
                if (self.n_failed_warp > 20
                        and self.n_failed_warp > 8 * self.n_successful_warp
                        and not self._failed_warp_warned):
                    ratio = self.n_failed_warp / (
                        self.n_failed_warp + self.n_successful_warp)
                    logger.warning(
                        f"{int(round(100 * ratio))}% of warping attempts are "
                        "failing. Consider lowering your input patch shapes "
                        "or warp_kwargs['warp_amount'].")
                    self._failed_warp_warned = True
                continue
            except coord_transforms.WarpingSanityError:
                logger.exception(
                    "Invalid coordinate values while warping. Retrying...")
                continue
            self.n_successful_warp += 1
            try:
                inp, target = self.transform(inp, target)
            except transforms._DropSample:
                logger.debug("Sample dropped.")
                continue
            break

        fname = os.path.basename(getattr(self.inputs[i], "fname", f"cube{i}"))
        sample = {
            "inp": np.ascontiguousarray(inp, dtype=floatX),
            "cube_meta": np.asarray(self.cube_meta[i]),
            "fname": fname,
        }
        if target is not None:
            sample["target"] = np.ascontiguousarray(target)
        return sample

    def __len__(self) -> int:
        return self.epoch_size

    @property
    def warp_stats(self) -> str:
        total = self.n_failed_warp + self.n_successful_warp
        quota = self.n_successful_warp / total if total else 0.0
        return (f"Warp stats: successful: {self.n_successful_warp}, "
                f"failed {self.n_failed_warp}, quota: {quota:.1f}")

    def warp_cut(self, inp_src, target_src, warp_prob, warp_kwargs):
        """Cut a (possibly warped) patch pair; see reference
        cnndata.py:283-361."""
        if warp_prob is True or warp_prob == 1:
            do_warp = True
        elif 0 < warp_prob < 1:
            do_warp = np.random.rand() < warp_prob
        else:
            do_warp = False
        if not do_warp:
            warp_kwargs = dict(warp_kwargs)
            warp_kwargs["warp_amount"] = 0

        if target_src is None:
            target_src_shape = None
            target_patch_shape = None
        else:
            target_src_shape = target_src.shape
            target_patch_shape = self.target_patch_shape

        # No rng: the matrix's generator is seeded from numpy's global
        # state, like every other draw of the sample.
        M = coord_transforms.get_warped_coord_transform(
            inp_src_shape=inp_src.shape,
            patch_shape=self.patch_shape,
            aniso_factor=self.aniso_factor,
            target_src_shape=target_src_shape,
            target_patch_shape=target_patch_shape,
            **warp_kwargs)
        return coord_transforms.warp_slice(
            inp_src=inp_src,
            patch_shape=self.patch_shape,
            M=M,
            target_src=target_src,
            target_patch_shape=target_patch_shape,
            target_discrete_ix=self.target_discrete_ix,
            input_discrete_ix=self.input_discrete_ix)

    def _getcube(self):
        """Priority-weighted random cube choice (reference
        cnndata.py:363-374)."""
        prios = np.asarray(self.cube_prios, np.float64)
        i = np.random.choice(np.arange(len(prios)), p=prios / prios.sum())
        inp_source = self.inputs[i]
        target_source = None if self.targets is None else self.targets[i]
        return inp_source, target_source, i

    def load_data(self) -> None:
        if len(self.inputs) == 0 and (self.targets is not None
                                      and len(self.targets) == 0):
            inp_files, target_files = self.open_files()
            self.inputs.extend(inp_files)
            if target_files is None:
                self.targets = None
            else:
                self.targets.extend(target_files)
        else:
            logger.info("Using directly specified data sources.")
        if self.cube_prios is None:
            if self.targets is None:
                prios = [inp.size for inp in self.inputs]
            else:
                prios = [t.size for t in self.targets]
            self.cube_prios = np.array(prios, np.float32) / np.sum(prios)
        logger.debug(f"cube_prios = {self.cube_prios}")

    def check_files(self) -> None:
        """Reference cnndata.py:399-423 (incl. neuro_data hint)."""
        notfound = False
        hint = False
        fullpaths = [f for f, _ in self.input_sources]
        if self.target_sources is not None:
            fullpaths.extend(f for f, _ in self.target_sources)
        for p in fullpaths:
            if not os.path.exists(p):
                print(f"{p} not found.")
                notfound = True
                if "neuro_data_cdhw" in p:
                    hint = True
        if hint:
            print("\nIt looks like you are referencing the neuro_data_cdhw "
                  "dataset.\nTo install it to the default location, run:\n"
                  "  $ wget https://github.com/ELEKTRONN/elektronn.github.io/"
                  "releases/download/neuro_data_cdhw/neuro_data_cdhw.zip\n"
                  "  $ unzip neuro_data_cdhw.zip -d ~/neuro_data_cdhw")
        if notfound:
            print("\nPlease fetch the necessary dataset and/or change the "
                  "relevant file paths in the network config.")
            sys.stdout.flush()
            sys.exit(1)

    def open_files(self):
        self.check_files()
        inp_sources, target_sources = [], []
        modestr = "Training" if self.train else "Validation"
        memstr = " (in memory)" if self.in_memory else ""
        logger.info(f"\n{modestr} data set{memstr}:")
        if self.target_sources is None:
            for (fname, key), meta in zip(self.input_sources, self.cube_meta):
                src = HDF5DataSource(fname=fname, key=key,
                                     in_memory=self.in_memory)
                logger.info(f"  input: {fname}[{key}]: {src.shape} "
                            f"({src.dtype})")
                inp_sources.append(src)
            target_sources = None
        else:
            for (fname, key), (tfname, tkey), meta in zip(
                    self.input_sources, self.target_sources, self.cube_meta):
                src = HDF5DataSource(fname=fname, key=key,
                                     in_memory=self.in_memory)
                tsrc = HDF5DataSource(fname=tfname, key=tkey,
                                      in_memory=self.in_memory)
                logger.info(f"  input: {fname}[{key}]: {src.shape} "
                            f"({src.dtype})")
                logger.info(f"  with target: {tfname}[{tkey}]: {tsrc.shape} "
                            f"({tsrc.dtype})")
                inp_sources.append(src)
                target_sources.append(tsrc)
        return inp_sources, target_sources

    def set_offset(self, offset: Sequence[int]) -> None:
        self.offset = np.array(offset)
        self.target_patch_shape = self.patch_shape - self.offset * 2


def get_preview_batch(
        h5data: Tuple[str, str],
        preview_shape: Optional[Tuple[int, ...]] = None,
        transform: Optional[Callable] = None,
        in_memory: bool = False,
        dim: Optional[int] = None,
) -> np.ndarray:
    """Load a center crop of an HDF5 volume as a (N, C, ...) preview
    batch. Reference cnndata.py:457-497."""
    import h5py
    fname, key = h5data
    with h5py.File(os.path.expanduser(fname), "r") as f:
        inp_h5 = f[key][()] if in_memory else f[key]
        if dim is None:
            if preview_shape is None:
                raise ValueError(
                    "At least one of preview_shape, dim must be defined.")
            dim = len(preview_shape)
        inp_shape = np.array(inp_h5.shape[-dim:])
        if preview_shape is None:
            inp_lo = np.zeros_like(inp_shape)
            inp_hi = inp_shape
        else:
            halfshape = np.array(preview_shape) // 2
            inp_center = inp_shape // 2
            inp_lo = inp_center - halfshape
            inp_hi = inp_center + halfshape
            if np.any(inp_center < halfshape):
                raise ValueError(
                    "preview_shape is too big for shape of input source. "
                    f"Requested {preview_shape}, but can only deliver "
                    f"{tuple(inp_shape)}.")
        if dim == 2:
            # Take a (H, W) center crop of the volume's middle z-slice.
            if inp_h5.ndim >= 3:
                mid_z = inp_h5.shape[-3] // 2
                arr = np.asarray(inp_h5[..., mid_z,
                                        inp_lo[0]:inp_hi[0],
                                        inp_lo[1]:inp_hi[1]])
            else:
                arr = np.asarray(inp_h5[inp_lo[0]:inp_hi[0],
                                        inp_lo[1]:inp_hi[1]])
            inp_np = arr[None].astype(floatX)
        else:
            inp_np = slice_3d(inp_h5, inp_lo, inp_hi,
                              prepend_empty_axis=True)
    if inp_np.ndim == dim + 1:
        inp_np = inp_np[:, None]  # add C dim
    if transform is not None:
        for n in range(inp_np.shape[0]):
            inp_np[n], _ = transform(inp_np[n], None)
    return inp_np.astype(floatX)


class SimpleNeuroData2d:
    """The z-slices of a 3D HDF5 volume pair, in memory: slices before
    z = 90 for training, the rest for validation (reference
    cnndata.py:499-570). ``inp`` is (D, H, W) or (C, D, H, W), the
    target (D, H, W) (or its first channel); a sample is the slice's
    ``transform(inp, target)``."""

    def __init__(self, inp_path: str, target_path: str,
                 inp_key: str = "raw", target_key: str = "lab",
                 train: bool = True, inp_dtype=np.float32,
                 target_dtype=np.int64,
                 transform: Callable = transforms.Identity(),
                 out_channels: Optional[int] = None):
        import h5py
        self.transform = transform
        self.out_channels = out_channels
        cut_z = 90  # the training/validation plane (reference :521)
        with h5py.File(os.path.expanduser(inp_path), "r") as f:
            inp = f[inp_key][()].astype(inp_dtype)
        with h5py.File(os.path.expanduser(target_path), "r") as f:
            target = f[target_key][()].astype(target_dtype)
        if inp.ndim == 3:
            inp = inp[None]
        if target.ndim == 4:
            target = target[0]
        zs = slice(None, cut_z) if train else slice(cut_z, None)
        self.inp = inp[:, zs]
        self.target = target[zs]
        self.close_files = lambda: None

    def __getitem__(self, index):
        inp, target = self.transform(self.inp[:, index], self.target[index])
        return {"inp": np.ascontiguousarray(inp, floatX),
                "target": np.ascontiguousarray(target)}

    def __len__(self):
        return self.target.shape[0]


def _load_image_file(path) -> np.ndarray:
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(os.path.expanduser(str(path))))


def _image_chw(path, dtype) -> np.ndarray:
    """An image file as (C, H, W): a gray image gets a channel axis, an
    (H, W, C) one is moved to channels first."""
    img = _load_image_file(path).astype(dtype)
    return img[None] if img.ndim == 2 else np.moveaxis(img, -1, 0)


def _transformed(transform, inp, target):
    """``transform(inp, target)``, drawn again while it drops the sample
    (``transforms._DropSample``)."""
    while True:
        try:
            return transform(inp, target)
        except transforms._DropSample:
            continue


class Segmentation2d:
    """Images and their label images from lists of file paths (png, tif
    and what else ``imageio`` reads), in memory (reference
    cnndata.py:573-681). An input path may be a list of single-channel
    layers, stacked as channels; an (H, W, C) image becomes (C, H, W).
    A label image's first channel is taken; ``invert_targets`` makes 0
    the foreground. ``offset`` (o_h, o_w) crops the target of a
    valid-conv model after the transform; ``epoch_multiplier`` repeats
    the list."""

    def __init__(self, inp_paths: Sequence, target_paths: Sequence,
                 transform: Callable = transforms.Identity(),
                 offset: Sequence[int] = (0, 0), inp_dtype=np.float32,
                 target_dtype=np.int64, invert_targets: bool = False,
                 out_channels: Optional[int] = None,
                 epoch_multiplier: int = 1):
        if len(inp_paths) != len(target_paths):
            raise ValueError("one target path per input path")
        self.inp_paths = list(inp_paths)
        self.target_paths = list(target_paths)
        self.transform = transform
        self.offset = np.asarray(offset)
        self.inp_dtype = inp_dtype
        self.target_dtype = target_dtype
        self.invert_targets = invert_targets
        self.out_channels = out_channels
        self.epoch_multiplier = epoch_multiplier
        self.inps = []
        self.targets = []
        for ip, tp in zip(self.inp_paths, self.target_paths):
            if isinstance(ip, (list, tuple)):
                layers = [_load_image_file(p).astype(inp_dtype) for p in ip]
                inp = np.stack([a if a.ndim == 2 else a[..., 0]
                                for a in layers])
            else:
                inp = _image_chw(ip, inp_dtype)
            target = _load_image_file(tp).astype(target_dtype)
            if target.ndim == 3:
                target = target[..., 0]
            if invert_targets:
                target = (target == 0).astype(target_dtype)
            self.inps.append(inp)
            self.targets.append(target)

    def __getitem__(self, index):
        index %= len(self.inps)
        inp, target = _transformed(self.transform, self.inps[index],
                                   self.targets[index])
        if np.any(self.offset > 0):
            o = self.offset
            target = target[..., o[0]:target.shape[-2] - o[0],
                            o[1]:target.shape[-1] - o[1]]
        return {"inp": np.ascontiguousarray(inp, floatX),
                "target": np.ascontiguousarray(target, self.target_dtype),
                "fname": str(self.inp_paths[index])}

    def __len__(self):
        return len(self.inps) * self.epoch_multiplier


class Reconstruction2d:
    """Image files as inputs and targets, for autoencoders: the target
    is a copy of the transformed input (reference cnndata.py:684-732)."""

    def __init__(self, inp_paths: Sequence,
                 transform: Callable = transforms.Identity(),
                 inp_dtype=np.float32, epoch_multiplier: int = 1):
        self.inp_paths = list(inp_paths)
        self.transform = transform
        self.inp_dtype = inp_dtype
        self.epoch_multiplier = epoch_multiplier
        self.inps = [_image_chw(p, inp_dtype) for p in self.inp_paths]

    def __getitem__(self, index):
        inp, _ = self.transform(self.inps[index % len(self.inps)], None)
        inp = np.ascontiguousarray(inp, floatX)
        return {"inp": inp, "target": inp.copy()}

    def __len__(self):
        return len(self.inps) * self.epoch_multiplier


class TripletData2d(Segmentation2d):
    """Triplets of :class:`Segmentation2d`'s images (reference
    cnndata.py:735-813): the anchor and the positive are two draws of
    ``transform`` on one image, the negative one of another image,
    chosen uniformly from ``rng`` (a numpy ``Generator``; a fresh one
    seeded 0 if None), where JAX draws from numpy's global state. The
    transforms draw from numpy's global state, as everywhere."""

    def __init__(self, *args, rng: Optional[np.random.Generator] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if len(self.inps) < 2:
            raise ValueError("TripletData2d needs at least two images")
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def __getitem__(self, index):
        index %= len(self.inps)
        neg_index = int(self.rng.integers(0, len(self.inps) - 1))
        if neg_index >= index:
            neg_index += 1

        def aug(i):
            a, _ = _transformed(self.transform, self.inps[i], None)
            return np.ascontiguousarray(a, floatX)

        return {"anchor": aug(index), "pos": aug(index),
                "neg": aug(neg_index)}


def calculate_class_weights(targets, mode: str = "inverse"):
    # Re-exported from data.utils for interface parity with the
    # reference data/__init__.py.
    from elektronn3_tpu_torch.data.utils import calculate_class_weights as ccw
    return ccw(targets, mode)
