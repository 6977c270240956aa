"""Transformations (data augmentation, normalization) for dense targets.

Counterpart of the JAX package's ``data/transforms/transforms.py``:
torchvision-style but ``(inp, target)``-pair based, numpy-backed
host-side transforms (reference elektronn3/data/transforms/
transforms.py, class list :50-1156).

Important conventions (same as reference, transforms.py:18-37):
- All transforms are callables ``t(inp, target) -> (inp, target)``.
- ``inp``: float ndarray ``(C, [D,] H, W)`` (channels-first on host;
  the dataset layer converts to channels-last before device transfer).
- ``target``: int ndarray ``([C,] [D,] H, W)`` or None.
- Geometric transforms apply identically to inp and target; photometric
  transforms only touch inp.
- Every random draw comes from the process's numpy random state
  (``np.random.rand``, ``normal``, ``randint``, ``uniform``), in the
  JAX package's order, or from a sampler's own generator where one was
  given: a loader that seeds that state per sample repeats its samples.

The photometric augmentations also run on the card, on whole batches
(``elektronn3_tpu_torch.data.warp``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from elektronn3_tpu_torch import floatX
from elektronn3_tpu_torch.data.transforms.random import (
    HalfNormal,
    RandomSampler,
)

try:
    import scipy.ndimage as ndimage
except ImportError:  # pragma: no cover
    ndimage = None


class _DropSample(Exception):
    """Sample dropped by a transform (e.g. DropIfTooMuchBG); the dataset
    retries with a new sample. Reference transforms.py:40-47."""


class Identity:
    def __call__(self, inp, target):
        return inp, target


class Compose:
    """Composes several transforms together. Reference transforms.py:50-76."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, inp, target):
        for t in self.transforms:
            inp, target = t(inp, target)
        return inp, target

    def __repr__(self):
        lines = [f"    {t}" for t in self.transforms]
        return "Compose([\n" + "\n".join(lines) + "\n])"


class Lambda:
    """Wraps a function ``f(inp, target) -> (inp, target)``.
    Reference transforms.py:79-106."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, inp, target):
        return self.func(inp, target)


class RandomSlicewiseTransform:
    """Apply a 2D transform to each z-slice of 3D data independently with
    probability ``prob`` per slice — e.g. 'missing-section' augmentation
    when wrapping a destructive transform. Reference transforms.py:109-161."""

    def __init__(self, transform: Callable, prob: float = 0.1,
                 inplace: bool = True):
        self.transform = transform
        self.prob = prob

    def __call__(self, inp, target):
        assert inp.ndim == 4, "RandomSlicewiseTransform expects (C, D, H, W)"
        inp = inp.copy()
        target = None if target is None else target.copy()
        D = inp.shape[1]
        for z in range(D):
            if np.random.rand() < self.prob:
                tslice = None if target is None else target[..., z, :, :]
                islice, tslice = self.transform(inp[:, z], tslice)
                inp[:, z] = islice
                if target is not None and tslice is not None:
                    target[..., z, :, :] = tslice
        return inp, target


class DropIfTooMuchBG:
    """Raise _DropSample (→ dataset retries) if more than ``threshold``
    fraction of the target is background class ``bg_id``.
    Reference transforms.py:164-181."""

    def __init__(self, bg_id: int = 0, threshold: float = 0.9):
        self.bg_id = bg_id
        self.threshold = threshold

    def __call__(self, inp, target):
        if target is None:
            return inp, target
        if np.mean(target == self.bg_id) > self.threshold:
            if np.random.rand() > 0.05:  # escape hatch (reference :179)
                raise _DropSample
        return inp, target


class RemapTargetIDs:
    """Remap label IDs (e.g. [1, 3, 7] -> [0, 1, 2]). If ``ids`` is a
    dict, use it as an explicit mapping; unmapped IDs become -1 (ignore).
    Reference transforms.py:184-231."""

    def __init__(self, ids: Union[Sequence[int], dict], reverse: bool = False):
        self.ids = ids
        self.reverse = reverse

    def __call__(self, inp, target):
        if target is None:
            return inp, target
        target = np.asarray(target)
        remapped = np.full_like(target, -1)
        if isinstance(self.ids, dict):
            mapping = self.ids.items()
        else:
            mapping = ((old, new) for new, old in enumerate(self.ids))
        for old, new in mapping:
            if self.reverse:
                old, new = new, old
            remapped[target == old] = new
        return inp, remapped


class SmoothOneHotTarget:
    """Convert dense targets to (smoothed) one-hot encoding.
    Reference transforms.py:234-262."""

    def __init__(self, out_channels: int, smooth_eps: float = 0.0):
        assert 0 <= smooth_eps < 0.5
        self.out_channels = out_channels
        self.smooth_eps = smooth_eps

    def __call__(self, inp, target):
        if target is None:
            return inp, target
        eye = np.eye(self.out_channels, dtype=floatX)
        if self.smooth_eps > 0.0:
            eye = eye * (1 - self.smooth_eps) \
                + self.smooth_eps / self.out_channels
        onehot = eye[target.astype(np.int64)]  # (..., C)
        onehot = np.moveaxis(onehot, -1, 0)  # (C, ...)
        if self.smooth_eps == 0.0:
            assert np.all(onehot.argmax(0) == target)
        return inp, onehot.astype(floatX)


class DistanceTransformTarget:
    """Converts binary segmentation targets to (signed) euclidean distance
    transforms, optionally scaled/normalized or as a vector field.
    Reference transforms.py:265-342."""

    def __init__(self, scale: Optional[float] = 50.0,
                 normalize_fn: Optional[Callable] = np.tanh,
                 inverted: bool = True, signed: bool = True,
                 vector: bool = False):
        self.scale = scale
        self.normalize_fn = normalize_fn
        self.inverted = inverted
        self.signed = signed
        self.vector = vector

    def edt(self, target: np.ndarray) -> np.ndarray:
        sh = target.shape
        if self.vector:
            if target.ndim == 2:
                coords = np.mgrid[:sh[0], :sh[1]]
            elif target.ndim == 3:
                coords = np.mgrid[:sh[0], :sh[1], :sh[2]]
            else:
                raise RuntimeError(f"Unexpected target shape {sh}")
            inds = ndimage.distance_transform_edt(
                target, return_distances=False, return_indices=True)
            dist = (inds - coords).astype(floatX)
            if self.scale is not None:
                dist /= self.scale
            return dist
        dist = ndimage.distance_transform_edt(target).astype(floatX)
        if self.scale is not None:
            dist /= self.scale
        return dist

    def __call__(self, inp, target):
        if target is None:
            return inp, target
        if ndimage is None:
            raise ImportError("scipy is required for DistanceTransformTarget")
        if self.inverted:
            target = 1 - target
        dist = self.edt(target)
        if self.signed and not self.vector:
            dist = dist - self.edt(1 - target)
        if self.normalize_fn is not None:
            dist = self.normalize_fn(dist)
        if dist.ndim == target.ndim:
            dist = dist[None]
        return inp, dist.astype(floatX)


class Normalize:
    """Per-channel normalization ``(x - mean) / std``.
    Reference transforms.py:345-402."""

    def __init__(self, mean: Union[float, Sequence[float]],
                 std: Union[float, Sequence[float]],
                 inplace: bool = False):
        self.mean = np.atleast_1d(np.asarray(mean, floatX))
        self.std = np.atleast_1d(np.asarray(std, floatX))

    def __call__(self, inp, target):
        inp = np.asarray(inp, dtype=floatX)
        normalized = np.empty_like(inp)
        if not inp.shape[0] == self.mean.shape[0] == self.std.shape[0]:
            raise ValueError(
                f"mean ({self.mean.shape[0]}) and std ({self.std.shape[0]}) "
                f"must have the same length as the C axis (number of "
                f"channels) of the input ({inp.shape[0]}).")
        for c in range(inp.shape[0]):
            normalized[c] = (inp[c] - self.mean[c]) / self.std[c]
        return normalized, target


class RandomBrightnessContrast:
    """Randomly augment brightness (additive) + contrast (multiplicative
    around the mean). Reference transforms.py:405-454."""

    def __init__(self, brightness_std: float = 0.5, contrast_std: float = 0.5,
                 channels: Optional[Sequence[int]] = None, prob: float = 1.0):
        self.brightness_std = brightness_std
        self.contrast_std = contrast_std
        self.channels = channels
        self.prob = prob

    def __call__(self, inp, target):
        if np.random.rand() > self.prob:
            return inp, target
        inp = np.array(inp, dtype=floatX, copy=True)
        channels = range(inp.shape[0]) if self.channels is None else self.channels
        for c in channels:
            a = 1 + np.random.normal(0, self.contrast_std)
            b = np.random.normal(0, self.brightness_std)
            m = inp[c].mean()
            inp[c] = a * (inp[c] - m) + m + b
        return inp, target


def _rescale_intensity(x: np.ndarray, out_range) -> np.ndarray:
    """skimage.exposure.rescale_intensity with in_range='image':
    linearly map [x.min(), x.max()] onto ``out_range``. Constant images
    map to the lower output bound (matching skimage's 0-division -> 0
    then scale behavior is NaN; we guard to the lower bound instead)."""
    lo, hi = float(x.min()), float(x.max())
    omin, omax = out_range
    if hi <= lo:
        return np.full_like(x, omin)
    return (x - lo) / (hi - lo) * (omax - omin) + omin


class RandomGammaCorrection:
    """Random per-channel gamma correction.

    Numeric parity with reference transforms.py:457-509: per channel,
    ``gamma ~ clip(Normal(mean=1, gamma_std), gamma_min, inf)``; the
    channel is rescaled to (0, 1), raised to ``gamma``
    (skimage.exposure.adjust_gamma) and rescaled back to its original
    intensity range.
    """

    def __init__(self, gamma_std: float = 0.5, gamma_min: float = 0.25,
                 channels: Optional[Sequence[int]] = None, prob: float = 1.0):
        if not channels:
            channels = None
        self.channels = channels
        self.prob = prob
        self.gamma_std = gamma_std
        self.gamma_min = gamma_min

    def __call__(self, inp, target):
        if np.random.rand() > self.prob:
            return inp, target
        inp = np.array(inp, dtype=floatX, copy=True)
        channels = range(inp.shape[0]) if self.channels is None else self.channels
        for c in channels:
            # reference gamma_generator: Normal(mean=1, sigma=gamma_std,
            # bounds=(gamma_min, inf)) — a clipped draw, not lognormal.
            gamma = np.clip(np.random.normal(1.0, self.gamma_std),
                            self.gamma_min, np.inf)
            x = inp[c]
            orig = (x.min(), x.max())
            x01 = _rescale_intensity(x, (0.0, 1.0))
            x01 = x01 ** gamma  # skimage.exposure.adjust_gamma(, gamma)
            inp[c] = _rescale_intensity(x01, orig)
        return inp, target


class RandomGrayAugment:
    """ELEKTRONN2-style gray value augmentation.

    Numeric parity with reference transforms.py:512-575: per channel,
    rescale to [0, 1]; then with per-channel draws
    ``alpha = 1 + (U-0.5)*0.3`` (contrast), ``beta = (U-0.5)*0.3``
    (brightness) and ``gamma = 2**U[-1,1]``, compute
    ``clip(x*alpha + beta, 0, 1) ** gamma`` and rescale the result back
    to the channel's original intensity range.
    """

    def __init__(self, channels: Optional[Sequence[int]] = None,
                 prob: float = 1.0):
        if not channels:
            channels = None
        self.channels = channels
        self.prob = prob

    def __call__(self, inp, target):
        if np.random.rand() > self.prob:
            return inp, target
        inp = np.array(inp, dtype=floatX, copy=True)
        channels = list(range(inp.shape[0])) if self.channels is None \
            else list(self.channels)
        nc = len(channels)
        origs = [(inp[c].min(), inp[c].max()) for c in channels]
        for c in channels:
            inp[c] = _rescale_intensity(inp[c], (0.0, 1.0))
        # Draw order matches the reference exactly (three rand(nc) calls)
        alpha = 1 + (np.random.rand(nc) - 0.5) * 0.3
        beta = (np.random.rand(nc) - 0.5) * 0.3
        gamma = 2.0 ** (np.random.rand(nc) * 2 - 1)
        for i, c in enumerate(channels):
            x = np.clip(inp[c] * alpha[i] + beta[i], 0, 1) ** gamma[i]
            inp[c] = _rescale_intensity(x, origs[i])
        return inp, target


class RandomGaussianBlur:
    """Random Gaussian blur with anisotropy-aware sigma (z sigma divided
    by ``aniso_factor``). Reference transforms.py:578-630."""

    def __init__(self, distsigma: Union[RandomSampler, float] = 1.0,
                 prob: float = 1.0, aniso_factor: Optional[float] = None):
        self.distsigma = distsigma if isinstance(distsigma, RandomSampler) \
            else HalfNormal(sigma=float(distsigma))
        self.prob = prob
        self.aniso_factor = aniso_factor if aniso_factor else 1.0

    def __call__(self, inp, target):
        if ndimage is None:
            raise ImportError("scipy is required for RandomGaussianBlur")
        if np.random.rand() > self.prob:
            return inp, target
        inp = np.array(inp, dtype=floatX, copy=True)
        spatial_ndim = inp.ndim - 1
        for c in range(inp.shape[0]):
            sigma = np.atleast_1d(self.distsigma(spatial_ndim)).astype(float)
            if sigma.shape[0] == 1:
                sigma = np.repeat(sigma, spatial_ndim)
            if spatial_ndim == 3:
                sigma[0] /= self.aniso_factor
            inp[c] = ndimage.gaussian_filter(inp[c], sigma)
        return inp, target


class AdditiveGaussianNoise:
    """Additive i.i.d. Gaussian noise. Reference transforms.py:670-708."""

    def __init__(self, sigma: float = 0.1,
                 channels: Optional[Sequence[int]] = None, prob: float = 1.0):
        self.sigma = sigma
        self.channels = channels
        self.prob = prob

    def __call__(self, inp, target):
        if np.random.rand() > self.prob:
            return inp, target
        inp = np.array(inp, dtype=floatX, copy=True)
        channels = range(inp.shape[0]) if self.channels is None else self.channels
        for c in channels:
            inp[c] = inp[c] + np.random.normal(0, self.sigma, inp[c].shape)
        return inp, target


class RandomCrop:
    """Random spatial crop to ``size`` (applied to inp and target
    identically). Reference transforms.py:711-777."""

    def __init__(self, size: Sequence[int]):
        self.size = np.asarray(size, np.int64)

    def __call__(self, inp, target):
        ndim_spatial = len(self.size)
        img_shape = np.asarray(inp.shape[-ndim_spatial:])
        assert np.all(self.size <= img_shape), \
            f"crop size {self.size} exceeds image shape {img_shape}"
        coords_lo = np.array([
            np.random.randint(0, img_shape[i] - self.size[i] + 1)
            for i in range(ndim_spatial)])
        coords_hi = coords_lo + self.size
        slices = tuple(slice(lo, hi) for lo, hi in zip(coords_lo, coords_hi))
        full = (Ellipsis,) + slices
        inp = inp[full]
        if target is not None:
            target = target[full]
        return inp, target


class ElasticTransform:
    """Elastic deformation (Simard et al. 2003): random smoothed
    displacement field applied to inp and target; discrete targets use
    order-0 interpolation. 2D and 3D. Supports centered target offsets
    when target is smaller than inp. Reference transforms.py:780-961."""

    def __init__(self, sigma: float = 4, alpha: float = 40, prob: float = 0.25,
                 target_discrete_ix: Optional[Sequence[int]] = None,
                 aniso_factor: float = 1.0):
        self.sigma = sigma
        self.alpha = alpha
        self.prob = prob
        self.target_discrete_ix = target_discrete_ix
        self.aniso_factor = aniso_factor

    def _displacement(self, shape):
        disp = []
        for i, s in enumerate(shape):
            d = ndimage.gaussian_filter(
                (np.random.rand(*shape) * 2 - 1), self.sigma,
                mode="constant", cval=0) * self.alpha
            if i == 0 and len(shape) == 3 and self.aniso_factor != 1:
                d = d / self.aniso_factor
            disp.append(d)
        return disp

    def __call__(self, inp, target):
        if ndimage is None:
            raise ImportError("scipy is required for ElasticTransform")
        if np.random.rand() > self.prob:
            return inp, target
        spatial = inp.shape[1:]
        ndim = len(spatial)
        grids = np.meshgrid(*[np.arange(s) for s in spatial], indexing="ij")
        disp = self._displacement(spatial)
        coords = [g + d for g, d in zip(grids, disp)]

        out_inp = np.empty_like(inp)
        for c in range(inp.shape[0]):
            out_inp[c] = ndimage.map_coordinates(
                inp[c], coords, order=1, mode="reflect")

        if target is None:
            return out_inp, target

        t = target if target.ndim == ndim + 1 else target[None]
        tgt_spatial = t.shape[1:]
        if tgt_spatial != spatial:
            offsets = [(s - ts) // 2 for s, ts in zip(spatial, tgt_spatial)]
            tcoords = [c[tuple(slice(o, o + ts) for o, ts in
                               zip(offsets, tgt_spatial))] - o
                       for c, o, ts in zip(coords, offsets, tgt_spatial)]
        else:
            tcoords = coords
        out_t = np.empty_like(t)
        for c in range(t.shape[0]):
            discrete = (self.target_discrete_ix is None
                        or c in self.target_discrete_ix)
            order = 0 if discrete else 1
            out_t[c] = ndimage.map_coordinates(
                t[c], tcoords, order=order, mode="reflect")
        if target.ndim == ndim:
            out_t = out_t[0]
        return out_inp, out_t.astype(target.dtype)


class SqueezeTarget:
    """Squeeze a specified target axis (e.g. singleton C).
    Reference transforms.py:964-979."""

    def __init__(self, dim: int = 0):
        self.dim = dim

    def __call__(self, inp, target):
        if target is None:
            return inp, target
        return inp, np.squeeze(target, axis=self.dim)


class RandomFlip:
    """Random flips along ``ndim_spatial`` trailing axes (applied to both
    inp and target). Reference transforms.py:982-1022."""

    def __init__(self, ndim_spatial: int = 2, prob: float = 0.5):
        self.ndim_spatial = ndim_spatial
        self.prob = prob

    def __call__(self, inp, target):
        flip_dims_bool = np.random.rand(self.ndim_spatial) < self.prob
        flip_dims = [-(i + 1) for i, f in
                     enumerate(reversed(flip_dims_bool)) if f]
        if not flip_dims:
            return inp, target
        inp = np.flip(inp, flip_dims).copy()
        if target is not None:
            target = np.flip(target, flip_dims).copy()
        return inp, target


class RandomRotate2d:
    """Random rotation in the xy plane (arbitrary angle), same angle for
    inp and target; discrete targets use order-0 interpolation.
    Reference transforms.py:1025-1078."""

    def __init__(self, angle_range: Tuple[float, float] = (-180, 180),
                 prob: float = 1.0):
        self.angle_range = angle_range
        self.prob = prob

    def __call__(self, inp, target):
        if ndimage is None:
            raise ImportError("scipy is required for RandomRotate2d")
        if np.random.rand() > self.prob:
            return inp, target
        angle = np.random.uniform(*self.angle_range)
        axes = (-2, -1)
        rot_inp = ndimage.rotate(
            inp, angle, axes=axes, order=1, reshape=False, mode="reflect")
        if target is None:
            return rot_inp.astype(inp.dtype), target
        rot_t = ndimage.rotate(
            target, angle, axes=axes, order=0, reshape=False, mode="reflect")
        return rot_inp.astype(inp.dtype), rot_t.astype(target.dtype)


class Clahe2d:
    """Contrast-limited adaptive histogram equalization (2D). Requires
    scikit-image. Reference transforms.py:1081-1095."""

    def __call__(self, inp, target):
        try:
            from skimage.exposure import equalize_adapthist
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "scikit-image is required for Clahe2d") from e
        assert inp.ndim == 3, "Clahe2d expects (C, H, W)"
        out = np.empty_like(inp)
        for c in range(inp.shape[0]):
            out[c] = equalize_adapthist(inp[c])
        return out, target


class AlbuSeg2d:
    """Wrapper for albumentations 2D segmentation augmentations.
    Reference transforms.py:1098-1132."""

    def __init__(self, albu):
        self.albu = albu

    def __call__(self, inp, target):
        assert inp.ndim == 3, "AlbuSeg2d expects (C, H, W)"
        img = np.moveaxis(inp, 0, -1)  # HWC for albumentations
        if target is not None:
            res = self.albu(image=img, mask=target)
            out_t = res["mask"]
        else:
            res = self.albu(image=img)
            out_t = None
        out = np.moveaxis(res["image"], -1, 0).astype(inp.dtype)
        return out, out_t


class RandomBlurring:
    """Random sub-region Gaussian blurring. See
    elektronn3_tpu_torch/data/transforms/random_blurring.py; reference
    transforms.py:633-667 + random_blurring.py."""

    def __init__(self, config: dict, patch_shape: Optional[Sequence[int]] = None):
        from elektronn3_tpu_torch.data.transforms import random_blurring
        self.config = dict(config)
        if patch_shape is not None:
            random_blurring.check_random_data_blurring_config(
                patch_shape, **self.config)

    def __call__(self, inp, target):
        from elektronn3_tpu_torch.data.transforms import random_blurring
        # In-place region blurring on a copy
        inp = np.array(inp, dtype=floatX, copy=True)
        random_blurring.apply_random_blurring(inp, **self.config)
        return inp, target
