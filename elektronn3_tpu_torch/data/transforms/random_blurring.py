"""Random sub-region Gaussian blurring with scheduled intensity.

Counterpart of the JAX package's ``data/transforms/random_blurring.py``.
Reference: elektronn3/data/transforms/random_blurring.py (ScalarScheduler
:37-156, check_random_data_blurring_config :159-240,
apply_random_blurring :243-341) + region_generator.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    import scipy.ndimage as ndimage
except ImportError:  # pragma: no cover
    ndimage = None


class ScalarScheduler:
    """Scalar that grows linearly or exponentially from ``value`` to
    ``max_value`` over ``steps`` updates (interval applies every
    ``interval`` steps). Reference random_blurring.py:37-156."""

    def __init__(self, value: float, max_value: Optional[float] = None,
                 growth_type: Optional[str] = None,
                 interval: Optional[int] = None,
                 steps_per_report: Optional[int] = None):
        self.value = float(value)
        self.max_value = max_value
        self.growth_type = growth_type
        self.interval = interval
        self.steps_per_report = steps_per_report
        self._step = 0
        if max_value is not None and interval:
            if growth_type == "lin":
                self._incr = (max_value - value) / interval
            elif growth_type == "exp":
                self._incr = (max_value / value) ** (1.0 / interval) \
                    if value > 0 else 1.0
            else:
                raise ValueError(f"Unknown growth_type {growth_type!r}")

    def step(self) -> float:
        if self.max_value is not None and self.value < self.max_value:
            if self.growth_type == "lin":
                self.value = min(self.value + self._incr, self.max_value)
            else:
                self.value = min(self.value * self._incr, self.max_value)
        self._step += 1
        return self.value

    def __float__(self):
        return float(self.value)


def check_random_data_blurring_config(
        patch_shape: Sequence[int],
        probability: float,
        threshold: ScalarScheduler,
        lower_lim_region_size: Sequence[int],
        upper_lim_region_size: Sequence[int],
        verbose: bool = False,
        save_path: Optional[str] = None,
        num_steps_save: Optional[int] = None) -> None:
    """Validate a region-blurring config against the patch shape.
    Reference random_blurring.py:159-240."""
    patch_shape = list(patch_shape)
    if not 0 <= probability <= 1:
        raise ValueError("probability must be within [0, 1]")
    thr = float(threshold) if not isinstance(threshold, ScalarScheduler) \
        else threshold.value
    if not 0 <= thr <= 1:
        raise ValueError("threshold must be within [0, 1]")
    lo = list(lower_lim_region_size)
    hi = list(upper_lim_region_size)
    if len(lo) != len(patch_shape) or len(hi) != len(patch_shape):
        raise ValueError("region size limits must match patch rank")
    for l, h, p in zip(lo, hi, patch_shape):
        if not (0 < l < h < p):
            raise ValueError(
                f"region size limits must satisfy 0 < {l} < {h} < {p}")


def apply_random_blurring(
        inp_sample: np.ndarray,
        probability: float = 0.5,
        threshold: ScalarScheduler = None,
        lower_lim_region_size: Sequence[int] = (2, 6, 6),
        upper_lim_region_size: Sequence[int] = (8, 16, 16),
        verbose: bool = False,
        save_path: Optional[str] = None,
        num_steps_save: Optional[int] = None) -> None:
    """Blur random sub-regions of ``inp_sample`` (C, D, H, W) in place
    until the blurred-volume fraction reaches ``threshold``.
    Reference random_blurring.py:243-341."""
    if ndimage is None:
        raise ImportError("scipy is required for apply_random_blurring")
    if threshold is None:
        threshold = ScalarScheduler(0.2)
    if np.random.rand() > probability:
        return
    thr = float(threshold.step() if isinstance(threshold, ScalarScheduler)
                else threshold)
    spatial = inp_sample.shape[1:]
    total = float(np.prod(spatial))
    blurred = 0.0
    lo = np.asarray(lower_lim_region_size)
    hi = np.asarray(upper_lim_region_size)
    while blurred / total < thr:
        size = np.array([np.random.randint(l, h + 1)
                         for l, h in zip(lo, hi)])
        start = np.array([np.random.randint(0, max(1, s - rs + 1))
                          for s, rs in zip(spatial, size)])
        slices = tuple(slice(st, st + rs) for st, rs in zip(start, size))
        for c in range(inp_sample.shape[0]):
            region = inp_sample[(c,) + slices]
            inp_sample[(c,) + slices] = ndimage.gaussian_filter(region, 1.5)
        blurred += float(np.prod(size))
