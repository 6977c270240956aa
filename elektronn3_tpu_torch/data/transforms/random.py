"""Random parameter samplers for augmentations.

Counterpart of the JAX package's ``data/transforms/random.py``
(reference elektronn3/data/transforms/random.py:9-72, scipy.stats
wrappers). A sampler draws from the ``rng`` it is given (a
``numpy.random.Generator`` or ``RandomState``) or, with none, from the
process's numpy random state, which the loaders seed per sample. (The
JAX package's samplers make a fresh, unseeded generator there.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RandomSampler:
    """Base class: wraps a distribution; ``__call__`` draws a sample."""

    def __init__(self, rng=None):
        self.rng = np.random if rng is None else rng

    def __call__(self, shape=None):
        raise NotImplementedError


class Normal(RandomSampler):
    def __init__(self, mean: float = 0.0, sigma: float = 1.0,
                 bounds: Optional[Sequence[float]] = None, rng=None):
        super().__init__(rng)
        self.mean, self.sigma, self.bounds = mean, sigma, bounds

    def __call__(self, shape=None):
        x = self.rng.normal(self.mean, self.sigma, shape)
        if self.bounds is not None:
            x = np.clip(x, *self.bounds)
        return x


class HalfNormal(RandomSampler):
    def __init__(self, sigma: float = 1.0,
                 bounds: Optional[Sequence[float]] = None, rng=None):
        super().__init__(rng)
        self.sigma, self.bounds = sigma, bounds

    def __call__(self, shape=None):
        x = np.abs(self.rng.normal(0.0, self.sigma, shape))
        if self.bounds is not None:
            x = np.clip(x, *self.bounds)
        return x


class RandInt(RandomSampler):
    def __init__(self, low: int = 0, high: int = 2, rng=None):
        super().__init__(rng)
        self.low, self.high = low, high

    def __call__(self, shape=None):
        draw = getattr(self.rng, "integers", None) or self.rng.randint
        return draw(self.low, self.high, shape)


class Uniform(RandomSampler):
    def __init__(self, low: float = 0.0, high: float = 1.0, rng=None):
        super().__init__(rng)
        self.low, self.high = low, high

    def __call__(self, shape=None):
        return self.rng.uniform(self.low, self.high, shape)
