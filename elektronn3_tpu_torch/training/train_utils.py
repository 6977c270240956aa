"""Training utilities: history tracking, timers, pretty-printing.

Counterpart of the JAX package's ``training/train_utils.py`` (reference
elektronn3/training/train_utils.py:23-242), host-side numpy only.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


def create_preview_batch_from_knossos(
        knossos_preview_config: Dict) -> np.ndarray:
    """A (1, C, D, H, W) float32 preview batch read from the KNOSSOS
    dataset(s) of ``knossos_preview_config`` (keys ``dataset``, one path
    or a list, a channel each; ``size``, ``offset``, ``mag``,
    ``target_mags``; optional ``scale_brightness``, the divisor).
    Reference train_utils.py:23-48; needs ``knossos_utils`` (or a class
    set as ``data.knossos.KnossosDataset``)."""
    from elektronn3_tpu_torch.data.knossos import _require_knossos
    config = knossos_preview_config
    for k in ("dataset", "size", "offset", "mag", "target_mags"):
        if k not in config:
            raise ValueError(
                f"Required key {k} missing from knossos_preview_config.")
    kd_cls = _require_knossos()
    datasets = config["dataset"]
    if isinstance(datasets, str):
        datasets = [datasets]
    inp = np.stack([kd_cls(path).load_raw(
        offset=config["offset"], size=config["size"], mag=config["mag"],
        datatype=np.float32) for path in datasets], axis=0)[None]
    return inp / config.get("scale_brightness", 1.0)


class AccumulationArray:
    """Growing record array with O(1) amortized append.
    Reference train_utils.py:112-221."""

    def __init__(self, right_shape=(), dtype=np.float32, n_init: int = 100,
                 data=None, ema_factor: float = 0.95):
        if isinstance(right_shape, int):
            right_shape = (right_shape,)
        self._shape = (n_init,) + tuple(right_shape)
        self.data = np.zeros(self._shape, dtype=dtype)
        self.length = 0
        self._ema_factor = ema_factor
        self.ema = None
        if data is not None:
            for d in data:
                self.append(d)

    def append(self, data):
        if self.length == self.data.shape[0]:
            new = np.zeros((self.data.shape[0] * 2,) + self.data.shape[1:],
                           dtype=self.data.dtype)
            new[:self.length] = self.data[:self.length]
            self.data = new
        self.data[self.length] = data
        self.length += 1
        if self.ema is None:
            self.ema = np.array(data, dtype=np.float64)
        else:
            self.ema = self._ema_factor * self.ema \
                + (1 - self._ema_factor) * np.asarray(data, np.float64)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return self.data[:self.length][idx]

    def mean(self):
        return self.data[:self.length].mean(0) if self.length else np.nan

    def sum(self):
        return self.data[:self.length].sum(0)

    def max(self):
        return self.data[:self.length].max(0)

    def min(self):
        return self.data[:self.length].min(0)

    def clear(self):
        self.length = 0


class HistoryTracker:
    """Tracks timeline/history/loss registers for plotting and logging.
    Reference train_utils.py:50-108."""

    def __init__(self):
        self.plotting_proc = None
        self.debug_outputs = None
        self.regression = None
        self.timeline = AccumulationArray(right_shape=3, n_init=int(1e5))
        self.history = AccumulationArray(right_shape=5, n_init=int(1e4))
        self.loss = AccumulationArray(n_init=int(1e5), ema_factor=0.99)
        self.batch_mean = AccumulationArray(n_init=int(1e5))

    def update_timeline(self, vals):
        self.timeline.append(vals)
        self.loss.append(vals[1])

    def update_history(self, vals):
        self.history.append(vals)

    def register_debug_output_names(self, names):
        self.debug_outputs = names


class Timer:
    """Wall-clock timer: ``t_passed`` is the seconds since construction.
    Reference train_utils.py:224-232."""

    def __init__(self):
        self.origin = time.time()
        self.t0 = self.origin

    @property
    def t_passed(self) -> float:
        return time.time() - self.origin


def pretty_string_time(t: float) -> str:
    """Elapsed seconds as a short string. Reference
    train_utils.py:234-242."""
    if t > 4000:
        s = f"{t / 3600:.2f} h"
    elif t > 300:
        s = f"{t / 60:.1f} min"
    else:
        s = f"{t:.0f} s"
    return s
