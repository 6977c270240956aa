"""Data utilities: dataset statistics, class weights, HDF5 writing,
offset probing, signal-handling context managers.

Counterpart of the JAX package's ``data/utils.py`` (reference
elektronn3/data/utils.py:41-301). ``save_to_h5`` imports h5py when it
is called.
"""

from __future__ import annotations

import os
import signal
from typing import Optional, Sequence, Tuple

import numpy as np

from elektronn3_tpu_torch.logger import logger

floatX = np.float32


def calculate_means(inputs: Sequence[np.ndarray]) -> Tuple[float, ...]:
    """Per-channel means over a list of (C, ...) arrays.
    Reference utils.py:41-49."""
    means = [np.mean(x, axis=tuple(range(1, np.ndim(x)))) for x in inputs]
    sizes = [np.prod(np.asarray(x).shape[1:]) for x in inputs]
    return tuple(np.average(np.array(means), axis=0, weights=sizes))


def calculate_stds(inputs: Sequence[np.ndarray]) -> Tuple[float, ...]:
    """Per-channel stds over a list of (C, ...) arrays.
    Reference utils.py:52-60."""
    stds = [np.std(x, axis=tuple(range(1, np.ndim(x)))) for x in inputs]
    sizes = [np.prod(np.asarray(x).shape[1:]) for x in inputs]
    return tuple(np.average(np.array(stds), axis=0, weights=sizes))


def calculate_offset(model_fn, inp_shape: Sequence[int]) -> Sequence[int]:
    """Determine the spatial shrinkage ('offset') of a dense-prediction
    model by a probe forward pass on zeros (valid convs shrink output).
    ``model_fn`` maps a channels-last array to a channels-last array.
    Reference utils.py:63-78 (adapted: takes a callable, not nn.Module).
    """
    x = np.zeros(tuple(inp_shape), floatX)
    out = np.asarray(model_fn(x))
    in_sp = np.array(x.shape[1:-1])
    out_sp = np.array(out.shape[1:-1])
    return tuple((in_sp - out_sp) // 2)


def get_class_counts(targets: Sequence[np.ndarray]) -> Tuple[np.ndarray, str]:
    """Count class occurrences. Reference utils.py:81-99."""
    ids, counts = np.unique(
        np.concatenate([np.asarray(t).reshape(-1) for t in targets]),
        return_counts=True)
    summary = "\n".join(
        f"  class {int(i)}: {c} ({c / counts.sum() * 100:.2f}%)"
        for i, c in zip(ids, counts))
    return counts, summary


def calculate_class_weights(
        targets: Sequence[np.ndarray], mode: str = "inverse",
) -> np.ndarray:
    """Balanced class weights for a target list; modes: 'inverse',
    'inversesquared', 'norpf' (≤1-capped inverse), 'binmean'.
    Reference utils.py:102-163."""
    counts, _ = get_class_counts(targets)
    freq = counts / counts.sum()
    if mode == "inverse":
        w = 1.0 / np.maximum(freq, 1e-12)
    elif mode == "inversesquared":
        w = 1.0 / np.maximum(freq, 1e-12) ** 2
    elif mode == "norpf":
        w = np.minimum(1.0 / np.maximum(freq, 1e-12), 1.0)
    elif mode == "binmean":
        # For binary problems: weight fg by bg frequency and vice versa.
        assert len(freq) == 2, "binmean mode requires binary targets"
        w = np.array([freq[1], freq[0]])
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    w = w / w.sum() * len(w)
    return w.astype(floatX)


def calculate_nd_slice(src, coords_lo, coords_hi):
    """Calculate the ([...],) + 3 trailing-dims slice into ``src``.
    Reference utils.py:166-184."""
    slneg = len(src.shape) - 3
    slices = [slice(None)] * slneg + [
        slice(int(lo), int(hi)) for lo, hi in zip(coords_lo, coords_hi)]
    return tuple(slices)


def save_to_h5(data, path: str, hdf5_names: Optional[Sequence[str]] = None,
               overwrite: bool = False, compression: bool = True) -> None:
    """Save array(s) to an HDF5 file. Reference utils.py:187-237."""
    import h5py
    path = os.path.expanduser(path)
    if (not overwrite) and os.path.isfile(path):
        raise FileExistsError(path)
    if isinstance(data, dict):
        items = data.items()
    else:
        if not isinstance(data, (list, tuple)):
            data = [data]
        if hdf5_names is None:
            hdf5_names = [f"data{i}" for i in range(len(data))]
        if len(hdf5_names) != len(data):
            raise ValueError("hdf5_names must match data length")
        items = zip(hdf5_names, data)
    kw = {"compression": "gzip"} if compression else {}
    with h5py.File(path, "w") as f:
        for name, arr in items:
            f.create_dataset(name, data=arr, **kw)


def squash01(img: np.ndarray) -> np.ndarray:
    """Squash array values into [0, 1]. Reference utils.py:240-250."""
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    if hi == lo:
        return np.zeros_like(img, floatX)
    return ((img - lo) / (hi - lo)).astype(floatX)


class DelayedInterrupt:
    """Context manager that defers SIGINT/SIGTERM until exit.
    Reference utils.py:253-276."""

    def __init__(self, signals=(signal.SIGINT, signal.SIGTERM)):
        self.signals = signals
        self._received = []
        self._old = {}

    def __enter__(self):
        self._received = []
        for sig in self.signals:
            self._old[sig] = signal.getsignal(sig)
            signal.signal(
                sig, lambda s, f: (self._received.append((s, f)),
                                   logger.warning(
                                       f"Signal {s} deferred until block "
                                       f"exits.")))
        return self

    def __exit__(self, *exc):
        for sig in self.signals:
            signal.signal(sig, self._old[sig])
        for s, f in self._received:
            old = self._old[s]
            if callable(old):
                old(s, f)
        return False


class CleanExit:
    """Context manager converting SIGINT/SIGTERM inside the block into a
    clean exit. Reference utils.py:279-288."""

    def __enter__(self):
        self._old_int = signal.getsignal(signal.SIGINT)
        self._old_term = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        signal.signal(signal.SIGTERM, signal.default_int_handler)
        return self

    def __exit__(self, exc_type, exc_value, exc_tb):
        signal.signal(signal.SIGINT, self._old_int)
        signal.signal(signal.SIGTERM, self._old_term)
        return exc_type is KeyboardInterrupt


class GracefulInterrupt:
    """Sets a flag on SIGINT/SIGTERM instead of raising, so loops can
    finish the current step and exit cleanly. Reference utils.py:291-301."""

    def __init__(self):
        self.stop = False
        signal.signal(signal.SIGINT, self._handler)
        signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, sig, frame):
        logger.warning(f"Received signal {sig}: finishing current step, "
                       "then stopping.")
        self.stop = True
