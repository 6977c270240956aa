"""Host-to-card input pipeline: batching, layout conversion, prefetch.

Counterpart of the JAX package's ``data/pipeline.py``:

- ``default_collate`` and ``to_channels_last``: sample dicts to one
  batch dict of numpy arrays, 'inp' (N, C, ...) moved to (N, ..., C),
  the models' layout.
- ``DataLoader``: JAX's arguments, built on ``torch.utils.data.
  DataLoader``. Under ``seed`` every sample is made under its own seed
  of numpy's global random state, in whichever process makes it.
- ``prefetch_to_device``: keeps ``size`` batches in flight on the card,
  copied from pinned host memory by ``non_blocking`` copies on a side
  stream.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def default_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into a batch dict.

    Array-like values (numpy arrays, CPU tensors, scalars) are stacked
    into one numpy array along a new batch axis; other values (e.g.
    'fname' strings) are collected into lists.
    """
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, (np.ndarray, torch.Tensor)) \
                or np.isscalar(first):
            batch[key] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[key] = vals
    return batch


def to_channels_last(batch: Dict[str, Any],
                     keys: Sequence[str] = ("inp",)) -> Dict[str, Any]:
    """Move the channel axis of (N, C, *spatial) arrays to the end."""
    out = dict(batch)
    for key in keys:
        if key in out and isinstance(out[key], np.ndarray) \
                and out[key].ndim >= 3:
            out[key] = np.ascontiguousarray(np.moveaxis(out[key], 1, -1))
    return out


class SeededSamples(torch.utils.data.Dataset):
    """``dataset[i]`` made under numpy seed ``(base + i) % 2**32``: the
    JAX loader's per-sample seeding (reference ``_worker_init_fn``,
    trainer.py:53-62). The draws of a sample depend on its index and
    ``base`` alone, not on the process or the worker that makes it."""

    def __init__(self, dataset, base: int):
        self.dataset = dataset
        self.base = base

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        np.random.seed((self.base + int(i)) % (2 ** 32))
        return self.dataset[i]


def _collate(samples, collate_fn, channels_last, keys, tensors):
    batch = collate_fn(samples)
    if channels_last:
        batch = to_channels_last(batch, keys)
    if tensors:
        batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                 and _placeable(v) else v for k, v in batch.items()}
    return batch


class DataLoader:
    """Batched loader over a map-style dataset.

    Args:
        dataset: object with ``__getitem__``/``__len__``.
        batch_size: samples per batch.
        num_workers: worker processes (0: the samples are made in the
            calling process).
        channels_last: move 'inp' (and the other ``channels_last_keys``)
            to channels-last, batch by batch.
        drop_last: drop the final incomplete batch.
        shuffle: a new order each epoch, from
            ``np.random.default_rng(seed + epoch)`` (unseeded without
            ``seed``), the JAX loader's.
        seed: sample i of epoch e is made under numpy seed
            ``seed + e * len(dataset) + i``, so a seeded loader repeats
            its batches and its workers do not repeat each other's
            draws, with any number of workers. The epoch moves on as a
            pass starts (JAX's as it ends), so a pass left early is not
            made again by the next; ``set_epoch`` sets it.
        timeout: seconds to wait for a worker's batch before raising.
        pin_memory: numeric arrays as CPU tensors that torch's pinning
            thread copies into pinned memory, off the calling thread,
            for ``non_blocking`` copies to the card.
        generator: a ``torch.Generator``: the order comes from torch's own
            sampler under it, as ``torch.utils.data.DataLoader(shuffle=
            True, generator=...)`` draws it, not from numpy's
            ``default_rng(seed + epoch)`` (the per-sample seeds stay
            ``seed``'s).
        collate_fn: samples to a batch dict.
        channels_last_keys: the batch keys moved to channels-last.
        worker_type: 'thread' or 'process', JAX's choice between its
            thread pool and its fork-started process pool. Both map onto
            the same thing here, ``torch.utils.data.DataLoader``'s worker
            processes (started with torch's default method, fork on
            Linux): torch has no thread workers, and a transform chain
            in Python runs in parallel only across processes. The
            per-sample seeds make every choice deterministic (JAX's
            'thread' workers share one random state and are not).
    """

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 2,
                 channels_last: bool = True, drop_last: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None,
                 timeout: float = 120.0, pin_memory: bool = False,
                 generator: Optional[torch.Generator] = None,
                 collate_fn=default_collate,
                 channels_last_keys: Sequence[str] = ("inp", "target_f"),
                 worker_type: str = "thread"):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be 'thread' or 'process', "
                             f"got {worker_type!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.channels_last = channels_last
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.timeout = timeout
        self.pin_memory = pin_memory
        self.generator = generator
        self.collate_fn = collate_fn
        self.channels_last_keys = tuple(channels_last_keys)
        self.worker_type = worker_type
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass epoch ``epoch``: its order and its
        samples' seeds."""
        self._epoch = epoch

    def _index_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                None if self.seed is None else self.seed + epoch)
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch = self._epoch
        self._epoch += 1
        dataset = self.dataset
        if self.seed is not None:
            dataset = SeededSamples(dataset,
                                    self.seed + epoch * len(self.dataset))
        if self.generator is not None and self.shuffle:
            order = dict(shuffle=True, generator=self.generator)
        else:
            order = dict(
                sampler=self._index_order(epoch).tolist(),
                generator=None if self.seed is None
                else torch.Generator().manual_seed(self.seed + epoch))
        loader = torch.utils.data.DataLoader(
            dataset, batch_size=self.batch_size, drop_last=self.drop_last,
            num_workers=self.num_workers,
            timeout=self.timeout if self.num_workers > 0 else 0,
            pin_memory=self.pin_memory,
            collate_fn=functools.partial(
                _collate, collate_fn=self.collate_fn,
                channels_last=self.channels_last,
                keys=self.channels_last_keys, tensors=self.pin_memory),
            **order)
        yield from loader


def _placeable(x) -> bool:
    return isinstance(x, torch.Tensor) or (
        isinstance(x, np.ndarray) and (np.issubdtype(x.dtype, np.number)
                                       or np.issubdtype(x.dtype, np.bool_)))


def prefetch_to_device(iterator, size: int = 2, device=None,
                       inp_dtype: Optional[torch.dtype] = None,
                       sharding=None):
    """Wrap a batch iterator: copy up to ``size`` batches ahead to
    ``device`` (default the current CUDA device).

    Each array goes through pinned host memory and a ``non_blocking``
    copy on a side stream, so the copy of batch N+1 overlaps the card's
    work on batch N; a batch is yielded once the compute stream has
    been made to wait for its copy. Integer arrays wider than 32 bits
    travel as int32 and are widened to int64 on the card (class
    targets need no more; torch's losses take int64). With
    ``inp_dtype`` (e.g. ``torch.bfloat16`` for a bf16 model) a floating
    'inp' is cast on the host before the copy, which halves its bytes at
    the numerics the model would give it anyway; an integer 'inp' (uint8
    raw) travels at its own width. Other values pass through.
    ``device="cpu"`` converts to tensors and copies nothing.
    ``sharding`` (``parallel.batch_sharding(mesh)``): only this rank's
    rows of each array are copied (``replicated(mesh)``: all of them),
    JAX's ``device_put`` of the batch with that sharding.
    """
    device = torch.device("cuda" if device is None else device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(batch):
        out, keep = {}, []
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            for k, x in batch.items():
                if not _placeable(x):
                    out[k] = x
                    continue
                if sharding is not None and np.ndim(x):
                    x = sharding.local(x)
                t = x if isinstance(x, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(x))
                wide = not t.is_floating_point() and t.dtype != torch.bool \
                    and t.element_size() > 4
                if wide:
                    t = t.to(torch.int32)
                elif k == "inp" and inp_dtype is not None \
                        and t.is_floating_point():
                    t = t.to(inp_dtype)
                if stream is not None:
                    t = t.pin_memory()
                    keep.append(t)
                t = t.to(device, non_blocking=True)
                out[k] = t.long() if wide else t
            event = stream.record_event() if stream is not None else None
        return out, event, keep

    def ready(item):
        out, event, _ = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in out.values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(current)
        return out

    pending = collections.deque()
    for batch in iterator:
        pending.append(place(batch))
        if len(pending) > size:
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())
