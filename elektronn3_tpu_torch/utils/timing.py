"""Timing helpers for device benchmarks.

Counterpart of the JAX package's ``utils/timing.py``: a timing loop that
ends with one host read of a result carries that read's round trip as
bias; :func:`sync_overhead_s` measures it on the device, so that a
benchmark can subtract it.
"""

from __future__ import annotations

import time

import torch


def sync_overhead_s(probe_reps: int = 5, device=None) -> float:
    """The seconds of a tiny launch and the host read of its scalar on
    ``device`` (default: the card where there is one, else the CPU): the
    minimum over ``probe_reps`` reps, each on a new value, after one
    warm-up rep. This is what a benchmark's final ``float(loss)`` adds to
    the device time."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    float(torch.zeros((), device=device) + 1.0)
    ts = []
    for i in range(probe_reps):
        t0 = time.perf_counter()
        float(torch.full((), float(i), device=device) + 1.0)
        ts.append(time.perf_counter() - t0)
    return min(ts)
