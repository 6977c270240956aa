"""Utilities of the port: device-memory debugging (``debug``) and the
host-read overhead of a timing loop (``timing``)."""

from elektronn3_tpu_torch.utils.debug import (
    device_memory_stats, find_live_arrays)
from elektronn3_tpu_torch.utils.timing import sync_overhead_s

__all__ = ["device_memory_stats", "find_live_arrays", "sync_overhead_s"]
