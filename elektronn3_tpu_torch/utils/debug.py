"""Device-memory debugging.

Counterpart of the JAX package's ``utils/debug.py`` (the reference's
``findcudatensors()``, trainer.py:1048-1071: the live CUDA tensors, for
leak hunting).
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional, Tuple

import torch

from elektronn3_tpu_torch.logger import logger


def find_live_arrays(min_bytes: int = 0, device=None,
                     ) -> List[Tuple[Tuple, str, int]]:
    """(shape, dtype, bytes) of every live ``torch.Tensor`` that ``gc``
    tracks (on ``device`` where given: a type such as ``'cuda'``, or one
    device), of at least ``min_bytes``, largest first. Parameters count
    too; views are counted by their own size."""
    want = None if device is None else torch.device(device)
    found = []
    total = 0
    for obj in gc.get_objects():
        try:
            if not isinstance(obj, torch.Tensor) or obj.is_meta:
                continue
            if want is not None and (obj.device.type != want.type or (
                    want.index is not None and obj.device != want)):
                continue
            nbytes = obj.numel() * obj.element_size()
        except Exception:
            continue
        if nbytes >= min_bytes:
            found.append((tuple(obj.shape), str(obj.dtype), nbytes))
            total += nbytes
    found.sort(key=lambda t: -t[2])
    logger.info(f"Found {len(found)} live tensors, "
                f"{total / 1e6:.1f} MB total")
    return found


def device_memory_stats() -> Dict[str, Dict[str, Optional[int]]]:
    """For each card, its bytes in use, their peak and the card's total
    (``torch.cuda.memory_stats``, ``mem_get_info``); ``{}`` without a
    card."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak"),
            "bytes_limit": int(total),
        }
    return stats
