"""Spatial sharding with halo exchange: dense prediction across ranks.

Counterpart of the JAX package's ``parallel/halo.py``: shard a spatial
axis of the volume over a mesh axis, extend each shard by ``halo``
slices from its ring neighbours, run the model on shard + halo, crop
the halo and reassemble. The shards at the ring's ends get zeros for
their missing neighbour, as ``ppermute`` leaves them, which is the zero
padding of single-process tiled inference.

:func:`exchange_halo` (a shard of its own on each rank) all-gathers
every rank's two boundary slabs and picks the neighbours' out of them.
That one design works on gloo over CPU tensors, on gloo over CUDA
tensors (which has no CUDA send/recv: two ranks sharing a card) and on
NCCL; point-to-point sends on NCCL would move less and are left for
later. :func:`sharded_spatial_apply` takes the full input on every rank,
so it reads the neighbours' slabs from it in place and needs no
exchange: the same values, with no collective before the output's
gather.
"""

from __future__ import annotations

from typing import Callable

import torch

from elektronn3_tpu_torch.parallel.collectives import gather
from elektronn3_tpu_torch.parallel.mesh import Axis, Mesh


def exchange_halo(x_local: torch.Tensor, halo: int, spatial_axis: int,
                  axis: Axis) -> torch.Tensor:
    """``x_local`` with ``halo`` slices of its left and right ring
    neighbours' shards along ``spatial_axis`` (an axis of the local
    tensor, batch at 0) concatenated on either side, zeros at the ring's
    ends. Every rank of ``axis`` must call it with shards of one
    shape."""
    length = x_local.shape[spatial_axis]
    if not 0 < halo <= length:
        raise ValueError(f"halo {halo} must be in 1..{length}, the "
                         "shard's extent")
    slabs = torch.stack([x_local.narrow(spatial_axis, 0, halo),
                         x_local.narrow(spatial_axis, length - halo, halo)])
    zeros = torch.zeros_like(slabs[0])
    if axis.group is None or axis.size == 1:
        from_left = from_right = zeros
    else:
        every = gather(slabs, axis)   # (2 * size, ...): (first, last) a rank
        i = axis.index
        from_left = every[2 * i - 1] if i > 0 else zeros
        from_right = every[2 * i + 2] if i < axis.size - 1 else zeros
    return torch.cat([from_left, x_local, from_right], dim=spatial_axis)


def sharded_spatial_apply(
        apply_fn: Callable[[torch.Tensor], torch.Tensor],
        mesh: Mesh,
        halo: int,
        spatial_axis: int = 1,
        axis_name: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function of the FULL channels-last input (every rank holds it,
    as JAX's one controller does) that takes this rank's shard of
    ``spatial_axis`` along the mesh axis ``axis_name``, extends it by
    ``halo`` slices of its ring neighbours' shards (read from the full
    input; zeros at the ring's ends), applies ``apply_fn`` (a
    same-conv map keeping the spatial shape), crops the halo and returns
    the full output, reassembled on every rank. The extent along
    ``spatial_axis`` must split evenly, and each shard's extent should
    suit the model's pooling; ``halo`` should cover the receptive
    field's half width."""
    axis = mesh.axis(axis_name)

    def full_apply(x: torch.Tensor) -> torch.Tensor:
        length = x.shape[spatial_axis]
        if length % axis.size:
            raise ValueError(f"extent {length} of axis {spatial_axis} does "
                             f"not split into {axis.size} shards")
        m = length // axis.size
        if not 0 < halo <= m:
            raise ValueError(f"halo {halo} must be in 1..{m}, the "
                             "shard's extent")
        lo, hi = axis.index * m, (axis.index + 1) * m
        a, b = max(lo - halo, 0), min(hi + halo, length)

        def zeros(k):
            shape = list(x.shape)
            shape[spatial_axis] = k
            return x.new_zeros(shape)
        # shard + halo as exchange_halo builds it: the neighbours' slabs
        # out of x, zeros beyond the volume's ends
        y = apply_fn(torch.cat([zeros(halo - (lo - a)),
                                x.narrow(spatial_axis, a, b - a),
                                zeros(halo - (b - hi))], dim=spatial_axis))
        y = y.narrow(spatial_axis, halo, y.shape[spatial_axis] - 2 * halo)
        return gather(y.contiguous(), axis, dim=spatial_axis)

    return full_apply
