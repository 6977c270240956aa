"""Meshes over the ``torch.distributed`` world.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX lays a named
grid over the devices one controller sees; the port has one process per
rank, so a :class:`Mesh` lays the grid over the ranks of the default
process group (rank ``r`` at the C-order coordinates of ``r`` in the
grid) and keeps, for each axis, the process group of the ranks that
differ from this rank only along that axis:

- a 'data' axis: batch sharding (data parallelism; the batch-norm
  statistics, the logits and the gradients are reduced over it);
- a 'space' axis: a spatial axis of the volume sharded with halo
  exchange (``parallel/halo.py``).

Without an initialized process group a mesh holds one rank and runs no
collective: the single-process program, unchanged. ``with mesh:``
makes it the active mesh, against which a model's ``axis_name`` is
resolved (JAX's ``with mesh:``).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch.distributed as dist

_ACTIVE: List["Mesh"] = []   # the meshes entered with ``with``, innermost last


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its name, its size, this
    rank's index along it, and the process group of the ranks along it
    (None without a process group: no collective runs)."""
    name: str
    size: int
    index: int
    group: Optional[dist.ProcessGroup]


def _world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A named grid over the first ``prod(shape)`` ranks of the world.

    ``shape`` maps each axis name to its size, in order (JAX's
    ``mesh.shape``). A rank beyond the grid takes part in building the
    groups (every rank must) and holds no axis. Build it with
    :func:`make_mesh`."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = int(np.prod(list(axes.values()), dtype=np.int64))
        self.rank, world = _world()
        sizes = tuple(self.shape.values())
        inside = self.rank < self.size
        coords = np.unravel_index(self.rank, sizes) if inside else None
        self._axes: Dict[str, Axis] = {}
        grouped = dist.is_available() and dist.is_initialized()
        for k, name in enumerate(self.axis_names):
            group = _axis_group(sizes, k, self.rank, world) if grouped \
                else None
            if inside:
                self._axes[name] = Axis(name, sizes[k], int(coords[k]), group)

    def axis(self, name: str) -> Axis:
        """This rank's :class:`Axis` ``name``; ``ValueError`` for a name
        the mesh lacks or a rank outside the grid."""
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        if name not in self._axes:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.shape}")
        return self._axes[name]

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def axis_index(self, name: str) -> int:
        return self.axis(name).index

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.remove(self)
        return False

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_group(sizes: tuple, k: int, rank: int,
                world: int) -> dist.ProcessGroup:
    """The group along axis ``k`` holding ``rank``. Every rank builds
    every slice's group in the same order (``new_group`` is collective
    over the world); a slice of the whole world is the default group."""
    others = [range(s) if j != k else range(1) for j, s in enumerate(sizes)]
    mine = None
    for base in itertools.product(*others):
        ranks = []
        for i in range(sizes[k]):
            c = list(base)
            c[k] = i
            ranks.append(int(np.ravel_multi_index(c, sizes)))
        if ranks == list(range(world)):
            return dist.group.WORLD
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with``, None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A :class:`Mesh` from an axis-name -> size dict, as
    ``make_mesh({'data': 4, 'space': 2})`` on 8 ranks. With ``axes=None``
    every rank goes on one 'data' axis. ``ValueError`` if the shape needs
    more ranks than the world has."""
    world = _world()[1]
    if axes is None:
        axes = {"data": world}
    n = int(np.prod(list(axes.values()), dtype=np.int64))
    if n > world:
        raise ValueError(f"Mesh shape {axes} needs {n} devices, have {world}")
    return Mesh(axes)


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A one-axis 'data' mesh over the first ``n_devices`` ranks (all by
    default)."""
    return make_mesh({"data": _world()[1] if n_devices is None
                      else n_devices})


class Sharding:
    """Where the leading (batch) dimension of an array lives: split over
    a mesh axis (:func:`batch_sharding`) or whole on every rank
    (:func:`replicated`). :meth:`local` cuts this rank's part."""

    def __init__(self, mesh: Mesh, axis: Optional[str]):
        self.mesh = mesh
        self.axis = axis

    def local(self, x):
        """This rank's rows of ``x`` (a tensor or numpy array): all of
        them when replicated, else the ``index``-th of ``size`` equal
        parts; ``ValueError`` if the parts would not be equal."""
        if self.axis is None:
            return x
        return shard_rows(x, self.mesh.axis(self.axis))


def shard_rows(x, axis: Axis):
    """The ``axis.index``-th of ``axis.size`` equal blocks of rows of
    ``x``."""
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"a batch of {n} does not split into "
                         f"{axis.size} equal shards over {axis.name!r}")
    m = n // axis.size
    return x[axis.index * m:(axis.index + 1) * m]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Split the leading (batch) dimension over ``axis``."""
    mesh.axis(axis)
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
