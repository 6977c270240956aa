"""Collectives over a mesh axis, differentiable where training needs it.

JAX takes these from ``lax`` (``psum``, ``all_gather``, ``ppermute``)
and transposes them itself; the port writes them over
``torch.distributed`` as autograd functions. Each takes an
:class:`~elektronn3_tpu_torch.parallel.mesh.Axis`; one whose group is
None (no process group) is the identity, so the single-process program
runs no collective.

The data-parallel step (``Trainer(mesh=...)``, JAX's ``shard_map``
step) has every rank run the model on its rows, gather the logits and
compute the SAME loss ``L`` of the global batch. Two places decide
whether its gradient is JAX's, or off by a factor of the axis size:

- :func:`psum` (the batch-norm statistics). ``y = sum_r x_r`` is used
  by every rank, each on its own rows, so rank ``r``'s autograd sees
  only its own part ``g_r = dL_r/dy`` of ``dL/dy = sum_r g_r``, and
  ``dL/dx_r = dL/dy`` for every ``r``. So the backward is again an
  all-reduce sum of the incoming cotangents, which is how JAX transposes
  ``psum``.
- :func:`all_gather` (the logits). ``Y = concat_r x_r`` feeds the loss,
  which every rank computes whole from ``Y``: rank ``r``'s cotangent of
  ``Y`` is already all of ``dL/dY``, the same on every rank. Its
  ``x_r`` is the ``r``-th block of ``Y``, so the backward is that block,
  with no sum (summing would count the loss ``size`` times).

The parameter gradients that follow are each rank's part of the sum
over the shards; :func:`sum_gradients` all-reduces them with a SUM, not
a mean, as JAX's gradient of the global loss is.

:func:`gather_shards` is the third case: a parameter split over the
ranks (the dry run's fsdp leg) is gathered whole for every rank's
forward, and each rank's cotangent of it is only its own rows' part of
the gradient. Its backward therefore sums the cotangents over the ranks
and keeps this rank's block, JAX's transpose of ``all_gather``
(``psum_scatter``); gloo has no reduce-scatter, so it all-reduces and
slices.

:class:`stats_group` is the counterpart of ``shard_map`` binding a
batch axis: while one is entered, the batch norms of
``modules/flat_norm.py`` and ``modules/layers.py`` sum their statistics
over its axis (JAX's ``axis_name`` on ``FlatBNStats``,
``FlatBatchNorm`` and ``nn.BatchNorm``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from elektronn3_tpu_torch.parallel.mesh import Axis

_STATS_GROUPS: List[Optional[Axis]] = []   # innermost last


class stats_group:
    """Context under which batch-norm statistics are summed over
    ``axis`` (None: per process, as outside any)."""

    def __init__(self, axis: Optional[Axis]):
        self.axis = axis

    def __enter__(self) -> Optional[Axis]:
        _STATS_GROUPS.append(self.axis)
        return self.axis

    def __exit__(self, *exc) -> bool:
        _STATS_GROUPS.pop()
        return False


def current_stats_group() -> Optional[Axis]:
    """The axis of the innermost :class:`stats_group`, None outside."""
    return _STATS_GROUPS[-1] if _STATS_GROUPS else None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.rows, ctx.index = x.shape[0], index
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        ctx.rows = x.shape[dim]
        return _gather0(x.movedim(dim, 0), group).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None,
                None, None)


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` on every one of them;
    its gradient is the same sum of the cotangents (see the module
    docstring)."""
    if axis is None or axis.group is None:
        return x
    return _PSum.apply(x, axis.group)


def all_gather(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along dim 0 in
    rank order (each rank's ``x`` of one shape); its gradient is this
    rank's block of the cotangent (see the module docstring)."""
    if axis is None or axis.group is None:
        return x
    return _AllGather.apply(x, axis.group, axis.index)


def gather_shards(x: torch.Tensor, axis: Optional[Axis],
                  dim: int) -> torch.Tensor:
    """Every rank's shard ``x`` of a parameter, concatenated along
    ``dim`` in rank order, contiguous; its gradient is this rank's block
    of the cotangents summed over the ranks (see the module
    docstring)."""
    if axis is None or axis.group is None:
        return x
    return _GatherShards.apply(x, axis.group, axis.index, dim)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_gather`` along dim 0 of a tensor of any dtype, in its
    own memory layout: the rows travel as bytes (gloo reduces no
    bfloat16 or bool, but moves bytes of any), and the result keeps the
    dimension order of ``x`` in memory (a channels-last view of
    channels-first logits stays one), so that what reads it (a loss, its
    backward) sums in the order it would on one process. A tensor whose
    dim 0 is not outermost in memory is gathered contiguous."""
    n = dist.get_world_size(group)
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    if not order or order[0] != 0:
        order = list(range(x.dim()))
    xm = x.permute(order).contiguous()
    if not xm.numel():
        out = xm.new_empty((xm.shape[0] * n,) + tuple(xm.shape[1:]))
    else:
        raw = xm.reshape(xm.shape[0], -1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=group)
        out = torch.cat(parts).view(x.dtype).reshape(
            (-1,) + tuple(xm.shape[1:]))
    return out.permute([order.index(d) for d in range(x.dim())])


def gather(x: torch.Tensor, axis: Optional[Axis],
           dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along ``dim``, with
    no gradient (serving: the reassembled output on every rank)."""
    if axis is None or axis.group is None:
        return x
    with torch.no_grad():
        return _gather0(x.detach().movedim(dim, 0),
                        axis.group).movedim(0, dim)


def sum_gradients(params: Iterable[torch.nn.Parameter],
                  axis: Optional[Axis]) -> None:
    """All-reduce the ``.grad`` of ``params`` with a SUM over ``axis``,
    one flat buffer a dtype, in place; parameters without a gradient are
    left out, on every rank alike (the ranks run one graph)."""
    if axis is None or axis.group is None:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=axis.group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
