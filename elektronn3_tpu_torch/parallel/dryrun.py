"""Multi-rank dry run: every parallel axis of the port, on CPU ranks.

Counterpart of the JAX package's ``parallel/dryrun.py`` (and its
``__graft_entry__.dryrun_multichip``). :func:`dryrun_multichip` starts
``n`` gloo ranks on the CPU (``distributed.launch``) and each runs
:func:`run_dryrun`, which raises on a failure:

- **dp**: a small batch-norm UNet on its library levels, one Adam step
  of ``train_step(mesh=...)`` on a batch split over the 'data' axis;
  the loss finite and the parameters the same on every rank.
- **fsdp-style parameter sharding** (JAX's ``_fsdp_spec``): the same
  step from the same start with each large kernel split over 'data' on
  its output-channel axis (:func:`fsdp_dims`), each rank holding its
  block and the block's Adam moments (:func:`fsdp_shard`), gathered
  whole for the forward (:func:`fsdp_step`); the loss finite, the
  gathered parameters the dp step's (1e-6), each sharded leaf and its
  moments a 1/n share.
- **sp**: the H axis split over a 'space' axis: each rank's shard with
  its neighbours' halo slabs (``exchange_halo``) equal to that block of
  the zero-padded input, the model's eval forward on shard + halo
  (``sharded_spatial_apply``) finite, and a tile-sharded ``Predictor``
  request.
- **dp over the kernel levels**: a bf16 ``pallas_flat=True`` UNet whose
  levels run the kernel ops (their plain versions on the CPU), the
  batch-norm statistics summed at every kernel level.
- **headline geometry** (n_blocks=4, start_filts=32, planar_blocks=(0,),
  patch (44, 88, 88), global batch 8, ``bench.py``'s): the level plan
  of each rank's shard, which must be the one-process plan of that
  shard; and, as JAX executes its quarter geometry on the CPU (its full
  step takes minutes there), one executed step at (22, 44, 44).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from elektronn3_tpu_torch.parallel.collectives import (
    all_gather, gather, gather_shards, stats_group, sum_gradients)
from elektronn3_tpu_torch.parallel.mesh import shard_rows

FSDP_MIN_SIZE = 512   # JAX's _fsdp_spec: smaller parameters replicate


def _same_on_every_rank(t: torch.Tensor, axis, what: str) -> None:
    every = gather(t.detach().reshape(1, -1), axis)
    if not bool((every == every[:1]).all()):
        raise AssertionError(f"dry run: {what} differs between ranks")


def _params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def fsdp_dims(model: nn.Module, n: int) -> Dict[str, Optional[int]]:
    """JAX's ``_fsdp_spec`` for each parameter of ``model`` over ``n``
    ranks: the dim it is split along, or None where it is replicated.
    JAX splits the last axis of a kernel of at least 2 axes and
    ``FSDP_MIN_SIZE`` elements when ``n`` divides it: the output channels,
    which are dim 0 of a torch conv or linear weight (C_out, C_in, k...)
    and dim 1 of a transposed conv's (C_in, C_out, k...)."""
    dims = {}
    for prefix, mod in model.named_modules():
        transposed = isinstance(mod, nn.modules.conv._ConvTransposeNd)
        for name, p in mod.named_parameters(recurse=False):
            d = 1 if transposed else 0
            split = p.dim() >= 2 and p.numel() >= FSDP_MIN_SIZE \
                and p.shape[d] % n == 0
            dims[f"{prefix}.{name}" if prefix else name] = \
                d if split else None
    return dims


def fsdp_shard(model: nn.Module, dims: Dict[str, Optional[int]], axis
               ) -> Dict[str, nn.Parameter]:
    """This rank's parameters of ``model`` as new leaves: its block
    (``axis.index`` of ``axis.size``) of each parameter ``dims`` splits,
    the others whole. An optimizer over them keeps each block's moments
    on its rank alone."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if dims[name] is not None:
            t = t.chunk(axis.size, dims[name])[axis.index]
        out[name] = nn.Parameter(t.contiguous().clone())
    return out


def fsdp_gather(params: Dict[str, torch.Tensor],
                dims: Dict[str, Optional[int]], axis
                ) -> Dict[str, torch.Tensor]:
    """The whole parameters from every rank's blocks (``gather_shards``:
    its backward leaves each rank the summed gradient of its block)."""
    return {k: p if dims[k] is None else gather_shards(p, axis, dims[k])
            for k, p in params.items()}


def fsdp_step(model: nn.Module, params: Dict[str, nn.Parameter],
              dims: Dict[str, Optional[int]], criterion: Callable,
              optimizer: torch.optim.Optimizer, inp: torch.Tensor,
              target: torch.Tensor, axis) -> torch.Tensor:
    """One training step of the fsdp leg, ``train_step(mesh=...)``'s
    with sharded parameters: ``model`` runs on this rank's rows of the
    global batch ``inp`` with the whole parameters gathered from
    ``params`` (``torch.func.functional_call``; its buffers, the running
    statistics, are its own and update as they do there) and its batch
    norms' statistics summed over ``axis``; the logits are all-gathered
    and the loss is the global batch's; the replicated parameters'
    gradients are summed over the axis (``sum_gradients``), the blocks'
    come summed from the gather; ``optimizer`` (over ``params``) steps.
    Returns the detached float32 loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    whole = fsdp_gather(params, dims, axis)
    with stats_group(axis):
        out = torch.func.functional_call(model, whole,
                                         (shard_rows(inp, axis),))
    loss = criterion(all_gather(out, axis), target).float()
    loss.backward()
    sum_gradients([p for k, p in params.items() if dims[k] is None], axis)
    optimizer.step()
    return loss.detach()


def _fsdp_leg(start: nn.Module, stepped: nn.Module, crit, x, y, axis
              ) -> None:
    """The fsdp step of ``start`` (a copy of the dp leg's model before
    its step) on the dp leg's batch, held against ``stepped``."""
    dims = fsdp_dims(start, axis.size)
    if not any(d is not None for d in dims.values()):
        raise AssertionError("dry run: fsdp shards no parameter")
    params = fsdp_shard(start, dims, axis)
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    loss = fsdp_step(start, params, dims, crit, opt, x, y, axis)
    if not np.isfinite(float(loss)):
        raise AssertionError("dry run: fsdp step gave a non-finite loss")
    ref = dict(stepped.named_parameters())
    with torch.no_grad():
        whole = fsdp_gather(params, dims, axis)
    for name, p in params.items():
        err = float((whole[name] - ref[name]).abs().max())
        if whole[name].shape != ref[name].shape or not err <= 1e-6:
            raise AssertionError(f"dry run: fsdp step's {name} is {err} "
                                 "off the dp step's")
        if dims[name] is not None:
            share = ref[name].numel() // axis.size
            sizes = [p.numel()] + [v.numel() for v in opt.state[p].values()
                                   if v.dim()]
            if sizes != [share] * 3:
                raise AssertionError(f"dry run: fsdp leaf {name} and its "
                                     f"moments hold {sizes}, not {share}")


def run_dryrun(n_devices: str) -> None:
    """One rank's dry run over a world of ``n_devices`` ranks (a string:
    the ``launch`` argument); raises on a failure."""
    import torch.distributed as dist

    from elektronn3_tpu_torch.inference import Predictor
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.parallel import make_mesh
    from elektronn3_tpu_torch.parallel.halo import (
        exchange_halo, sharded_spatial_apply)
    from elektronn3_tpu_torch.training import train_step

    n = int(n_devices)
    if dist.get_world_size() != n:
        raise RuntimeError(f"run_dryrun({n}) in a world of "
                           f"{dist.get_world_size()} ranks")
    mesh = make_mesh({"data": n})
    data = mesh.axis("data")
    rng = np.random.default_rng(0)
    crit = CEDiceLoss()

    def batch(shape, dtype=torch.float32):
        x = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
        y = torch.as_tensor(rng.integers(0, 2, size=shape[:-1]))
        return x, y

    # dp, library levels
    model = UNet(n_blocks=2, start_filts=4, planar_blocks=(0,),
                 normalization="batch", device="cpu")
    start = copy.deepcopy(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x, y = batch((2 * n, 4, 16, 16, 1))
    loss = train_step(model, crit, opt, x, y, mesh=mesh)
    if not np.isfinite(float(loss)):
        raise AssertionError("dry run: dp step gave a non-finite loss")
    _same_on_every_rank(_params(model), data, "dp parameters")

    # fsdp: the same step from the same start, large kernels split
    _fsdp_leg(start, model, crit, x, y, data)

    # sp: H split over a 'space' axis, halo exchange
    model.eval()
    space = make_mesh({"space": n})
    x = torch.as_tensor(rng.normal(size=(1, 4, 16 * n, 16, 1)),
                        dtype=torch.float32)
    i = space.axis_index("space")
    zeros = torch.zeros_like(x.narrow(2, 0, 4))
    if not torch.equal(
            exchange_halo(x.narrow(2, 16 * i, 16), 4, 2, space.axis("space")),
            torch.cat([zeros, x, zeros], dim=2).narrow(2, 16 * i, 24)):
        raise AssertionError("dry run: halo exchange gave other slabs")
    fwd = sharded_spatial_apply(model, space, halo=4, spatial_axis=2)
    with torch.no_grad():
        out = fwd(x)
    if out.shape[:-1] != (1, 4, 16 * n, 16) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError("dry run: spatial forward failed")
    probs = Predictor(model, tile_shape=(4, 16, 16), overlap_shape=(2, 4, 4),
                      mesh=mesh, shard_mode="tiles").predict(
        rng.normal(size=(1, 1, 8, 32, 32)).astype(np.float32))
    if not np.isfinite(probs).all():
        raise AssertionError("dry run: tile-sharded request failed")

    # dp over the kernel levels (plain versions on the CPU)
    model = UNet(n_blocks=2, start_filts=32, planar_blocks=(0,),
                 normalization="batch", pallas_flat=True,
                 dtype=torch.bfloat16, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    shape = (n, 2, 8, 16, 1)
    if model.level_kinds((1,) + shape[1:]) != ["kernels", "library"]:
        raise AssertionError(f"dry run: kernel levels planned as "
                             f"{model.level_kinds(shape)}")
    loss = train_step(model, crit, opt, *batch(shape, torch.bfloat16),
                      mesh=mesh)
    if not np.isfinite(float(loss)):
        raise AssertionError("dry run: kernel-level dp step failed")
    _same_on_every_rank(_params(model), data, "kernel-level parameters")

    # headline geometry: the plan of the shard at full size, one step at
    # a quarter of it
    global_batch = max(8, n)
    if global_batch % n:
        global_batch = n * (global_batch // n + 1)
    model = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,),
                 normalization="batch", device="cpu")
    full = (global_batch // n, 44, 88, 88, 1)
    if model.level_kinds(full) != UNet(
            n_blocks=4, start_filts=32, planar_blocks=(0,),
            device="meta").level_kinds(full):
        raise AssertionError("dry run: the headline plan depends on the "
                             "mesh")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = train_step(model, crit, opt,
                      *batch((global_batch, 22, 44, 44, 1)), mesh=mesh)
    if not np.isfinite(float(loss)):
        raise AssertionError("dry run: headline-geometry step failed")
    _same_on_every_rank(_params(model), data, "headline parameters")
    if dist.get_rank() == 0:
        print(f"DRYRUN_OK {n}", flush=True)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """Run :func:`run_dryrun` on ``n_devices`` gloo ranks on the CPU
    (each a process of its own, one thread); raises ``RuntimeError``
    if a rank fails or ``timeout`` seconds pass."""
    from elektronn3_tpu_torch.parallel.distributed import launch

    outs = launch("elektronn3_tpu_torch.parallel.dryrun:run_dryrun",
                  n_devices, [str(n_devices)], device="cpu",
                  timeout=timeout)
    if f"DRYRUN_OK {n_devices}" not in outs[0]:
        raise RuntimeError(f"dry run on {n_devices} ranks printed no "
                           f"result: {outs[0][-2000:]}")
