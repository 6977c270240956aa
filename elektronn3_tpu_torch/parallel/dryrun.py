"""Multi-rank dry run: every parallel axis of the port, on CPU ranks.

Counterpart of the JAX package's ``parallel/dryrun.py`` (and its
``__graft_entry__.dryrun_multichip``). :func:`dryrun_multichip` starts
``n`` gloo ranks on the CPU (``distributed.launch``) and each runs
:func:`run_dryrun`, which raises on a failure:

- **dp**: a small batch-norm UNet on its library levels, one Adam step
  of ``train_step(mesh=...)`` on a batch split over the 'data' axis;
  the loss finite and the parameters the same on every rank.
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

JAX's fsdp-style parameter sharding is not in the port (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch


def _same_on_every_rank(t: torch.Tensor, axis, what: str) -> None:
    from elektronn3_tpu_torch.parallel.collectives import gather
    every = gather(t.detach().reshape(1, -1), axis)
    if not bool((every == every[:1]).all()):
        raise AssertionError(f"dry run: {what} differs between ranks")


def _params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


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
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = train_step(model, crit, opt, *batch((2 * n, 4, 16, 16, 1)),
                      mesh=mesh)
    if not np.isfinite(float(loss)):
        raise AssertionError("dry run: dp step gave a non-finite loss")
    _same_on_every_rank(_params(model), data, "dp parameters")

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
