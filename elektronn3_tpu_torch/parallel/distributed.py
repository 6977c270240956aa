"""Multi-process setup: ``torch.distributed`` and meshes over its ranks.

Counterpart of the JAX package's ``parallel/distributed.py``. JAX runs
one process a host and ``jax.distributed`` joins the hosts; the port
runs one process a card (a rank), as ``torchrun`` launches it:

1. Every rank calls :func:`init_distributed` once, before building a
   mesh. It reads its setup from explicit arguments, else from
   ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), Slurm's
   (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``) or Open
   MPI's (``OMPI_COMM_WORLD_*``); the last two need ``MASTER_ADDR``.
   The backend is NCCL on ``cuda:LOCAL_RANK``; the CPU (gloo) only when
   the caller asks for it.
2. :func:`make_global_mesh` lays a 'data' axis over every rank.
3. ``Trainer(mesh=mesh, batch_size=global_batch)``: each rank draws the
   same global batch and keeps its rows (:func:`host_local_batch` cuts
   and checks a rank's rows of an array).

For example, on one host with 4 cards::

    torchrun --nproc-per-node 4 train.py   # each rank:
        init_distributed()
        mesh = make_global_mesh()
        Trainer(model, ..., mesh=mesh, batch_size=8)

:func:`launch` starts such ranks as processes of its own (the tests,
:func:`~elektronn3_tpu_torch.parallel.dryrun.dryrun_multichip` and the
card's check of two ranks sharing a card use it).
"""

from __future__ import annotations

import datetime
import importlib
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elektronn3_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger("elektronn3_tpu_torch")

_DEVICE: List[torch.device] = []   # this rank's device, once initialized


def _cluster_env() -> Optional[Dict[str, int]]:
    """(rank, world, local rank) from torchrun's, Slurm's or Open MPI's
    environment, None without any."""
    for rank, world, local in (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
                               ("SLURM_PROCID", "SLURM_NTASKS",
                                "SLURM_LOCALID"),
                               ("OMPI_COMM_WORLD_RANK",
                                "OMPI_COMM_WORLD_SIZE",
                                "OMPI_COMM_WORLD_LOCAL_RANK")):
        if rank in os.environ and world in os.environ:
            return dict(rank=int(os.environ[rank]),
                        world=int(os.environ[world]),
                        local=int(os.environ.get(local, 0)))
    return None


def _init_method(address: str) -> str:
    """A ``tcp://`` or ``file://`` URL from a URL or ``host:port``."""
    if "://" in address:
        return address
    return f"tcp://{address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout: float = 600.0) -> bool:
    """Join the ranks' default process group. Returns True if the world
    has more than one rank, False for one rank or without a cluster
    environment (JAX's return).

    ``coordinator_address`` (``host:port``, ``tcp://...`` or
    ``file://...``), ``num_processes`` and ``process_id`` given
    together set up the group; otherwise the cluster environment does
    (see the module docstring), and without one nothing happens.
    ``device``: 'cpu' asks for the CPU and gloo; None is
    ``cuda:LOCAL_RANK``; a 'cuda:k' string pins every rank of this
    process to card k (ranks sharing a card, which NCCL refuses: pass
    ``backend='gloo'``). ``backend`` defaults to NCCL for a card and
    gloo for the CPU. A rank never falls back to the CPU: without CUDA,
    a card device raises."""
    explicit = coordinator_address is not None
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        rank, world = process_id, num_processes
        local = process_id if local_rank is None else local_rank
        method = _init_method(coordinator_address)
    else:
        env = _cluster_env()
        if env is None:
            return False
        rank, world, local = env["rank"], env["world"], env["local"]
        if local_rank is not None:
            local = local_rank
        if "MASTER_ADDR" not in os.environ:
            logger.info("cluster environment without MASTER_ADDR; running "
                        "single-process.")
            return False
        method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                  f"{os.environ.get('MASTER_PORT', '29500')}")
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU.")
        dev = torch.device(device) if device is not None \
            else torch.device("cuda", local)
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    _DEVICE[:] = [dev]
    return world > 1


def local_device() -> torch.device:
    """The device :func:`init_distributed` gave this rank; the current
    card without a process group (a ``RuntimeError`` without one)."""
    if _DEVICE:
        return _DEVICE[0]
    if not torch.cuda.is_available():
        raise RuntimeError("no process group and no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def num_processes() -> int:
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() \
        if dist.is_available() and dist.is_initialized() else 0


def make_global_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over every rank of the job; with ``axes=None`` one 'data'
    axis (ranks in order, so a host's cards are neighbours on it)."""
    return make_mesh(axes)


def host_local_batch(global_shape: Sequence[int], local, mesh: Mesh,
                     axis: str = "data",
                     device=None) -> torch.Tensor:
    """This rank's rows of a global batch as a tensor on ``device``
    (default :func:`local_device`), with the shapes checked: ``local``
    holds ``global_shape[0] / size`` rows of the other dimensions of
    ``global_shape``, ``size`` the mesh axis ``axis``'s (JAX's
    ``host_local_batch`` assembles the global array from these parts;
    here each rank keeps its own)."""
    size = mesh.axis_size(axis)
    local = torch.as_tensor(np.asarray(local) if not isinstance(
        local, torch.Tensor) else local)
    want = (global_shape[0] // size,) + tuple(global_shape[1:])
    if global_shape[0] % size or tuple(local.shape) != want:
        raise ValueError(f"local shard {tuple(local.shape)} is not a "
                         f"1/{size} row block of {tuple(global_shape)}")
    return local.to(local_device() if device is None else device)


def _rank_main() -> None:
    """The body of one process of :func:`launch`: join the group, call
    the target, wait for every rank, leave the group."""
    target, store, rank, world, device, backend, *args = sys.argv[1:]
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(store, int(world), int(rank), device=device or None,
                     backend=backend or None)
    try:
        module, name = target.split(":")
        getattr(importlib.import_module(module), name)(*args)
        # No rank tears the group down while another still moves data
        # of the last collective through it.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(target: str, nprocs: int, args: Sequence[str] = (), *,
           device: Optional[str] = None, backend: Optional[str] = None,
           timeout: float = 300.0, workdir: Optional[str] = None,
           pythonpath: Sequence[str] = ()) -> List[str]:
    """Run ``target`` ('module:function') in ``nprocs`` new processes,
    ranks 0..nprocs-1 of one world joined through a ``file://`` store in
    ``workdir`` (a new temporary directory if None): each calls
    :func:`init_distributed` with ``device`` and ``backend``, then
    ``function(*args)`` (strings), then leaves the group. ``device``
    None is :func:`init_distributed`'s: rank r on ``cuda:r`` over NCCL
    (a ``RuntimeError`` here without CUDA); 'cpu' asks for gloo CPU
    ranks, which run one thread each. Returns each rank's standard
    output. If a rank fails or ``timeout`` seconds pass, every rank
    still running is killed (the others would wait in a collective) and
    ``RuntimeError`` gives the failed ranks' standard error."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("launch: no CUDA device; pass device='cpu' to "
                           "run the ranks on the CPU.")
    own = workdir is None
    if own:
        workdir = tempfile.mkdtemp(prefix="e3t-launch-")
    store = "file://" + os.path.join(workdir, f"store-{uuid.uuid4().hex}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root, *pythonpath] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        env.pop(k, None)
    code = ("from elektronn3_tpu_torch.parallel.distributed import "
            "_rank_main; _rank_main()")
    procs, outs = [], []
    try:
        for r in range(nprocs):
            out = tempfile.TemporaryFile(dir=workdir)
            err = tempfile.TemporaryFile(dir=workdir)
            outs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, target, store, str(r),
                 str(nprocs), device or "", backend or "",
                 *map(str, args)],
                env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for out, err in outs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read().decode(errors="replace"),
                      err.read().decode(errors="replace")))
        out.close()
        err.close()
    if own:
        shutil.rmtree(workdir, ignore_errors=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        why = f"timed out after {timeout} s" if timed_out else "failed"
        raise RuntimeError(
            f"launch({target!r}, {nprocs}) {why}; ranks {failed}:\n"
            + "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                        f"{texts[r][1][-3000:]}" for r in failed))
    return [t[0] for t in texts]
