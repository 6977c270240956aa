"""The port's ``parallel`` package (elektronn3_tpu_torch.parallel) on the
CPU: meshes, the multi-process setup, halo exchange, the losses of the
data-parallel step and the norms that take no collective.

Ranks run as processes of their own through ``parallel.launch`` (gloo,
a ``file://`` store in ``tmp_path``, one thread each, every launch under
a hard timeout), with bodies in ``tests/_torch_parallel_ranks.py``,
which imports no JAX; the JAX side runs here on the virtual CPU devices
of ``tests/conftest.py``.

- Meshes and setup in one process: shapes, the too-large
  ``ValueError``, ``init_distributed`` False without a cluster
  environment, ``host_local_batch``'s rows and checks; on 4 ranks a
  (2, 2) mesh's axes and groups; two processes joined through
  ``init_distributed()`` from torchrun's environment variables (the
  counterpart of ``tests/test_multihost.py``) training two steps alike,
  as the one-process step on the global batch does.
- ``exchange_halo`` and ``sharded_spatial_apply`` (the identity and a
  three-tap conv along the sharded axis) on 2 and 4 ranks against JAX's
  on as many devices, zeros at the ring's ends included; on one rank
  the plain result, and their checks of the extent and the halo.
- ``CEDiceLoss`` and a class-weighted cross entropy of the gathered
  logits on 2 ranks against JAX's loss of the global batch and
  ``jax.grad``.
- A group-norm UNet's training forward under a mesh: the one-process
  per-sample result, no collective; a 'batchp' UNet raises; a
  batch-norm ``UNet(axis_name='data')`` under ``with mesh:`` is the
  statistics group's.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.parallel import make_mesh as jax_mesh
from elektronn3_tpu.parallel.halo import exchange_halo as jax_exchange
from elektronn3_tpu.parallel.halo import (
    sharded_spatial_apply as jax_spatial_apply)
from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.parallel import (
    batch_sharding, data_parallel_mesh, exchange_halo, host_local_batch,
    init_distributed, launch, make_mesh, replicated, sharded_spatial_apply)
from elektronn3_tpu_torch.parallel.mesh import Axis
from elektronn3_tpu_torch.training import train_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANK_TIMEOUT = 120
HALO_SHAPE, HALO, HALO_AXIS = (2, 3, 16, 5, 2), 2, 2
TAPS = (0.25, 0.5, -0.75)
SMALL = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=8,
             planar_blocks=(0,))
GROUP = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
             planar_blocks=(0,), normalization="group", pallas_flat=True)


def _launch(body, n, d, spec):
    torch.save(spec, d / "spec.pt")
    launch(f"_torch_parallel_ranks:{body}", n, [str(d / "spec.pt")],
           timeout=RANK_TIMEOUT, workdir=str(d), pythonpath=[HERE],
           device="cpu")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# Meshes and setup in one process
# ---------------------------------------------------------------------------

def test_mesh_in_one_process_is_one_rank_without_collectives():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    axis = mesh.axis("data")
    assert (axis.size, axis.index, axis.group) == (1, 0, None)
    assert data_parallel_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="no axis 'space'"):
        mesh.axis("space")
    x = np.arange(12).reshape(4, 3)
    assert np.array_equal(batch_sharding(mesh).local(x), x)
    assert replicated(mesh).local(x) is x


def test_prefetch_to_device_keeps_this_ranks_rows():
    """``prefetch_to_device(sharding=batch_sharding(mesh))`` keeps the
    rank's block of rows of every array (rank 1 of 2 here, through a
    mesh that reports that axis), ``replicated`` all of them."""
    from elektronn3_tpu_torch.data.pipeline import prefetch_to_device
    from elektronn3_tpu_torch.parallel.mesh import Axis, Sharding

    class _Rank1Of2:
        def axis(self, name):
            return Axis(name, 2, 1, None)
    batch = {"inp": np.arange(24, dtype=np.float32).reshape(4, 6),
             "target": np.arange(4), "name": "b0"}
    got = next(prefetch_to_device(iter([batch]), device="cpu",
                                  sharding=Sharding(_Rank1Of2(), "data")))
    assert torch.equal(got["inp"], torch.from_numpy(batch["inp"][2:]))
    assert torch.equal(got["target"], torch.tensor([2, 3]))
    assert got["name"] == "b0"
    got = next(prefetch_to_device(iter([batch]), device="cpu",
                                  sharding=replicated(make_mesh())))
    assert torch.equal(got["inp"], torch.from_numpy(batch["inp"]))
    with pytest.raises(ValueError, match="equal shards"):
        next(prefetch_to_device(iter([{"inp": np.zeros((3, 2))}]),
                                device="cpu",
                                sharding=Sharding(_Rank1Of2(), "data")))


def test_init_distributed_without_cluster_env_is_false(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    # Slurm's variables without a coordinator: stay single-process.
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    assert init_distributed() is False
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("localhost:1234")


def test_ranks_go_on_the_card_unless_the_cpu_is_asked_for(monkeypatch,
                                                          tmp_path):
    """``launch`` and ``init_distributed`` put a rank on the card by
    default; without CUDA they raise before any rank or group starts,
    rather than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch("_torch_parallel_ranks:step", 2, workdir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(f"file://{tmp_path}/store", 1, 0)
    assert list(tmp_path.iterdir()) == []


def test_host_local_batch_checks_the_rows():
    mesh = make_mesh()
    local = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = host_local_batch((2, 3, 4), local, mesh, device="cpu")
    assert torch.equal(got, torch.from_numpy(local))
    with pytest.raises(ValueError, match="row block"):
        host_local_batch((4, 3, 4), local, mesh, device="cpu")
    with pytest.raises(ValueError, match="row block"):
        host_local_batch((2, 3, 5), local, mesh, device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_from_torchrun_environment(tmp_path):
    """Two processes with RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/
    MASTER_PORT set as torchrun sets them: ``init_distributed()`` joins
    them (True), ``make_global_mesh()`` is {'data': 2}, and two SGD
    steps give both ranks the same losses and parameters, those of the
    one-process steps on the global batch (SGD: Adam would scale the
    rounding noise of the exactly-zero gradient of a conv bias that
    feeds a batch norm up to a full step)."""
    rng = np.random.default_rng(3)
    m = UNet(device="cpu", **SMALL)
    x = torch.as_tensor(rng.normal(size=(4, 2, 8, 8, 1)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 2, size=(4, 2, 8, 8)))
    torch.save(dict(kw=SMALL, state=m.state_dict(), x=x, y=y),
               tmp_path / "spec.pt")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parallel_ranks.py"),
         "env_rank", str(tmp_path / "spec.pt")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["multi"] for r in ranks] == [True, True]
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["shape"] == {"data": 2}
    assert ranks[0]["losses"] == ranks[1]["losses"]
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    crit = ploss.CEDiceLoss(1.0, 1.0)
    ref = [float(train_step(m, crit, opt, x, y)) for _ in range(2)]
    np.testing.assert_allclose(ranks[0]["losses"], ref, rtol=1e-5)
    for name, p in m.named_parameters():
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name])
        err = float((ranks[0]["params"][name] - p.detach()).abs().max())
        assert err <= 1e-4 * float(p.detach().abs().max()) + 1e-6, \
            (name, err)


# ---------------------------------------------------------------------------
# Halo exchange against JAX; a (2, 2) mesh
# ---------------------------------------------------------------------------

def _jax_conv(t):
    pad = jnp.zeros_like(jax.lax.slice_in_dim(t, 0, 1, axis=HALO_AXIS))
    t = jnp.concatenate([pad, t, pad], axis=HALO_AXIS)
    n_out = t.shape[HALO_AXIS] - 2
    return sum(w * jax.lax.slice_in_dim(t, k, k + n_out, axis=HALO_AXIS)
               for k, w in enumerate(TAPS))


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    x = np.random.default_rng(7).normal(size=HALO_SHAPE).astype(np.float32)
    res = {}
    for n in (2, 4):
        ranks = _launch("halo", n, tmp_path_factory.mktemp(f"halo{n}"), dict(
            x=torch.from_numpy(x), halo=HALO, axis=HALO_AXIS, taps=TAPS))
        mesh = jax_mesh({"space": n})
        spec = P(*[("space" if i == HALO_AXIS else None)
                   for i in range(x.ndim)])
        exchanged = jax.jit(shard_map(
            lambda t: jax_exchange(t, HALO, HALO_AXIS, "space"), mesh=mesh,
            in_specs=(spec,), out_specs=spec, check_vma=False))(x)
        ref = dict(
            exchanged=np.split(np.asarray(exchanged), n, axis=HALO_AXIS),
            identity=np.asarray(jax.jit(jax_spatial_apply(
                lambda t: t, mesh, HALO, HALO_AXIS, "space"))(x)),
            conv=np.asarray(jax.jit(jax_spatial_apply(
                _jax_conv, mesh, HALO, HALO_AXIS, "space"))(x)))
        res[n] = (x, ranks, ref)
    return res


@pytest.mark.parametrize("n", [2, 4])
def test_exchange_halo_matches_jax(halo_runs, n):
    """Each rank's shard with its neighbours' slabs is JAX's block of
    that shard; the ring's ends hold zeros."""
    x, ranks, ref = halo_runs[n]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["exchanged"].numpy(),
                                      ref["exchanged"][r])
    first = ranks[0]["exchanged"].narrow(HALO_AXIS, 0, HALO)
    last = ranks[-1]["exchanged"].narrow(
        HALO_AXIS, ranks[-1]["exchanged"].shape[HALO_AXIS] - HALO, HALO)
    assert not first.any() and not last.any()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fn", ["identity", "conv"])
def test_sharded_spatial_apply_matches_jax(halo_runs, n, fn):
    """The full output on every rank is JAX's (the identity gives the
    input back; the conv with its halo is the unsharded conv)."""
    x, ranks, ref = halo_runs[n]
    for got in ranks:
        np.testing.assert_allclose(got[fn].numpy(), ref[fn], rtol=1e-6,
                                   atol=1e-6)
    if fn == "identity":
        np.testing.assert_array_equal(ranks[0][fn].numpy(), x)
    else:
        np.testing.assert_allclose(ref[fn], np.asarray(_jax_conv(x)),
                                   rtol=1e-6, atol=1e-6)


def _torch_conv(t):
    pad = torch.zeros_like(t.narrow(HALO_AXIS, 0, 1))
    t = torch.cat([pad, t, pad], dim=HALO_AXIS)
    n_out = t.shape[HALO_AXIS] - 2
    return sum(w * t.narrow(HALO_AXIS, k, n_out) for k, w in enumerate(TAPS))


class _FirstOf2:
    """A mesh whose 'space' axis has 2 ranks, this one the first, and no
    group (so nothing is gathered): for the checks made before any
    collective."""

    def axis(self, name):
        return Axis(name, 2, 0, None)


def test_exchange_halo_without_a_group_pads_zeros():
    """One rank is both ring ends: zeros on either side; a halo beyond
    the shard's extent raises."""
    x = torch.randn(HALO_SHAPE)
    one = Axis("space", 1, 0, None)
    zeros = torch.zeros_like(x.narrow(HALO_AXIS, 0, HALO))
    assert torch.equal(exchange_halo(x, HALO, HALO_AXIS, one),
                       torch.cat([zeros, x, zeros], dim=HALO_AXIS))
    with pytest.raises(ValueError, match="halo"):
        exchange_halo(x, HALO_SHAPE[HALO_AXIS] + 1, HALO_AXIS, one)


@pytest.mark.parametrize("fn", ["identity", "conv"])
def test_sharded_spatial_apply_in_one_process_is_the_plain_apply(fn):
    """On a one-rank 'space' axis the shard is the volume, its halo the
    zeros of the conv's own padding: the plain result, bit for bit."""
    f = (lambda t: t) if fn == "identity" else _torch_conv
    x = torch.randn(HALO_SHAPE)
    got = sharded_spatial_apply(f, make_mesh({"space": 1}), HALO,
                                HALO_AXIS)(x)
    assert torch.equal(got, f(x))


@pytest.mark.parametrize("extent, halo, match", [
    (15, HALO, "does not split"), (16, 9, "halo 9 must be in 1..8"),
    (16, 0, "halo 0 must be in")])
def test_sharded_spatial_apply_checks_extent_and_halo(extent, halo, match):
    """An extent the ranks do not divide, a halo beyond a shard or of
    nothing raise ValueError before any collective."""
    shape = list(HALO_SHAPE)
    shape[HALO_AXIS] = extent
    with pytest.raises(ValueError, match=match):
        sharded_spatial_apply(lambda t: t, _FirstOf2(), halo, HALO_AXIS)(
            torch.zeros(shape))


def test_two_axis_mesh_groups(halo_runs):
    """On 4 ranks {'data': 2, 'space': 2}: rank r sits at (r // 2, r % 2)
    and each axis's group sums the ranks along that axis alone; a shape
    of 8 raises."""
    _, ranks, _ = halo_runs[4]
    for r, got in enumerate(ranks):
        assert got["coords"] == (r // 2, r % 2)
        assert got["sums"] == {"data": (r % 2) * 2 + 2, "space":
                               (r // 2) * 4 + 1}
        assert got["too_large"]


# ---------------------------------------------------------------------------
# Losses of the gathered logits; norms that take no collective
# ---------------------------------------------------------------------------

LOGITS_SHAPE = (4, 3, 4, 4, 2)
WEIGHT = (0.3, 1.7)


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=LOGITS_SHAPE).astype(np.float32)
    target = rng.integers(0, 2, size=LOGITS_SHAPE[:-1])
    losses = _launch("losses", 2, tmp_path_factory.mktemp("losses"), dict(
        logits=torch.from_numpy(logits), target=torch.from_numpy(target),
        weight=WEIGHT))
    m = UNet(device="cpu", **GROUP)
    x = torch.as_tensor(rng.normal(size=(4, 2, 8, 16, 1)),
                        dtype=torch.float32)
    norms = _launch("norms", 2, tmp_path_factory.mktemp("norms"), dict(
        kw=GROUP, state=m.state_dict(), x=x, bn_state=UNet(
            device="cpu", **dict(GROUP, normalization="batch")).state_dict()))
    return dict(logits=logits, target=target, losses=losses, norms=norms,
                model=m, x=x)


@pytest.mark.parametrize("name", ["cedice", "weighted_ce"])
def test_global_loss_and_gradient_match_jax(two_rank_runs, name):
    """The loss of the gathered logits and each rank's gradient are JAX's
    loss of the global batch and its block of ``jax.grad``. Without the
    gather each rank's loss is of its own rows: Dice sums over batch and
    space and the weighted cross entropy divides a sum by a sum, so the
    mean of the per-rank losses is another number (asserted below), and
    so is the gradient that a DDP-style average of them gives."""
    run = two_rank_runs
    crit = (jloss.CEDiceLoss(1.0, 1.0) if name == "cedice"
            else jloss.CrossEntropyLoss(weight=jnp.asarray(WEIGHT)))
    target = jnp.asarray(run["target"])
    loss, grad = jax.value_and_grad(lambda o: crit(o, target))(
        jnp.asarray(run["logits"]))
    grad = np.split(np.asarray(grad), 2)
    for r, got in enumerate(run["losses"]):
        got = got[name]
        assert abs(got["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
        np.testing.assert_allclose(got["grad"].numpy(), grad[r], rtol=1e-5,
                                   atol=1e-8)
    alone = np.mean([got[name]["alone"] for got in run["losses"]])
    assert abs(alone - float(loss)) > 1e-4


def test_group_norm_under_a_mesh_is_per_sample(two_rank_runs):
    """A group norm's statistics are each sample's own: the kernel
    levels' ``gn_prologue`` and the library ``GroupNorm`` run no
    collective under a mesh, and each rank's logits are the one-process
    forward of its rows, bit for bit."""
    run = two_rank_runs
    m = run["model"].train()
    for r, got in enumerate(run["norms"]):
        assert got["calls"] == []
        with torch.no_grad():
            ref = m(run["x"][2 * r:2 * r + 2])
        assert torch.equal(got["local"], ref)


def test_batchp_across_ranks_raises(two_rank_runs):
    """'batchp' trains its batch norms on one rank's rows (K8/K10): across
    two ranks it raises rather than normalize each shard by itself, as
    JAX's 'batchp' levels do under shard_map."""
    for got in two_rank_runs["norms"]:
        assert "normalization='batchp'" in got["raised"]
        assert "2 ranks" in got["raised"]


def test_unet_axis_name_under_a_mesh_sums_the_statistics(two_rank_runs):
    """``UNet(axis_name='data')`` in training under ``with mesh:`` (JAX's
    ``axis_name`` under ``shard_map``) gives the statistics group's
    logits and running statistics, bit for bit; they are not the rank's
    own rows' (the model by itself)."""
    for got in two_rank_runs["norms"]:
        ref, ax, alone = (got["bn"][k] for k in ("stats_group", "axis_name",
                                                 "alone"))
        assert torch.equal(ax["out"], ref["out"])
        assert ax["buffers"].keys() == ref["buffers"].keys()
        for k, b in ref["buffers"].items():
            assert torch.equal(ax["buffers"][k], b), k
        assert not torch.allclose(alone["out"], ref["out"], atol=1e-3)
