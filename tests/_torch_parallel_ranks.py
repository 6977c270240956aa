"""Rank bodies of the port's multi-process tests (tests/
test_torch_parallel*.py), run by ``elektronn3_tpu_torch.parallel.launch``
on gloo CPU ranks. This module imports torch and the port only, never
JAX: each rank reads its inputs from a ``spec.pt`` the test wrote, and
writes what the test compares to ``rank{r}.pt`` beside it."""

import contextlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from elektronn3_tpu_torch.parallel import (
    all_gather, exchange_halo, make_mesh, sharded_spatial_apply,
    stats_group)
from elektronn3_tpu_torch.parallel.mesh import shard_rows


def _spec(path):
    return torch.load(path, weights_only=False)


def _save(path, obj):
    torch.save(obj, os.path.join(os.path.dirname(path),
                                 f"rank{dist.get_rank()}.pt"))


def _model(kw, state):
    from elektronn3_tpu_torch.models import UNet
    m = UNet(device="cpu", **kw)
    m.load_state_dict(state)
    return m


def step(path):
    """One ``train_step(mesh=...)`` per case of the spec, SGD at rate 0
    so the gradients stay in ``.grad``: the loss, every gradient, the new
    buffers, and the collectives counted."""
    from elektronn3_tpu_torch.modules import loss as ploss
    from elektronn3_tpu_torch.training import train_step
    spec = _spec(path)
    mesh = make_mesh({"data": dist.get_world_size()})
    out = {}
    for name, case in spec.items():
        m = _model(case["kw"], case["state"])
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        loss = train_step(m, ploss.CEDiceLoss(1.0, 1.0), opt, case["x"],
                          case["y"], mesh=mesh)
        out[name] = dict(
            loss=float(loss),
            grads={n: p.grad.clone() for n, p in m.named_parameters()},
            buffers={n: b.clone() for n, b in m.named_buffers()},
            kinds=m.level_kinds((1,) + tuple(case["x"].shape[1:])))
    _save(path, out)


def halo(path):
    """``exchange_halo`` of this rank's shard, and ``sharded_spatial_apply``
    of the identity and of a three-tap conv along the sharded axis."""
    spec = _spec(path)
    x, h, ax = spec["x"], spec["halo"], spec["axis"]
    n = dist.get_world_size()
    mesh = make_mesh({"space": n})
    space = mesh.axis("space")
    m = x.shape[ax] // n
    local = x.narrow(ax, space.index * m, m)
    taps = spec["taps"]

    def conv(t):
        pad = torch.zeros_like(t.narrow(ax, 0, 1))
        t = torch.cat([pad, t, pad], dim=ax)
        n_out = t.shape[ax] - 2
        return sum(w * t.narrow(ax, k, n_out) for k, w in enumerate(taps))

    out = dict(exchanged=exchange_halo(local, h, ax, space),
               identity=sharded_spatial_apply(lambda t: t, mesh, h, ax)(x),
               conv=sharded_spatial_apply(conv, mesh, h, ax)(x))
    if n == 4:
        grid = make_mesh({"data": 2, "space": 2})
        out["coords"] = (grid.axis_index("data"), grid.axis_index("space"))
        out["sums"] = {}
        for name in ("data", "space"):
            t = torch.tensor([float(dist.get_rank())])
            dist.all_reduce(t, group=grid.axis(name).group)
            out["sums"][name] = int(t)
        try:
            make_mesh({"data": 8})
            out["too_large"] = False
        except ValueError:
            out["too_large"] = True
    _save(path, out)


def losses(path):
    """``CEDiceLoss`` and a class-weighted cross entropy of the gathered
    logits, and each loss of this rank's rows alone, with the gradients
    of this rank's logits."""
    from elektronn3_tpu_torch.modules import loss as ploss
    spec = _spec(path)
    dp = make_mesh({"data": dist.get_world_size()}).axis("data")
    out = {}
    for name, crit in (("cedice", ploss.CEDiceLoss(1.0, 1.0)),
                       ("weighted_ce", ploss.CrossEntropyLoss(
                           weight=spec["weight"]))):
        local = shard_rows(spec["logits"], dp).clone().requires_grad_()
        loss = crit(all_gather(local, dp), spec["target"])
        loss.backward()
        alone = crit(local.detach(), shard_rows(spec["target"], dp))
        out[name] = dict(loss=float(loss), grad=local.grad.clone(),
                         alone=float(alone))
    _save(path, out)


def norms(path):
    """A group-norm UNet's training forward under the statistics group
    (its local logits, and the collectives it ran), a 'batchp' UNet's,
    which must raise, and a batch-norm UNet's three ways (the group,
    its ``axis_name`` under the mesh, neither): logits and buffers."""
    from elektronn3_tpu_torch.models import UNet
    spec = _spec(path)
    mesh = make_mesh({"data": dist.get_world_size()})
    dp = mesh.axis("data")
    m = _model(spec["kw"], spec["state"]).train()
    calls = []
    real = dist.all_reduce, dist.all_gather

    def count(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    dist.all_reduce, dist.all_gather = map(count, real)
    try:
        with stats_group(dp):
            local = m(shard_rows(spec["x"], dp))
    finally:
        dist.all_reduce, dist.all_gather = real
    batchp = UNet(device="cpu", **dict(spec["kw"], normalization="batchp",
                                       pallas_flat=False)).train()
    try:
        with stats_group(dp):
            batchp(shard_rows(spec["x"], dp))
        raised = ""
    except ValueError as e:
        raised = str(e)
    # A batch-norm UNet under the statistics group, and with
    # ``axis_name='data'`` under ``with mesh:``, and by itself.
    bn_kw = dict(spec["kw"], normalization="batch")
    runs = {}
    for how in ("stats_group", "axis_name", "alone"):
        kw = dict(bn_kw, axis_name="data") if how == "axis_name" else bn_kw
        bn = _model(kw, spec["bn_state"]).train()
        with (stats_group(dp) if how == "stats_group" else mesh
              if how == "axis_name" else contextlib.nullcontext()):
            out = bn(shard_rows(spec["x"], dp))
        runs[how] = dict(out=out.detach(), buffers={
            n: b.clone() for n, b in bn.named_buffers()})
    _save(path, dict(local=local.detach(), calls=calls, raised=raised,
                     bn=runs))


def predictor(path):
    """The spec's model served through ``Predictor(mesh=...)``: the whole
    input split along H over a 'space' axis of every rank with a halo,
    and a tile grid split over a 'data' axis of every rank."""
    from elektronn3_tpu_torch.inference import Predictor
    spec = _spec(path)
    m = _model(spec["kw"], spec["state"])
    n = dist.get_world_size()
    spatial = Predictor(m, mesh=make_mesh({"space": n}), shard_axis=2,
                        halo=spec["halo"]).predict(spec["spatial_inp"])
    tiles = Predictor(m, mesh=make_mesh({"data": n}), shard_mode="tiles",
                      **spec["tiles_kw"]).predict(spec["tiles_inp"])
    _save(path, dict(spatial=spatial, tiles=tiles))


class ToySet:
    """Map-style dataset of ``n`` (C=1, 2, 8, 8) samples, each from its
    index's own generator (the same on every rank)."""

    def __init__(self, n, offset=0):
        self.n, self.offset = n, offset

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.offset + i)
        return {"inp": rng.normal(size=(1, 2, 8, 8)).astype(np.float32),
                "target": rng.integers(0, 2, size=(2, 8, 8)).astype(
                    np.int64)}


def run_trainer(kw, state, save_root, mesh=None, strategy="auto",
                hist_failures=None):
    """A ``Trainer`` of the spec's model for 3 steps (batch 4 of 8
    samples: two epochs, each validated on 5 samples, the last batch of
    1), then ``bn_update`` on the validation set's batches; returns the
    Trainer. The tests run it in one process too, on the global batch.
    With a list ``hist_failures``, every ``add_histogram`` of rank 0's
    writer raises, and is counted there."""
    from elektronn3_tpu_torch.data.pipeline import DataLoader
    from elektronn3_tpu_torch.modules import loss as ploss
    from elektronn3_tpu_torch.training import Trainer, bn_update, metrics
    m = _model(kw, state)
    tr = Trainer(m, ploss.CEDiceLoss(1.0, 1.0),
                 optimizer=torch.optim.SGD(m.parameters(), lr=0.1),
                 train_dataset=ToySet(8), valid_dataset=ToySet(5, 100),
                 valid_metrics={"val_DSC": metrics.DSC(),
                                "val_AUROC": metrics.AUROC()},
                 batch_size=4, save_root=save_root, exp_name="run",
                 tb_hist_interval=1, mesh=mesh, shard_strategy=strategy,
                 preview_batch=np.zeros((1, 1, 2, 8, 8), np.float32),
                 preview_interval=1, seed=5)
    if hist_failures is not None and tr.tb is not None:
        def failing(*args, **kwargs):
            hist_failures.append(args[0])
            raise RuntimeError("histogram writer failed")
        tr.tb.add_histogram = failing
    tr.run(max_steps=3)
    bn_update(DataLoader(ToySet(8, 200), batch_size=4, num_workers=0,
                         shuffle=False), tr.model,
              mesh=mesh)
    return tr


def trainer(path):
    """``run_trainer`` under a mesh of every rank, each rank with a save
    root of its own, rank 0's histogram writer failing: what each wrote,
    its stats, its parameters and buffers, the histograms that failed."""
    spec = _spec(path)
    root = os.path.join(os.path.dirname(path), f"root{dist.get_rank()}")
    failed = []
    tr = run_trainer(spec["kw"], spec["state"], root, make_mesh(),
                     spec["strategy"], hist_failures=failed)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs) \
        if os.path.isdir(root) else []
    _save(path, dict(
        files=files, stats=tr.last_stats, step=tr.step, hist_failed=failed,
        params={n: p.detach().clone() for n, p in tr.model.named_parameters()},
        buffers={n: b.clone() for n, b in tr.model.named_buffers()}))


def env_rank(path):
    """``init_distributed()`` from torchrun's environment variables, the
    global mesh, two ``train_step``s of the spec's model on its global
    batch; the losses and the final parameters."""
    from elektronn3_tpu_torch.modules import loss as ploss
    from elektronn3_tpu_torch.parallel import (
        init_distributed, make_global_mesh, num_processes)
    from elektronn3_tpu_torch.training import train_step
    torch.set_num_threads(1)
    multi = init_distributed(device="cpu")
    spec = _spec(path)
    mesh = make_global_mesh()
    m = _model(spec["kw"], spec["state"])
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    crit = ploss.CEDiceLoss(1.0, 1.0)
    res = [float(train_step(m, crit, opt, spec["x"], spec["y"], mesh=mesh))
           for _ in range(2)]
    _save(path, dict(multi=multi, world=num_processes(), losses=res,
                     shape=mesh.shape,
                     params={n: p.detach().clone()
                             for n, p in m.named_parameters()}))
    dist.destroy_process_group()


if __name__ == "__main__":
    globals()[sys.argv[1]](*sys.argv[2:])
