"""The port's data-parallel training step (``train_step(mesh=...)``) on
gloo CPU ranks against JAX's ``shard_map`` step on a mesh of as many
virtual CPU devices, in float32.

The JAX side is the JAX Trainer's own sharded forward
(``Trainer._apply_sharded``, the ``shard_strategy='shard_map'`` path:
the model cloned with ``axis_name='data'``, each device on its batch
shard, the batch-norm statistics psum'd, the loss of the global batch
outside). The port's ranks run as processes of their own
(``parallel.launch``, a ``file://`` store in ``tmp_path``, one thread
each, a hard timeout), importing no JAX, on the same variables through
``state_dict_from_flax``. Cases, each run on 2 and 4 ranks, held
against JAX's step on 2 devices (the XLA executor's also on 4: JAX
lowers a fused step in interpret mode for about 30 s a mesh size) and
against the port's one-process step on both:

- ``kernels``: the headline structure with ``pallas_flat=True`` (JAX's
  fused executor in interpret mode, reaching every backward kernel the
  port replaces; the port's L0 and L1 on the kernel ops' plain
  versions, their statistics through ``bn_train_prologue``);
- ``library``: the same model with ``pallas_flat=False`` (every batch
  norm through ``apply_norm``, flax's ``nn.BatchNorm(axis_name=...)``).

``tests/test_torch_parallel_flat.py`` runs the ``vup=True`` and silu
flat-executor cases through the same helpers.

The loss, every parameter gradient and the new running statistics match
at ``tests/test_torch_train.py``'s tolerances for the same model: the
loss within 1e-5 relative, each leaf within 1e-3 of its own scale plus
1e-6. The same step also matches the port's one-process step on the
global batch within 1e-5 of each tensor's max plus the same 1e-6 (the
sums over ranks add the same terms in another order; the bias of a conv
feeding a batch norm has an exact gradient of 0 and a computed one of
rounding noise, up to 2.4e-7 here).

JAX's XLA executor (the ``library`` case) does not agree with itself
at that tolerance: its sharded step on 2 devices and its one-device step
differ by up to 5.2e-3 of a small leaf (``up_1/BatchNorm_1/bias`` in one
run of this file's draw, another leaf in another: XLA's sharded sums
vary between runs; the port's one-process step is within 1e-6 of JAX's
one-device step there, and on 4 devices all three agree within 1e-5).
So for that case the bound of each leaf adds JAX's own distance between
its sharded and one-device steps. The fused cases keep the plain bound.
"""

import os

import jax
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.parallel import data_parallel_mesh
from elektronn3_tpu.training.trainer import Trainer as JaxTrainer
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.parallel import launch
from test_torch_kernels import _spy_pallas
from test_torch_train import (BWD_ROWS, LEAF_ATOL, LEAF_TOL, LOSS_RTOL,
                              _assert_trees, _batch, _jax_step, _leaves,
                              _randomize)

HERE = os.path.dirname(os.path.abspath(__file__))
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
# name: (port kwargs, JAX kwargs, global batch shape, E3TPU_VUP)
CASES = {
    "kernels": (dict(KW, pallas_flat=True), dict(KW, pallas_flat=True),
                (4, 4, 12, 16, 1), False),
    "library": (dict(KW, n_blocks=3, pallas_flat=False),
                dict(KW, n_blocks=3, pallas_flat=False), (4, 4, 16, 16, 1),
                False),
}
# (case, rank count) held against JAX's sharded step: every case at 2,
# the XLA executor's also at 4 (JAX lowers each fused step in interpret
# mode for about 30 s a mesh size)
JAX_AT = [("kernels", 2), ("library", 2), ("library", 4)]
SELF_TOL = 1e-5
RANK_TIMEOUT = 240


def _jax_sharded_step(model, v, x, y, n):
    """(loss, grads, new batch_stats) of JAX's shard_map step on an
    ``n``-device 'data' mesh: the JAX Trainer's ``_apply_sharded`` on a
    stub holding the attributes it reads (tests/test_parallel.py's)."""
    class _Stub:
        pass
    mesh = data_parallel_mesh(n)
    tr = _Stub()
    tr.mesh = mesh
    tr._sm_axis = "data"
    tr._sm_model = model.clone(axis_name="data")
    tr._apply_local = JaxTrainer._apply_local
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(params):
        out, bs = JaxTrainer._apply_sharded(tr, params, v["batch_stats"],
                                            x, True, None)
        return crit(out, y).astype(jax.numpy.float32), bs
    (loss, bs), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return float(loss), g, bs


def _one_process(kw, v, x, y):
    """The port's one-process step on the global batch."""
    m = UNet(device="cpu", **kw)
    m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
    m.train()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                      torch.from_numpy(y).long())
    loss.backward()
    return dict(loss=float(loss),
                grads={n: p.grad for n, p in m.named_parameters()},
                buffers=dict(m.named_buffers()))


def run_cases(cases, jax_at, tmp_path_factory, seed, spy=(), noise=()):
    """Per case and rank count: the ranks' results (one ``launch`` a rank
    count, running every case), JAX's sharded step where ``jax_at`` has
    the pair, the port's one-process step; and the JAX kernels among
    ``spy`` that the JAX steps reached. For the cases in ``noise`` also
    JAX's one-device step, whose distance from JAX's sharded step joins
    the bound."""
    rng = np.random.default_rng(seed)
    data = {}
    for name, (pkw, jkw, shape, _) in cases.items():
        x, y = _batch(rng, shape)
        v = _randomize(junet.init_unet(
            junet.UNet(**dict(jkw, pallas_flat=False)), shape), rng)
        data[name] = (v, x, y)
    res = {"seen": set()}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"step{n}")
        torch.save({name: dict(kw=pkw, x=torch.from_numpy(data[name][1]),
                               y=torch.from_numpy(data[name][2]).long(),
                               state=state_dict_from_flax(
                                   jax.device_get(data[name][0]),
                                   UNet(device="cpu", **pkw)))
                    for name, (pkw, _, _, _) in cases.items()},
                   d / "spec.pt")
        launch("_torch_parallel_ranks:step", n, [str(d / "spec.pt")],
               timeout=RANK_TIMEOUT, workdir=str(d), pythonpath=[HERE],
               device="cpu")
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(n)]
        for name, (pkw, jkw, shape, vup) in cases.items():
            v, x, y = data[name]
            res[name, n] = dict(v=v, ranks=ranks)
            if (name, n) not in jax_at:
                continue
            with pytest.MonkeyPatch.context() as mp:
                if vup:
                    mp.setenv("E3TPU_VUP", "1")
                seen = _spy_pallas(mp, set(spy))
                res[name, n]["ref"] = _jax_sharded_step(
                    junet.UNet(**jkw), v, x, y, n)
            res["seen"] |= seen
    for name, (pkw, jkw, _, _) in cases.items():
        res[name, "one"] = _one_process(pkw, *data[name])
        if name in noise:
            v, x, y = data[name]
            res[name, "jax_one"] = _jax_step(
                junet.UNet(**jkw), v, x, y, jloss.CEDiceLoss(1.0, 1.0))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, JAX_AT, tmp_path_factory, 22, BWD_ROWS,
                     {"library"})


def _flax(tree, v, kind):
    return flax_from_state_dict(tree, v, (kind,))[kind]


def check_jax(runs, case, n, what):
    """The ranks' step against JAX's: the loss, every gradient, the new
    running statistics."""
    run = runs[case, n]
    v, (loss, grads, bs) = run["v"], run["ref"]
    port = run["ranks"][0][case]
    if what == "loss":
        assert abs(port["loss"] - loss) <= LOSS_RTOL * abs(loss)
        return
    got = _flax(port["grads" if what == "grads" else "buffers"], v,
                "params" if what == "grads" else "batch_stats")
    ref = grads if what == "grads" else bs
    if (case, "jax_one") not in runs:
        _assert_trees(got, ref)
        return
    own = _leaves(runs[case, "jax_one"][1 if what == "grads" else 2])
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        scale = float(np.max(np.abs(ref[k])))
        err = float(np.max(np.abs(got[k] - ref[k])))
        jax_noise = float(np.max(np.abs(own[k] - ref[k])))
        assert err <= LEAF_TOL * scale + LEAF_ATOL + jax_noise, \
            (k, err, scale, jax_noise)


def check_one_process(runs, case, n):
    """Every rank ends with the same loss, gradients and running
    statistics (bit for bit), and they are the one-process step's on
    the global batch."""
    ranks = [r[case] for r in runs[case, n]["ranks"]]
    one = runs[case, "one"]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k in ("grads", "buffers"):
            for name, t in r[k].items():
                assert torch.equal(t, ranks[0][k][name]), (k, name)
    port = ranks[0]
    assert abs(port["loss"] - one["loss"]) <= SELF_TOL * abs(one["loss"])
    for k in ("grads", "buffers"):
        for name, ref in one[k].items():
            if not ref.is_floating_point():
                assert torch.equal(port[k][name], ref), name
                continue
            err = float((port[k][name] - ref).abs().max())
            assert err <= SELF_TOL * float(ref.abs().max()) + LEAF_ATOL, \
                (k, name, err)


@pytest.mark.parametrize("case, n", JAX_AT)
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_data_parallel_step_matches_jax_shard_map(runs, case, n, what):
    check_jax(runs, case, n, what)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_step_matches_one_process_step(runs, case, n):
    check_one_process(runs, case, n)


def test_cases_reach_their_norm_sites(runs):
    """JAX's fused step reaches every backward kernel the port replaces;
    the port plans L0 and L1 on the kernels at the shard's shape (one
    row at 4 ranks) with ``pallas_flat=True`` and no kernel level
    without."""
    assert runs["seen"] == BWD_ROWS
    kinds = {c: runs[c, 4]["ranks"][0][c]["kinds"] for c in CASES}
    assert kinds["kernels"][:2] == ["kernels"] * 2
    assert set(kinds["library"]) == {"library"}
