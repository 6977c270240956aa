"""The port's training path (elektronn3_tpu_torch) against the JAX
package's, on the CPU in float32.

- The training step of the headline structure (n_blocks=4,
  start_filts=32, planar L0, batch norm with random statistics and
  affine parameters) at input (2, 4, 12, 16, 1), loss ``CEDiceLoss(1,
  1)``: the JAX step with ``pallas_flat=True`` reaches all seven backward
  kernels the port replaces (rows 8, 10, 13, 14, 15, 18 and 21, in
  interpret mode; L2 declines at H=3 and L3 has C=256), the one with
  ``pallas_flat=False`` none. The port's step, given the same variables
  through ``state_dict_from_flax``, runs its kernel ops' plain forward
  and backward versions and must match both in the loss (1e-5
  relative), in every parameter gradient and in the new running
  statistics (each leaf within 1e-3 of its own scale plus 1e-6: the two
  frameworks sum in other orders, and a batch norm's backward subtracts
  nearly equal sums; the bias of a conv feeding a batch norm has an
  exact gradient of 0 and a computed one of rounding noise).
- A 3-step SGD trajectory against the XLA executor.
- The losses against the JAX losses, in value and gradient.
- ``UNet(in_channels=3)`` in eval and in training against JAX (its
  conv1 at C=32 runs the kernel op with a 3-channel input).
- ``Trainer.run`` and ``load_state``, and the default optimizer against
  optax's ``adamw``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from elektronn3_tpu_torch.training import (
    NaNException, Trainer, default_optimizer, train_step)

SHAPE = (2, 4, 12, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
BWD_ROWS = {"_conv_bnact_bwd", "_pool_bwd_impl", "_conv1_bwd",
            "_conv64_bwd", "_pool64_bwd_impl", "_upconv64_bwd",
            "_upconv122_f64_bwd"}
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-3
LEAF_ATOL = 1e-6


def _randomize(variables, rng):
    """Non-trivial parameters: random conv biases, BN scales of both
    signs, shifted means, variances in [0.5, 1.5]."""
    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "keys"):
                out[k] = walk(v, kind)
                continue
            v = np.asarray(v)
            if kind == "params" and k == "bias":
                v = 0.1 * rng.normal(size=v.shape)
            elif k == "scale":
                v = rng.normal(size=v.shape)
            elif k == "mean":
                v = 0.2 * rng.normal(size=v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, size=v.shape)
            out[k] = jnp.asarray(v, jnp.float32)
        return out
    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


def _assert_trees(port, ref, tol=LEAF_TOL):
    port, ref = _leaves(port), _leaves(ref)
    assert port.keys() == ref.keys()
    for k in ref:
        scale = float(np.max(np.abs(ref[k])))
        err = float(np.max(np.abs(port[k] - ref[k])))
        assert err <= tol * scale + LEAF_ATOL, (k, err, scale)


def _batch(rng, shape, classes=2):
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, classes, size=shape[:-1]).astype(np.int32)
    return x, y


def _jax_step(model, v, x, y, crit):
    """(loss, grads, new batch_stats) of one JAX training step."""
    def loss_fn(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32), \
            mut["batch_stats"]
    (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    return float(loss), g, bs


def _port_model(v, **kw):
    m = UNet(device="cpu", **kw)
    m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
    return m


def _port_step(m, v, x, y, crit):
    """(loss, grads, new batch_stats) of one port training step, both
    trees in flax layout."""
    m.train()
    m.zero_grad()
    loss = crit(m(torch.from_numpy(x)), torch.from_numpy(y).long())
    loss.backward()
    grads = flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, v, ("params",))
    bs = flax_from_state_dict(m.state_dict(), v, ("batch_stats",))
    return float(loss.detach()), grads["params"], bs["batch_stats"]


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    x, y = _batch(rng, SHAPE)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    v = _randomize(junet.init_unet(m_xla, SHAPE), rng)
    crit = jloss.CEDiceLoss(1.0, 1.0)
    seen = set()
    real = pl.pallas_call

    def spy(*a, **k):
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_name in BWD_ROWS:
                seen.add(f.f_code.co_name)
            f = f.f_back
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", spy)
        fused_step = _jax_step(junet.UNet(pallas_flat=True, **KW), v, x, y,
                               crit)
    xla_step = _jax_step(m_xla, v, x, y, crit)
    m = _port_model(v, **KW)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("conv_bnact", "pool_bnact", "upconv_bnact"):
            fn = getattr(fused, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            mp.setattr(fused, name, counted)
        port_step = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
    return dict(v=v, x=x, y=y, fused=fused_step, xla=xla_step,
                port=port_step, seen=seen, calls=calls)


def test_jax_fused_step_reaches_every_ported_backward_row(runs):
    assert runs["seen"] == BWD_ROWS


def test_port_step_goes_through_kernel_ops(runs):
    # L0, L1 and their decoder levels: 8 convs, 2 pools, 2 upconvs.
    assert runs["calls"] == {"conv_bnact": 8, "pool_bnact": 2,
                             "upconv_bnact": 2}


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_train_step_matches_jax(runs, executor, what):
    ref = runs["fused" if executor == "pallas_flat=True" else "xla"]
    port = runs["port"]
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


def test_sgd_trajectory_matches_jax():
    """Three SGD steps on three batches from the default init: the loss
    of each step (1e-5 relative), then the parameters and running
    statistics. The trajectory itself amplifies rounding: JAX's own
    parameters after three steps move by up to 1.3% in some batch-norm
    biases when its initial parameters are perturbed by 1e-7 (relative,
    seeded noise), through ReLU and max-pool switches. So each leaf of
    the port may differ from JAX by 4 times that self-difference, on top
    of the per-step leaf tolerance."""
    lr = 0.01
    rng = np.random.default_rng(9)
    batches = [_batch(rng, SHAPE) for _ in range(3)]
    model = junet.UNet(pallas_flat=False, **KW)
    v = junet.init_unet(model, SHAPE)
    jcrit = jloss.CEDiceLoss(1.0, 1.0)

    def jax_trajectory(jv):
        losses = []
        for x, y in batches:
            jl, g, bs = _jax_step(model, jv, x, y, jcrit)
            jv = {"params": jax.tree_util.tree_map(
                lambda p, d: p - lr * d, jv["params"], g),
                "batch_stats": bs}
            losses.append(jl)
        return losses, _leaves(jv)

    jlosses, ref = jax_trajectory(v)
    noise = np.random.default_rng(1)
    _, moved = jax_trajectory({
        "params": jax.tree_util.tree_map(
            lambda p: p * (1 + 1e-7 * jnp.asarray(
                noise.normal(size=p.shape), jnp.float32)), v["params"]),
        "batch_stats": v["batch_stats"]})
    m = _port_model(v, **KW)
    opt = torch.optim.SGD(m.parameters(), lr=lr)
    pcrit = ploss.CEDiceLoss(1.0, 1.0)
    for (x, y), jl in zip(batches, jlosses):
        loss = train_step(m, pcrit, opt, torch.from_numpy(x),
                          torch.from_numpy(y).long())
        assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    port = _leaves(flax_from_state_dict(m.state_dict(), v))
    assert port.keys() == ref.keys()
    for k in ref:
        bound = (LEAF_TOL * float(np.max(np.abs(ref[k]))) + LEAF_ATOL
                 + 4 * float(np.max(np.abs(moved[k] - ref[k]))))
        err = float(np.max(np.abs(port[k] - ref[k])))
        assert err <= bound, (k, err, bound)


# --- losses -----------------------------------------------------------------

LOSSES = {
    "CEDiceLoss(1,1)": (lambda: jloss.CEDiceLoss(1.0, 1.0),
                        lambda: ploss.CEDiceLoss(1.0, 1.0)),
    "CEDiceLoss-class-weight": (
        lambda: jloss.CEDiceLoss(0.3, 0.7, class_weight=[0.2, 1.0, 2.0]),
        lambda: ploss.CEDiceLoss(0.3, 0.7, class_weight=[0.2, 1.0, 2.0])),
    "DiceLoss": (lambda: jloss.DiceLoss(), lambda: ploss.DiceLoss()),
    "DiceLoss-weight-smooth": (
        lambda: jloss.DiceLoss(weight=[1.0, 0.5, 2.0], smooth=0.1),
        lambda: ploss.DiceLoss(weight=[1.0, 0.5, 2.0], smooth=0.1)),
    "CrossEntropyLoss": (lambda: jloss.CrossEntropyLoss(),
                         lambda: ploss.CrossEntropyLoss()),
    "CrossEntropyLoss-weight-ignore": (
        lambda: jloss.CrossEntropyLoss(weight=[0.5, 1.0, 3.0],
                                       ignore_index=1),
        lambda: ploss.CrossEntropyLoss(weight=[0.5, 1.0, 3.0],
                                       ignore_index=1)),
    "CombinedLoss": (
        lambda: jloss.CombinedLoss([jloss.CrossEntropyLoss(),
                                    jloss.DiceLoss()], [1.0, 2.0]),
        lambda: ploss.CombinedLoss([ploss.CrossEntropyLoss(),
                                    ploss.DiceLoss()], [1.0, 2.0])),
}


@pytest.mark.parametrize("name", list(LOSSES))
@pytest.mark.parametrize("onehot", [False, True])
def test_loss_matches_jax(name, onehot):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 3, 4, 5, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(2, 3, 4, 5))
    if onehot:
        y = np.eye(3, dtype=np.float32)[y]
    jcrit, pcrit = (f() for f in LOSSES[name])
    jval, jgrad = jax.value_and_grad(
        lambda o: jcrit(o, jnp.asarray(y)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    pval = pcrit(t, torch.from_numpy(y))
    (pgrad,) = torch.autograd.grad(pval, t)
    assert abs(float(pval.detach()) - float(jval)) <= \
        1e-5 * max(1.0, abs(float(jval)))
    assert np.max(np.abs(pgrad.numpy() - np.asarray(jgrad))) <= \
        1e-5 * max(1e-3, float(np.max(np.abs(np.asarray(jgrad)))))


def test_loss_upcasts_bf16_logits():
    logits = torch.randn(2, 3, 4, 5, 2, generator=torch.Generator()
                         .manual_seed(0))
    y = torch.randint(0, 2, (2, 3, 4, 5), generator=torch.Generator()
                      .manual_seed(1))
    crit = ploss.CEDiceLoss(1.0, 1.0)
    lb = crit(logits.bfloat16(), y)
    assert lb.dtype == torch.float32
    assert float(lb) == pytest.approx(
        float(crit(logits.bfloat16().float(), y)), abs=0)


# --- in_channels = 3 --------------------------------------------------------

def test_unet_in_channels_3_matches_jax():
    """The planar C=32 level's conv1 with a 3-channel input (K1 takes any
    C_in on the CUDA-core body; it used to be refused on the card): the
    eval forward against both JAX executors, and a training step against
    the XLA executor."""
    kw = dict(KW, in_channels=3)
    shape = SHAPE[:-1] + (3,)
    rng = np.random.default_rng(8)
    x, y = _batch(rng, shape)
    m_xla = junet.UNet(pallas_flat=False, **kw)
    v = _randomize(junet.init_unet(m_xla, shape), rng)
    m = _port_model(v, **kw)
    assert m.plan(shape) == [True, True, False, False]
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x)).numpy()
    for model in (junet.UNet(pallas_flat=True, **kw), m_xla):
        ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
        assert np.max(np.abs(out - ref)) <= 2e-4, np.max(np.abs(out - ref))
    ref = _jax_step(m_xla, v, x, y, jloss.CEDiceLoss(1.0, 1.0))
    port = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
    assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    _assert_trees(port[1], ref[1])
    _assert_trees(port[2], ref[2])


def test_eval_forward_builds_no_graph(runs):
    m = _port_model(runs["v"], **KW).eval()
    out = m(torch.from_numpy(runs["x"]))
    assert not out.requires_grad


# --- Trainer ----------------------------------------------------------------

class _Patches(torch.utils.data.Dataset):
    """Seeded (C, D, H, W) inputs and (D, H, W) class targets."""

    def __init__(self, n, shape=(1, 4, 12, 16), seed=0):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + shape).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + shape[1:])

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


def _small_unet(seed=0):
    return UNet(n_blocks=2, start_filts=32, planar_blocks=(0,),
                device="cpu", generator=torch.Generator().manual_seed(seed))


def test_trainer_runs_and_resumes(tmp_path):
    model = _small_unet()
    tr = Trainer(model, ploss.CEDiceLoss(1.0, 1.0),
                 train_dataset=_Patches(5), batch_size=2,
                 save_root=str(tmp_path), exp_name="run", seed=3,
                 nan_check_interval=3)
    tr.run(max_steps=4)
    assert tr.step == 4 and tr.epoch == 2
    files = sorted(os.listdir(tmp_path / "run"))
    assert files == ["state_dict.pth", "state_dict_final.pth",
                     "state_dict_initial.pth"]
    initial = _small_unet(0).state_dict()
    assert not torch.equal(initial["down_convs.0.conv1.weight"],
                           model.state_dict()["down_convs.0.conv1.weight"])
    tr2 = Trainer(_small_unet(1), ploss.CEDiceLoss(1.0, 1.0),
                  train_dataset=_Patches(5), batch_size=2,
                  save_root=str(tmp_path), exp_name="resumed")
    tr2.load_state(str(tmp_path / "run" / "state_dict_final.pth"))
    assert tr2.step == 4 and tr2.epoch == 2
    a, b = model.state_dict(), tr2.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert all(torch.equal(sa["state"][i]["exp_avg"],
                           sb["state"][i]["exp_avg"]) for i in sa["state"])
    with pytest.raises(RuntimeError, match="not empty"):
        Trainer(_small_unet(), ploss.CEDiceLoss(), train_dataset=_Patches(2),
                save_root=str(tmp_path), exp_name="run")


def test_trainer_nan_guard(tmp_path):
    def nan_loss(out, target):
        return out.float().sum() * float("nan")
    tr = Trainer(_small_unet(), nan_loss, train_dataset=_Patches(4),
                 batch_size=2, save_root=str(tmp_path), exp_name="nan",
                 nan_check_interval=2)
    with pytest.raises(NaNException):
        tr.run(max_steps=4)


def test_default_optimizer_matches_optax_adamw():
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(2, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    lin = torch.nn.Linear(5, 2, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0))
    opt = default_optimizer(lin, 1e-3)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        lin.weight.grad = torch.from_numpy(g)
        opt.step()
    assert np.max(np.abs(lin.weight.detach().numpy() - np.asarray(jp))) \
        <= 1e-6
