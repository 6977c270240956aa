"""Shared helpers of the model-zoo parity tests
(``test_torch_zoo_modules.py``, ``test_torch_zoo_models.py``): the port's
weights carried to a flax tree, tree comparisons and the tolerances.

Tolerances (stated once, used by both files):
- float32 forward: max |port - jax| <= 1e-4 * max |jax|;
- gradients: ||port - jax|| <= 1e-3 * ||jax|| for every leaf; a leaf
  whose true gradient is zero (a conv bias feeding a batch norm: JAX's
  below 1e-5 of the whole gradient's norm) below 1e-4 of that norm;
- running statistics: max |port - jax| <= 1e-5 * max(1, max |jax|);
- bfloat16 forward: max |port - jax| <= 5e-2 * max |jax|.
"""

from __future__ import annotations

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from elektronn3_tpu import models as J
from elektronn3_tpu_torch import models as P
from elektronn3_tpu_torch.models.convert import (
    _flatten, flax_from_state_dict, state_dict_from_flax)

FWD_TOL = 1e-4
GRAD_TOL = 1e-3
ZERO_GRAD = 1e-5
STATS_TOL = 1e-5
BF16_TOL = 5e-2


def flax_vars(jax_module, port, *args, traced: bool = True, **kw):
    """The flax variables of ``jax_module`` holding ``port``'s weights:
    the tree's shapes from ``jax.eval_shape`` of its init (its eager
    init where JAX's model does not trace: ``traced=False``), filled by
    ``flax_from_state_dict`` (every leaf of both sides used), and checked
    to come back to ``port``'s state_dict through
    ``state_dict_from_flax``."""
    key = jax.random.PRNGKey(0)
    def init(*a):
        return jax_module.init({"params": key, "dropout": key}, *a, **kw)
    shapes = jax.eval_shape(init, *args) if traced else init(*args)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    colls = tuple(c for c in ("params", "batch_stats") if c in template)
    variables = flax_from_state_dict(port.state_dict(), template, colls,
                                     model=port)
    back = state_dict_from_flax(variables, port)
    for name, t in port.state_dict().items():
        assert torch.equal(back[name], t), name
    return variables


_RANDOMIZED = ("weight", "bias", "running_mean", "running_var", "gamma",
               "beta", "v", "mean", "dev", "g", "gain")
_POSITIVE = ("running_var", "gamma", "dev", "gain", "v")


def randomize_(module: torch.nn.Module, seed: int = 7) -> None:
    """Give the norm parameters and statistics (and Rezero's ``g``, WS
    ``gain``) values from a seed, so a test sees them act: scales and
    deviations in [0.5, 1.5], shifts and means in [-0.5, 0.5]."""
    from elektronn3_tpu_torch.modules.layers import (
        BatchNorm, Conv, ConvTranspose, Dense)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Conv, ConvTranspose, Dense)):
                tensors = [("bias", mod.bias)] if mod.bias is not None \
                    else []
                tensors += [("gain", getattr(mod, "gain", None))]
            else:
                tensors = list(mod.named_parameters(recurse=False)) \
                    + list(mod.named_buffers(recurse=False))
            for name, t in tensors:
                if t is None or name not in _RANDOMIZED:
                    continue
                u = torch.rand(t.shape, generator=gen)
                positive = name in _POSITIVE or (
                    name == "weight" and isinstance(mod, BatchNorm))
                t.copy_((0.5 + u) if positive else (u - 0.5))


def rel_err(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def assert_close(port, ref, tol, what=""):
    err = rel_err(port, ref)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def assert_grads(port_tree, ref_tree, what="", noise_tree=None):
    """Every leaf of two flax-layout trees within GRAD_TOL of the
    reference leaf's norm; the same leaves on both sides. A leaf whose
    reference is below ZERO_GRAD of the whole gradient's norm is zero
    but for rounding (a conv bias feeding a batch norm): the port's must
    then be below 10 x ZERO_GRAD of it too. ``noise_tree``: the
    reference's gradient under a small input noise; a leaf's bound is
    then at least twice the reference's own move."""
    p, r = _flatten(port_tree), _flatten(ref_tree)
    assert set(p) == set(r), (what, set(p) ^ set(r))
    total = np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2)
                        for v in r.values()))
    for path in r:
        ref = np.asarray(r[path], np.float64)
        port = np.asarray(p[path], np.float64)
        name = f"{what} {'/'.join(path)}"
        if np.linalg.norm(ref) <= ZERO_GRAD * total:
            assert np.linalg.norm(port) <= 10 * ZERO_GRAD * total, name
            continue
        diff = np.linalg.norm(port - ref)
        bound = GRAD_TOL * np.linalg.norm(ref)
        if noise_tree is not None:
            moved = np.asarray(_flatten(noise_tree)[path], np.float64)
            bound = max(bound, 2 * np.linalg.norm(moved - ref))
        assert diff <= bound, f"{name}: |d| {diff:.3g} > {bound:.3g}"


def assert_stats(port_tree, ref_tree, what=""):
    p, r = _flatten(port_tree), _flatten(ref_tree)
    assert set(p) == set(r), (what, set(p) ^ set(r))
    for path in r:
        ref = np.asarray(r[path], np.float64)
        err = np.abs(np.asarray(p[path], np.float64) - ref).max()
        assert err <= STATS_TOL * max(1.0, np.abs(ref).max()), (
            f"{what} {'/'.join(path)}: {err:.3g}")


def port_grads(port, variables):
    """The port's parameter gradients as a flax 'params' tree."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in port.named_parameters()}
    return flax_from_state_dict(grads, variables, ("params",),
                                model=port)["params"]


class DropoutTape:
    """Replaces flax's ``nn.Dropout`` by the identity (a test-only
    patch: dropout's draws cannot match across frameworks) and records
    the rate of every call that would drop (not deterministic)."""

    def __init__(self, monkeypatch):
        self.rates = []
        tape = self

        def call(self, inputs, deterministic=None, rng=None):
            det = fnn.merge_param("deterministic", self.deterministic,
                                  deterministic)
            if not det and self.rate > 0:
                tape.rates.append(float(self.rate))
            return inputs

        monkeypatch.setattr(fnn.Dropout, "__call__", call)


def port_dropout_rates(port, *args):
    """The rates of the port's dropout calls in one training forward (a
    forward hook on every ``nn.Dropout``); the state is restored after."""
    state = copy.deepcopy(port.state_dict())
    rates = []
    hooks = [m.register_forward_hook(
        lambda mod, a, out: rates.append(float(mod.p)))
        for m in port.modules() if isinstance(m, torch.nn.Dropout)]
    was = port.training
    port.train()
    try:
        with torch.no_grad():
            port(*args)
    finally:
        port.train(was)
        port.load_state_dict(state)
        for h in hooks:
            h.remove()
    return rates


def dropout_off_(port) -> None:
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)



# ---------------------------------------------------------------------------
# The model zoo's cases (tests/test_torch_zoo_models*.py)
# ---------------------------------------------------------------------------

CPU = dict(device="cpu")
_SMALL_TIRAMISU = dict(down_blocks=(2, 3), up_blocks=(3, 2),
                       bottleneck_layers=2, growth_rate=4,
                       out_chans_first_conv=8)

# id: (JAX model, port model, input shape, jit-able in JAX)
CASES = {
    "simple3d": (lambda **k: J.Simple3DNet(**k),
                 lambda **k: P.Simple3DNet(**k), (1, 8, 8, 8, 1), True),
    "extended3d": (lambda **k: J.Extended3DNet(**k),
                   lambda **k: P.Extended3DNet(**k), (2, 8, 16, 16, 1),
                   True),
    "n3d": (lambda **k: J.N3DNet(**k), lambda **k: P.N3DNet(**k),
            (1, 8, 16, 16, 1), True),
    # D = 10 flattens 700 features, which JAX pools by a reshape (its
    # uneven bins of fewer features do not trace; test_adaptive_pool
    # holds them), in the channels-last order across D.
    "stacked2scalar": (
        lambda **k: J.StackedConv2Scalar(in_channels=1, n_classes=5, **k),
        lambda **k: P.StackedConv2Scalar(1, 5, **k), (2, 10, 128, 128, 1),
        True),
    "unet3d_lite": (lambda **k: J.UNet3dLite(**k),
                    lambda **k: P.UNet3dLite(**k), (1, 22, 140, 140, 1),
                    True),
    "vnet": (lambda **k: J.VNet(fac=4, **k),
             lambda **k: P.VNet(fac=4, **k), (1, 16, 16, 16, 1), True),
    "vnet_prelu": (lambda **k: J.VNet(fac=4, relu=False, **k),
                   lambda **k: P.VNet(fac=4, relu=False, **k),
                   (1, 16, 16, 16, 1), True),
    "fcn32s": (lambda **k: J.fcn32s(n_classes=2, red_fac=16, **k),
               lambda **k: P.fcn32s(n_classes=2, red_fac=16, **k),
               (1, 32, 32, 32, 1), True),
    "fcn8s": (lambda **k: J.fcn8s(n_classes=2, red_fac=16, **k),
              lambda **k: P.fcn8s(n_classes=2, red_fac=16, **k),
              (1, 32, 32, 32, 1), True),
    "FCN8s": (lambda **k: J.FCN8s(n_class=2, backbone="vgg11", **k),
              lambda **k: P.FCN8s(n_class=2, backbone="vgg11", **k),
              (1, 32, 32, 3), True),
    "FCNs": (lambda **k: J.FCNs(n_class=2, backbone="vgg11", **k),
             lambda **k: P.FCNs(n_class=2, backbone="vgg11", **k),
             (1, 32, 32, 3), True),
    "msdnet2d": (lambda **k: J.MSDNet(num_layers=6, volumetric=False, **k),
                 lambda **k: P.MSDNet(num_layers=6, volumetric=False, **k),
                 (1, 16, 16, 1), True),
    "msdnet3d": (lambda **k: J.MSDNet(num_layers=6, volumetric=True, **k),
                 lambda **k: P.MSDNet(num_layers=6, volumetric=True, **k),
                 (1, 8, 16, 16, 1), True),
    "tiramisu": (
        lambda **k: J.FCDenseNet(in_channels=1, n_classes=3,
                                 **_SMALL_TIRAMISU, **k),
        lambda **k: P.FCDenseNet(in_channels=1, n_classes=3,
                                 **_SMALL_TIRAMISU, **k),
        (1, 16, 20, 1), True),
}


def inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def jax_runner(jm, jit):
    """JAX's model's eval forward (``mutable`` batch statistics, which
    VNet's ContBN updates in eval too, dropped) and one training step of
    the loss ``sum(out * w)``, as one function of (params, batch_stats,
    x, w), jitted where the model traces."""
    def both(params, bs, x, w):
        def loss_fn(p):
            out, new = jm.apply({"params": p, "batch_stats": bs}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out * w), new
        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        ev, _ = jm.apply({"params": params, "batch_stats": bs}, x,
                         train=False, mutable=["batch_stats"])
        return ev, loss, grads, new.get("batch_stats", {})

    return jax.jit(both) if jit else both


def jax_run(fn, variables, x, w):
    """(eval output, loss, grads, new batch_stats) of JAX's model, by
    its :func:`jax_runner` ``fn``."""
    out = fn(variables["params"], variables.get("batch_stats", {}),
             jnp.asarray(x), jnp.asarray(w))
    return jax.tree_util.tree_map(np.asarray, out)


# Models whose float32 gradient JAX itself holds only to ~1e-3 (see the
# module docstring): their bound includes JAX's move under input noise.
_ILL_CONDITIONED = ("unet3d_lite",)


def check_model(name, monkeypatch):
    """Eval forward, one training step (loss, every gradient, the new
    running statistics), the converter both ways, and the dropout
    sites."""
    jf, pf, shape, jit = CASES[name]
    tape = DropoutTape(monkeypatch)
    torch.manual_seed(0)
    port = pf(**CPU)
    randomize_(port)
    x = inputs(shape)
    jm = jf()
    variables = flax_vars(jm, port, x, train=False, traced=jit)

    rates = port_dropout_rates(port, t(x))
    dropout_off_(port)
    port.eval()
    with torch.no_grad():
        ev = port(t(x)).numpy()
    w = np.random.default_rng(4).normal(size=ev.shape).astype(np.float32)
    port.train()
    out = port(t(x))
    loss = (out * t(w)).sum()
    loss.backward()

    tape.rates.clear()
    run = jax_runner(jm, jit)   # one lowering for both of its inputs
    jev, jloss, jgrads, jstats = jax_run(run, variables, x, w)
    assert sorted(rates) == sorted(tape.rates), (rates, tape.rates)
    assert_close(ev, jev, FWD_TOL, f"{name} eval")
    # A sum's rounding scales with the sum of its terms' magnitudes.
    scale = np.abs(w * out.detach().numpy()).sum()
    assert abs(loss.item() - jloss) <= FWD_TOL * scale, (loss, jloss)
    noise = None
    if name in _ILL_CONDITIONED:
        xn = x + 1e-6 * np.random.default_rng(9).normal(
            size=x.shape).astype(np.float32)
        noise = jax_run(run, variables, xn, w)[2]
    assert_grads(port_grads(port, variables), jgrads, name, noise)
    if jstats:
        new = flax_from_state_dict(port.state_dict(), variables,
                                     ("batch_stats",), model=port)
        assert_stats(new["batch_stats"], jstats, name)
