"""The port's UNet configuration surface (elektronn3_tpu_torch) against
the JAX package's, on the CPU in float32.

For each option (``conv_mode='valid'``, ``merge_mode='add'`` on the
kernel plan and on the library plan, the four resizeconv ``up_mode``s,
``attention=True``, ``full_norm=False``, ``activation='prelu'``,
``checkpointing`` True and 'policy') the same seeded parameters
(converted with ``state_dict_from_flax``; batch norms with random
statistics and affine parameters) and the same numpy input go through
the JAX UNet at ``pallas_flat=False`` (XLA) and the port's UNet (its
kernel levels on the kernel ops' plain versions): the eval forward
within 1e-5 of the output's scale, and one training step: the loss
within 1e-5 (relative), every parameter gradient and the new running
statistics each within 1e-3 of the leaf's scale plus 1e-6 (the floors of
``test_torch_train.py``). ``'add'`` on a kernel level is also held
against JAX's fused executor (``pallas_flat=True``, its ``dup_weights``
merge, in Pallas interpret mode). Then the port alone: ``level_kinds``
and ``decoder_kinds`` follow JAX's structural declines, an ``'add'``
kernel merge runs K1 on a doubled weight, ``vup=True`` plans as
``vup=False`` under 'add', ``logit_dtype``, ``'rrelu'`` (JAX's eval
forward; training slopes in [1/8, 1/3]), checkpointing's step the same
bits as the plain one with the running statistics updated once, the
converter both ways over the new trees, and the bad options' errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused, vup

BASE = dict(in_channels=1, out_channels=2, start_filts=32,
            planar_blocks=(0,), normalization="batch")
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-3
LEAF_ATOL = 1e-6

# name: (model options, input shape, the port's pallas_flat)
CONFIGS = {
    # L0 (1,3,3) convs, L1 3x3x3: (6, 20, 20) -> (2, 4, 4).
    "valid": (dict(n_blocks=2, conv_mode="valid"), (2, 6, 20, 20, 1),
              "auto"),
    # L0 and L1 on the kernels, the L1 decoder's 'add' merge too.
    "add_kernels": (dict(n_blocks=3, merge_mode="add"), (2, 4, 8, 8, 1),
                    True),
    "add_library": (dict(n_blocks=2, merge_mode="add"), (2, 2, 8, 8, 1),
                    False),
    "resizeconv_nearest": (dict(n_blocks=2, up_mode="resizeconv_nearest"),
                           (2, 2, 8, 8, 1), "auto"),
    "resizeconv_linear": (dict(n_blocks=2, up_mode="resizeconv_linear"),
                          (2, 2, 8, 8, 1), "auto"),
    "resizeconv_nearest1": (dict(n_blocks=2,
                                 up_mode="resizeconv_nearest1"),
                            (2, 2, 8, 8, 1), "auto"),
    "resizeconv_linear1": (dict(n_blocks=2, up_mode="resizeconv_linear1"),
                           (2, 2, 8, 8, 1), "auto"),
    # theta halves D, the planar L1 keeps it: phi is resized (shrunk).
    "attention": (dict(n_blocks=2, attention=True), (2, 4, 8, 8, 1),
                  "auto"),
    "full_norm": (dict(n_blocks=2, full_norm=False), (2, 2, 8, 8, 1),
                  "auto"),
    "prelu": (dict(n_blocks=2, activation="prelu"), (2, 2, 8, 8, 1),
              "auto"),
    "checkpointing": (dict(n_blocks=2, checkpointing=True), (2, 2, 8, 8, 1),
                      "auto"),
    "checkpointing_policy": (dict(n_blocks=2, checkpointing="policy"),
                             (2, 2, 8, 8, 1), "auto"),
}


def _randomize(variables, rng):
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
            elif k == "slope":
                v = np.asarray(rng.uniform(0.1, 0.4))
            elif k == "mean":
                v = 0.2 * rng.normal(size=v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, size=v.shape)
            out[k] = np.asarray(v, np.float32)
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


def _assert_trees(port, ref):
    port, ref = _leaves(port), _leaves(ref)
    assert port.keys() == ref.keys()
    for k in ref:
        scale = float(np.max(np.abs(ref[k])))
        err = float(np.max(np.abs(port[k] - ref[k])))
        assert err <= LEAF_TOL * scale + LEAF_ATOL, (k, err, scale)


def _jax_model(kw, pallas_flat=False):
    return junet.UNet(pallas_flat=pallas_flat, **BASE, **kw)


def _init(jm, shape, rng):
    """``init_unet``'s variables (jitted: one compile, not one an op),
    randomized."""
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda x: jm.init({"params": key, "dropout": key}, x,
                                  train=False))(
        jnp.zeros(shape, jm.dtype))
    return _randomize(jax.device_get(v), rng)


def _jax_fwd(jm, v, x):
    return np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        v, x))


def _jax_step(model, v, x, y):
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32), \
            mut["batch_stats"]
    (loss, bs), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return float(loss), jax.device_get(g), jax.device_get(bs)


def _port_model(v, kw, pallas_flat="auto", **extra):
    m = UNet(device="cpu", pallas_flat=pallas_flat, **BASE, **kw, **extra)
    m.load_state_dict(state_dict_from_flax(v, m))
    return m


def _port_step(m, v, x, y):
    m.train()
    m.zero_grad()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                      torch.from_numpy(y).long())
    loss.backward()
    grads = flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, v, ("params",))
    bs = flax_from_state_dict(m.state_dict(), v, ("batch_stats",))
    return float(loss.detach()), grads["params"], bs["batch_stats"]


def _inputs(shape, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 2, size=shape[:-1]).astype(np.int32)
    return rng, x, y


@functools.lru_cache(maxsize=None)
def _jax_run(jax_kw, shape):
    """(variables, x, y, eval forward, step) of the JAX model."""
    kw = dict(jax_kw)
    rng, x, _ = _inputs(shape)
    jm = _jax_model(kw)
    v = _init(jm, shape, rng)
    fwd_ref = _jax_fwd(jm, v, x)
    # A valid-conv model's target has its output's (smaller) shape.
    y = rng.integers(0, 2, size=fwd_ref.shape[:-1]).astype(np.int32)
    return v, x, y, fwd_ref, _jax_step(jm, v, x, y)


@functools.lru_cache(maxsize=None)
def _run(name):
    """JAX's and the port's eval forward and training step of a config,
    from the same variables. JAX's checkpointing changes no number, so
    the checkpointed configs are held against JAX's plain model."""
    kw, shape, pf = CONFIGS[name]
    jax_kw = tuple(sorted((k, v) for k, v in kw.items()
                          if k != "checkpointing"))
    v, x, y, fwd_ref, ref = _jax_run(jax_kw, shape)
    m = _port_model(v, kw, pf)
    fwd = m.eval()(torch.from_numpy(x)).numpy()
    return dict(kinds=m.level_kinds(shape), fwd=(fwd, fwd_ref),
                port=_port_step(m, v, x, y), ref=ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    fwd, ref = _run(name)["fwd"]
    assert fwd.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(fwd - ref).max()) <= FWD_TOL * max(scale, 1.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_step_matches_jax(name):
    r = _run(name)
    (lp, gp, bp), (lr, gr, br) = r["port"], r["ref"]
    assert abs(lp - lr) <= LOSS_RTOL * abs(lr)
    _assert_trees(gp, gr)
    _assert_trees(bp, br)


def test_configs_run_the_planned_kinds():
    """The kernel plans the comparisons above hold: the 'add' merges
    and the resizeconv encoders on the kernels, the rest as JAX plans."""
    assert _run("add_kernels")["kinds"] == ["kernels", "kernels",
                                            "library"]
    assert _run("resizeconv_linear")["kinds"] == ["kernels", "library"]
    assert _run("valid")["kinds"] == ["library", "library"]
    assert _run("attention")["kinds"] == ["library", "library"]
    assert _run("full_norm")["kinds"] == ["kernels", "library"]
    assert _run("prelu")["kinds"] == ["library", "library"]


def test_add_merge_matches_jax_fused_executor():
    """The headline-like 'add' model's eval forward against JAX's fused
    executor, whose C=32 decoder merge conv runs ``dup_weights`` in
    Pallas interpret mode (its C=64 decoder, 'concat'-only, on XLA)."""
    kw, shape = dict(n_blocks=2, merge_mode="add"), (2, 2, 8, 16, 1)
    rng, x, _ = _inputs(shape, 9)
    jm = _jax_model(kw, pallas_flat=True)
    v = _init(jm, shape, rng)
    ref = _jax_fwd(jm, v, x)
    m = _port_model(v, kw, True)
    assert m.level_kinds(shape) == ["kernels", "library"]
    out = m.eval()(torch.from_numpy(x)).numpy()
    assert float(np.abs(out - ref).max()) <= FWD_TOL * max(
        float(np.abs(ref).max()), 1.0)


def test_add_kernel_merge_runs_k1_on_a_doubled_weight(monkeypatch):
    m = UNet(device="cpu", n_blocks=3, merge_mode="add", **BASE)
    seen = []
    real = fused.conv_bnact

    def spy(xs, inv, shift, w, *a, **k):
        seen.append((len(xs), tuple(w.shape)))
        return real(xs, inv, shift, w, *a, **k)
    monkeypatch.setattr(fused, "conv_bnact", spy)
    m.eval()(torch.zeros(2, 4, 8, 8, 1))
    merges = [s for s in seen if s[0] == 2]
    # up_0 (C=64, kd 3) and up_1 (C=32, kd 1): [up, skip] over 2C.
    assert merges == [(2, (64, 128, 3, 3, 3)), (2, (32, 64, 1, 3, 3))]
    assert tuple(m.up_convs[0].conv1.weight.shape) == (64, 64, 3, 3, 3)


def test_vup_plans_as_without_under_add(monkeypatch):
    kw = dict(n_blocks=3, merge_mode="add", start_filts=32,
              in_channels=1, out_channels=2, planar_blocks=(0,))
    x = torch.from_numpy(_inputs((2, 4, 8, 8, 1))[1])
    a = UNet(device="cpu", vup=True, **kw)
    b = UNet(device="cpu", vup=False, **kw)
    b.load_state_dict(a.state_dict())

    def refuse(*args, **kwargs):
        raise AssertionError("conv_vup under merge_mode='add'")
    monkeypatch.setattr(vup, "conv_vup", refuse)
    assert torch.equal(a.eval()(x), b.eval()(x))


@pytest.mark.parametrize("opt, kinds, dec", [
    (dict(conv_mode="valid"), ["library"] * 3, ["library"] * 2),
    (dict(attention=True), ["library"] * 3, ["library"] * 2),
    (dict(up_mode="resizeconv_nearest"), ["kernels", "kernels", "library"],
     ["library"] * 2),
    (dict(merge_mode="add"), ["kernels", "kernels", "library"],
     ["kernels", "kernels"]),
    (dict(full_norm=False), ["kernels", "kernels", "library"],
     ["kernels", "kernels"]),
])
def test_level_kinds_follow_jax_declines(opt, kinds, dec):
    m = UNet(device="meta", n_blocks=3, **BASE, **opt)
    assert m.level_kinds((2, 4, 16, 16, 1)) == kinds
    assert m.decoder_kinds((2, 4, 16, 16, 1)) == dec
    # JAX runs its fused conv1 (the input's gradient zero) on a kernel
    # L0 of a bf16 pallas_flat=True model, and declines on a library one.
    m16 = UNet(device="meta", n_blocks=3, pallas_flat=True,
               dtype=torch.bfloat16, **BASE, **opt)
    assert m16._conv1_input_grad((2, 4, 16, 16, 1)) == (
        kinds[0] == "library")


@pytest.mark.parametrize("model_dtype, logit_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None), (torch.float32, None)])
def test_logit_dtype(model_dtype, logit_dtype):
    m = UNet(device="cpu", n_blocks=2, dtype=model_dtype,
             logit_dtype=logit_dtype, **BASE).eval()
    out = m(torch.zeros(1, 2, 8, 8, 1))
    want = logit_dtype or (torch.bfloat16 if model_dtype == torch.bfloat16
                           else torch.float32)
    assert out.dtype == want and out.shape == (1, 2, 8, 8, 2)


def test_logit_dtype_float32_matches_jax():
    """A bf16 model with float32 logits against JAX's (bf16 floor)."""
    kw, shape = dict(n_blocks=2, dtype=jnp.bfloat16,
                     logit_dtype=jnp.float32), (2, 2, 8, 8, 1)
    rng, x, _ = _inputs(shape, 3)
    jm = _jax_model(kw)
    v = _init(jm, shape, rng)
    ref = _jax_fwd(jm, v, x)
    m = _port_model(v, dict(n_blocks=2), "auto", dtype=torch.bfloat16,
                    logit_dtype=torch.float32)
    out = m.eval()(torch.from_numpy(x))
    assert ref.dtype == np.float32 and out.dtype == torch.float32
    assert float(np.abs(out.numpy() - ref).max()) <= 5e-2 * float(
        np.abs(ref).max())


def test_rrelu_eval_matches_jax_and_training_slopes_are_bounded():
    kw, shape = dict(n_blocks=2, activation="rrelu"), (2, 2, 8, 8, 1)
    rng, x, _ = _inputs(shape, 4)
    jm = _jax_model(kw)
    v = _init(jm, shape, rng)
    ref = _jax_fwd(jm, v, x)
    m = _port_model(v, kw)
    out = m.eval()(torch.from_numpy(x)).numpy()
    assert float(np.abs(out - ref).max()) <= FWD_TOL * max(
        float(np.abs(ref).max()), 1.0)
    act = m.down_convs[0].act.train()
    t = -torch.rand(10_000) - 0.1
    y = act(t)
    slope = y / t
    assert float(slope.min()) >= 1 / 8 - 1e-6
    assert float(slope.max()) <= 1 / 3 + 1e-6
    assert float(slope.std()) > 0.05
    assert torch.equal(act(-t), -t)


def test_checkpointing_step_is_the_plain_step():
    """A checkpointed step (both modes) gives the plain step's loss,
    gradients and running statistics bit for bit: the recompute leaves
    the norm buffers as the forward left them."""
    _, x, y = _inputs((2, 2, 8, 8, 1), 6)
    steps = []
    for ck in (False, True, "policy"):
        m = UNet(device="cpu", n_blocks=2, checkpointing=ck,
                 generator=torch.Generator().manual_seed(1), **BASE).train()
        loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                          torch.from_numpy(y).long())
        loss.backward()
        steps.append((loss.detach(), {n: p.grad for n, p in
                                      m.named_parameters()},
                      {n: b.clone() for n, b in m.named_buffers()}))
    for loss, grads, bufs in steps[1:]:
        assert torch.equal(loss, steps[0][0])
        assert all(torch.equal(grads[n], steps[0][1][n]) for n in grads)
        assert all(torch.equal(bufs[n], steps[0][2][n]) for n in bufs)


@pytest.mark.parametrize("opt", [
    dict(attention=True, up_mode="resizeconv_linear", full_norm=False,
         activation="prelu"),
    dict(conv_mode="valid", merge_mode="add", up_mode="resizeconv_nearest1"),
])
def test_converter_round_trip_of_the_new_trees(opt):
    shape = (1, 8, 24, 24, 1) if opt.get("conv_mode") == "valid" \
        else (1, 4, 8, 8, 1)
    jm = _jax_model(dict(n_blocks=2, **opt))
    v = _init(jm, shape, np.random.default_rng(2))
    m = _port_model(v, dict(n_blocks=2, **opt))
    back = flax_from_state_dict(m.state_dict(), v)
    for coll in v:
        ref, got = _leaves(v[coll]), _leaves(back[coll])
        assert ref.keys() == got.keys()
        assert all(np.array_equal(ref[k], got[k]) for k in ref)


@pytest.mark.parametrize("opt, err", [
    (dict(up_mode="bilinear"), "valid mode for upsampling"),
    (dict(merge_mode="mul"), "valid mode for merging"),
    (dict(conv_mode="full"), "not a valid conv_mode"),
    (dict(checkpointing="all"), "checkpointing must be"),
])
def test_bad_options_raise(opt, err):
    with pytest.raises(ValueError, match=err):
        UNet(device="meta", **BASE, **opt)
