"""Training the port's group and instance norm models on the kernels'
per-sample mode, against the JAX package's, on the CPU.

- Op level: the per-sample backward of rows 8, 10, 13, 14, 15, 18 and 21
  of PERF.md's kernel table. JAX's entry with (n, B, 128) per-sample
  prologue lanes and per-sample statistics runs in interpret mode under
  ``jax.vjp`` (a spy on ``pallas_call`` shows that its backward reached
  the row's kernel); the port's op with (B, C) prologue vectors and
  ``want_stats='per_sample'`` runs its kernels' plain versions on a CPU
  tensor under ``torch.autograd.grad``. Both take the same cotangents:
  of the output and of each sample's statistics, (B, C) rows. B = 2
  samples of different scales and vectors, float32 and bfloat16.
  Tolerances as tests/test_torch_group_norm.py states them: float32
  1e-4 of each output's or gradient's scale; bfloat16 one unit in the
  last place of each value plus 1e-4 of the scale; each row of a (B, C)
  gradient (dinv, dshift) 1e-4 (float32) or 1e-3 (bfloat16) of its row's
  scale.
- The per-sample ops give gradients (the vup path's and the 2D model's
  per-sample mode is tests/test_torch_vup_group.py's and
  tests/test_torch_2d_group.py's).
- Model level: the headline structure (n_blocks=4, start_filts=32,
  planar L0) at input (2, 4, 12, 16, 1) with 'group', 'group4' and
  'instance', random affine parameters: one training step of the kernel
  plan (``pallas_flat=True``: L0, L1 and their decoder levels on the
  per-sample ops' plain forward and backward) against JAX's
  ``pallas_flat=True`` step (interpret mode), loss within 1e-5 relative
  and each gradient within 1e-3 of its leaf's scale + 1e-6, as
  tests/test_torch_train.py holds the 'batch' step.
- The bf16 forward of the same models ('group' and 'instance', both port
  plans) against both JAX executors, within the bf16 output floor of
  benchmark/tpu_exactness_check.py (5e-2 of the output's scale) against
  the executor of the same plan, and no farther from the float32 output
  than JAX's own bf16 executors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import flat_fused as ffu
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from test_torch_group_norm import (
    B, KW, SHAPE, _JDT, _TDT, _close, _close_rows, _jax_tree, _lanes_ps,
    _pro, _q, _seeded_port, _x)
from test_torch_kernels import _spy_pallas
from test_torch_train import LOSS_RTOL, _assert_trees, _batch

NORMS = ("group", "group4", "instance")


def _tt(a, dtype, grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(_TDT[dtype])
    return t.requires_grad_(grad)


def _scaled_cts(rng, shape, dtype):
    """An output cotangent of different scales per sample, values of
    ``dtype``."""
    return _x(rng, shape, dtype) * np.float32(0.1)


def _grads(jfn, pfn, args, cts, dtype):
    """The gradients of every argument of both functions for the same
    cotangents (``args``: numpy arrays, each with its JAX dtype)."""
    jargs = [jnp.asarray(a).astype(jd) for a, jd in args]
    _, pull = jax.vjp(jfn, *jargs)
    jg = pull(tuple(jnp.asarray(c).astype(jd) for c, jd in cts))
    targs = [_tt(a, "bfloat16" if jd == jnp.bfloat16 else "float32", True)
             for a, jd in args]
    pout = pfn(*targs)
    pg = torch.autograd.grad(
        pout, targs, [_tt(c, "bfloat16" if jd == jnp.bfloat16
                          else "float32") for c, jd in cts])
    return jg, pg


def _stats_cts(rng, c):
    """(B, C) cotangents of the per-sample (sum, sumsq): rows of
    different scales."""
    return ((1e-3 * rng.normal(size=(B, c))).astype(np.float32),
            (1e-4 * rng.normal(size=(B, c))).astype(np.float32))


def _conv32_case(rng, dtype, nin, act):
    """Row 8: the C=32 executor's conv (L0 conv2 and the up_2 merge)."""
    D, H, W, cout = 2, 6, 8, 32
    jdt = _JDT[dtype]
    x = _x(rng, (B, D, H, W, 32 * nin), dtype)
    w = _q(0.1 * rng.normal(size=(1, 3, 3, 32 * nin, cout)), dtype)
    b = _q(0.1 * rng.normal(size=cout), dtype)
    inv, shift = _pro(rng, 32 * nin)

    def jfn(x, inv, shift, w, b):
        ys, (s, q) = ffu.conv_bnact_flat(
            fc.to_flat(x), _lanes_ps(inv, 32), _lanes_ps(shift, 32), w, b,
            H, W, (0,) * nin, True, act)
        return (fc.from_flat(ys, H, W, padded=True), ffu.fold_lane_stats(s),
                ffu.fold_lane_stats(q))

    def pfn(x, inv, shift, w, b):
        xs = [x[..., 32 * i:32 * (i + 1)] for i in range(nin)]
        return fused.conv_bnact(xs, inv, shift, w.permute(4, 3, 0, 1, 2), b,
                                act, want_stats="per_sample")
    args = [(x, jdt), (inv, jnp.float32), (shift, jnp.float32), (w, jdt),
            (b, jdt)]
    return jfn, pfn, args, (B, D, H, W, cout), cout


def _conv1_case(rng, dtype, input_grad):
    """Row 13: the network input's conv (no prologue)."""
    D, H, W = 2, 6, 8
    jdt = _JDT[dtype]
    x = _x(rng, (B, D, H, W, 1), dtype)
    w = (0.3 * rng.normal(size=(1, 3, 3, 1, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)

    def jfn(x, w, b):
        (y,), (s, q) = ffu.conv1_bnstats_flat(x, w, b, H, W, jdt,
                                              input_grad, True)
        return (fc.from_flat((y,), H, W, padded=True),
                ffu.fold_lane_stats(s), ffu.fold_lane_stats(q))

    def pfn(x, w, b):
        # The model's L0 conv1: the float32 parameters, the input in the
        # model dtype.
        return fused.conv_bnact([x], None, None, w.permute(4, 3, 0, 1, 2), b,
                                "linear", want_stats="per_sample",
                                input_grad=input_grad)
    args = [(x, jdt), (w, jnp.float32), (b, jnp.float32)]
    return jfn, pfn, args, (B, D, H, W, 32), 32


def _conv64_case(rng, dtype, cins, kd, act):
    """Row 14: the C=64 executor's conv (L1 conv1 and conv2, the up_1
    merge)."""
    D, H, W, cout = 4, 4, 6, 64
    jdt = _JDT[dtype]
    cin = sum(cins)
    x = _x(rng, (B, D, H, W, cin), dtype)
    w = _q(0.05 * rng.normal(size=(kd, 3, 3, cin, cout)), dtype)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _pro(rng, cin)
    bounds = np.cumsum((0,) + cins)
    cpad = 64 - cin if cin < 64 else 0

    def jfn(x, inv, shift, w, b):
        chunks = sum((f64.to_flat64(x[..., lo:hi])
                      for lo, hi in zip(bounds[:-1], bounds[1:])), ())
        pad = ((0, 0), (0, cpad))
        ys, (s, q) = f64.conv3_bnact_flat64(
            chunks, _lanes_ps(jnp.pad(inv, pad, constant_values=1.0), 64),
            _lanes_ps(jnp.pad(shift, pad), 64),
            jnp.pad(w, ((0, 0),) * 3 + ((0, cpad), (0, 0))), b, H, W, True,
            act)
        return (f64.from_flat64(ys, H, W, cout), f64.fold_lane_stats64(s),
                f64.fold_lane_stats64(q))

    def pfn(x, inv, shift, w, b):
        xs = [x[..., lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        return fused.conv_bnact(xs, inv, shift, w.permute(4, 3, 0, 1, 2), b,
                                act, want_stats="per_sample")
    args = [(x, jdt), (inv, jnp.float32), (shift, jnp.float32),
            (w, jnp.float32), (b, jnp.float32)]
    return jfn, pfn, args, (B, D, H, W, cout), cout


def _pool_case(rng, dtype, window, act):
    """Rows 10 and 15: the pool with the level's skip."""
    C = 32 if window == (1, 2, 2) else 64
    D, H, W = 4, 4, 8 if C == 32 else 6
    jdt = _JDT[dtype]
    x = _x(rng, (B, D, H, W, C), dtype)
    inv, shift = _pro(rng, C)

    def jfn(x, inv, shift):
        if C == 32:
            pooled, skip = ffu.pool_bnact_flat_skip(
                fc.to_flat(x), _lanes_ps(inv, 32), _lanes_ps(shift, 32), H,
                W, (0,), act, "dense5")
            return pooled, fc.from_flat(tuple(skip), H, W, padded=True)
        pooled, skip = f64.pool222_bnact_flat64_skip(
            f64.to_flat64(x), _lanes_ps(inv, 64), _lanes_ps(shift, 64), H, W,
            C, act)
        return pooled, f64.from_flat64(tuple(skip), H, W, C)

    def pfn(x, inv, shift):
        return fused.pool_bnact(x, inv, shift, act, window)
    args = [(x, jdt), (inv, jnp.float32), (shift, jnp.float32)]
    pooled = (B, D // window[0], H // 2, W // 2, C)
    return jfn, pfn, args, [pooled, (B, D, H, W, C)]


def _upconv222_case(rng, dtype):
    """Row 18: up_1 from the dense L2 output (no prologue)."""
    D1, H1, W1, cin, cout = 2, 2, 3, 128, 64
    jdt = _JDT[dtype]
    dec = _x(rng, (B, D1, H1, W1, cin), dtype)
    w = _q(0.05 * rng.normal(size=(2, 2, 2, cin, cout)), dtype)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)

    def jfn(dec, w, b):
        ys, (s, q) = f64.upconv222_bn_flat64(dec, w, b, 2 * H1, 2 * W1,
                                             "per_sample")
        return (f64.from_flat64(ys, 2 * H1, 2 * W1, cout),
                f64.fold_lane_stats64(s), f64.fold_lane_stats64(q))

    def pfn(dec, w, b):
        return fused.upconv_bnact(dec, None, None,
                                  w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b,
                                  "linear", want_stats="per_sample")
    args = [(dec, jdt), (w, jnp.float32), (b, jnp.float32)]
    return jfn, pfn, args, (B, 2 * D1, 2 * H1, 2 * W1, cout), cout


def _upconv122_case(rng, dtype, act):
    """Row 21: up_2 from the L1 carry (with its prologue)."""
    D, H1, W1 = 2, 3, 4
    jdt = _JDT[dtype]
    x = _x(rng, (B, D, H1, W1, 64), dtype)
    w = _q(0.1 * rng.normal(size=(1, 2, 2, 64, 32)), dtype)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    inv, shift = _pro(rng, 64)

    def jfn(x, inv, shift, w, b):
        (chunk,) = f64.to_flat64(x)
        (y,), (s, q) = f64.upconv122_from_flat64(
            chunk, _lanes_ps(inv, 64), _lanes_ps(shift, 64), w, b, 2 * H1,
            2 * W1, "per_sample", act)
        return (fc.from_flat((y,), 2 * H1, 2 * W1, padded=True),
                ffu.fold_lane_stats(s), ffu.fold_lane_stats(q))

    def pfn(x, inv, shift, w, b):
        return fused.upconv_bnact(x, inv, shift,
                                  w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b,
                                  act, want_stats="per_sample")
    args = [(x, jdt), (inv, jnp.float32), (shift, jnp.float32),
            (w, jnp.float32), (b, jnp.float32)]
    return jfn, pfn, args, (B, D, 2 * H1, 2 * W1, 32), 32


# case -> (builder(rng, dtype), the JAX backward function it must reach)
BWD_CASES = {
    "row8-conv32-leaky": (lambda r, dt: _conv32_case(r, dt, 1, "leaky"),
                          "_conv_bnact_bwd"),
    "row8-merge32+32-relu": (lambda r, dt: _conv32_case(r, dt, 2, "relu"),
                             "_conv_bnact_bwd"),
    "row10-pool122-relu": (lambda r, dt: _pool_case(r, dt, (1, 2, 2),
                                                    "relu"),
                           "_pool_bwd_impl"),
    "row13-conv1": (lambda r, dt: _conv1_case(r, dt, False), "_conv1_bwd"),
    "row13-conv1-input-grad": (lambda r, dt: _conv1_case(r, dt, True),
                               "_conv1_bwd"),
    "row14-cin32-kd3-relu": (lambda r, dt: _conv64_case(r, dt, (32,), 3,
                                                        "relu"),
                             "_conv64_bwd"),
    "row14-merge64+64-kd3-leaky": (
        lambda r, dt: _conv64_case(r, dt, (64, 64), 3, "leaky"),
        "_conv64_bwd"),
    "row15-pool222-relu": (lambda r, dt: _pool_case(r, dt, (2, 2, 2),
                                                    "relu"),
                           "_pool64_bwd_impl"),
    "row18-upconv222-128to64": (_upconv222_case, "_upconv64_bwd"),
    "row21-upconv122-prologue-relu": (
        lambda r, dt: _upconv122_case(r, dt, "relu"), "_upconv122_f64_bwd"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_per_sample_backward_matches_jax_kernel(case, dtype,
                                                      monkeypatch):
    """Every argument's gradient; a per-sample prologue's gradients row
    by row, and each sample's rows differ."""
    builder, row_fn = BWD_CASES[case]
    rng = np.random.default_rng([len(case), len(dtype), 16])
    jfn, pfn, args, out_shape, *c = builder(rng, dtype)
    if case.startswith(("row10", "row15")):
        # the pooled output's and the skip's cotangents
        cts = [(_scaled_cts(rng, s, dtype), _JDT[dtype])
               for s in out_shape]
    else:
        cts = [(_scaled_cts(rng, out_shape, dtype), _JDT[dtype]),
               *((v, jnp.float32) for v in _stats_cts(rng, c[0]))]
    seen = _spy_pallas(monkeypatch, {row_fn})
    jg, pg = _grads(jfn, pfn, args, cts, dtype)
    assert seen == {row_fn}
    for (a, jd), p, j in zip(args, pg, jg):
        assert p.dtype == _TDT["bfloat16" if jd == jnp.bfloat16
                               else "float32"]
        if a.ndim == 2:      # (B, C): dinv or dshift
            _close_rows(p, j, dtype)
            assert not np.allclose(np.asarray(j)[0], np.asarray(j)[1])
        else:
            _close(p.float(), jnp.asarray(j).astype(jnp.float32),
                   "bfloat16" if jd == jnp.bfloat16 else "float32")


def test_per_sample_ops_return_gradients():
    """Each op takes a gradient through its per-sample mode: (N, C)
    vectors get (N, C) gradients and per-sample statistics their (N, C)
    cotangents; a wrong per-sample shape is a ValueError."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 2, 4, 4, 32, generator=g, requires_grad=True)
    inv = torch.randn(2, 32, generator=g, requires_grad=True)
    shift = torch.randn(2, 32, generator=g, requires_grad=True)
    w = torch.randn(32, 32, 1, 3, 3, generator=g, requires_grad=True)
    wu = torch.randn(32, 32, 1, 2, 2, generator=g, requires_grad=True)
    b = torch.zeros(32, requires_grad=True)
    y, s, q = fused.conv_bnact([x], inv, shift, w, b, "relu",
                               want_stats="per_sample")
    pooled, skip = fused.pool_bnact(x, inv, shift, "relu", (1, 2, 2))
    u, us, uq = fused.upconv_bnact(x, inv, shift, wu, b, "relu",
                                   want_stats="per_sample")
    assert s.shape == us.shape == (2, 32)
    loss = (y.sum() + (s * s).sum() + q.sum() + pooled.sum()
            + (skip * skip).sum() + u.sum() + us.sum() + uq.sum())
    grads = torch.autograd.grad(loss, [x, inv, shift, w, wu, b])
    assert [tuple(t.shape) for t in grads] == [
        tuple(t.shape) for t in (x, inv, shift, w, wu, b)]
    assert all(bool(torch.isfinite(t).all()) and bool(t.abs().sum() > 0)
               for t in grads)
    with pytest.raises(ValueError, match="prologue vector shape"):
        fused.pool_bnact(x, torch.ones(3, 32), torch.zeros(3, 32), "relu",
                         (1, 2, 2))
    with pytest.raises(ValueError, match="want_stats"):
        fused.conv_bnact([x], None, None, w, b, "relu",
                         want_stats="per_channel")


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

# The JAX backward kernels of rows 8, 10, 13, 14, 15, 18 and 21 that the
# fused step reaches at SHAPE (L2 declines at H=3).
BWD_ROWS = {"_conv_bnact_bwd", "_pool_bwd_impl", "_conv1_bwd",
            "_conv64_bwd", "_pool64_bwd_impl", "_upconv64_bwd",
            "_upconv122_f64_bwd"}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(31)
    x, y = _batch(rng, SHAPE)
    out = {"x": x, "y": y}
    for i, norm in enumerate(NORMS):
        kw = dict(KW, normalization=norm)
        m0 = _seeded_port(60 + i, **kw)
        jf = junet.UNet(pallas_flat=True, **kw)
        v = jax.tree_util.tree_map(
            jnp.asarray, flax_from_state_dict(m0.state_dict(),
                                              _jax_tree(jf, SHAPE),
                                              ("params",)))
        out[norm] = dict(m0=m0, v=v, kw=kw)
    return out


def _port_step(m, x, y):
    m.train()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                      torch.from_numpy(y).long())
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  m.named_parameters()}


@pytest.mark.parametrize("norm", NORMS)
def test_port_group_kernel_step_matches_jax_fused_step(models, norm,
                                                       monkeypatch):
    """One training step through the kernel levels' per-sample mode (the
    plain versions here) against JAX's fused step, which reaches every
    per-sample backward kernel of the slice."""
    r = models[norm]
    x, y = models["x"], models["y"]
    jf = junet.UNet(pallas_flat=True, **r["kw"])
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(p):
        out = jf.apply({"params": p}, jnp.asarray(x), train=True)
        return crit(out, jnp.asarray(y)).astype(jnp.float32)
    seen = _spy_pallas(monkeypatch, BWD_ROWS)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(r["v"]["params"])
    assert seen == BWD_ROWS
    m = UNet(device="cpu", pallas_flat=True, **r["kw"])
    m.load_state_dict(state_dict_from_flax(jax.device_get(r["v"]), m))
    assert m.level_kinds(SHAPE) == ["kernels", "kernels", "library",
                                    "library"]
    fused.reset_launches()
    loss, grads = _port_step(m, x, y)
    jl = float(jl)
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl), (loss, jl)
    _assert_trees(flax_from_state_dict(grads, r["v"], ("params",))
                  ["params"], jg)


# benchmark/tpu_exactness_check.py's bf16 floor for outputs of one plan
# against another executor (its 'mosaic' bf16 tolerance).
BF16_FLOOR = 5e-2


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("norm", ["group", "instance"])
def test_port_group_bf16_forward_matches_both_jax_executors(models, norm):
    """The bf16 eval forward of both port plans against both JAX bf16
    executors and JAX's float32 XLA executor, on the same parameters (the
    model dtype bf16, its parameters float32). max |a - b| / max(1,
    max |b|):
    - each port plan against the JAX executor of its plan (kernels
      against the fused one in interpret mode, library against XLA)
      within the floor;
    - against the other executor within the floor plus JAX's own
      distance between its two bf16 executors on these inputs (5.4e-2
      for 'instance' here: the two round at other points);
    - each port plan's distance to the float32 output at most twice the
      larger of the JAX bf16 executors' own."""
    r = models[norm]
    x = models["x"]
    refs = {}
    # the float32 reference is the XLA executor's alone
    for pf, dt in ((True, jnp.bfloat16), (False, jnp.bfloat16),
                   (False, jnp.float32)):
        jm = junet.UNet(pallas_flat=pf, dtype=dt, **r["kw"])
        v = flax_from_state_dict(r["m0"].state_dict(),
                                 _jax_tree(jm, SHAPE), ("params",))
        refs[pf, dt] = np.asarray(jax.jit(
            lambda v, x: jm.apply(v, x, train=False))(
                jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
            .astype(jnp.float32))
    truth = refs[False, jnp.float32]
    spread = _rel(refs[True, jnp.bfloat16], refs[False, jnp.bfloat16])
    jax_err = max(_rel(refs[pf, jnp.bfloat16], truth) for pf in (True, False))
    for pf in (True, False):
        m = UNet(device="cpu", pallas_flat=pf, dtype=torch.bfloat16,
                 **r["kw"])
        m.load_state_dict(r["m0"].state_dict())
        with torch.no_grad():
            out = m.eval()(torch.from_numpy(x)).float().numpy()
        assert _rel(out, refs[pf, jnp.bfloat16]) <= BF16_FLOOR
        assert _rel(out, refs[not pf, jnp.bfloat16]) <= BF16_FLOOR + spread
        assert _rel(out, truth) <= 2.0 * jax_err
