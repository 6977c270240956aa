"""The port's group and instance norm (``normalization='group'``,
``'group<G>'``, ``'instance'``) against the JAX package's, on the CPU.

- Op level: the per-sample mode of the forward kernels, rows 1, 2, 3, 4, 6
  and 7 of PERF.md's kernel table (JAX's ``want_stats='per_sample'`` and
  (n, B, 128) prologue lanes, in interpret mode; a spy on ``pallas_call``
  shows that JAX reached each row's entry), against the port's ops with
  (B, C) prologue vectors and ``want_stats='per_sample'``, which take the
  kernels' plain versions on a CPU tensor. B = 2 samples of different
  scales and vectors, float32 and bfloat16 (inputs, weights and biases
  values of the dtype). Tolerances: float32 1e-4 of each output's scale
  (at least 1); bfloat16 one unit in the last place of each value plus
  1e-4 of the scale (the two sum in other orders before the one
  rounding); each row of the (B, C) statistics 1e-4 of its scale in
  float32, 1e-3 in bfloat16 (sums of outputs that may sit one unit
  apart).
- ``gn_prologue`` against ``FlatGNStats`` (the same (B, C) sums, group
  counts 8, 4 and one a channel, a cancelling variance that clamps): 1e-6
  of each vector's scale; ``identity_prologue``'s per-sample form
  against JAX's; ``GroupNorm`` against flax's ``nn.GroupNorm``.
- Model level: the headline structure (n_blocks=4, start_filts=32, planar
  L0) at input (2, 4, 12, 16, 1) with 'group', 'group4' and 'instance',
  random affine parameters: the eval forward with ``pallas_flat=True``
  (L0, L1 and their decoder levels on the kernels' per-sample mode; L2,
  which declines at H=3, L3 and up_0 on ``GroupNorm``) against JAX's
  fused executor, and with ``pallas_flat=False`` against JAX's XLA
  executor (flax ``nn.GroupNorm``): 2e-4, float32. One training step on
  the library plan against JAX's ``pallas_flat=False`` step (loss 1e-5
  relative, each gradient 1e-3 of its leaf's scale + 1e-6, as
  tests/test_torch_train.py). Scaling sample 1 by 10 leaves sample 0's
  output unchanged (bitwise). The converter round trips through both
  JAX trees exactly. Training through a kernel level runs (its step
  against JAX's is tests/test_torch_group_train.py's); a group count that
  does not divide a level's channels sends the level to the library,
  whose ``GroupNorm`` raises flax's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.modules.flat_norm import FlatGNStats
from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import flat_fused as ffu
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.modules.flat_norm import gn_prologue
from elektronn3_tpu_torch.modules.layers import GroupNorm
from elektronn3_tpu_torch.models.convert import (
    conv_weight_from_flax, convtranspose_weight_from_flax)
from elektronn3_tpu_torch.ops import fused
from test_torch_kernels import _spy_pallas
from test_torch_train import LOSS_RTOL, _assert_trees, _batch

TOL = 1e-4
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B = 2


def _q(a, dtype):
    """float32 numpy values of ``dtype`` (bfloat16 rounds)."""
    return np.array(jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
                    .astype(jnp.float32))


def _x(rng, shape, dtype):
    """Samples of different scales (1 and 3)."""
    scale = np.arange(1, shape[0] * 2, 2, dtype=np.float32).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    return _q(scale * rng.normal(size=shape), dtype)


def _pro(rng, c):
    """(B, c) per-sample (inv, shift), negative scales among them."""
    return (rng.normal(size=(B, c)).astype(np.float32),
            (0.2 * rng.normal(size=(B, c))).astype(np.float32))


def _lanes_ps(v, cc):
    """(B, n * cc) per-sample vectors -> JAX's (n, B, 128) lanes."""
    v = jnp.asarray(v)
    return jnp.stack([jnp.tile(v[:, i * cc:(i + 1) * cc], (1, 128 // cc))
                      for i in range(v.shape[1] // cc)])


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TDT[dtype])


def _close(port, ref, dtype, tol=TOL):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref)
    scale = max(1.0, float(np.abs(ref).max()))
    bound = tol * scale
    if dtype == "bfloat16":
        bound = bound + 2.0 ** -7 * np.abs(ref)
    assert np.all(err <= bound), (float(err.max()), scale)


def _close_rows(port, ref, dtype):
    """(B, C) statistics, row by row against each row's scale."""
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape == (B, ref.shape[1]), port.shape
    tol = 1e-3 if dtype == "bfloat16" else TOL
    for p, r in zip(port, ref):
        scale = max(1.0, float(np.abs(r).max()))
        assert float(np.abs(p - r).max()) <= tol * scale


def _row1(rng, dtype, nin=2, act="relu"):
    D, H, W, cout = 2, 6, 8, 32
    xs = [_x(rng, (B, D, H, W, 32), dtype) for _ in range(nin)]
    w = _q(0.1 * rng.normal(size=(1, 3, 3, 32 * nin, cout)), dtype)
    b = _q(0.1 * rng.normal(size=cout), dtype)
    inv, shift = _pro(rng, 32 * nin)
    jdt = _JDT[dtype]
    chunks = sum((fc.to_flat(jnp.asarray(x).astype(jdt)) for x in xs), ())
    ys, (s, q) = ffu.conv_bnact_flat(
        chunks, _lanes_ps(inv, 32), _lanes_ps(shift, 32),
        jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt), H, W,
        (0,) * nin, True, act)
    ref = (fc.from_flat(ys, H, W, padded=True), ffu.fold_lane_stats(s),
           ffu.fold_lane_stats(q))
    port = fused.conv_bnact([_t(x, dtype) for x in xs], _t(inv), _t(shift),
                            _t(conv_weight_from_flax(w)), _t(b), act,
                            want_stats="per_sample")
    return port, ref


def _row2(rng, dtype, act="relu"):
    D, H, W = 2, 6, 8
    x = _x(rng, (B, D, H, W, 32), dtype)
    inv, shift = _pro(rng, 32)
    pooled, _ = ffu.pool_bnact_flat_skip(
        fc.to_flat(jnp.asarray(x).astype(_JDT[dtype])), _lanes_ps(inv, 32),
        _lanes_ps(shift, 32), H, W, (0,), act, "dense5")
    port = fused.pool_bnact(_t(x, dtype), _t(inv), _t(shift), act,
                            (1, 2, 2))[0]
    return (port,), (pooled,)


def _row3(rng, dtype):
    D, H, W = 2, 6, 8
    x = _x(rng, (B, D, H, W, 1), dtype)
    w = (0.3 * rng.normal(size=(1, 3, 3, 1, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    (y,), (s, q) = ffu.conv1_bnstats_flat(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), H, W, _JDT[dtype],
        True, True)
    ref = (fc.from_flat((y,), H, W, padded=True), ffu.fold_lane_stats(s),
           ffu.fold_lane_stats(q))
    port = fused.conv_bnact([_t(x, dtype)], None, None,
                            _t(conv_weight_from_flax(w)), _t(b), "linear",
                            want_stats="per_sample")
    return port, ref


def _row4(rng, dtype, cins=(64, 64), kd=3, act="leaky"):
    D, H, W, cout = 4, 4, 6, 64
    cin = sum(cins)
    xs = [_x(rng, (B, D, H, W, c), dtype) for c in cins]
    w = _q(0.05 * rng.normal(size=(kd, 3, 3, cin, cout)), dtype)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _pro(rng, cin)
    jdt = _JDT[dtype]
    chunks = sum((f64.to_flat64(jnp.asarray(x).astype(jdt)) for x in xs),
                 ())
    ys, (s, q) = f64.conv3_bnact_flat64(
        chunks, _lanes_ps(inv, 64), _lanes_ps(shift, 64), jnp.asarray(w),
        jnp.asarray(b), H, W, True, act)
    ref = (f64.from_flat64(ys, H, W, cout), f64.fold_lane_stats64(s),
           f64.fold_lane_stats64(q))
    port = fused.conv_bnact([_t(x, dtype) for x in xs], _t(inv), _t(shift),
                            _t(conv_weight_from_flax(w)), _t(b), act,
                            want_stats="per_sample")
    return port, ref


def _row6(rng, dtype, cin=128, cout=64):
    D1, H1, W1 = 2, 2, 3
    dec = _x(rng, (B, D1, H1, W1, cin), dtype)
    w = _q(0.05 * rng.normal(size=(2, 2, 2, cin, cout)), dtype)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    ys, (s, q) = f64.upconv222_bn_flat64(
        jnp.asarray(dec).astype(_JDT[dtype]), jnp.asarray(w),
        jnp.asarray(b), 2 * H1, 2 * W1, "per_sample")
    ref = (f64.from_flat64(ys, 2 * H1, 2 * W1, cout),
           f64.fold_lane_stats64(s), f64.fold_lane_stats64(q))
    port = fused.upconv_bnact(_t(dec, dtype), None, None,
                              _t(convtranspose_weight_from_flax(w)), _t(b),
                              "linear", want_stats="per_sample")
    return port, ref


def _row7(rng, dtype, act="relu"):
    D, H1, W1 = 2, 3, 4
    x = _x(rng, (B, D, H1, W1, 64), dtype)
    w = _q(0.1 * rng.normal(size=(1, 2, 2, 64, 32)), dtype)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    inv, shift = _pro(rng, 64)
    (chunk,) = f64.to_flat64(jnp.asarray(x).astype(_JDT[dtype]))
    (y,), (s, q) = f64.upconv122_from_flat64(
        chunk, _lanes_ps(inv, 64), _lanes_ps(shift, 64), jnp.asarray(w),
        jnp.asarray(b), 2 * H1, 2 * W1, "per_sample", act)
    ref = (fc.from_flat((y,), 2 * H1, 2 * W1, padded=True),
           ffu.fold_lane_stats(s), ffu.fold_lane_stats(q))
    port = fused.upconv_bnact(_t(x, dtype), _t(inv), _t(shift),
                              _t(convtranspose_weight_from_flax(w)), _t(b),
                              act, want_stats="per_sample")
    return port, ref


# case -> (the case's function, the JAX entry whose pallas_call it
# must reach)
OP_CASES = {
    "row1-merge32+32-relu": (_row1, "conv_bnact_flat"),
    "row2-pool122-relu": (_row2, "pool_bnact_flat_skip"),
    "row3-conv1": (_row3, "conv1_bnstats_flat"),
    "row4-merge64+64-kd3-leaky": (_row4, "conv3_bnact_flat64"),
    "row6-upconv222-128to64": (_row6, "upconv222_bn_flat64"),
    "row7-upconv122-prologue-relu": (_row7, "upconv122_from_flat64"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OP_CASES))
def test_plain_per_sample_op_matches_jax_kernel(case, dtype, monkeypatch):
    make_case, entry = OP_CASES[case]
    seen = _spy_pallas(monkeypatch, {entry})
    port, ref = make_case(np.random.default_rng([len(case), len(dtype)]),
                          dtype)
    assert seen == {entry}
    _close(port[0], ref[0], dtype)
    assert port[0].dtype == _TDT[dtype]
    for p, r in zip(port[1:], ref[1:]):
        assert p.dtype == torch.float32
        _close_rows(p, r, dtype)
        # The rows differ: the statistics are those of each sample.
        assert not np.allclose(np.asarray(r)[0], np.asarray(r)[1])


# ---------------------------------------------------------------------------
# gn_prologue against FlatGNStats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,groups", [(32, 8), (64, 4), (128, 128)])
def test_gn_prologue_matches_flat_gn_stats(c, groups):
    """The same (B, C) sums over 96 voxels a sample; channel 0 of sample
    1 sits on a large mean with a variance that cancels below 0."""
    rng = np.random.default_rng(c + groups)
    spatial = 96
    y = rng.normal(size=(B, spatial, c)).astype(np.float32)
    y[1, :, 0] = 3.0e3 + 1e-4 * rng.normal(size=spatial)
    s, q = y.sum(1), (y * y).sum(1)
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    cc = 32 if c == 32 else 64
    mod = FlatGNStats(num_groups=groups, cc=cc)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    inv_l, shift_l = mod.apply(params, jnp.asarray(s), jnp.asarray(q),
                               spatial, c // cc)
    # (n, B, 128) lanes -> (B, C)
    jinv = np.concatenate([np.asarray(inv_l[i])[:, :cc]
                           for i in range(c // cc)], axis=1)
    jshift = np.concatenate([np.asarray(shift_l[i])[:, :cc]
                             for i in range(c // cc)], axis=1)
    norm = GroupNorm(groups, c)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    inv, shift = gn_prologue(norm, torch.from_numpy(s), torch.from_numpy(q),
                             spatial, groups)
    assert inv.shape == shift.shape == (B, c)
    for got, ref in ((inv, jinv), (shift, jshift)):
        err = float(np.abs(got.detach().numpy() - ref).max())
        assert err <= 1e-6 * float(np.abs(ref).max()), err


def test_identity_prologue_per_sample_form():
    """``identity_prologue`` with ``batch``: JAX's ``identity_prologue(n,
    batch)`` (ones and zeros, (n, B, 128) lanes) as (B, C)."""
    from elektronn3_tpu.modules.flat_norm import \
        identity_prologue as jax_identity
    from elektronn3_tpu_torch.modules.flat_norm import identity_prologue
    inv, shift = identity_prologue(64, batch=3)
    jinv, jshift = jax_identity(2, 3)
    assert inv.shape == shift.shape == (3, 64)
    assert np.array_equal(inv.numpy(), np.asarray(jinv)[:, :, :32]
                          .transpose(1, 0, 2).reshape(3, 64))
    assert np.array_equal(shift.numpy(), np.asarray(jshift)[:, :, :32]
                          .transpose(1, 0, 2).reshape(3, 64))
    assert identity_prologue(64)[0].shape == (64,)


def test_group_norm_matches_flax_group_norm():
    """The library levels' GroupNorm against flax ``nn.GroupNorm`` (the
    JAX UNet's, eps 1e-6) in float32 and bfloat16, and flax's error for
    a group count that does not divide the channels."""
    import flax.linen as fnn
    rng = np.random.default_rng(7)
    for dtype in ("float32", "bfloat16"):
        x = _x(rng, (B, 3, 4, 5, 64), dtype)
        scale = rng.normal(size=64).astype(np.float32)
        bias = rng.normal(size=64).astype(np.float32)
        for groups, jmod in ((8, fnn.GroupNorm(num_groups=8,
                                                dtype=_JDT[dtype])),
                             (64, fnn.GroupNorm(num_groups=None,
                                                group_size=1,
                                                dtype=_JDT[dtype]))):
            ref = jmod.apply({"params": {"scale": scale, "bias": bias}},
                             jnp.asarray(x).astype(_JDT[dtype]))
            norm = GroupNorm(groups, 64)
            with torch.no_grad():
                norm.weight.copy_(torch.from_numpy(scale))
                norm.bias.copy_(torch.from_numpy(bias))
            _close(norm(_t(x, dtype)), ref, dtype)
    with pytest.raises(ValueError, match="does not divide"):
        GroupNorm(3, 64)(torch.zeros(1, 2, 2, 2, 64))


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

SHAPE = (2, 4, 12, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,))
NORMS = ("group", "group4", "instance")


def _seeded_port(seed, **kw):
    """A port model with random conv biases and norm scales of both
    signs, biases shifted."""
    m = UNet(device="cpu", generator=torch.Generator().manual_seed(seed),
             **kw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif ".norm" in name:
                p.copy_(torch.randn(p.shape, generator=g))
    return m


def _jax_tree(model, shape):
    return jax.eval_shape(lambda: junet.init_unet(model, shape))


def _jax_step(model, params, x, y, crit):
    """(loss, grads) of one JAX training step (no batch statistics)."""
    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(x), train=True)
        return crit(out, jnp.asarray(y)).astype(jnp.float32)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), g


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(29)
    x, y = _batch(rng, SHAPE)
    out = {"x": x, "y": y}
    for i, norm in enumerate(NORMS):
        kw = dict(KW, normalization=norm)
        m0 = _seeded_port(40 + i, **kw)
        jf = junet.UNet(pallas_flat=True, **kw)
        jx = junet.UNet(pallas_flat=False, **kw)
        trees = {True: _jax_tree(jf, SHAPE), False: _jax_tree(jx, SHAPE)}
        v = jax.tree_util.tree_map(
            jnp.asarray, flax_from_state_dict(m0.state_dict(), trees[False],
                                              ("params",)))
        with pytest.MonkeyPatch.context() as mp:
            seen = _spy_pallas(mp, set(OP_CASES_ENTRIES))
            y_fused = np.asarray(jax.jit(
                lambda v, x: jf.apply(v, x, train=False))(v, jnp.asarray(x)))
        y_xla = np.asarray(jx.apply(v, jnp.asarray(x), train=False))
        fwd = {}
        for pf in (True, False):
            m = UNet(device="cpu", pallas_flat=pf, **kw)
            m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
            fused.reset_launches()
            with torch.no_grad():
                fwd[pf] = (m.eval()(torch.from_numpy(x)).numpy(),
                           m.level_kinds(SHAPE))
        out[norm] = dict(m0=m0, v=v, trees=trees, y_fused=y_fused,
                         y_xla=y_xla, seen=seen, fwd=fwd)
    return out


# The JAX entries of rows 1-7 the fused forward reaches at SHAPE.
OP_CASES_ENTRIES = ("conv_bnact_flat", "pool_bnact_flat_skip",
                    "conv1_bnstats_flat", "conv3_bnact_flat64",
                    "pool222_bnact_flat64_skip", "upconv222_bn_flat64",
                    "upconv122_from_flat64")


@pytest.mark.parametrize("norm", NORMS)
def test_jax_fused_group_forward_reaches_rows_1_to_7(runs, norm):
    assert runs[norm]["seen"] == set(OP_CASES_ENTRIES)


@pytest.mark.parametrize("pf", [True, False],
                         ids=["pallas_flat=True", "pallas_flat=False"])
@pytest.mark.parametrize("norm", NORMS)
def test_port_group_forward_matches_jax(runs, norm, pf):
    """pallas_flat=True against JAX's fused executor (the kernels'
    per-sample mode on L0, L1 and their decoder levels), False against
    its XLA executor."""
    r = runs[norm]
    y, kinds = r["fwd"][pf]
    ref = r["y_fused"] if pf else r["y_xla"]
    assert kinds == (["kernels", "kernels", "library", "library"] if pf
                     else ["library"] * 4)
    assert y.shape == ref.shape == SHAPE[:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


@pytest.mark.parametrize("norm", NORMS)
def test_port_group_samples_are_independent(runs, norm):
    """Per-sample statistics: scaling sample 1 by 10 leaves sample 0's
    output as it was, on the kernel plan."""
    m = UNet(device="cpu", pallas_flat=True, **dict(KW, normalization=norm))
    m.load_state_dict(runs[norm]["m0"].state_dict())
    x = torch.from_numpy(runs["x"])
    x2 = x.clone()
    x2[1] *= 10.0
    with torch.no_grad():
        y, y2 = m.eval()(x), m(x2)
    assert torch.equal(y[0], y2[0])
    assert not torch.allclose(y[1], y2[1])


def test_port_group_library_step_matches_jax(runs):
    """One training step of the library plan (plain autograd, as JAX's
    XLA path) against JAX's ``pallas_flat=False`` step: loss and every
    gradient."""
    r = runs["group"]
    x, y = runs["x"], runs["y"]
    jx = junet.UNet(pallas_flat=False, **dict(KW, normalization="group"))
    jloss_, jg = _jax_step(jx, r["v"]["params"], x, y,
                           jloss.CEDiceLoss(1.0, 1.0))
    m = UNet(device="cpu", pallas_flat=False, **dict(KW,
                                                     normalization="group"))
    m.load_state_dict(state_dict_from_flax(jax.device_get(r["v"]), m))
    m.train()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                      torch.from_numpy(y).long())
    loss.backward()
    grads = flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, r["v"], ("params",))
    assert abs(float(loss.detach()) - jloss_) <= LOSS_RTOL * abs(jloss_)
    _assert_trees(grads["params"], jg)


def test_port_group_kernel_training_runs(runs):
    """Training through a kernel level with group norm runs the
    per-sample ops' backward: every parameter gets a finite gradient
    (tests/test_torch_group_train.py holds the step against JAX's)."""
    m = UNet(device="cpu", pallas_flat=True, **dict(KW,
                                                    normalization="group"))
    m.load_state_dict(runs["group"]["m0"].state_dict())
    x = torch.from_numpy(runs["x"])
    m.train()(x).float().square().mean().backward()
    for name, p in m.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    with torch.no_grad():
        assert m(x).shape == SHAPE[:-1] + (2,)


@pytest.mark.parametrize("pf", [True, False],
                         ids=["pallas_flat=True", "pallas_flat=False"])
def test_converter_round_trip_group_is_exact(runs, pf):
    """torch -> each JAX executor's tree -> torch, bit for bit: the slots
    ``GroupNorm_<n>`` of every level, in the order that both executors'
    ``init`` gives (the fused one's ``_stats_prologue``, the XLA one's
    auto-names), and no batch statistics."""
    for norm in NORMS:
        r = runs[norm]
        tree = r["trees"][pf]
        assert "batch_stats" not in tree or not tree["batch_stats"]
        assert jax.tree_util.tree_structure(tree["params"]) == \
            jax.tree_util.tree_structure(r["trees"][not pf]["params"])
        for level, n in (("down_0", 2), ("up_2", 3), ("down_2", 2),
                         ("up_0", 3)):
            assert sorted(k for k in tree["params"][level]
                          if k.startswith("GroupNorm")) == \
                [f"GroupNorm_{i}" for i in range(n)], level
        m0 = r["m0"]
        v = flax_from_state_dict(m0.state_dict(), tree, ("params",))
        kw = dict(KW, normalization=norm)
        sd = state_dict_from_flax(v, UNet(device="cpu", pallas_flat=pf,
                                          **kw))
        ref = m0.state_dict()
        assert sd.keys() == ref.keys()
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k
        back = flax_from_state_dict(sd, tree, ("params",))
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, back, v))


def test_group_count_not_dividing_a_level_goes_to_the_library():
    """'group3' divides no level's channels: every level declines the
    kernels (JAX's ``_norm_fused_ok``) and the library's GroupNorm raises
    flax's error."""
    m = UNet(device="cpu", pallas_flat=True, normalization="group3", **KW)
    assert m.level_kinds(SHAPE) == ["library"] * 4
    with pytest.raises(ValueError, match="does not divide"):
        with torch.no_grad():
            m.eval()(torch.zeros(SHAPE))
    UNet(device="meta", normalization="instance", dim=2, n_blocks=2,
         pallas_flat=False)
