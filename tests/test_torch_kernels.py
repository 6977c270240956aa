"""The port's fused ops (elektronn3_tpu_torch.ops.fused) against the JAX
package's Pallas kernels they replace, rows 1 to 7 of the port's kernel
table (forward) and rows 8, 10, 13, 14, 15, 18 and 21 (their merged
backward kernels): the same numpy-seeded inputs go through the JAX op
(interpret mode on the CPU, converted with the flat-layout helpers) and
through the port's op, which takes its plain PyTorch version on a CPU
tensor. A backward case differentiates both with the same cotangents
(nonzero ones for the statistics side outputs): ``jax.vjp`` reaches the
op's custom-VJP Pallas kernel, ``torch.autograd.grad`` the port's
``autograd.Function`` and its plain backward. float32 throughout;
tolerance 1e-4 of each output's or gradient's scale.

tests/test_torch_cuda.py holds each CUDA kernel against these plain
versions on the card.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import flat_fused as ffu
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.models.convert import (
    conv_weight_from_flax, convtranspose_weight_from_flax)
from elektronn3_tpu_torch.ops import fused

TOL = 1e-4


def _close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(port - ref)))
    assert err <= TOL * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bn(rng, c):
    """Per-channel (inv, shift) with negative scales among them."""
    return (rng.normal(size=c).astype(np.float32),
            (0.2 * rng.normal(size=c)).astype(np.float32))


def _lanes(v, cc):
    """(n*cc,) per-channel vector -> (n, 128) lane vectors."""
    return jnp.stack([jnp.tile(v[i * cc:(i + 1) * cc], 128 // cc)
                      for i in range(v.shape[0] // cc)])


def _row1_conv_bnact_flat(rng, nin, act):
    B, D, H, W, cout = 1, 2, 6, 8, 32
    x = rng.normal(size=(B, D, H, W, 32 * nin)).astype(np.float32)
    w = (0.1 * rng.normal(size=(1, 3, 3, 32 * nin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _bn(rng, 32 * nin)
    ys, _ = ffu.conv_bnact_flat(fc.to_flat(jnp.asarray(x)),
                                _lanes(jnp.asarray(inv), 32),
                                _lanes(jnp.asarray(shift), 32),
                                jnp.asarray(w), jnp.asarray(b), H, W,
                                (0,) * nin, False, act)
    ref = fc.from_flat(ys, H, W, padded=True)
    xs = [_t(x[..., i * 32:(i + 1) * 32]) for i in range(nin)]
    port = fused.conv_bnact(xs, _t(inv), _t(shift),
                            _t(conv_weight_from_flax(w)), _t(b), act)
    return port, ref


def _row2_pool_bnact_flat_skip(rng, act):
    B, D, H, W = 1, 2, 6, 8
    x = rng.normal(size=(B, D, H, W, 32)).astype(np.float32)
    inv, shift = _bn(rng, 32)
    xs = fc.to_flat(jnp.asarray(x))
    pooled, skip = ffu.pool_bnact_flat_skip(
        xs, _lanes(jnp.asarray(inv), 32), _lanes(jnp.asarray(shift), 32),
        H, W, (0,), act, "dense5")
    assert skip[0] is xs[0]
    port = fused.pool_bnact(_t(x), _t(inv), _t(shift), act, (1, 2, 2))[0]
    return port, pooled


def _row3_conv1_bnstats_flat(rng):
    B, D, H, W = 2, 2, 6, 8
    x = rng.normal(size=(B, D, H, W, 1)).astype(np.float32)
    w = (0.3 * rng.normal(size=(1, 3, 3, 1, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    (y,), _ = ffu.conv1_bnstats_flat(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), H, W, jnp.float32,
                                     True, False)
    ref = fc.from_flat((y,), H, W, padded=True)
    port = fused.conv_bnact([_t(x)], None, None,
                            _t(conv_weight_from_flax(w)), _t(b), "linear")
    return port, ref


def _row4_conv3_bnact_flat64(rng, cins, kd, act):
    B, D, H, W, cout = 1, 4, 4, 6, 64
    cin = sum(cins)
    xs = [rng.normal(size=(B, D, H, W, c)).astype(np.float32) for c in cins]
    w = (0.05 * rng.normal(size=(kd, 3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _bn(rng, cin)
    # Narrow (32-channel) inputs are zero-padded into one 64-lane chunk.
    cpad = 64 - cin if cin < 64 else 0
    chunks = sum((f64.to_flat64(jnp.asarray(x)) for x in xs), ())
    ys, _ = f64.conv3_bnact_flat64(
        chunks, f64.lane_vec64(jnp.pad(jnp.asarray(inv), (0, cpad))),
        f64.lane_vec64(jnp.pad(jnp.asarray(shift), (0, cpad))),
        jnp.pad(jnp.asarray(w), ((0, 0),) * 3 + ((0, cpad), (0, 0))),
        jnp.asarray(b), H, W, False, act)
    ref = f64.from_flat64(ys, H, W, cout)
    port = fused.conv_bnact([_t(x) for x in xs], _t(inv), _t(shift),
                            _t(conv_weight_from_flax(w)), _t(b), act)
    return port, ref


def _row5_pool222_bnact_flat64_skip(rng, act):
    B, D, H, W, C = 1, 4, 4, 6, 64
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    inv, shift = _bn(rng, C)
    pooled, _ = f64.pool222_bnact_flat64_skip(
        f64.to_flat64(jnp.asarray(x)), f64.lane_vec64(jnp.asarray(inv)),
        f64.lane_vec64(jnp.asarray(shift)), H, W, C, act)
    port = fused.pool_bnact(_t(x), _t(inv), _t(shift), act, (2, 2, 2))[0]
    return port, pooled


def _row6_upconv222_bn_flat64(rng, cin, cout):
    B, D1, H1, W1 = 1, 2, 2, 3
    dec = rng.normal(size=(B, D1, H1, W1, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(2, 2, 2, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    ys, _ = f64.upconv222_bn_flat64(jnp.asarray(dec), jnp.asarray(w),
                                    jnp.asarray(b), 2 * H1, 2 * W1, False)
    ref = f64.from_flat64(ys, 2 * H1, 2 * W1, cout)
    port = fused.upconv_bnact(_t(dec), None, None,
                              _t(convtranspose_weight_from_flax(w)), _t(b),
                              "linear")
    return port, ref


def _row7_upconv122_from_flat64(rng, act):
    B, D, H1, W1 = 1, 2, 3, 4
    x = rng.normal(size=(B, D, H1, W1, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(1, 2, 2, 64, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    inv, shift = _bn(rng, 64)
    (chunk,) = f64.to_flat64(jnp.asarray(x))
    (y,), _ = f64.upconv122_from_flat64(
        chunk, f64.lane_vec64(jnp.asarray(inv)),
        f64.lane_vec64(jnp.asarray(shift)), jnp.asarray(w), jnp.asarray(b),
        2 * H1, 2 * W1, False, act)
    ref = fc.from_flat((y,), 2 * H1, 2 * W1, padded=True)
    port = fused.upconv_bnact(_t(x), _t(inv), _t(shift),
                              _t(convtranspose_weight_from_flax(w)), _t(b),
                              act)
    return port, ref


CASES = {
    "row1-conv32-relu": lambda r: _row1_conv_bnact_flat(r, 1, "relu"),
    "row1-merge32+32-leaky": lambda r: _row1_conv_bnact_flat(r, 2, "leaky"),
    "row2-pool122-relu": lambda r: _row2_pool_bnact_flat_skip(r, "relu"),
    "row2-pool122-leaky": lambda r: _row2_pool_bnact_flat_skip(r, "leaky"),
    "row3-conv1": _row3_conv1_bnstats_flat,
    "row4-cin32-kd3-linear": lambda r: _row4_conv3_bnact_flat64(
        r, (32,), 3, "linear"),
    "row4-cin64-kd3-relu": lambda r: _row4_conv3_bnact_flat64(
        r, (64,), 3, "relu"),
    "row4-merge64+64-kd3-relu": lambda r: _row4_conv3_bnact_flat64(
        r, (64, 64), 3, "relu"),
    "row4-cin64-kd1-leaky": lambda r: _row4_conv3_bnact_flat64(
        r, (64,), 1, "leaky"),
    "row5-pool222-relu": lambda r: _row5_pool222_bnact_flat64_skip(
        r, "relu"),
    "row6-upconv222-128to64": lambda r: _row6_upconv222_bn_flat64(
        r, 128, 64),
    "row7-upconv122-prologue-relu": lambda r: _row7_upconv122_from_flat64(
        r, "relu"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_op_matches_jax_kernel(case):
    port, ref = CASES[case](np.random.default_rng(11))
    _close(port, ref)


def test_conv_pads_zero_after_prologue():
    """A halo voxel contributes 0, not act(0 * inv + shift): with a
    large positive shift, a 1-voxel input's border outputs see only the
    taps that land inside."""
    x = torch.zeros(1, 1, 3, 3, 8)
    w = torch.zeros(32, 8, 1, 3, 3)
    w[:, :, 0, :, :] = 1.0
    inv = torch.ones(8)
    shift = torch.full((8,), 5.0)
    y = fused.conv_bnact([x], inv, shift, w, torch.zeros(32), "relu")
    # centre sees 9 in-bounds taps of 8 channels, a corner 4.
    assert float(y[0, 0, 1, 1, 0]) == pytest.approx(9 * 8 * 5.0)
    assert float(y[0, 0, 0, 0, 0]) == pytest.approx(4 * 8 * 5.0)


def test_pool_takes_max_after_prologue():
    """A negative scale reverses the order: the pooled value is the
    max of the prologued values, i.e. minus the raw minimum."""
    x = torch.randn(1, 2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    y, _ = fused.pool_bnact(x, torch.full((8,), -1.0), torch.zeros(8),
                            "linear", (1, 2, 2))
    windows = x.reshape(1, 2, 2, 2, 2, 2, 8)      # (N, D, Ho, 2, Wo, 2, C)
    assert torch.equal(y, -windows.amin(dim=(3, 5)))


def test_contract_is_checked_on_the_cpu():
    """Each op checks its kernel's shape contract before it dispatches,
    so a CPU call refuses what the card refuses."""
    x = torch.zeros(1, 2, 4, 4, 3)
    with pytest.raises(ValueError, match="C_out % 32"):
        fused.conv_bnact([x], None, None, torch.zeros(16, 3, 1, 3, 3),
                         torch.zeros(16), "linear")
    # Row 13's backward (one input of at most 4 channels) takes at most
    # 256 output channels. (An input gradient at any other channel count
    # is K4's, on a copy padded to 32-channel blocks where C_in % 32 != 0:
    # a 5-channel input takes one.)
    xg = torch.zeros(1, 2, 4, 4, 1, requires_grad=True)
    with pytest.raises(ValueError, match="row 13"):
        fused.conv_bnact([xg], None, None, torch.zeros(288, 1, 1, 3, 3),
                         torch.zeros(288), "linear")
    x5 = torch.zeros(1, 2, 4, 4, 5, requires_grad=True)
    fused.conv_bnact([x5], None, None, torch.zeros(32, 5, 1, 3, 3),
                     torch.zeros(32), "linear").sum().backward()
    assert x5.grad.shape == x5.shape
    with pytest.raises(ValueError, match="pool_bnact"):
        fused.pool_bnact(torch.zeros(1, 2, 3, 4, 8), None, None, "relu",
                         (1, 2, 2))
    xu = torch.zeros(1, 2, 2, 2, 48, requires_grad=True)
    with pytest.raises(ValueError, match="K7"):
        fused.upconv_bnact(xu, None, None, torch.zeros(48, 32, 2, 2, 2),
                           torch.zeros(32), "linear")


# ---------------------------------------------------------------------------
# Backward rows: jax.vjp through the Pallas op against autograd through
# the port's op, on dense NDHWC arguments (the flat-layout conversions,
# lane tiling and lane folding are inside the JAX function, so JAX
# differentiates them too).
# ---------------------------------------------------------------------------

def _fold32(st):
    return ffu.fold_lane_stats(st)


def _stat_cts(yshape):
    """Cotangent shapes of (y, sum, sumsq)."""
    return [yshape, (yshape[-1],), (yshape[-1],)]


def _grads(jfn, pfn, args, cts, wrt):
    """Outputs and the gradients of the arguments ``wrt`` (indices) of
    both functions for the same cotangents."""
    jargs = [jnp.asarray(a) for a in args]

    def jpart(*sub):
        full = list(jargs)
        for i, v in zip(wrt, sub):
            full[i] = v
        return jfn(*full)
    jout, pull = jax.vjp(jpart, *[jargs[i] for i in wrt])
    jg = pull(tuple(jnp.asarray(c) for c in cts))
    targs = [_t(a) for a in args]
    for i in wrt:
        targs[i].requires_grad_(True)
    pout = pfn(*targs)
    pg = torch.autograd.grad(pout, [targs[i] for i in wrt],
                             [_t(c) for c in cts])
    return jout, jg, pout, pg


def _conv_flat_case(rng, nin, act):
    B, D, H, W, cout = 2, 2, 6, 8, 32
    x = rng.normal(size=(B, D, H, W, 32 * nin)).astype(np.float32)
    w = (0.1 * rng.normal(size=(1, 3, 3, 32 * nin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _bn(rng, 32 * nin)

    def jfn(x, inv, shift, w, b):
        ys, (s, q) = ffu.conv_bnact_flat(
            fc.to_flat(x), _lanes(inv, 32), _lanes(shift, 32), w, b, H, W,
            (0,) * nin, True, act)
        return fc.from_flat(ys, H, W, padded=True), _fold32(s), _fold32(q)

    def pfn(x, inv, shift, w, b):
        xs = [x[..., 32 * i:32 * (i + 1)] for i in range(nin)]
        return fused.conv_bnact(xs, inv, shift, w.permute(4, 3, 0, 1, 2),
                                b, act, want_stats=True)
    return jfn, pfn, (x, inv, shift, w, b), _stat_cts((B, D, H, W, cout)), \
        range(5)


def _conv1_case(rng, act, input_grad=False):
    B, D, H, W = 2, 2, 6, 8
    x = rng.normal(size=(B, D, H, W, 1)).astype(np.float32)
    w = (0.3 * rng.normal(size=(1, 3, 3, 1, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)

    def jfn(x, w, b):
        (y,), (s, q) = ffu.conv1_bnstats_flat(x, w, b, H, W, jnp.float32,
                                              input_grad, False)
        return fc.from_flat((y,), H, W, padded=True), _fold32(s), \
            _fold32(q)

    def pfn(x, w, b):
        return fused.conv_bnact([x], None, None, w.permute(4, 3, 0, 1, 2), b,
                                "linear", want_stats=True)
    # Without input_grad the network input takes no gradient (JAX's
    # default); with it, the port's row-13 backward gives dx (the plain
    # K4 composed with K5) against the kernel's in-kernel dgrad.
    wrt = (0, 1, 2) if input_grad else (1, 2)
    return jfn, pfn, (x, w, b), _stat_cts((B, D, H, W, 32)), wrt


def _conv64_case(rng, cins, kd, act):
    B, D, H, W, cout = 2, 4, 4, 6, 64
    cin = sum(cins)
    cpad = 64 - cin if cin < 64 else 0
    x = rng.normal(size=(B, D, H, W, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(kd, 3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _bn(rng, cin)
    bounds = np.cumsum((0,) + cins)

    def jfn(x, inv, shift, w, b):
        chunks = sum((f64.to_flat64(x[..., lo:hi])
                      for lo, hi in zip(bounds[:-1], bounds[1:])), ())
        ys, (s, q) = f64.conv3_bnact_flat64(
            chunks, f64.lane_vec64(jnp.pad(inv, (0, cpad))),
            f64.lane_vec64(jnp.pad(shift, (0, cpad))),
            jnp.pad(w, ((0, 0),) * 3 + ((0, cpad), (0, 0))), b, H, W, True,
            act)
        return (f64.from_flat64(ys, H, W, cout), f64.fold_lane_stats64(s),
                f64.fold_lane_stats64(q))

    def pfn(x, inv, shift, w, b):
        xs = [x[..., lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        return fused.conv_bnact(xs, inv, shift, w.permute(4, 3, 0, 1, 2),
                                b, act, want_stats=True)
    return jfn, pfn, (x, inv, shift, w, b), _stat_cts((B, D, H, W, cout)), \
        range(5)


def _pool_case(rng, window, act, tie):
    C = 32 if window == (1, 2, 2) else 64
    B, D, H, W = 2, 4, 4, 8 if C == 32 else 6
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    inv, shift = _bn(rng, C)
    if tie:
        # Half-integer values under a positive scale: windows hold exact
        # ties of their max, whose gradient goes to every tied element.
        x = np.round(2 * x) / 2
        inv, shift = np.abs(inv) + 0.5, np.full_like(shift, 2.0)

    def jfn(x, inv, shift):
        if C == 32:
            xs = fc.to_flat(x)
            pooled, skip = ffu.pool_bnact_flat_skip(
                xs, _lanes(inv, 32), _lanes(shift, 32), H, W, (0,), act,
                "dense5")
            return pooled, fc.from_flat(tuple(skip), H, W, padded=True)
        pooled, skip = f64.pool222_bnact_flat64_skip(
            f64.to_flat64(x), f64.lane_vec64(inv), f64.lane_vec64(shift), H,
            W, C, act)
        return pooled, f64.from_flat64(tuple(skip), H, W, C)

    def pfn(x, inv, shift):
        # The raw input is the level's skip, the pool's second output:
        # its cotangent is summed into the pool's dx (K6's dskip).
        return fused.pool_bnact(x, inv, shift, act, window)
    pooled = (B, D // window[0], H // 2, W // 2, C)
    return jfn, pfn, (x, inv, shift), [pooled, (B, D, H, W, C)], range(3)


def _upconv222_case(rng):
    B, D1, H1, W1, cin, cout = 2, 2, 2, 3, 128, 64
    dec = rng.normal(size=(B, D1, H1, W1, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(2, 2, 2, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)

    def jfn(dec, w, b):
        ys, (s, q) = f64.upconv222_bn_flat64(dec, w, b, 2 * H1, 2 * W1,
                                             True)
        return (f64.from_flat64(ys, 2 * H1, 2 * W1, cout),
                f64.fold_lane_stats64(s), f64.fold_lane_stats64(q))

    def pfn(dec, w, b):
        return fused.upconv_bnact(dec, None, None,
                                  w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b,
                                  "linear", want_stats=True)
    return jfn, pfn, (dec, w, b), \
        _stat_cts((B, 2 * D1, 2 * H1, 2 * W1, cout)), range(3)


def _upconv122_case(rng, act):
    B, D, H1, W1 = 2, 2, 3, 4
    x = rng.normal(size=(B, D, H1, W1, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(1, 2, 2, 64, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    inv, shift = _bn(rng, 64)

    def jfn(x, inv, shift, w, b):
        (chunk,) = f64.to_flat64(x)
        (y,), (s, q) = f64.upconv122_from_flat64(
            chunk, f64.lane_vec64(inv), f64.lane_vec64(shift), w, b, 2 * H1,
            2 * W1, True, act)
        return (fc.from_flat((y,), 2 * H1, 2 * W1, padded=True),
                _fold32(s), _fold32(q))

    def pfn(x, inv, shift, w, b):
        return fused.upconv_bnact(x, inv, shift,
                                  w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b,
                                  act, want_stats=True)
    return jfn, pfn, (x, inv, shift, w, b), \
        _stat_cts((B, D, 2 * H1, 2 * W1, 32)), range(5)


# case -> (builder, the JAX backward function it must reach)
BWD_CASES = {
    "row8-conv32-leaky": (lambda r: _conv_flat_case(r, 1, "leaky"),
                          "_conv_bnact_bwd"),
    "row8-merge32+32-relu": (lambda r: _conv_flat_case(r, 2, "relu"),
                             "_conv_bnact_bwd"),
    "row10-pool122-relu": (lambda r: _pool_case(r, (1, 2, 2), "relu",
                                                False), "_pool_bwd_impl"),
    "row10-pool122-tie": (lambda r: _pool_case(r, (1, 2, 2), "relu", True),
                          "_pool_bwd_impl"),
    "row13-conv1": (lambda r: _conv1_case(r, "linear"), "_conv1_bwd"),
    "row13-conv1-input-grad": (lambda r: _conv1_case(r, "linear", True),
                               "_conv1_bwd"),
    "row14-cin32-kd3-relu": (lambda r: _conv64_case(r, (32,), 3, "relu"),
                             "_conv64_bwd"),
    "row14-merge64+64-kd3-leaky": (
        lambda r: _conv64_case(r, (64, 64), 3, "leaky"), "_conv64_bwd"),
    "row14-cin64-kd1-relu": (lambda r: _conv64_case(r, (64,), 1, "relu"),
                             "_conv64_bwd"),
    "row15-pool222-relu": (lambda r: _pool_case(r, (2, 2, 2), "relu",
                                                False), "_pool64_bwd_impl"),
    "row18-upconv222-128to64": (_upconv222_case, "_upconv64_bwd"),
    "row21-upconv122-prologue-relu": (lambda r: _upconv122_case(r, "relu"),
                                      "_upconv122_f64_bwd"),
}


def _spy_pallas(monkeypatch, names):
    """Record which of ``names`` is on the stack of each pallas_call."""
    seen = set()
    real = pl.pallas_call

    def spy(*a, **k):
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_name in names:
                seen.add(f.f_code.co_name)
            f = f.f_back
        return real(*a, **k)
    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_backward_matches_jax_kernel(case, monkeypatch):
    """Weights enter both functions in flax layout (the port's op takes
    the torch view), so both gradients come back in one layout."""
    builder, row_fn = BWD_CASES[case]
    rng = np.random.default_rng(17)
    jfn, pfn, args, ct_shapes, wrt = builder(rng)
    cts = [(0.1 * rng.normal(size=shp)).astype(np.float32)
           for shp in ct_shapes]
    seen = _spy_pallas(monkeypatch, {row_fn})
    jout, jg, pout, pg = _grads(jfn, pfn, args, cts, list(wrt))
    assert seen == {row_fn}
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)
