"""The port's fused ops (elektronn3_tpu_torch.ops.fused) against the JAX
package's Pallas kernels they replace, rows 1 to 7 of the port's kernel
table: the same numpy-seeded inputs go through the JAX op (interpret
mode on the CPU, converted with the flat-layout helpers) and through
the port's op, which takes its plain PyTorch version on a CPU tensor.
float32 throughout; tolerance 1e-4 of the output's scale.

tests/test_torch_cuda.py holds each CUDA kernel against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    port = fused.pool_bnact(_t(x), _t(inv), _t(shift), act, (1, 2, 2))
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
    port = fused.pool_bnact(_t(x), _t(inv), _t(shift), act, (2, 2, 2))
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
    y = fused.pool_bnact(x, torch.full((8,), -1.0), torch.zeros(8),
                         "linear", (1, 2, 2))
    windows = x.reshape(1, 2, 2, 2, 2, 2, 8)      # (N, D, Ho, 2, Wo, 2, C)
    assert torch.equal(y, -windows.amin(dim=(3, 5)))
