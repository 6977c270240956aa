"""The port's pool with the level's skip routed through it (K2/K6,
``fused.pool_bnact``, which returns (pooled, skip)) against the JAX package's
``*_skip`` primitives, rows 2/10, 5/15 and 16/17 of the kernel table in
PERF.md: ``flat_fused.pool_bnact_flat_skip`` (C=32, (1, 2, 2)),
``flat_fused64.pool222_bnact_flat64_skip`` (C=64, (2, 2, 2)) and
``flat_fused64.pool122_bnact_flat64_skip`` (C=64, (1, 2, 2)), whose
backward sums the skip's cotangent into dx inside the kernel before its
one rounding (interpret mode). The same numpy-seeded inputs and
cotangents go through ``jax.vjp`` and through ``torch.autograd.grad`` of
the port's op on the CPU, which runs K6's plain version with ``dskip``.

Cases: float32 and bfloat16; relu and leaky; windows with exact ties
(relu zeros under a negative shift, and repeated half-integer values);
and a skip without a cotangent (``dskip`` None in the port, a zero
cotangent in JAX). Tolerances: the pooled output and dx float32 1e-4 of
their scale, bfloat16 one unit in the last place of each value; dinv
and dshift (float32 sums in both) 1e-4 of their scale.

Also: the skip is ``x`` itself (a view, no copy) whose cotangent reaches
the pool's backward, so ``x`` takes one gradient, the sum of both
outputs' rounded once; and the headline UNet's kernel level hands its
decoder that skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import flat_fused as ffu
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.ops import fused
from test_torch_kernels import _vjp

TOL = 1e-4
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lanes(v, cc):
    """(n*cc,) per-channel vector -> (n, 128) lane vectors."""
    return jnp.stack([jnp.tile(v[i * cc:(i + 1) * cc], 128 // cc)
                      for i in range(v.shape[0] // cc)])


def _jax_fn(row, shape, act):
    """JAX's ``*_skip`` primitive of ``row`` on dense NDHWC arguments:
    (pooled, skip)."""
    B, D, H, W, C = shape

    def fn(x, inv, shift):
        if row == "2/10":
            pooled, skip = ffu.pool_bnact_flat_skip(
                fc.to_flat(x), _lanes(inv, 32), _lanes(shift, 32), H, W,
                (0,), act, "dense5")
            return pooled, fc.from_flat(tuple(skip), H, W, padded=True)
        prim = (f64.pool222_bnact_flat64_skip if row == "5/15"
                else f64.pool122_bnact_flat64_skip)
        pooled, skip = prim(f64.to_flat64(x), f64.lane_vec64(inv),
                            f64.lane_vec64(shift), H, W, C, act)
        return pooled, f64.from_flat64(tuple(skip), H, W, C)
    return fn


ROWS = {"2/10": ((2, 2, 4, 8, 32), (1, 2, 2)),
        "5/15": ((2, 4, 4, 6, 64), (2, 2, 2)),
        "16/17": ((2, 1, 4, 6, 64), (1, 2, 2))}
CASES = [(row, dtype, act, tie, skip_ct)
         for row in ROWS for dtype in ("float32", "bfloat16")
         for act, tie, skip_ct in (("relu", False, True),
                                   ("relu", True, True),
                                   ("leaky", False, False))]


def _inputs(rng, shape, dtype, tie):
    """x (values of ``dtype``), inv, shift. ``tie``: half-integer x under
    a positive scale and a negative shift, so windows hold repeated
    maxima and relu zeros (ties at 0)."""
    C = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    inv = rng.normal(size=C).astype(np.float32)
    shift = (0.2 * rng.normal(size=C)).astype(np.float32)
    if tie:
        x = np.round(2 * x) / 2
        inv = np.abs(inv) + 0.5
        shift = np.full_like(shift, -1.0)
    x = np.array(jnp.asarray(x).astype(_JDT[dtype]).astype(jnp.float32))
    return x, inv, shift


def _close(port, ref, dtype):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref)
    scale = max(1.0, float(np.abs(ref).max()))
    if dtype == "bfloat16":
        assert np.all(err <= 2.0 ** -8 * np.abs(ref)), float(err.max())
    else:
        assert float(err.max()) <= TOL * scale, (float(err.max()), scale)


@pytest.mark.parametrize("row,dtype,act,tie,skip_ct", CASES)
def test_plain_pool_skip_matches_jax_skip_primitive(row, dtype, act, tie,
                                                    skip_ct):
    shape, window = ROWS[row]
    rng = np.random.default_rng(
        [list(ROWS).index(row), len(dtype), len(act), tie])
    x, inv, shift = _inputs(rng, shape, dtype, tie)
    pooled = (shape[0], shape[1] // window[0], shape[2] // 2,
              shape[3] // 2, shape[4])
    dp = (0.5 * rng.normal(size=pooled)).astype(np.float32)
    dsk = (0.5 * rng.normal(size=shape)).astype(np.float32)
    if not skip_ct:
        dsk = np.zeros_like(dsk)
    jdt = _JDT[dtype]
    jout, jg = _vjp(_jax_fn(row, shape, act),
                    (jnp.asarray(x).astype(jdt), jnp.asarray(inv),
                     jnp.asarray(shift)),
                    (jnp.asarray(dp).astype(jdt),
                     jnp.asarray(dsk).astype(jdt)))

    tdt = _TDT[dtype]
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tinv = torch.from_numpy(inv).requires_grad_(True)
    tshift = torch.from_numpy(shift).requires_grad_(True)
    p, s = fused.pool_bnact(tx, tinv, tshift, act, window)
    assert s.data_ptr() == tx.data_ptr() and torch.equal(s, tx)
    outs, cts = [p], [torch.from_numpy(dp).to(tdt)]
    if skip_ct:   # else the skip takes no cotangent: K6's dskip is None
        outs.append(s)
        cts.append(torch.from_numpy(dsk).to(tdt))
    pg = torch.autograd.grad(outs, [tx, tinv, tshift], cts)
    _close(p, jout[0], dtype)
    assert pg[0].dtype == tdt
    _close(pg[0], jg[0], dtype)
    for got, ref in zip(pg[1:], jg[1:]):
        _close(got, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_skip_gives_x_one_gradient(dtype):
    """On the CPU the op's plain backward adds the skip's cotangent into
    dx before the one rounding: x's gradient is round(dpre * inv + dskip),
    which the two-consumer graph (the pool and a separate use of x) only
    reaches in float32, where its add is the same float32 add. The skip
    output shares the pool's backward node."""
    rng = np.random.default_rng(5)
    tdt = _TDT[dtype]
    x = torch.from_numpy(rng.normal(size=(2, 2, 4, 6, 32))
                         .astype(np.float32)).to(tdt)
    inv = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    dp = torch.from_numpy(rng.normal(size=(2, 2, 2, 3, 32))
                          .astype(np.float32)).to(tdt)
    dsk = torch.from_numpy(rng.normal(size=(2, 2, 4, 6, 32))
                           .astype(np.float32)).to(tdt)
    xa = x.clone().requires_grad_(True)
    pooled, skip = fused.pool_bnact(xa, inv, shift, "relu", (1, 2, 2))
    assert skip.grad_fn is pooled.grad_fn
    assert "PoolBnAct" in pooled.grad_fn.name()
    (got,) = torch.autograd.grad([pooled, skip], [xa], [dp, dsk])
    dx, _, _ = fused.pool_bnact_bwd_plain(x, inv, shift, "relu", (1, 2, 2),
                                          dp)
    pre_round, _, _ = fused.pool_bnact_bwd_plain(
        x.float(), inv, shift, "relu", (1, 2, 2), dp, dsk)
    assert torch.equal(got, pre_round.to(tdt))
    xb = x.clone().requires_grad_(True)
    p2 = fused.pool_bnact(xb, inv, shift, "relu", (1, 2, 2))[0]
    (two,) = torch.autograd.grad([p2, xb * 1.0], [xb], [dp, dsk])
    assert torch.equal(two, dx + dsk)
    if dtype == "float32":
        assert torch.equal(got, two)


def test_unet_kernel_level_skip_is_the_pools_output():
    """The headline UNet's kernel level (L0 on the CPU's plain path) hands
    its decoder the pool's second output as the skip's raw tensor, so the
    decoder's gradient of it reaches K6's backward."""
    from elektronn3_tpu_torch.models import UNet
    m = UNet(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
             planar_blocks=(0,), device="cpu",
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 8, 8, 1)
    assert m.level_kinds(x.shape)[0] == "kernels"
    _, skip = m.down_convs[0](x, "kernels")
    assert isinstance(skip, fused.FusedActs)
    assert "PoolBnAct" in skip.raw.grad_fn.name()
