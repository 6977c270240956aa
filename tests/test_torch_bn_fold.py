"""The 'batchp' norm's two reductions with their glue, on the CPU: the
plain versions of K8 (``bn_stats_plain``: the sums, then mean, var, inv,
scale and shift, and the running update) and K10
(``bn_bwd_reduce_plain``: the sums, then a, b, c of dx = a g + b x + c,
dgamma and dbeta) against the JAX package's ``ops/pallas_bn.py`` in
interpret mode (``batch_norm_train``'s forward and its ``jax.vjp``) and
its ``PallasBatchNorm`` module's running update.

Cases: C in {32, 256}, float32 and bfloat16, a ragged R (1059 rows, two
of the JAX kernels' 1024-row tiles) and a large mean offset whose float32
variance cancels below 0 in some channels (the clamp; the operands of
tests/test_torch_batchp.py). Tolerances as there: 1e-4 of each output's
scale (at least 1), one unit of the last place of a bfloat16 output, and
where the variance cancels the rounding of the large, nearly opposite
terms of y = x * scale + shift and dx = a g + b x + c; inv against
``rsqrt`` of JAX's variance, the running statistics against the
module's (momentum 0.9 in flax, 0.1 in torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.modules.pallas_norm import PallasBatchNorm as JaxBN
from elektronn3_tpu.ops import pallas_bn as jbn
from elektronn3_tpu_torch.ops import pallas_bn
from test_torch_batchp import EPS, _clamped, _close, _operands, _ulp

CASES = [(c, dtype, kind) for c in (32, 256)
         for dtype in ("float32", "bfloat16") for kind in ("ragged",
                                                           "offset")]


def _inputs(c, dtype, kind):
    rng = np.random.default_rng(3 * c + len(kind) + len(dtype))
    x, gamma, beta = _operands(kind, dtype, c, rng)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    gy = jnp.asarray(rng.normal(size=x.shape).astype(np.float32)).astype(
        jnp.dtype(dtype))
    ra_mean = rng.normal(0.5, 1.0, size=c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    gt = torch.tensor(np.asarray(gy.astype(jnp.float32))).to(xt.dtype)
    return xj, gy, gamma, beta, ra_mean, ra_var, xt, gt


def _extras(xj, gy, gamma, jmean, jvar, kind):
    """The rounding of y's and dx's large, nearly cancelling terms where
    the variance cancels (test_torch_batchp.py)."""
    if kind != "offset":
        return 0.0, 0.0
    xr = np.asarray(xj.astype(jnp.float32))
    inv = 1 / np.sqrt(np.asarray(jvar, np.float64) + EPS)
    g64 = np.asarray(gy.astype(jnp.float32), np.float64)
    dgamma = (g64 * (xr - np.asarray(jmean)) * inv).sum(0)
    b = gamma * inv * inv * dgamma / xr.shape[0]
    return (8 * _ulp(np.abs(xr * gamma * inv).max(), "float32"),
            8 * _ulp(np.abs(xr * b).max(), "float32"))


@pytest.mark.parametrize("c,dtype,kind", CASES)
def test_bn_stats_plain_matches_jax_forward_and_running_update(c, dtype,
                                                               kind):
    """K8's plain version: mean and the clamped var as JAX's
    ``batch_norm_train`` returns them, inv = rsqrt(var + eps), y from its
    scale and shift (K9's plain version) as JAX's y, and the running
    buffers as ``PallasBatchNorm`` updates them."""
    xj, gy, gamma, beta, ra_mean, ra_var, xt, _ = _inputs(c, dtype, kind)
    module = JaxBN(use_running_average=False, epsilon=EPS)
    variables = {"params": {"scale": jnp.asarray(gamma),
                            "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}
    jy, state = module.apply(variables, xj, mutable=["batch_stats"])
    _, jmean, jvar = jbn.batch_norm_train(xj, jnp.asarray(gamma),
                                          jnp.asarray(beta), EPS)

    x2d = xt.reshape(-1, c)
    running = (torch.from_numpy(ra_mean.copy()),
               torch.from_numpy(ra_var.copy()), 0.1)
    st = pallas_bn.bn_stats_plain(x2d, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), EPS, running)
    assert st.shape == (5, c) and st.dtype == torch.float32
    y = pallas_bn.bn_normalize_plain(x2d, st[3], st[4]).view(xt.shape)
    _close(st[0], jmean)
    _close(st[1], jvar)
    _close(st[2], jax.lax.rsqrt(jvar + EPS))
    if kind == "offset":
        clamped = _clamped(np.asarray(xj.astype(jnp.float32)))
        assert clamped.any() == (dtype == "float32")
        assert np.all(st[1].numpy()[clamped] == 0)
    _close(y, jy, dtype, _extras(xj, gy, gamma, jmean, jvar, kind)[0])
    _close(running[0], state["batch_stats"]["mean"])
    _close(running[1], state["batch_stats"]["var"])


@pytest.mark.parametrize("c,dtype,kind", CASES)
def test_bn_bwd_reduce_plain_matches_jax_vjp(c, dtype, kind):
    """K10's plain version from K8's mean and var: dgamma and dbeta as
    JAX's ``jax.vjp`` of ``batch_norm_train`` gives them, and dx from its
    a, b, c (K11's plain version) as JAX's dx."""
    xj, gy, gamma, beta, _, _, xt, gt = _inputs(c, dtype, kind)
    (_, jmean, jvar), pull = jax.vjp(
        lambda x, g, b: jbn.batch_norm_train(x, g, b, EPS), xj,
        jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = pull((gy, jnp.ones(c), jnp.ones(c)))

    x2d, g2d = xt.reshape(-1, c), gt.reshape(-1, c)
    gamma_t = torch.from_numpy(gamma)
    st = pallas_bn.bn_stats_plain(x2d, gamma_t, torch.from_numpy(beta), EPS)
    f = pallas_bn.bn_bwd_reduce_plain(g2d, x2d, st[0], st[1], gamma_t, EPS)
    assert f.shape == (5, c) and f.dtype == torch.float32
    dx = pallas_bn.bn_bwd_dx_plain(g2d, x2d, f[0], f[1], f[2])
    assert dx.dtype == xt.dtype
    _close(dx.view(xt.shape), jdx, dtype,
           _extras(xj, gy, gamma, jmean, jvar, kind)[1])
    _close(f[3], jdg)
    _close(f[4], jdb)
