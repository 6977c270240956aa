"""The port's semi-fused flat executor ops against the JAX package's, on
the CPU: rows 26/27 (``flat_conv3`` and its ``_wgrad``), row 28
(``conv_direct``), ``pool_flat``'s tie rule, ``FlatBatchNorm`` and the
'gelu' activation.

- Rows 26/27: the port's ``ops/flat_conv.flat_conv3`` (K1 with the
  identity prologue; its plain version on a CPU tensor) against JAX's
  ``flat_conv3`` in interpret mode, forward and ``jax.vjp`` (dx, dW,
  db). JAX's inputs go through ``to_flat`` and its output comes back
  through ``from_flat``, so both take and return NDHWC; the weight and
  bias are float32 parameters that both round to the model dtype, as
  ``_FlatConv`` does.
- Row 28: ``ops/pallas_conv.conv_direct`` against JAX's ``conv_direct``
  (interpret mode), planar and not.
- ``pool_flat``: windows with forced bf16 ties, whose gradient both
  split evenly among the tied elements at each of the two stages.
- ``flat_batch_norm`` against ``FlatBatchNorm`` (training, forward and
  ``jax.vjp``; eval), and ``get_activation('gelu')`` against
  ``jax.nn.gelu`` and the JAX package's 'gelu' (the tanh form).

Tolerances: float32 1e-4 of the scale (``TOL`` of
tests/test_torch_kernels.py); bfloat16 1e-2 of max|ref| plus one bf16
ulp of each value (``chip_smoke.py`` ``check_close``): the two sum in
other orders before the one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.modules import flat_norm as jflat_norm
from elektronn3_tpu.modules import layers as jlayers
from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import pallas_conv as jpc
from elektronn3_tpu_torch.models.convert import conv_weight_from_flax
from elektronn3_tpu_torch.modules.flat_norm import flat_batch_norm
from elektronn3_tpu_torch.modules.layers import get_activation
from elektronn3_tpu_torch.ops import flat_conv, pallas_conv
from test_torch_kernels import TOL, _spy_pallas, _vjp

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(port, ref, dtype):
    """float32: within TOL of max(1, max|ref|); bf16: 1e-2 max|ref| plus
    one bf16 ulp of each reference value."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref)
    scale = float(np.max(np.abs(ref)))
    if dtype == "bfloat16":
        _, e = np.frexp(ref)
        bound = 1e-2 * scale + np.ldexp(1.0, e - 8)
    else:
        bound = TOL * max(1.0, scale)
    assert np.all(err <= bound), (float(err.max()), scale)


def _rounded(a, dtype):
    """A float32 numpy array of values representable in ``dtype``."""
    return np.asarray(jnp.asarray(a).astype(_JDT[dtype]).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Rows 26/27: flat_conv3 and its backward
# ---------------------------------------------------------------------------

# (kd, input channels, C_out, dtype, (B, D, H, W)): each case at its own
# shape, so that JAX traces (and the spy sees) its kernels anew.
FLAT_CASES = [
    (1, (32,), 32, "float32", (2, 2, 6, 8)),
    (1, (32, 32), 32, "bfloat16", (1, 3, 6, 10)),
    (3, (32,), 64, "float32", (1, 3, 4, 8)),
    (1, (64, 64), 64, "bfloat16", (1, 2, 4, 10)),
    (3, (32, 32), 32, "bfloat16", (1, 4, 6, 6)),
]


@pytest.mark.parametrize("kd,cins,cout,dtype,shape", FLAT_CASES)
def test_flat_conv3_plain_matches_rows_26_27(kd, cins, cout, dtype, shape,
                                             monkeypatch):
    """Forward, then ``jax.vjp`` against the port's autograd (K4's and
    K5's plain versions): dx of each input, dW and db."""
    rng = np.random.default_rng(61 + kd + sum(cins) + cout)
    B, D, H, W = shape
    cin = sum(cins)
    x = _rounded(rng.normal(size=(B, D, H, W, cin)), dtype)
    w = (0.1 * rng.normal(size=(kd, 3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    dy = _rounded(0.1 * rng.normal(size=(B, D, H, W, cout)), dtype)
    jdt = _JDT[dtype]

    def jfn(x, w, b):
        ys = fc.flat_conv3(fc.to_flat(x, kd), w.astype(jdt), b.astype(jdt),
                           kd, H, W)
        return fc.from_flat(ys, H, W, padded=True)

    seen = _spy_pallas(monkeypatch, {"conv_flat", "_wgrad"})
    jy, (jdx, jdw, jdb) = _vjp(jfn, (jnp.asarray(x, jdt), jnp.asarray(w),
                                     jnp.asarray(b)), jnp.asarray(dy, jdt))
    assert seen == {"conv_flat", "_wgrad"}
    assert jy.dtype == jdt

    bounds = np.cumsum((0,) + cins)
    xs = [torch.tensor(x[..., lo:hi], dtype=_TDT[dtype], requires_grad=True)
          for lo, hi in zip(bounds[:-1], bounds[1:])]
    tw = torch.tensor(conv_weight_from_flax(w), requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    py = flat_conv.flat_conv3(xs, tw, tb)
    assert py.dtype == _TDT[dtype]
    py.backward(torch.tensor(dy, dtype=_TDT[dtype]))
    _assert_close(py, jy, dtype)
    _assert_close(torch.cat([t.grad for t in xs], -1), jdx, dtype)
    _assert_close(tw.grad.permute(2, 3, 4, 1, 0), jdw, dtype)
    _assert_close(tb.grad, jdb, dtype)


def test_flat_conv3_statistics_are_those_of_the_stored_output():
    """``want_stats`` returns the per-channel float32 sum and sum of
    squares of the stored, dtype-rounded output (what JAX's
    ``FlatBatchNorm`` reduces)."""
    rng = np.random.default_rng(67)
    x = torch.tensor(rng.normal(size=(2, 2, 4, 6, 32)),
                     dtype=torch.bfloat16)
    w = torch.tensor(0.1 * rng.normal(size=(32, 32, 1, 3, 3)),
                     dtype=torch.float32)
    b = torch.tensor(rng.normal(size=32), dtype=torch.float32)
    y, s, q = flat_conv.flat_conv3([x], w, b, want_stats=True)
    yf = y.float()
    assert torch.allclose(s, yf.sum((0, 1, 2, 3)), rtol=1e-6, atol=1e-4)
    assert torch.allclose(q, (yf * yf).sum((0, 1, 2, 3)), rtol=1e-6,
                          atol=1e-4)
    assert torch.equal(y, flat_conv.flat_conv3([x], w, b))


# ---------------------------------------------------------------------------
# Row 28: conv_direct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planar,dtype,cin,cout", [
    (True, "float32", 32, 32), (True, "bfloat16", 64, 32),
    (False, "float32", 64, 64), (False, "bfloat16", 128, 64)])
def test_conv_direct_plain_matches_row_28(planar, dtype, cin, cout,
                                          monkeypatch):
    rng = np.random.default_rng(71 + cin + cout + planar)
    kd = 1 if planar else 3
    x = _rounded(rng.normal(size=(1, 4, 8, 12, cin)), dtype)
    w = (0.1 * rng.normal(size=(kd, 3, 3, cin, cout))).astype(np.float32)
    seen = _spy_pallas(monkeypatch, {"conv_direct"})
    ref = jpc.conv_direct(jnp.asarray(x, _JDT[dtype]), jnp.asarray(w),
                          planar=planar)
    assert seen == {"conv_direct"}
    got = pallas_conv.conv_direct(torch.tensor(x, dtype=_TDT[dtype]),
                                  torch.tensor(conv_weight_from_flax(w)),
                                  planar)
    assert got.dtype == _TDT[dtype] and ref.dtype == _JDT[dtype]
    _assert_close(got, ref, dtype)


def test_conv_direct_refuses_a_weight_of_the_other_depth():
    x = torch.zeros(1, 2, 4, 4, 32)
    with pytest.raises(ValueError, match="planar"):
        pallas_conv.conv_direct(x, torch.zeros(32, 32, 3, 3, 3), True)


# ---------------------------------------------------------------------------
# pool_flat and its tie rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pool_flat_splits_ties_as_jax(dtype):
    """Values on a grid of 0.5 make most 2x2 windows hold ties; both
    gradients split each tie evenly at the w stage and again at the h
    stage (bit for bit: halving is exact), unlike torch's index-based
    pool, which routes it to one element."""
    rng = np.random.default_rng(73)
    B, D, H, W, C = 2, 2, 6, 8, 64
    x = np.round(2 * rng.normal(size=(B, D, H, W, C))).astype(np.float32) / 2
    dp = _rounded(rng.normal(size=(B, D, H // 2, W // 2, C)), dtype)
    jdt = _JDT[dtype]
    jy, (jdx,) = _vjp(lambda v: fc.pool_flat(fc.to_flat(v), H, W),
                      (jnp.asarray(x, jdt),), jnp.asarray(dp, jdt))
    tx = torch.tensor(x, dtype=_TDT[dtype], requires_grad=True)
    py = flat_conv.pool_flat(tx)
    py.backward(torch.tensor(dp, dtype=_TDT[dtype]))
    assert np.array_equal(_np(py), _np(jy))
    assert np.array_equal(_np(tx.grad), _np(jdx))
    win = torch.tensor(x).view(B, D, H // 2, 2, W // 2, 2, C)
    ties = (win == win.amax((3, 5), keepdim=True)).sum((3, 5)) > 1
    assert int(ties.sum()) > 100
    tm = torch.tensor(x, requires_grad=True)
    torch.nn.functional.max_pool3d(
        tm.permute(0, 4, 1, 2, 3), (1, 2, 2)).permute(0, 2, 3, 4, 1) \
        .backward(torch.tensor(dp))
    assert not np.array_equal(tm.grad.numpy(), _np(jdx))


def test_pool_flat_refuses_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        flat_conv.pool_flat(torch.zeros(1, 1, 5, 4, 32))


# ---------------------------------------------------------------------------
# FlatBatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_batch_norm_matches_jax(dtype):
    """Training: output, the input's and the affine parameters'
    gradients (through the statistics too) and the new running
    statistics (unclamped variance); eval on the running statistics. A
    large mean makes the variance the difference of large sums."""
    rng = np.random.default_rng(79)
    B, D, H, W, C = 2, 2, 4, 6, 64
    x = _rounded(3.0 + rng.normal(size=(B, D, H, W, C)), dtype)
    scale = rng.normal(size=C).astype(np.float32)
    bias = (0.2 * rng.normal(size=C)).astype(np.float32)
    mean0 = (0.2 * rng.normal(size=C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=C).astype(np.float32)
    dy = _rounded(rng.normal(size=x.shape), dtype)
    jdt = _JDT[dtype]
    mod = jflat_norm.FlatBatchNorm()
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def jfn(x, scale, bias, train):
        y, mut = mod.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": stats}, fc.to_flat(x), H=H, W=W,
            use_running_average=not train, mutable=["batch_stats"])
        return fc.from_flat(y, H, W, padded=True), mut["batch_stats"]

    (jy, jbs), pull = jax.vjp(lambda *a: jfn(*a, True), jnp.asarray(x, jdt),
                              jnp.asarray(scale), jnp.asarray(bias))
    jg = pull((jnp.asarray(dy, jdt),
               jax.tree_util.tree_map(jnp.zeros_like, jbs)))
    jeval = jfn(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                False)[0]

    norm = torch.nn.BatchNorm3d(C, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor(scale))
        norm.bias.copy_(torch.tensor(bias))
        norm.running_mean.copy_(torch.tensor(mean0))
        norm.running_var.copy_(torch.tensor(var0))
    tx = torch.tensor(x, dtype=_TDT[dtype], requires_grad=True)
    py = flat_batch_norm(norm, tx)
    py.backward(torch.tensor(dy, dtype=_TDT[dtype]))
    _assert_close(py, jy, dtype)
    _assert_close(tx.grad, jg[0], dtype)
    _assert_close(norm.weight.grad, jg[1], "float32" if dtype == "float32"
                  else dtype)
    _assert_close(norm.bias.grad, jg[2], dtype)
    _assert_close(norm.running_mean, jbs["mean"], "float32")
    _assert_close(norm.running_var, jbs["var"], "float32")
    norm.eval()
    with torch.no_grad():
        norm.running_mean.copy_(torch.tensor(mean0))
        norm.running_var.copy_(torch.tensor(var0))
        _assert_close(flat_batch_norm(norm, tx), jeval, dtype)


# ---------------------------------------------------------------------------
# 'gelu'
# ---------------------------------------------------------------------------

def test_gelu_is_jax_tanh_form():
    """The port's 'gelu' is ``jax.nn.gelu`` (approximate=True), which is
    what the JAX package's 'gelu' (flax ``nn.gelu``) computes; the exact
    erf form differs from it by up to about 4.7e-4."""
    x = np.linspace(-6.0, 6.0, 4801).astype(np.float32)
    got = get_activation("gelu")(torch.from_numpy(x)).numpy()
    for ref in (jax.nn.gelu(jnp.asarray(x)),
                jlayers.get_activation("gelu")(jnp.asarray(x))):
        assert np.max(np.abs(got - np.asarray(ref))) <= 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(exact - got)) > 1e-4
