"""The port's ``normalization='batchp'`` against the JAX package's, on the
CPU: rows 29-31 of the kernel table in PERF.md (``ops/pallas_bn.py``,
interpret mode) and the models that run them.

- Op level: ``batch_norm_train`` (y, mean, var, and under ``jax.vjp``
  dx, dgamma, dbeta) and ``batch_norm_inference`` of the JAX package
  against the port's ops, which take their kernels' plain versions
  (K8-K11) on a CPU tensor, at C in {32, 256}, float32 and bfloat16:
  a ragged R (1059 rows, two of the JAX kernels' 1024-row tiles), a large
  mean offset whose variance cancels to a negative value in some
  channels (the clamp; the inputs are exact quarter steps on two rows,
  so both frameworks' sums and statistics are the same bits), and in
  eval a running variance with entries near 0, one negative (no clamp
  there). A spy on ``pallas_call`` shows that JAX reached ``_bn_stats``,
  ``_bn_normalize`` and both ``pallas_call``s of ``_bn_bwd``.
  Tolerance: 1e-4 of each output's scale (at least 1), a bfloat16
  output one unit of its last place besides; where the variance cancels,
  ``x * scale`` and ``shift`` are large and nearly opposite, so the
  rounding of each (8 float32 ulps of their magnitude) is added.
- Model level: the headline structure (n_blocks=4, start_filts=32,
  planar L0) with 'batchp' at input (2, 4, 12, 16, 1), built in the port
  with ``pallas_flat=True`` (L0, L1 and their decoder levels on the
  kernel ops, whose norms take the conv statistics; L2, which declines
  at H=3, L3 and up_0 on the 'batchp' op: 7 norms) and with
  ``pallas_flat=False`` (17 norms on the op), each against JAX's
  ``pallas_flat=False`` executor, in which every norm is
  ``PallasBatchNorm``: the eval forward (2e-4), one training step's loss
  (1e-5 relative), every gradient and every new running statistic
  (1e-3 of each leaf's scale + 1e-6, tests/test_torch_train.py). The
  JAX fused executor's kernel levels are 'batch''s, held against the
  port there; here its tree is used, with ``BatchNorm_<n>`` on the
  kernel levels and ``PallasBatchNorm_<n>`` on the others, for the
  converter, whose round trips through both trees are exact.
- The 2D model of tests/test_pallas_bn.py (n_blocks=2, start_filts=8,
  dim=2, 'batchp' at every level): eval forward and one training step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.ops import pallas_bn as jbn
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.modules import pallas_norm
from elektronn3_tpu_torch.ops import pallas_bn
from test_torch_2d import _jax_step
from test_torch_kernels import _spy_pallas
from test_torch_train import LOSS_RTOL, _assert_trees, _batch, _port_step

TOL = 1e-4
EPS = 1e-5
JAX_ROWS = {"_bn_stats", "_bn_normalize", "_bn_bwd"}
JAX_KERNELS = {"_stats_kernel", "_normalize_kernel", "_bwd_reduce_kernel",
               "_bwd_dx_kernel"}
SHAPE = (2, 4, 12, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batchp")
SHAPE_2D = (2, 16, 16, 1)
KW_2D = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=8,
             dim=2, normalization="batchp")


def _spy_kernels(monkeypatch):
    """The kernel bodies of the ``pallas_call``s made (inside any spy
    already installed)."""
    seen = []
    real = pl.pallas_call

    def spy(kernel, *a, **k):
        seen.append(kernel.__name__)
        return real(kernel, *a, **k)
    monkeypatch.setattr(pl, "pallas_call", spy)
    return seen


def _ulp(a, dtype):
    """One unit of the last place of ``a`` in ``dtype``."""
    bits = 8 if dtype == "bfloat16" else 24
    return np.ldexp(1.0, np.frexp(np.abs(a))[1] - bits)


def _close(port, ref, dtype="float32", extra=0.0):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max())) + extra
    if dtype == "bfloat16":
        bound = bound + _ulp(ref, dtype)
    err = np.abs(port - ref)
    assert np.all(err <= bound), float(err.max())


def _operands(kind, dtype, c, rng):
    """x (float32 values, exact in bf16 for the offset case), gamma,
    beta."""
    gamma = rng.normal(1.0, 0.5, size=c).astype(np.float32)
    beta = rng.normal(0.0, 0.3, size=c).astype(np.float32)
    k = rng.integers(-8, 9, size=(2, c))
    if kind == "ragged":
        x = rng.normal(2.0, 3.0, size=(3, 353, c))
    elif dtype == "float32":
        # Two rows of quarter steps around 1e4: sums of two terms are the
        # same in any order, and q / R - mean^2 cancels to a few ulps of
        # 1e8, below 0 in about a quarter of the channels (clamped to 0).
        x = 1e4 + k / 4.0
    else:
        # Steps of 8 around 1024, exact in bfloat16, whose squares and
        # sums are exact in float32: the offset without a clamp.
        x = 1024.0 + 8.0 * k
    return x.astype(np.float32), gamma, beta


def _clamped(x):
    """Channels whose float32 variance q / R - mean^2 is below 0."""
    x2 = x.reshape(-1, x.shape[-1]).astype(np.float32)
    r = np.float32(x2.shape[0])
    mean = x2.sum(0, dtype=np.float32) / r
    return (x2 * x2).sum(0, dtype=np.float32) / r - mean * mean < 0


@pytest.mark.parametrize("kind", ["ragged", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [32, 256])
def test_batch_norm_train_matches_rows_29_31(c, dtype, kind, monkeypatch):
    """Forward (rows 29/30: y and the statistics) and backward (row 31:
    dx, dgamma, dbeta; the statistics' cotangents are ignored in both)."""
    rng = np.random.default_rng(c + len(kind) + len(dtype))
    x, gamma, beta = _operands(kind, dtype, c, rng)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    gy = jnp.asarray(rng.normal(size=x.shape).astype(np.float32)).astype(jdt)
    names = _spy_pallas(monkeypatch, JAX_ROWS)
    kernels = _spy_kernels(monkeypatch)
    (jy, jmean, jvar), pull = jax.vjp(
        lambda x, g, b: jbn.batch_norm_train(x, g, b, EPS), xj,
        jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = pull((gy, jnp.ones(c), jnp.ones(c)))
    assert names == JAX_ROWS and sorted(kernels) == sorted(JAX_KERNELS)

    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))) \
        .to(getattr(torch, dtype)).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    y, mean, var = pallas_bn.batch_norm_train(xt, gt, bt, EPS)
    assert y.dtype == xt.dtype and not (mean.requires_grad
                                        or var.requires_grad)
    y.backward(torch.tensor(np.asarray(gy.astype(jnp.float32)))
               .to(xt.dtype))
    assert xt.grad.dtype == xt.dtype and gt.grad.dtype == torch.float32

    _close(mean, jmean)
    _close(var, jvar)
    extra_y = extra_dx = 0.0
    if kind == "offset":
        xr = np.asarray(xj.astype(jnp.float32))
        clamped = _clamped(xr)
        assert clamped.any() == (dtype == "float32")
        assert np.all(np.asarray(jvar)[clamped] == 0)
        assert np.all(var.numpy()[clamped] == 0)
        # y = x * scale + shift and dx = a g + b x + c, with x * scale
        # and b x large and nearly cancelled by shift and c.
        inv = 1 / np.sqrt(np.asarray(jvar, np.float64) + EPS)
        g64 = np.asarray(gy.astype(jnp.float32), np.float64)
        dgamma = (g64 * (xr - np.asarray(jmean)) * inv).sum(0)
        b = gamma * inv * inv * dgamma / xr.shape[0]
        extra_y = 8 * _ulp(np.abs(xr * gamma * inv).max(), "float32")
        extra_dx = 8 * _ulp(np.abs(xr * b).max(), "float32")
    _close(y, jy, dtype, extra_y)
    _close(xt.grad, jdx, dtype, extra_dx)
    _close(gt.grad, jdg)
    _close(bt.grad, jdb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [32, 256])
def test_batch_norm_inference_matches_row_30(c, dtype, monkeypatch):
    """Eval from running statistics, one variance entry exactly 0, one
    tiny and one slightly negative: JAX does not clamp it (rsqrt(var +
    eps) of 9e-6, not of 1e-5), and neither does the port."""
    rng = np.random.default_rng(7 + c)
    x, gamma, beta = _operands("ragged", dtype, c, rng)
    mean = rng.normal(2.0, 1.0, size=c).astype(np.float32)
    var = rng.uniform(0.5, 9.0, size=c).astype(np.float32)
    var[:3] = (0.0, 1e-7, -1e-6)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    names = _spy_pallas(monkeypatch, {"_bn_normalize"})
    ref = jbn.batch_norm_inference(xj, *map(jnp.asarray,
                                            (gamma, beta, mean, var)), EPS)
    assert names == {"_bn_normalize"}
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    y = pallas_bn.batch_norm_inference(
        xt, *map(torch.from_numpy, (gamma, beta, mean, var)), EPS)
    assert y.dtype == xt.dtype
    extra = 8 * _ulp(float(np.abs(x * gamma / np.sqrt(var + EPS)).max()),
                     "float32")
    _close(y, ref, dtype, extra)
    clamped = pallas_bn.batch_norm_inference(
        xt, *map(torch.from_numpy, (gamma, beta, mean,
                                    np.maximum(var, 0))), EPS)
    assert not torch.equal(clamped[..., 2], y[..., 2])


@pytest.mark.parametrize("shape,msg", [((4, 12), "multiple of 8"),
                                       ((0, 16), "R >= 1"),
                                       ((4, 4096), "multiple of 8")])
def test_batchp_contract_refuses_what_the_kernels_refuse(shape, msg):
    """Checked on every device, so a CPU call refuses what the card
    does: C % 8, R >= 1, C <= 2048, a contiguous operand."""
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=msg):
        pallas_bn.batch_norm_train(x, torch.ones(shape[1]),
                                   torch.zeros(shape[1]))
    with pytest.raises(ValueError, match="contiguous"):
        pallas_bn.batch_norm_train(torch.zeros(16, 8).t(), torch.ones(8),
                                   torch.zeros(8))


@pytest.mark.parametrize("sms", [132, 16])
def test_reduce_plan_covers_every_row(sms):
    """K8's and K10's plan on a card of ``sms`` SMs (the H100 has 132):
    clusters of 1-8 blocks that cover every row, in whole row groups
    of a block (less than one group a block to spare), one cluster up to SINGLE_CLUSTER_MAX elements, at most
    BLOCKS_PER_SM blocks an SM above, and a function of its arguments
    alone."""
    for r, c in [(1, 8), (37, 32), (10_648, 256), (85_221, 128),
                 (2_725_888, 32), (5_000_000, 2048)]:
        cs, ncl, rpb = pallas_bn.reduce_plan(r, c, sms)
        nblocks = cs * ncl
        rpp = 256 // (c // 8)
        assert cs in (1, 2, 4, 8) and r <= nblocks * rpb < r + nblocks * rpp
        assert rpb % rpp == 0
        assert (ncl == 1) == (r * c <= pallas_bn.SINGLE_CLUSTER_MAX) or \
            pallas_bn.max_clusters(sms) == 1
        assert ncl <= pallas_bn.max_clusters(sms)
        assert nblocks <= max(8, sms * pallas_bn.BLOCKS_PER_SM)
        assert pallas_bn.reduce_plan(r, c, sms) == (cs, ncl, rpb)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

def _seeded_port(seed, **kw):
    """A port model with random conv biases, norm scales of both signs,
    shifted means and variances in [0.5, 1.5]."""
    m = UNet(device="cpu", generator=torch.Generator().manual_seed(seed),
             **kw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif ".norm" in name:
                p.copy_(torch.randn(p.shape, generator=g))
        for name, b in m.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return m


def _jax_tree(model, shape):
    return jax.eval_shape(lambda: junet.init_unet(model, shape))


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _norm_calls(monkeypatch):
    """(R, C) of each call of the 'batchp' op's training forward."""
    calls = []
    real = pallas_norm.batch_norm_train

    def counted(x, *a, **k):
        calls.append((x.numel() // x.shape[-1], x.shape[-1]))
        return real(x, *a, **k)
    monkeypatch.setattr(pallas_norm, "batch_norm_train", counted)
    return calls


def _model_runs(seed, kw, shape, builds):
    rng = np.random.default_rng(seed)
    x, y = _batch(rng, shape)
    m0 = _seeded_port(seed, **kw)
    jm = junet.UNet(pallas_flat=False, **kw)
    v = _as_jax(flax_from_state_dict(m0.state_dict(), _jax_tree(jm, shape)))
    crit = jloss.CEDiceLoss(1.0, 1.0)
    with pytest.MonkeyPatch.context() as mp:
        seen = _spy_pallas(mp, JAX_ROWS)
        jax_step = _jax_step(jm, v, x, y, crit)
        y_jax = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            v, jnp.asarray(x)))
    out = dict(m0=m0, v=v, x=x, jax_step=jax_step, y_jax=y_jax, seen=seen)
    for pf in builds:
        m = UNet(device="cpu", pallas_flat=pf, **kw)
        m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
        with pytest.MonkeyPatch.context() as mp:
            calls = _norm_calls(mp)
            step = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
        m = UNet(device="cpu", pallas_flat=pf, **kw)
        m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
        with torch.no_grad():
            fwd = m.eval()(torch.from_numpy(x)).numpy()
        out[pf] = dict(step=step, calls=calls, fwd=fwd, plan=m.plan(shape))
    return out


@pytest.fixture(scope="module")
def runs():
    return _model_runs(61, KW, SHAPE, (True, False))


def test_jax_batchp_step_reaches_rows_29_31(runs):
    assert runs["seen"] == JAX_ROWS


@pytest.mark.parametrize("pf,plan,calls", [
    (True, [True, True, False, False],
     [(48, 128)] * 2 + [(8, 256)] * 2 + [(48, 128)] * 3),
    (False, [False] * 4,
     [(1536, 32)] * 2 + [(384, 64)] * 2 + [(48, 128)] * 2 + [(8, 256)] * 2
     + [(48, 128)] * 3 + [(384, 64)] * 3 + [(1536, 32)] * 3)],
    ids=["pallas_flat=True", "pallas_flat=False"])
def test_port_batchp_step_runs_the_op_on_library_levels(runs, pf, plan,
                                                        calls):
    """The plan does not depend on the norm; the op runs exactly where a
    level runs the library ops: L2 (declined at H=3), L3 and up_0 on the
    kernel plan, every level without it."""
    assert runs[pf]["plan"] == plan
    assert UNet(device="meta", **dict(KW, normalization="batch")).plan(
        SHAPE) == UNet(device="meta", **KW).plan(SHAPE)
    assert runs[pf]["calls"] == calls


@pytest.mark.parametrize("pf", [True, False],
                         ids=["pallas_flat=True", "pallas_flat=False"])
def test_port_batchp_forward_matches_jax(runs, pf):
    y, ref = runs[pf]["fwd"], runs["y_jax"]
    assert y.shape == ref.shape == SHAPE[:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
@pytest.mark.parametrize("pf", [True, False],
                         ids=["pallas_flat=True", "pallas_flat=False"])
def test_port_batchp_train_step_matches_jax(runs, pf, what):
    """The running statistics meet here: the port's kernel levels update
    with the unclamped variance (``FlatBNStats``), its library levels and
    every JAX norm with the clamped one; they agree wherever the
    variance is not below 0."""
    port, ref = runs[pf]["step"], runs["jax_step"]
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


@pytest.mark.parametrize("pf", [True, False],
                         ids=["pallas_flat=True", "pallas_flat=False"])
def test_converter_round_trip_batchp_is_exact(runs, pf):
    """torch -> the JAX executor's tree -> torch, bit for bit. The fused
    tree is mixed: ``BatchNorm_<n>`` on the kernel levels,
    ``PallasBatchNorm_<n>`` on L2, the bottom L3 and up_0; the XLA tree
    has ``PallasBatchNorm_<n>`` everywhere."""
    m0 = runs["m0"]
    tree = _jax_tree(junet.UNet(pallas_flat=pf, **KW), SHAPE)
    names = {p: sorted(v) for p, v in tree["params"].items()}
    kernel = "BatchNorm" if pf else "PallasBatchNorm"
    for level, kind in (("down_0", kernel), ("up_2", kernel),
                        ("down_2", "PallasBatchNorm"),
                        ("down_3", "PallasBatchNorm"),
                        ("up_0", "PallasBatchNorm")):
        assert f"{kind}_1" in names[level], (level, names[level])
    v = flax_from_state_dict(m0.state_dict(), tree)
    sd = state_dict_from_flax(v, UNet(device="cpu", pallas_flat=pf, **KW))
    ref = m0.state_dict()
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    back = flax_from_state_dict(sd, tree)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, v))


@pytest.fixture(scope="module")
def runs2d():
    return _model_runs(67, KW_2D, SHAPE_2D, ("auto",))


def test_port_batchp_2d_model_matches_jax(runs2d):
    """Every level of the 2D sf=8 model runs the op (C=8 and 16 have no
    fused kernels, in JAX or here): the eval forward, then the step's
    loss, gradients and running statistics."""
    r = runs2d["auto"]
    assert runs2d["seen"] == JAX_ROWS
    assert r["plan"] == [False, False] and len(r["calls"]) == 7
    assert np.max(np.abs(r["fwd"] - runs2d["y_jax"])) <= 2e-4
    port, ref = r["step"], runs2d["jax_step"]
    assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    _assert_trees(port[1], ref[1])
    _assert_trees(port[2], ref[2])
