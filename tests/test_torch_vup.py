"""The port's vup path (elektronn3_tpu_torch.ops.vup and ``UNet(vup=
True)``) against the JAX package's, on the CPU in float32: rows 1 (its
vup mode), 9, 22 and 23 of the kernel table in PERF.md.

- The ops: the vup merge conv (``conv_bnact_flat_vup``, with and
  without statistics) and the statistics pass
  (``upconv122_stats_from_flat64``) against the port's plain versions
  on the same numpy-seeded inputs, at ``test_flat_vup.py``'s size
  (B, D, H, W) = (2, 3, 8, 8) and at H / 2 odd (JAX asserts an even
  W / 2); then ``jax.vjp`` of both against ``torch.autograd`` in every
  input (carry, invc, shiftc, wu, bu, skip, inv, shift, w, b), which
  reaches ``_conv_vup_bwd`` and ``_upconv122_stats_bwd``. Tolerance
  1e-4 of each output's or gradient's scale (tests/test_torch_kernels.py).
- The port's vup forward is bitwise its materializing plain path (JAX
  holds itself to the same, ``test_vup_forward_bitwise``), also at
  W / 2 odd, where JAX's op cannot run, and in bfloat16; its gradients
  match the materializing path's within 1e-4 of scale in float32.
- The headline structure at ``ROW24_SHAPE`` with ``vup=True`` against
  JAX's ``pallas_flat=True`` under ``E3TPU_VUP=1`` (eval forward, 2e-4)
  and one training step against JAX's jitted XLA step (loss 1e-5 relative,
  every gradient and new running statistic at LEAF_TOL, as
  tests/test_torch_train.py), the port's step calling the vup ops once
  each and no upconv at L0; ``vup=True`` against ``vup=False`` (3D and
  2D), ``level_kinds`` and the converter unchanged, ``vup='auto'`` and
  a merge conv without a skip raising ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.models.torch_import import load_torch_state_dict
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.ops import flat_conv as fc
from elektronn3_tpu.ops import flat_fused as ffu
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused, vup
from test_torch_2d import _jax_step
from test_torch_headline_rows import ROW24_SHAPE, _jax_forward
from test_torch_kernels import (_bn, _close, _fold32, _grads, _lanes,
                                _spy_pallas, _t)
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,
                              _port_model, _port_step, _randomize)

KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
# (B, D, H, W): test_flat_vup.py's size, and H / 2 odd.
SHAPES = [(2, 3, 8, 8), (2, 3, 6, 8)]
VUP_FWD, VUP_BWD = "conv_bnact_flat_vup", "_conv_vup_bwd"
STATS_FWD, STATS_BWD = "upconv122_stats_from_flat64", "_upconv122_stats_bwd"
NAMES = ["carry", "invc", "shiftc", "wu", "bu", "skip", "inv", "shift", "w",
         "b"]


def _args(rng, shape):
    """Dense NDHWC arguments, weights in flax layout: the C=64 carry at
    (H/2, W/2), its prologue, the (1, 2, 2) upconv 64->32, the C=32
    skip, the merge prologue (upconv slot first) and the 64->32 merge
    conv."""
    B, D, H, W = shape
    carry = rng.normal(size=(B, D, H // 2, W // 2, 64)).astype(np.float32)
    invc, shiftc = _bn(rng, 64)
    wu = (0.2 * rng.normal(size=(1, 2, 2, 64, 32))).astype(np.float32)
    bu = (0.1 * rng.normal(size=32)).astype(np.float32)
    skip = rng.normal(size=(B, D, H, W, 32)).astype(np.float32)
    inv, shift = _bn(rng, 64)
    w = (0.1 * rng.normal(size=(1, 3, 3, 64, 32))).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    return [carry, invc, shiftc, wu, bu, skip, inv, shift, w, b]


def _pwu(wu):
    """flax (1, 2, 2, C_c, C_u) ConvTranspose kernel -> torch layout."""
    return wu.flip(0, 1, 2).permute(3, 4, 0, 1, 2)


def _vup_fns(shape, want_stats, act="relu"):
    _, _, H, W = shape

    def jfn(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b):
        (chunk,) = f64.to_flat64(carry)
        ys, st = ffu.conv_bnact_flat_vup(
            chunk, f64.lane_vec64(invc), f64.lane_vec64(shiftc), wu, bu,
            fc.to_flat(skip), _lanes(inv, 32), _lanes(shift, 32), w, b, H, W,
            (0, 0), want_stats, act, act)
        y = fc.from_flat(ys, H, W, padded=True)
        return (y, _fold32(st[0]), _fold32(st[1])) if want_stats else (y,)

    def pfn(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b):
        out = vup.conv_vup(carry, invc, shiftc, _pwu(wu), bu, skip, inv,
                           shift, w.permute(4, 3, 0, 1, 2), b, act, act,
                           want_stats=want_stats)
        return out if want_stats else (out,)
    return jfn, pfn


def _stats_fns(shape, act="relu"):
    _, _, H, W = shape

    def jfn(carry, invc, shiftc, wu, bu):
        (chunk,) = f64.to_flat64(carry)
        s, q = f64.upconv122_stats_from_flat64(
            chunk, f64.lane_vec64(invc), f64.lane_vec64(shiftc), wu, bu, H,
            W, True, act)
        return _fold32(s), _fold32(q)

    def pfn(carry, invc, shiftc, wu, bu):
        return vup.upconv_stats(carry, invc, shiftc, _pwu(wu), bu, act)
    return jfn, pfn


# ---------------------------------------------------------------------------
# The ops against JAX's Pallas ops (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("want_stats", [False, True])
def test_vup_forward_matches_jax(shape, want_stats, monkeypatch):
    args = _args(np.random.default_rng(81), shape)
    jfn, pfn = _vup_fns(shape, want_stats)
    seen = _spy_pallas(monkeypatch, {VUP_FWD})
    ref = jfn(*[jnp.asarray(a) for a in args])
    assert seen == {VUP_FWD}
    port = pfn(*[_t(a) for a in args])
    assert len(port) == len(ref) == (3 if want_stats else 1)
    for p, j in zip(port, ref):
        _close(p, j)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_upconv_stats_matches_jax(shape, monkeypatch):
    args = _args(np.random.default_rng(82), shape)[:5]
    jfn, pfn = _stats_fns(shape)
    seen = _spy_pallas(monkeypatch, {STATS_FWD})
    ref = jfn(*[jnp.asarray(a) for a in args])
    assert seen == {STATS_FWD}
    for p, j in zip(pfn(*[_t(a) for a in args]), ref):
        _close(p, j)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_vup_backward_matches_jax(shape, monkeypatch):
    """Every input's gradient, the statistics cotangents nonzero: JAX's
    ``_conv_vup_bwd`` against the port's plain row-9 chain."""
    rng = np.random.default_rng(83)
    args = _args(rng, shape)
    jfn, pfn = _vup_fns(shape, True)
    B, D, H, W = shape
    ct_shapes = [(B, D, H, W, 32), (32,), (32,)]
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32) for s in ct_shapes]
    seen = _spy_pallas(monkeypatch, {VUP_FWD, VUP_BWD})
    jout, jg, pout, pg = _grads(jfn, pfn, args, cts, list(range(10)))
    assert seen == {VUP_FWD, VUP_BWD}
    for p, j in zip(pout, jout):
        _close(p, j)
    for name, p, j in zip(NAMES, pg, jg):
        assert p.shape == j.shape, name
        _close(p, j)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_upconv_stats_backward_matches_jax(shape, monkeypatch):
    """Row 23: ``_upconv122_stats_bwd`` against the port's plain chain
    on ``ds + 2 y dq``, every input's gradient."""
    rng = np.random.default_rng(84)
    args = _args(rng, shape)[:5]
    jfn, pfn = _stats_fns(shape)
    cts = [(0.1 * rng.normal(size=32)).astype(np.float32),
           (0.01 * rng.normal(size=32)).astype(np.float32)]
    seen = _spy_pallas(monkeypatch, {STATS_FWD, STATS_BWD})
    jout, jg, pout, pg = _grads(jfn, pfn, args, cts, list(range(5)))
    assert seen == {STATS_FWD, STATS_BWD}
    for p, j in zip(pout, jout):
        _close(p, j)
    for name, p, j in zip(NAMES, pg, jg):
        assert p.shape == j.shape, name
        _close(p, j)


# ---------------------------------------------------------------------------
# The vup path against the port's materializing path
# ---------------------------------------------------------------------------

def _materializing(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b,
                   act="relu"):
    u, s_u, q_u = fused.upconv_bnact(carry, invc, shiftc, wu, bu, act,
                                     want_stats=True)
    return fused.conv_bnact([u, skip], inv, shift, w, b, act,
                            want_stats=True) + (s_u, q_u)


def _vup_path(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b,
              act="relu"):
    s_u, q_u = vup.upconv_stats(carry, invc, shiftc, wu, bu, act)
    return vup.conv_vup(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b,
                        act, act, want_stats=True) + (s_u, q_u)


def _torch_args(shape, dtype=torch.float32, seed=85):
    args = _args(np.random.default_rng(seed), shape)
    out = [_t(a) for a in args]
    out[3] = _pwu(out[3]).contiguous()
    out[8] = out[8].permute(4, 3, 0, 1, 2).contiguous()
    for i in (0, 5):
        out[i] = out[i].to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", SHAPES + [(2, 3, 8, 6), (1, 2, 10, 14)],
                         ids=str)
def test_vup_forward_bitwise_materializing(shape, dtype):
    """The merge output, its statistics and the upconv statistics, bit
    for bit; (2, 3, 8, 6) and (1, 2, 10, 14) have W / 2 odd, which
    JAX's vup asserts against."""
    args = _torch_args(shape, dtype)
    for got, want in zip(_vup_path(*args), _materializing(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (2, 3, 8, 6)], ids=str)
def test_vup_backward_matches_materializing(shape):
    """float32: the same function, so every gradient within 1e-4 of its
    scale (the chain rounds nothing in float32; only the order of sums
    differs)."""
    args = _torch_args(shape)
    for a in args:
        a.requires_grad_(True)
    rng = np.random.default_rng(86)
    B, D, H, W = shape
    cts = [_t(0.1 * rng.normal(size=s)) for s in
           [(B, D, H, W, 32), (32,), (32,), (32,), (32,)]]
    g_v = torch.autograd.grad(_vup_path(*args), args, cts)
    g_m = torch.autograd.grad(_materializing(*args), args, cts)
    for name, a, b in zip(NAMES, g_v, g_m):
        _close(a, b.detach().numpy())


def test_vup_contract_raises():
    carry, invc, shiftc, wu, bu, skip, inv, shift, w, b = _torch_args(
        (1, 2, 8, 8))
    with pytest.raises(ValueError, match="skip"):
        vup.conv_vup(carry, invc, shiftc, wu, bu, None, inv, shift, w, b,
                     "relu", "relu")
    with pytest.raises(ValueError, match="skip"):
        vup.conv_vup(carry, invc, shiftc, wu, bu, skip[:, :, :6], inv,
                     shift, w, b, "relu", "relu")
    with pytest.raises(ValueError, match="upconv weight"):
        vup.upconv_stats(carry[..., :48], invc[:48], shiftc[:48],
                         wu[:48], bu, "relu")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_run():
    """Variables, a batch, JAX's XLA step and both JAX eval forwards
    (``pallas_flat=True`` under ``E3TPU_VUP=1``, the spy recording the
    vup functions it reaches), and the port's ``vup=True`` eval forward
    and step (the vup ops' and upconv's calls recorded)."""
    rng = np.random.default_rng(87)
    x, y = _batch(rng, ROW24_SHAPE)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    v = _randomize(junet.init_unet(m_xla, ROW24_SHAPE), rng)
    out = dict(v=v, x=x, y=y,
               xla=_jax_step(m_xla, v, x, y, jloss.CEDiceLoss(1.0, 1.0)),
               y_xla=_jax_forward(False, v, x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("E3TPU_VUP", "1")
        out["seen"] = _spy_pallas(mp, {VUP_FWD, "upconv122_from_flat64"})
        out["y_fused"] = _jax_forward(True, v, x)
    m = _port_model(v, pallas_flat=True, vup=True, **KW)
    with torch.no_grad():
        out["y_port"] = m.eval()(torch.from_numpy(x)).numpy()
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((vup, "conv_vup"), (vup, "upconv_stats"),
                          (fused, "upconv_bnact")):
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls.append((_name, tuple(a[0].shape)))
                return _fn(*a, **k)
            mp.setattr(mod, name, counted)
        out["port"] = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
    out["calls"] = sorted(calls)
    out["kinds"] = m.level_kinds(ROW24_SHAPE)
    return out


def test_jax_vup_forward_reaches_the_vup_conv(model_run):
    """Under E3TPU_VUP=1 JAX's up_2 runs the vup merge conv and no
    materializing upconv of the C=64 carry."""
    assert model_run["seen"] == {VUP_FWD}


@pytest.mark.parametrize("executor", ["pallas_flat=True E3TPU_VUP=1",
                                      "pallas_flat=False"])
def test_port_vup_forward_matches_jax(model_run, executor):
    ref = model_run["y_fused" if executor.startswith("pallas_flat=True")
                    else "y_xla"]
    y = model_run["y_port"]
    assert y.shape == ref.shape == ROW24_SHAPE[:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_vup_train_step_matches_jax(model_run, what):
    port, ref = model_run["port"], model_run["xla"]
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


def test_port_vup_step_runs_the_vup_ops(model_run):
    """One statistics pass and one vup merge conv on the carried C=64
    activation (2, 4, 8, 8, 64); the upconvs of up_0 (dense L3) and
    up_1 (the carried C=128 activation) as before; no upconv into L0.
    The level kinds are those of ``vup=False``."""
    assert model_run["calls"] == sorted([
        ("conv_vup", (2, 4, 8, 8, 64)), ("upconv_stats", (2, 4, 8, 8, 64)),
        ("upconv_bnact", (2, 1, 2, 2, 256)),
        ("upconv_bnact", (2, 2, 4, 4, 128))])
    m = UNet(device="meta", pallas_flat=True, **KW)
    assert model_run["kinds"] == m.level_kinds(ROW24_SHAPE) == \
        ["kernels", "kernels", "kernels", "library"]


def _step(m, x, t):
    m.train()
    m.zero_grad()
    y = m(x)
    loss = ploss.CEDiceLoss(1.0, 1.0)(y, t)
    loss.backward()
    return y.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


@pytest.mark.parametrize("kw,shape", [
    (KW, (2, 4, 16, 24, 1)),
    (dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32, dim=2,
          normalization="batch"), (2, 24, 40, 1))], ids=["3d", "2d"])
def test_vup_true_matches_vup_false(kw, shape):
    """The same model with ``vup`` on and off: the training forward, the
    new running statistics and the eval forward bit for bit; every
    gradient within 1e-4 of its scale (float32, biases before a batch
    norm aside: their exact gradient is 0, and both paths compute
    rounding noise); the same parameters and level kinds."""
    rng = np.random.default_rng(88)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 2, size=shape[:-1])).long()
    runs = []
    for on in (False, True):
        m = UNet(device="cpu", pallas_flat=True, vup=on,
                 generator=torch.Generator().manual_seed(3), **kw)
        y, g = _step(m, x, t)
        with torch.no_grad():
            e = m.eval()(x)
        runs.append((m, y, g, e))
    (m0, y0, g0, e0), (m1, y1, g1, e1) = runs
    assert m1.vup and not m0.vup
    assert m0.level_kinds(shape) == m1.level_kinds(shape)
    assert torch.equal(y0, y1) and torch.equal(e0, e1)
    b0, b1 = m0.state_dict(), m1.state_dict()
    assert b0.keys() == b1.keys()
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    for n in g0:
        if n.endswith(".bias") and "conv_final" not in n and "norm" not in n:
            continue
        _close(g1[n], g0[n].numpy())


def test_vup_flag_is_a_bool():
    """JAX's ``E3TPU_VUP=auto`` turns the path on; the port takes only
    True or False."""
    for bad in ("auto", "1", 1, None):
        with pytest.raises(ValueError, match="vup"):
            UNet(device="meta", vup=bad, **KW)


def test_converter_round_trip_with_vup(model_run):
    """``vup`` adds no parameter: the flax tree goes through the vup
    model's state_dict and back unchanged."""
    v = jax.device_get(model_run["v"])
    m = UNet(device="cpu", pallas_flat=True, vup=True, **KW)
    back = load_torch_state_dict(state_dict_from_flax(v, m),
                                 junet.UNet(pallas_flat=False, **KW),
                                 variables=v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        assert np.array_equal(np.asarray(a), np.asarray(flat_b[path])), path
