"""The vup path (``UNet(vup=True)``, elektronn3_tpu_torch.ops.vup) under
group and instance norm against the JAX package's, on the CPU: the
per-sample mode of rows 1 (its vup mode), 9, 22 and 23 of the kernel
table in PERF.md.

- Op level: JAX's ``conv_bnact_flat_vup`` with ``want_stats=
  'per_sample'`` and ``upconv122_stats_from_flat64`` with
  ``'per_sample'``, (n, B, 128) per-sample prologue lanes for the carry
  and the merge, in interpret mode (a spy on ``pallas_call`` shows that
  JAX reached each entry), against the port's ``vup.conv_vup`` and
  ``vup.upconv_stats`` with (B, C) prologue vectors, which take the
  kernels' plain versions on a CPU tensor: the forward (output and
  (B, C) statistics), and under ``jax.vjp`` against
  ``torch.autograd.grad`` every argument's gradient for the same
  cotangents (of the output and of each sample's statistics), which
  reaches ``_conv_vup_bwd`` (row 9) and ``_upconv122_stats_bwd`` (row
  23). B = 2 samples of different scales and vectors, float32 and
  bfloat16. The tolerances of tests/test_torch_group_norm.py: float32
  1e-4 of each output's or gradient's scale; bfloat16 one unit in the
  last place (2^-7 of each value) plus 1e-4 of the scale; each row of a
  (B, C) result 1e-4 (float32) or 1e-3 (bfloat16) of its row's scale,
  and the two rows differ.
- Model level: the headline structure cut to three levels (start_filts
  32, planar L0; L1 a C=64 kernel level whose decoder carries its
  output into the vup merge of up_0) at input (2, 2, 8, 16, 1) with
  'group', 'group4' and 'instance', random affine parameters: the
  ``vup=True`` eval forward against JAX's ``pallas_flat=True`` forward
  under ``E3TPU_VUP=1`` (its training forward, the same function for a
  norm without running state; 2e-4, float32, as tests/test_torch_vup.py),
  and one training step against JAX's fused step there (loss within
  1e-5 relative, every gradient within 1e-3 of its leaf's scale + 1e-6,
  as tests/test_torch_train.py), the port's step calling the vup ops
  once each and no upconv into L0; ``vup=True`` against ``vup=False``
  under group norm (the forward bitwise, the gradients within 1e-4 of
  their scale), and the converter through the vup model unchanged.
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
from elektronn3_tpu_torch.ops import fused, vup
from test_torch_group_norm import (
    B, _JDT, _TDT, _close, _close_rows, _jax_tree, _lanes_ps, _pro, _q,
    _seeded_port, _x)
from test_torch_group_train import _grads, _scaled_cts, _stats_cts, _tt
from test_torch_kernels import _spy_pallas
from test_torch_train import LOSS_RTOL, _assert_trees, _batch
from test_torch_vup import (STATS_BWD, STATS_FWD, VUP_BWD, VUP_FWD, _pwu,
                            _step)

DTYPES = ["float32", "bfloat16"]
# (D, H, W) of the ops' merge level (W / 2 even, as JAX asserts).
OP_DHW = (2, 8, 8)


def _vup_args(rng, dtype):
    """Numpy arguments with their JAX dtypes: the C=64 carry at (H/2,
    W/2) and its (B, 64) prologue, the (1, 2, 2) upconv 64->32 (flax
    layout, float32 parameters of values of the dtype), the C=32 skip,
    the (B, 64) merge prologue (u's slot first) and the 64->32 merge conv
    (weight and bias in the dtype, as JAX's _FusedConvVup passes
    them)."""
    D, H, W = OP_DHW
    jdt = _JDT[dtype]
    carry = _x(rng, (B, D, H // 2, W // 2, 64), dtype)
    invc, shiftc = _pro(rng, 64)
    wu = _q(0.2 * rng.normal(size=(1, 2, 2, 64, 32)), dtype)
    bu = (0.1 * rng.normal(size=32)).astype(np.float32)
    skip = _x(rng, (B, D, H, W, 32), dtype)
    inv, shift = _pro(rng, 64)
    w = _q(0.1 * rng.normal(size=(1, 3, 3, 64, 32)), dtype)
    b = _q(0.1 * rng.normal(size=32), dtype)
    f32 = jnp.float32
    return [(carry, jdt), (invc, f32), (shiftc, f32), (wu, f32), (bu, f32),
            (skip, jdt), (inv, f32), (shift, f32), (w, jdt), (b, jdt)]


def _vup_fns(act="relu"):
    """Row 1's vup mode with per-sample statistics: (y, s, q)."""
    _, H, W = OP_DHW

    def jfn(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b):
        (chunk,) = f64.to_flat64(carry)
        ys, st = ffu.conv_bnact_flat_vup(
            chunk, _lanes_ps(invc, 64), _lanes_ps(shiftc, 64), wu, bu,
            fc.to_flat(skip), _lanes_ps(inv, 32), _lanes_ps(shift, 32), w, b,
            H, W, (0, 0), "per_sample", act, act)
        return (fc.from_flat(ys, H, W, padded=True),
                ffu.fold_lane_stats(st[0]), ffu.fold_lane_stats(st[1]))

    def pfn(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b):
        return vup.conv_vup(carry, invc, shiftc, _pwu(wu), bu, skip, inv,
                            shift, w.permute(4, 3, 0, 1, 2), b, act, act,
                            want_stats="per_sample")
    return jfn, pfn


def _stats_fns(act="relu"):
    """Row 22 with per-sample statistics: (s, q)."""
    _, H, W = OP_DHW

    def jfn(carry, invc, shiftc, wu, bu):
        (chunk,) = f64.to_flat64(carry)
        s, q = f64.upconv122_stats_from_flat64(
            chunk, _lanes_ps(invc, 64), _lanes_ps(shiftc, 64), wu, bu, H, W,
            "per_sample", act)
        return ffu.fold_lane_stats(s), ffu.fold_lane_stats(q)

    def pfn(carry, invc, shiftc, wu, bu):
        return vup.upconv_stats(carry, invc, shiftc, _pwu(wu), bu, act,
                                want_stats="per_sample")
    return jfn, pfn


# case -> (the functions, how many of the arguments they take, the JAX
# forward and backward functions they must reach)
OP_CASES = {"row1-vup/row9": (_vup_fns, 10, VUP_FWD, VUP_BWD),
            "row22/row23": (_stats_fns, 5, STATS_FWD, STATS_BWD)}


def _check(port, ref, jd, dtype):
    """A result or gradient: (B, C) row by row (the two rows differ),
    else against its scale; the port's in its argument's dtype."""
    tdt = "bfloat16" if jd == jnp.bfloat16 else "float32"
    assert port.dtype == _TDT[tdt]
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if ref.ndim == 2:
        _close_rows(port.float(), ref, dtype)
        assert not np.allclose(ref[0], ref[1])
    else:
        _close(port.float(), ref, tdt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(OP_CASES))
def test_plain_per_sample_vup_forward_matches_jax(case, dtype, monkeypatch):
    """Rows 1 (vup mode) and 22: the output and the (B, C) statistics."""
    fns, nargs, fwd, _ = OP_CASES[case]
    rng = np.random.default_rng([len(case), len(dtype), 17])
    args = _vup_args(rng, dtype)[:nargs]
    jfn, pfn = fns()
    seen = _spy_pallas(monkeypatch, {fwd})
    ref = jfn(*[jnp.asarray(a).astype(jd) for a, jd in args])
    assert seen == {fwd}
    out = pfn(*[_tt(a, "bfloat16" if jd == jnp.bfloat16 else "float32")
                for a, jd in args])
    assert len(out) == len(ref)
    for i, (p, j) in enumerate(zip(out, ref)):
        _check(p, j, args[0][1] if i == 0 and nargs == 10 else jnp.float32,
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(OP_CASES))
def test_plain_per_sample_vup_backward_matches_jax(case, dtype, monkeypatch):
    """Rows 9 and 23: every argument's gradient for the cotangents of
    the output and of each sample's statistics; the (B, C) prologue
    vectors' gradients row by row."""
    fns, nargs, _, bwd = OP_CASES[case]
    rng = np.random.default_rng([len(case), len(dtype), 18])
    args = _vup_args(rng, dtype)[:nargs]
    jfn, pfn = fns()
    cts = [(v, jnp.float32) for v in _stats_cts(rng, 32)]
    if nargs == 10:
        D, H, W = OP_DHW
        cts = [(_scaled_cts(rng, (B, D, H, W, 32), dtype), _JDT[dtype]),
               *cts]
    seen = _spy_pallas(monkeypatch, {bwd})
    jg, pg = _grads(jfn, pfn, args, cts, dtype)
    assert seen == {bwd}
    for (a, jd), p, j in zip(args, pg, jg):
        _check(p, j, jd, dtype)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

SHAPE = (2, 2, 8, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
          planar_blocks=(0,))
NORMS = ("group", "group4", "instance")


@pytest.fixture(scope="module")
def models():
    """For each norm: random parameters, JAX's ``pallas_flat=True``
    fused training step under ``E3TPU_VUP=1`` and its forward (the spy
    recording the vup entries they reach), and the port's ``vup=True``
    eval forward and step (its vup ops' and upconvs' calls recorded)."""
    rng = np.random.default_rng(37)
    x, y = _batch(rng, SHAPE)
    out = {"x": x, "y": y}
    crit = jloss.CEDiceLoss(1.0, 1.0)
    for i, norm in enumerate(NORMS):
        kw = dict(KW, normalization=norm)
        m0 = _seeded_port(70 + i, **kw)
        jf = junet.UNet(pallas_flat=True, **kw)
        v = jax.tree_util.tree_map(
            jnp.asarray, flax_from_state_dict(m0.state_dict(),
                                              _jax_tree(jf, SHAPE),
                                              ("params",)))

        def loss_fn(p):
            o = jf.apply({"params": p}, jnp.asarray(x), train=True)
            return crit(o, jnp.asarray(y)).astype(jnp.float32), o
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("E3TPU_VUP", "1")
            seen = _spy_pallas(mp, {VUP_FWD, VUP_BWD, STATS_FWD, STATS_BWD,
                                    "upconv122_from_flat64"})
            # A group norm keeps no running state: the training forward
            # is the eval forward, so one compiled step gives both.
            (jl, y_jax), jg = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v["params"])
            y_jax = np.asarray(y_jax)
        m = UNet(device="cpu", pallas_flat=True, vup=True, **kw)
        m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
        with torch.no_grad():
            y_port = m.eval()(torch.from_numpy(x)).numpy()
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for mod, name in ((vup, "conv_vup"), (vup, "upconv_stats"),
                              (fused, "upconv_bnact")):
                def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                    calls.append((_name, tuple(a[0].shape)))
                    return _fn(*a, **k)
                mp.setattr(mod, name, counted)
            m.train()
            loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                              torch.from_numpy(y).long())
            loss.backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        out[norm] = dict(
            m0=m0, v=v, kw=kw, seen=seen, y_jax=y_jax, y_port=y_port,
            jax_step=(float(jl), jg), port_step=(float(loss.detach()), grads),
            calls=sorted(calls), kinds=m.level_kinds(SHAPE))
    return out


@pytest.mark.parametrize("norm", NORMS)
def test_jax_vup_group_reaches_the_vup_entries(models, norm):
    """Under E3TPU_VUP=1 JAX's up_0 runs the vup merge conv and the
    statistics pass, forward and backward, and no materializing upconv
    of the C=64 carry."""
    assert models[norm]["seen"] == {VUP_FWD, VUP_BWD, STATS_FWD, STATS_BWD}


@pytest.mark.parametrize("norm", NORMS)
def test_port_vup_group_forward_matches_jax(models, norm):
    r = models[norm]
    assert r["kinds"] == ["kernels", "kernels", "library"]
    assert r["y_port"].shape == r["y_jax"].shape == SHAPE[:-1] + (2,)
    err = np.max(np.abs(r["y_port"] - r["y_jax"]))
    assert err <= 2e-4, err


@pytest.mark.parametrize("norm", NORMS)
def test_port_vup_group_step_matches_jax(models, norm):
    """The loss and every gradient of one step: the vup path's
    per-sample backward (rows 9 and 23, their (B, C) cotangents and
    prologue gradients) against JAX's."""
    r = models[norm]
    (loss, grads), (jl, jg) = r["port_step"], r["jax_step"]
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl), (loss, jl)
    _assert_trees(flax_from_state_dict(grads, r["v"], ("params",))
                  ["params"], jg)


@pytest.mark.parametrize("norm", NORMS)
def test_port_vup_group_step_runs_the_vup_ops(models, norm):
    """The training step's statistics pass and vup merge conv on the
    carried C=64 activation (2, 2, 4, 8, 64); the upconv of up_1 (from
    the library bottom's dense output); no upconv into L0."""
    carry = (2, 2, 4, 8, 64)
    assert models[norm]["calls"] == sorted(
        [("conv_vup", carry), ("upconv_stats", carry),
         ("upconv_bnact", (2, 1, 2, 4, 128))])


def test_vup_true_matches_vup_false_under_group_norm():
    """The same group-norm model with ``vup`` on and off: the training
    forward and the eval forward bit for bit; every gradient within 1e-4
    of its scale (float32; conv biases before a group norm aside: their
    exact gradient is 0); the same parameters and level kinds."""
    rng = np.random.default_rng(89)
    shape = (2, 2, 8, 12, 1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 2, size=shape[:-1])).long()
    runs = []
    for on in (False, True):
        m = _seeded_port(91, vup=on, pallas_flat=True,
                         **dict(KW, normalization="group"))
        yt, g = _step(m, x, t)
        with torch.no_grad():
            e = m.eval()(x)
        runs.append((m, yt, g, e))
    (m0, y0, g0, e0), (m1, y1, g1, e1) = runs
    assert m0.level_kinds(shape) == m1.level_kinds(shape) == \
        ["kernels", "kernels", "library"]
    assert torch.equal(y0, y1) and torch.equal(e0, e1)
    assert m0.state_dict().keys() == m1.state_dict().keys()
    for n in g0:
        if n.endswith(".bias") and ".conv" in n and "conv_final" not in n:
            continue
        _close(g1[n], g0[n].numpy(), "float32")


def test_converter_round_trip_vup_group_is_exact(models):
    """The vup tree is the materializing tree: the flax parameters go
    through the ``vup=True`` group model's state_dict and back
    unchanged."""
    r = models["group"]
    v = jax.device_get(r["v"])
    m = UNet(device="cpu", pallas_flat=True, vup=True, **r["kw"])
    sd = state_dict_from_flax(v, m)
    back = flax_from_state_dict(sd, v, ("params",))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, v))


def test_vup_per_sample_contract_raises():
    """A prologue row count that is not the batch's, an (N, C) inv with a
    (C,) shift, or row 22 without statistics: ValueError, on the CPU as
    on the card."""
    g = torch.Generator().manual_seed(4)
    carry = torch.randn(2, 1, 2, 2, 64, generator=g)
    skip = torch.randn(2, 1, 4, 4, 32, generator=g)
    wu = torch.randn(64, 32, 1, 2, 2, generator=g)
    bu = torch.zeros(32)
    w = torch.randn(32, 64, 1, 3, 3, generator=g)
    b = torch.zeros(32)
    rows = torch.ones(2, 64)
    with pytest.raises(ValueError, match="prologue vector shape"):
        vup.conv_vup(carry, torch.ones(3, 64), torch.zeros(3, 64), wu, bu,
                     skip, rows, rows, w, b, "relu", "relu")
    with pytest.raises(ValueError, match="differ"):
        vup.conv_vup(carry, rows, rows, wu, bu, skip, rows,
                     torch.zeros(64), w, b, "relu", "relu")
    with pytest.raises(ValueError, match="want_stats"):
        vup.upconv_stats(carry, rows, rows, wu, bu, "relu", want_stats=False)
    y, s, q = vup.conv_vup(carry, rows, rows, wu, bu, skip, rows, rows, w, b,
                           "relu", "relu", want_stats="per_sample")
    su, qu = vup.upconv_stats(carry, rows, rows, wu, bu, "relu",
                              want_stats="per_sample")
    assert s.shape == q.shape == (2, 32) and su.shape == qu.shape == (2, 32)
