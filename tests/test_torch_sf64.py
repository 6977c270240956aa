"""The port's C=128 kernel levels and the start_filts=64 3D UNet against
the JAX package's, on the CPU in float32.

- Kernel level (plain versions, tolerances of
  tests/test_torch_kernels.py): K3/K7 (``upconv_bnact``) with the
  carried prologue at C_in 128 -> 64 and 256 -> 128, in both depths,
  with statistics, relu and leaky, against rows 24 and 25 of the kernel
  table in PERF.md (``upconv122_f64in``, ``upconv222_f64in`` and
  ``_upconv_f64in_bwd_call``, interpret mode); K1/K4/K5
  (``conv_bnact``) at C_out=128, kd=3, over 2 and 4 input chunks
  (128 and the 128+128 merge) against ``conv3_bnact_flat64``; K2/K6
  (2, 2, 2) at C=128 against ``pool222_bnact_flat64_skip``; the head
  from a C=64 activation against ``head_bnact_from_flat64`` (XLA in JAX),
  in float32 and bfloat16.
- The planner: the C=128 voxel gate of ``pallas_flat='auto'`` at the
  four shapes the gate decides for the port's paths, ``True`` and
  ``False``.
- Model level: ``UNet(n_blocks=3, start_filts=64, planar_blocks=(0,))``
  with batch norm (random statistics and affine parameters) at input
  (2, 4, 16, 16, 1), built in the port with ``pallas_flat=True``. JAX's
  ``pallas_flat=True`` plan is the port's level by level there: L0
  (4 x 16 x 16, C=64, planar) and L1 (4 x 8 x 8, C=128) fused, the
  bottom L2 (C=256) on XLA; up_0 takes L2's dense output (row 6 at
  256 -> 128) and up_1 the carried C=128 activation of up_0 through row
  24's (1, 2, 2) form, its backward row 25; the head reads up_1's C=64
  carry. These are the levels of the chip's n_blocks=4 model but its
  C=512 bottom: at a CPU-sized input that bottom's batch norm holds 8
  voxels, and the step's gradients then differ between the two JAX
  executors by several times the tolerance (rounding, not an error of
  either). The eval
  forward against both JAX executors (2e-4), one training step (loss
  1e-5 relative, every gradient and new running statistic within 1e-3
  of its scale + 1e-6, the bounds of tests/test_torch_train.py), a
  tiled Predictor request against the JAX Predictor (1e-4), and the
  converter round trip of the sf=64 tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.models.torch_import import load_torch_state_dict
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.models import unet as punet
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from test_torch_2d import _jax_step
from test_torch_kernels import (TOL, _bn, _close, _grads, _spy_pallas,
                                _stat_cts)
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,
                              _port_model, _port_step, _randomize)

SHAPE = (2, 4, 16, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=64,
          planar_blocks=(0,), normalization="batch")
ROWS = {"upconv122_f64in", "_upconv_f64in_bwd_call"}


def _flax_convt(w):
    """A flax ConvTranspose kernel (kz, 2, 2, I, O) as the port's
    (I, O, kz, 2, 2) torch weight (taps flipped)."""
    return w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)


# ---------------------------------------------------------------------------
# Rows 24/25: the upconv that consumes a carried C=128 (or 256) decoder
# activation, in its (1, 2, 2) and (2, 2, 2) forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kz,cin,cout,act", [
    (1, 128, 64, "relu"), (2, 128, 64, "leaky"), (1, 256, 128, "leaky"),
    (2, 256, 128, "relu")])
def test_upconv_f64in_plain_matches_rows_24_25(kz, cin, cout, act,
                                               monkeypatch):
    """Forward with statistics (row 24) and backward with statistics
    cotangents (row 25): gradients of the carried input, its prologue
    (inv, shift) and the weights. Weights enter both in flax layout."""
    rng = np.random.default_rng(41 + kz + cin)
    B, D1, H1, W1 = 2, 2, 2, 4      # W1 even: the TPU kernel's lane pairs
    H, W = 2 * H1, 2 * W1
    x = rng.normal(size=(B, D1, H1, W1, cin)).astype(np.float32)
    inv, shift = _bn(rng, cin)
    w = (0.05 * rng.normal(size=(kz, 2, 2, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    jop = f64.upconv222_f64in if kz == 2 else f64.upconv122_f64in

    def jfn(x, inv, shift, w, b):
        ys, (s, q) = jop(f64.to_flat64(x), f64.lane_vec64(inv),
                         f64.lane_vec64(shift), w, b, H, W, True, act)
        return (f64.from_flat64(ys, H, W, cout), f64.fold_lane_stats64(s),
                f64.fold_lane_stats64(q))

    def pfn(x, inv, shift, w, b):
        return fused.upconv_bnact(x, inv, shift, _flax_convt(w), b, act,
                                  want_stats=True)
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32)
           for s in _stat_cts((B, kz * D1, H, W, cout))]
    names = {jop.__name__, "_upconv_f64in_bwd_call"}
    seen = _spy_pallas(monkeypatch, names)
    jout, jg, pout, pg = _grads(jfn, pfn, (x, inv, shift, w, b), cts,
                                range(5))
    assert seen == names
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)


# ---------------------------------------------------------------------------
# The C=128 level's convs and pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cins,act", [((128,), "relu"),
                                      ((128, 128), "leaky")])
def test_conv_c128_plain_matches_conv3_bnact_flat64(cins, act, monkeypatch):
    """K1 forward with statistics, then K4 and K5 (``_conv64_bwd``),
    at C_out=128, kd=3: conv2 of a C=128 level (2 input chunks) and the
    decoder merge conv over [upconv output, skip] (4 chunks)."""
    rng = np.random.default_rng(43 + len(cins))
    B, D, H, W, cout = 2, 4, 4, 6, 128
    cin = sum(cins)
    x = rng.normal(size=(B, D, H, W, cin)).astype(np.float32)
    w = (0.03 * rng.normal(size=(3, 3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    inv, shift = _bn(rng, cin)
    bounds = np.cumsum((0,) + cins)

    def jfn(x, inv, shift, w, b):
        chunks = sum((f64.to_flat64(x[..., lo:hi])
                      for lo, hi in zip(bounds[:-1], bounds[1:])), ())
        ys, (s, q) = f64.conv3_bnact_flat64(
            chunks, f64.lane_vec64(inv), f64.lane_vec64(shift), w, b, H, W,
            True, act)
        return (f64.from_flat64(ys, H, W, cout), f64.fold_lane_stats64(s),
                f64.fold_lane_stats64(q))

    def pfn(x, inv, shift, w, b):
        xs = [x[..., lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
        return fused.conv_bnact(xs, inv, shift, w.permute(4, 3, 0, 1, 2),
                                b, act, want_stats=True)
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32)
           for s in _stat_cts((B, D, H, W, cout))]
    seen = _spy_pallas(monkeypatch, {"conv3_bnact_flat64", "_conv64_bwd"})
    jout, jg, pout, pg = _grads(jfn, pfn, (x, inv, shift, w, b), cts,
                                range(5))
    assert seen == {"conv3_bnact_flat64", "_conv64_bwd"}
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)


@pytest.mark.parametrize("tie", [False, True])
def test_pool222_c128_plain_matches_jax(tie, monkeypatch):
    """K2/K6 (2, 2, 2) at C=128 (two lane chunks in JAX), forward and
    backward with the skip cotangent; ``tie`` gives windows exact ties,
    whose gradient goes to every tied element."""
    rng = np.random.default_rng(47)
    B, D, H, W, C = 2, 4, 4, 6, 128
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    inv, shift = _bn(rng, C)
    if tie:
        x = np.round(2 * x) / 2
        inv, shift = np.abs(inv) + 0.5, np.full_like(shift, 2.0)

    def jfn(x, inv, shift):
        pooled, skip = f64.pool222_bnact_flat64_skip(
            f64.to_flat64(x), f64.lane_vec64(inv), f64.lane_vec64(shift), H,
            W, C, "relu")
        return pooled, f64.from_flat64(tuple(skip), H, W, C)

    def pfn(x, inv, shift):
        return fused.pool_bnact(x, inv, shift, "relu", (2, 2, 2))
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32)
           for s in [(B, D // 2, H // 2, W // 2, C), (B, D, H, W, C)]]
    seen = _spy_pallas(monkeypatch, {"pool222_bnact_flat64",
                                     "_pool64_bwd_impl"})
    jout, jg, pout, pg = _grads(jfn, pfn, (x, inv, shift), cts, range(3))
    assert seen == {"pool222_bnact_flat64", "_pool64_bwd_impl"}
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_c64_matches_head_bnact_from_flat64(dtype):
    """The head of a model whose decoder ends at C=64 (``_FusedHead64``:
    prologue, then the 1x1 conv as a float32 GEMM, XLA in JAX) against
    the port's ``head_bnact``, forward and backward, with the raw input
    in the model dtype and the weight and bias rounded to it first, as
    unet.py:763-764 does. Logits and every gradient but dx to 1e-4 of
    their scale; dx, stored in the model dtype, to one unit of its last
    place besides."""
    rng = np.random.default_rng(71)
    B, D, H, W, C, cout = 2, 2, 4, 6, 64, 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    inv, shift = _bn(rng, C)
    w = np.array(jnp.asarray(0.2 * rng.normal(size=(1, 1, 1, C, cout)))
                 .astype(jdt).astype(jnp.float32))
    b = np.array(jnp.asarray(0.1 * rng.normal(size=cout)).astype(jdt)
                 .astype(jnp.float32))
    dy = (0.1 * rng.normal(size=(B, D, H, W, cout))).astype(np.float32)

    def jfn(x, inv, shift, w, b):
        return f64.head_bnact_from_flat64(
            f64.to_flat64(x.astype(jdt)), f64.lane_vec64(inv),
            f64.lane_vec64(shift), w.astype(jdt), b.astype(jdt), H, W,
            "relu", out_dtype=jnp.float32)
    jargs = [jnp.asarray(a) for a in (x, inv, shift, w, b)]
    jout, pull = jax.vjp(jfn, *jargs)
    jg = pull(jnp.asarray(dy))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (x, inv, shift, w, b)]
    xr = targs[0].to(tdt)
    xr.retain_grad()
    pout = fused.head_bnact(
        fused.FusedActs(xr, targs[1], targs[2]), "relu",
        targs[3].permute(4, 3, 0, 1, 2).to(tdt), targs[4].to(tdt),
        torch.float32)
    pout.backward(torch.from_numpy(dy))
    _close(pout, jout)
    assert xr.grad.dtype == tdt
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23
    jdx = np.asarray(jg[0].astype(jnp.float32))
    pdx = xr.grad.float().numpy()
    assert np.all(np.abs(pdx - jdx) <= ulp * np.abs(jdx)
                  + TOL * np.abs(jdx).max())
    for p, j in zip(targs[1:], jg[1:]):
        _close(p.grad, j)


# ---------------------------------------------------------------------------
# The planner: pallas_flat and the C=128 voxel gate
# ---------------------------------------------------------------------------

_HEADLINE = dict(n_blocks=4, start_filts=32, planar_blocks=(0,))
_SF64 = dict(n_blocks=4, start_filts=64, planar_blocks=(0,))
_2D = dict(n_blocks=4, start_filts=32, dim=2)


@pytest.mark.parametrize("kw,shape,auto,forced", [
    # bench.py's headline step: L2 (22,22,22) = 10,648 vox < 60,000.
    (_HEADLINE, (8, 44, 88, 88, 1), [True, True, False, False],
     [True, True, True, False]),
    # The 2D model at (640, 640): L2 (160, 160) = 25,600 vox.
    (_2D, (8, 640, 640, 1), [True, True, False, False],
     [True, True, True, False]),
    # The sf=64 step: L1 (44,44,44) = 85,184 vox takes the kernels.
    (_SF64, (8, 44, 88, 88, 1), [True, True, False, False],
     [True, True, False, False]),
    # The headline Predictor's input tile: L2 (64,64,64) = 262,144 vox.
    (_HEADLINE, (2, 128, 256, 256, 1), [True, True, True, False],
     [True, True, True, False])],
    ids=["headline-bench", "2d-640", "sf64-bench", "headline-tile"])
def test_plan_voxel_gate(kw, shape, auto, forced):
    """'auto' (the default) declines a C=128 level under
    FUSED128_MIN_VOX voxels; True takes every level the kernels take by
    structure; False none."""
    assert punet.FUSED128_MIN_VOX == junet._FUSED128_MIN_VOX == 60_000
    assert UNet(device="meta", **kw).plan(shape) == auto
    assert UNet(device="meta", pallas_flat=True, **kw).plan(shape) == forced
    assert UNet(device="meta", pallas_flat=False, **kw).plan(shape) == \
        [False] * 4


def test_plan_reads_the_gate_constant(monkeypatch):
    """The crossover measurement raises the constant above L1's 85,184
    voxels: the sf=64 model's L1 then runs the library, L0 the
    kernels. A model that planned the shape before replans it under the
    new constant and under a new ``pallas_flat``."""
    model = UNet(device="meta", **_SF64)
    shape = (8, 44, 88, 88, 1)
    assert model.plan(shape) == [True, True, False, False]
    monkeypatch.setattr(punet, "FUSED128_MIN_VOX", 100_000)
    assert model.plan(shape) == [True, False, False, False]
    model.pallas_flat = True
    assert model.plan(shape) == [True, True, False, False]


def test_pallas_flat_rejects_other_values():
    with pytest.raises(ValueError, match="pallas_flat"):
        UNet(device="meta", pallas_flat="yes")


# ---------------------------------------------------------------------------
# The sf=64 model: eval forward, one training step, Predictor, converter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(53)
    x, y = _batch(rng, SHAPE)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    m_fused = junet.UNet(pallas_flat=True, **KW)
    v = _randomize(junet.init_unet(m_xla, SHAPE), rng)
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def forward(model):
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
        return np.asarray(fn(v, jnp.asarray(x)))

    with pytest.MonkeyPatch.context() as mp:
        seen = _spy_pallas(mp, ROWS)
        fused_step = _jax_step(m_fused, v, x, y, crit)
        y_fused = forward(m_fused)
    xla_step = _jax_step(m_xla, v, x, y, crit)
    y_xla = forward(m_xla)

    m = _port_model(v, pallas_flat=True, **KW)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("conv_bnact", "pool_bnact", "upconv_bnact"):
            fn = getattr(fused, name)

            def counted(*a, _fn=fn, _name=name, **k):
                x0 = a[0][0] if _name == "conv_bnact" else a[0]
                calls.append((_name, tuple(x0.shape), a[1] is None))
                return _fn(*a, **k)
            mp.setattr(fused, name, counted)
        port_step = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
    return dict(v=v, x=x, fused=fused_step, xla=xla_step, y_fused=y_fused,
                y_xla=y_xla, port=port_step, seen=seen, calls=calls)


def test_jax_sf64_fused_step_reaches_rows_24_25(runs):
    assert runs["seen"] == ROWS


def test_port_sf64_step_goes_through_kernel_ops(runs):
    """L0, L1 and their decoder levels: 8 convs, 2 pools, 2 upconvs.
    up_0 takes L2's dense 256-channel output (no prologue); up_1 the
    carried 128-channel activation of up_0 with its prologue (row 24)."""
    calls = runs["calls"]
    assert [c[0] for c in calls].count("conv_bnact") == 8
    assert ("pool_bnact", (2, 4, 16, 16, 64), False) in calls
    assert ("pool_bnact", (2, 4, 8, 8, 128), False) in calls
    assert ("upconv_bnact", (2, 2, 4, 4, 256), True) in calls
    assert ("upconv_bnact", (2, 4, 8, 8, 128), False) in calls
    assert len(calls) == 12


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
def test_port_sf64_forward_matches_jax(runs, executor):
    ref = runs["y_fused" if executor == "pallas_flat=True" else "y_xla"]
    m = _port_model(runs["v"], pallas_flat=True, **KW).eval()
    with torch.no_grad():
        y = m(torch.from_numpy(runs["x"])).numpy()
    assert y.shape == ref.shape == SHAPE[:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_sf64_train_step_matches_jax(runs, executor, what):
    ref = runs["fused" if executor == "pallas_flat=True" else "xla"]
    port = runs["port"]
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


def test_converter_round_trip_sf64_is_exact(runs):
    """The sf=64 tree (C=64 to 256, a planar L0) -> torch -> flax, bit
    for bit; the fused executors' parameters have the XLA path's tree."""
    v = jax.device_get(runs["v"])
    m = UNet(device="cpu", **KW)
    sd = state_dict_from_flax(v, m)
    assert tuple(sd["down_convs.1.conv2.weight"].shape) == (128, 128, 3, 3, 3)
    assert tuple(sd["up_convs.1.upconv.weight"].shape) == (128, 64, 1, 2, 2)
    fused_shapes = jax.eval_shape(
        lambda: junet.init_unet(junet.UNet(pallas_flat=True, **KW), SHAPE))
    assert jax.tree_util.tree_map(np.shape, fused_shapes) == \
        jax.tree_util.tree_map(np.shape, v)
    back = load_torch_state_dict(sd, junet.UNet(pallas_flat=False, **KW),
                                 variables=v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        assert np.array_equal(np.asarray(a), np.asarray(flat_b[path])), path


def test_predictor_sf64_matches_jax(runs):
    """A tiled request whose input tiles are (4, 16, 16): the port's
    model takes L1 (C=128) and the carry into up_1 on the kernel ops;
    the JAX Predictor runs the XLA executor on the same variables."""
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(runs["v"]))
    vol = np.random.default_rng(59).normal(size=(1, 1, 4, 32, 32)) \
        .astype(np.float32)
    kw = dict(tile_shape=(4, 8, 8), overlap_shape=(0, 4, 4), batch_size=3)
    ref = JaxPredictor(junet.UNet(pallas_flat=False, **KW), v,
                       **kw).predict(vol)
    pm = _port_model(runs["v"], pallas_flat=True, **KW)
    assert pm.plan((3, 4, 16, 16, 1)) == [True, True, False]
    out = Predictor(pm, **kw).predict(vol)
    assert out.shape == ref.shape == (1, 2, 4, 32, 32)
    assert np.max(np.abs(out - np.asarray(ref, np.float32))) <= 1e-4
