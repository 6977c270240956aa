"""The port's 2D U-Net (``UNet(dim=2)``, the model of
examples/train_simple2d.py) against the JAX package's, on the CPU in
float32, and the default device.

- Kernel level: the plain versions of K2/K6 (``pool_bnact`` with a
  (1, 2, 2) window, forward and backward) against the C=64 executor's
  planar pool, rows 16 and 17 of the kernel table in PERF.md
  (``pool122_bnact_flat64_skip`` and ``_pool122_bwd_impl``, interpret
  mode), at C=64 and C=128, relu and leaky, with an exact tie; the
  plain versions of K3/K7 (``upconv_bnact`` from a dense input, kd=1,
  with statistics) against rows 19 and 20 (``upconv122_bn_flat64`` and
  ``_upconv122_64_bwd``) at 128->64 and 256->128. The tolerances of
  tests/test_torch_kernels.py.
- Model level, ``n_blocks=4, start_filts=32, dim=2``, batch norm with
  random statistics and affine parameters, input (2, 12, 32, 1). At this
  input JAX's ``pallas_flat=True`` plan is the port's level by level:
  L0 (12 x 32, C=32) and L1 (6 x 16, C=64) fused, L2 (3 x 8, C=128)
  declined for its odd H, so the up level into L1 takes L2's dense
  output through row 19 at 128->64, as the port's K3 does, the port
  model being built with its default ``pallas_flat='auto'`` here. (At
  an even L2, ``pallas_flat=True`` fuses L2 too, with no voxel gate, and
  the up level takes row 24 instead: tests/test_torch_headline_rows.py
  and tests/test_torch_sf64.py hold the port built with
  ``pallas_flat=True`` against JAX there.) The eval forward against
  both JAX executors (2e-4), and one training step: loss within 1e-5
  relative, every gradient and new running statistic within 1e-3 of
  its scale + 1e-6 (the bounds of tests/test_torch_train.py).
- The converter round trip of the 2D tree, the Predictor (whole, tiled,
  argmax) against the JAX Predictor, ``CEDiceLoss`` on 2D logits, a
  declined 2D level (ceil-mode pool and autocrop), ``Trainer.run`` on a
  2D dataset, and ``UNet()`` raising without a card.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.models.torch_import import load_torch_state_dict
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.ops import flat_fused64 as f64
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from elektronn3_tpu_torch.training import Trainer
from test_torch_kernels import (_bn, _close, _grads, _spy_pallas,
                                _stat_cts, _t)
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,
                              _port_model, _port_step, _randomize)

SHAPE = (2, 12, 32, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          dim=2, normalization="batch")
ROWS = {"pool122_bnact_flat64", "_pool122_bwd_impl", "upconv122_bn_flat64",
        "_upconv122_64_bwd"}


# ---------------------------------------------------------------------------
# Rows 16/17: the planar pool of the C=64 executor (C=64 and C=128)
# ---------------------------------------------------------------------------

def _pool122_case(rng, c, act, tie=False):
    B, D, H, W = 2, 1, 4, 6
    x = rng.normal(size=(B, D, H, W, c)).astype(np.float32)
    inv, shift = _bn(rng, c)
    if tie:
        # Half-integer values under a positive scale: windows hold exact
        # ties of their max, whose gradient goes to every tied element.
        x = np.round(2 * x) / 2
        inv, shift = np.abs(inv) + 0.5, np.full_like(shift, 2.0)

    def jfn(x, inv, shift):
        pooled, skip = f64.pool122_bnact_flat64_skip(
            f64.to_flat64(x), f64.lane_vec64(inv), f64.lane_vec64(shift),
            H, W, c, act)
        return pooled, f64.from_flat64(tuple(skip), H, W, c)

    def pfn(x, inv, shift):
        # The raw input is the level's skip: its cotangent adds to the
        # pool's input gradient through autograd.
        return fused.pool_bnact(x, inv, shift, act, (1, 2, 2)), x * 1.0
    return jfn, pfn, (x, inv, shift), \
        [(B, D, H // 2, W // 2, c), (B, D, H, W, c)]


POOL_CASES = {
    "row16-c64-relu": (64, "relu", False), "row16-c64-leaky": (64, "leaky",
                                                               False),
    "row16-c128-relu": (128, "relu", False),
    "row16-c64-tie": (64, "relu", True), "row16-c128-tie": (128, "relu",
                                                            True),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool122_plain_matches_rows_16_17(case, monkeypatch):
    """Forward (row 16) and backward (row 17, with the skip cotangent)
    of the port's (1, 2, 2) pool against the C=64 executor's."""
    rng = np.random.default_rng(23)
    jfn, pfn, args, ct_shapes = _pool122_case(rng, *POOL_CASES[case])
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32) for s in ct_shapes]
    seen = _spy_pallas(monkeypatch, {"pool122_bnact_flat64",
                                     "_pool122_bwd_impl"})
    jout, jg, pout, pg = _grads(jfn, pfn, args, cts, [0, 1, 2])
    assert seen == {"pool122_bnact_flat64", "_pool122_bwd_impl"}
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)


# ---------------------------------------------------------------------------
# Rows 19/20: the (1, 2, 2) upconv from a dense input into the C=64
# executor (128->64, and 256->128)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(128, 64), (256, 128)])
def test_upconv122_plain_matches_rows_19_20(cin, cout, monkeypatch):
    """Forward with statistics (row 19) and backward with statistics
    cotangents (row 20). Weights enter both in flax layout."""
    rng = np.random.default_rng(29)
    B, D, H1, W1 = 2, 1, 2, 3
    dec = rng.normal(size=(B, D, H1, W1, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(1, 2, 2, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)

    def jfn(dec, w, b):
        ys, (s, q) = f64.upconv122_bn_flat64(dec, w, b, 2 * H1, 2 * W1,
                                             True)
        return (f64.from_flat64(ys, 2 * H1, 2 * W1, cout),
                f64.fold_lane_stats64(s), f64.fold_lane_stats64(q))

    def pfn(dec, w, b):
        return fused.upconv_bnact(dec, None, None,
                                  w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b,
                                  "linear", want_stats=True)
    cts = [(0.1 * rng.normal(size=s)).astype(np.float32)
           for s in _stat_cts((B, D, 2 * H1, 2 * W1, cout))]
    seen = _spy_pallas(monkeypatch, {"upconv122_bn_flat64",
                                     "_upconv122_64_bwd"})
    jout, jg, pout, pg = _grads(jfn, pfn, (dec, w, b), cts, [0, 1, 2])
    assert seen == {"upconv122_bn_flat64", "_upconv122_64_bwd"}
    for p, j in zip(pout, jout):
        _close(p, j)
    for p, j in zip(pg, jg):
        _close(p, j)


# ---------------------------------------------------------------------------
# The 2D model: eval forward and one training step against both JAX
# executors
# ---------------------------------------------------------------------------

def _jax_step(model, v, x, y, crit):
    """(loss, grads, new batch_stats) of one jitted JAX training step."""
    def loss_fn(params, x, y):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return crit(out, y).astype(jnp.float32), mut["batch_stats"]
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, bs), g = step(v["params"], jnp.asarray(x), jnp.asarray(y))
    return float(loss), g, bs


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(31)
    x, y = _batch(rng, SHAPE)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    m_fused = junet.UNet(pallas_flat=True, **KW)
    v = _randomize(junet.init_unet(m_xla, SHAPE), rng)
    crit = jloss.CEDiceLoss(1.0, 1.0)
    seen = set()
    real = pl.pallas_call

    def spy(*a, **k):
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_name in ROWS:
                seen.add(f.f_code.co_name)
            f = f.f_back
        return real(*a, **k)

    def forward(model):
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
        return np.asarray(fn(v, jnp.asarray(x)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", spy)
        fused_step = _jax_step(m_fused, v, x, y, crit)
        y_fused = forward(m_fused)
    xla_step = _jax_step(m_xla, v, x, y, crit)
    y_xla = forward(m_xla)

    m = _port_model(v, **KW)
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


def test_jax_2d_fused_step_reaches_rows_16_17_19_20(runs):
    assert runs["seen"] == ROWS


def test_port_2d_step_goes_through_kernel_ops(runs):
    """L0 and L1 with their decoder levels: 8 convs, 2 pools, 2 upconvs
    on the D=1 view; the L1 pool at C=64 (row 16) and the up_1 upconv
    from L2's dense 128-channel output without a prologue (row 19)."""
    calls = runs["calls"]
    assert [c[0] for c in calls].count("conv_bnact") == 8
    assert ("pool_bnact", (2, 1, 6, 16, 64), False) in calls
    assert ("upconv_bnact", (2, 1, 3, 8, 128), True) in calls
    assert ("upconv_bnact", (2, 1, 6, 16, 64), False) in calls
    assert len(calls) == 12


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
def test_port_2d_forward_matches_jax(runs, executor):
    ref = runs["y_fused" if executor == "pallas_flat=True" else "y_xla"]
    m = _port_model(runs["v"], **KW).eval()
    with torch.no_grad():
        y = m(torch.from_numpy(runs["x"])).numpy()
    assert y.shape == ref.shape == SHAPE[:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_2d_train_step_matches_jax(runs, executor, what):
    ref = runs["fused" if executor == "pallas_flat=True" else "xla"]
    port = runs["port"]
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


def test_converter_round_trip_2d_is_exact(runs):
    """flax 2D kernels (3, 3, I, O) and (2, 2, I, O) -> torch (O, I, 3,
    3) and (I, O, 2, 2) -> back through torch_import, bit for bit. The
    fused executors' 2D parameters have the XLA path's tree (``_p2d``),
    so one converter serves both."""
    v = jax.device_get(runs["v"])
    m = UNet(device="cpu", **KW)
    sd = state_dict_from_flax(v, m)
    assert tuple(sd["down_convs.1.conv1.weight"].shape) == (64, 32, 3, 3)
    assert tuple(sd["up_convs.1.upconv.weight"].shape) == (128, 64, 2, 2)
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


@pytest.mark.parametrize("w,plan", [(30, [True, False, False, False]),
                                    (28, [True, True, False, False])])
def test_port_2d_declined_level_matches_jax(runs, w, plan):
    """W=30: L1 is 6 x 15 (odd W) and runs plain torch; its ceil-mode
    pool and the decoder's autocrop work on 2D tensors, and the L0
    kernel decoder lifts L1's dense output. W=28: L2 is 3 x 7 and L3
    2 x 4 (ceil mode), so L2's decoder crops the upsampled tensor."""
    v = runs["v"]
    x = np.random.default_rng(w).normal(size=(1, 12, w, 1)) \
        .astype(np.float32)
    ref = np.asarray(junet.UNet(pallas_flat=False, **KW).apply(
        v, jnp.asarray(x), train=False))
    m = _port_model(v, **KW).eval()
    assert m.plan(x.shape) == plan
    with torch.no_grad():
        y = m(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


def test_2d_model_refuses_a_volume():
    m = UNet(n_blocks=2, dim=2, device="cpu")
    with pytest.raises(ValueError, match=r"\(N, H, W, 1\)"):
        m(torch.zeros(1, 2, 8, 8, 1))


def test_cedice_loss_on_2d_logits_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 6, 10, 2)).astype(np.float32)
    y = rng.integers(0, 2, size=(2, 6, 10))
    jval, jgrad = jax.value_and_grad(
        lambda o: jloss.CEDiceLoss(1.0, 1.0)(o, jnp.asarray(y)))(
            jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    pval = ploss.CEDiceLoss(1.0, 1.0)(t, torch.from_numpy(y))
    (pgrad,) = torch.autograd.grad(pval, t)
    assert abs(float(pval.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    assert np.max(np.abs(pgrad.numpy() - np.asarray(jgrad))) <= \
        1e-5 * float(np.max(np.abs(np.asarray(jgrad))))


# ---------------------------------------------------------------------------
# Predictor 2D against the JAX Predictor (tests/test_inference.py's cases)
# ---------------------------------------------------------------------------

PKW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
           dim=2, normalization="batch")
IMAGE = (1, 1, 32, 32)
TILED = dict(tile_shape=(16, 16), overlap_shape=(8, 8), batch_size=3)


@pytest.fixture(scope="module")
def models2d():
    rng = np.random.default_rng(7)
    jm = junet.UNet(pallas_flat=False, **PKW)
    v = jax.tree_util.tree_map(
        np.asarray, _randomize(junet.init_unet(jm, (1, 32, 32, 1)), rng))
    pm = UNet(device="cpu", **PKW)
    pm.load_state_dict(state_dict_from_flax(v, pm))
    return jm, v, pm, rng.normal(size=IMAGE).astype(np.float32)


@pytest.mark.parametrize("mode", ["whole", "tiled"])
def test_predictor_2d_matches_jax(models2d, mode):
    jm, v, pm, img = models2d
    kw = TILED if mode == "tiled" else {}
    ref = JaxPredictor(jm, v, **kw).predict(img)
    out = Predictor(pm, **kw).predict(img)
    assert out.shape == ref.shape == (1, 2) + IMAGE[2:]
    assert out.dtype == np.float32
    assert np.max(np.abs(out - np.asarray(ref, np.float32))) <= 1e-4


def test_predictor_2d_takes_rank_from_the_model(models2d):
    """Without a tile shape an (H, W) image is read as 2D (the model's
    ``dim``), not as a 3-D volume."""
    _, _, pm, img = models2d
    out = Predictor(pm).predict(img[0, 0])
    assert out.shape == (1, 2) + IMAGE[2:]


@pytest.mark.parametrize("thr", [True, 0.4])
def test_predictor_2d_argmax_matches_jax(models2d, thr):
    jm, v, pm, img = models2d
    ref = JaxPredictor(jm, v, argmax_with_threshold=thr,
                       **TILED).predict(img)
    out = Predictor(pm, argmax_with_threshold=thr, **TILED).predict(img)
    assert out.dtype == np.uint8 and out.shape == ref.shape == \
        (1, 1) + IMAGE[2:]
    probs = Predictor(pm, **TILED).predict(img)
    cut = 0.5 if thr is True else thr
    ambiguous = np.abs(probs[:, 1:2] - cut) < 1e-5
    assert np.all((out == ref) | ambiguous)


# ---------------------------------------------------------------------------
# Trainer on 2D batches, and the default device
# ---------------------------------------------------------------------------

class _Images(torch.utils.data.Dataset):
    """Seeded (1, H, W) inputs and (H, W) class targets."""

    def __init__(self, n, shape=(1, 16, 24), seed=0):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + shape).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + shape[1:])

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


def test_trainer_runs_2d(tmp_path):
    model = UNet(n_blocks=3, start_filts=32, dim=2, device="cpu")
    before = model.state_dict()["down_convs.1.conv1.weight"].clone()
    tr = Trainer(model, ploss.CEDiceLoss(1.0, 1.0),
                 train_dataset=_Images(4), batch_size=2,
                 save_root=str(tmp_path), exp_name="run2d",
                 nan_check_interval=2)
    tr.run(max_steps=3)
    assert tr.step == 3 and np.isfinite(tr.last_stats["tr_loss"]).all()
    assert tr.last_misc["tr_speed_vx"] > 0
    assert not torch.equal(before,
                           model.state_dict()["down_convs.1.conv1.weight"])


def test_unet_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    """The card is the default device: without one, ``UNet()`` raises
    instead of quietly building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dim in (3, 2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            UNet(dim=dim)
    m = UNet(dim=2, device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert Predictor(m).device.type == "cpu"
