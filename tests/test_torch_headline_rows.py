"""Rows 24 (its (2, 2, 2) form), 11 and 12 of the kernel table in
PERF.md on the headline 3D UNet, and the JAX level gates the port does
not carry over, on the CPU in float32.

- Row 24, (2, 2, 2): the headline structure (n_blocks=4,
  start_filts=32, planar L0, batch norm with random statistics and
  affine parameters) at input (2, 4, 16, 16, 1), where L2 (2 x 4 x 4,
  C=128) is even. JAX's ``pallas_flat=True`` fuses L0, L1 and L2 there,
  so up_1 takes the carried C=128 activation of up_0 through
  ``upconv222_f64in`` and its backward through ``_upconv_f64in_bwd_call``;
  the port built with ``pallas_flat=True`` runs K3/K7 with the
  prologue at 128 -> 64, kd=2. The eval forward against both JAX
  executors and one training step against the XLA executor.
- Rows 11/12: at input (2, 3, 12, 16, 1) L1 (3 x 6 x 8) has an odd
  depth under the (2, 2, 2) pool and declines in both frameworks, so the
  L0 decoder takes L1's dense 64-channel output: JAX through
  ``upconv_bn_flat`` (row 11) and ``_upconv_bwd`` (row 12), the port
  through K3/K7 from a dense input, kd=1, into 32 channels. One training
  step and the eval forward against both JAX executors.
- The JAX gates that model the TPU and not the function (the
  ``pallas_flat='auto'`` backend and dtype test, the C=32 executor's
  ``W % 8`` and row bound, the 2D H-tiling, the decoder carry's
  ``(W // 2) % 2``): at a shape where each binds in JAX, the port runs
  the kernels and still gives JAX's result. The scoped-VMEM gates do not
  bind in interpret mode, so every fused JAX run in these tests is such
  a shape.

Tolerances: forward 2e-4; loss 1e-5 relative, every gradient and new
running statistic within 1e-3 of its scale + 1e-6 (tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from test_torch_2d import _jax_step
from test_torch_kernels import _spy_pallas
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,
                              _port_model, _port_step, _randomize)

KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
ROW24_SHAPE = (2, 4, 16, 16, 1)
ROWS11_SHAPE = (2, 3, 12, 16, 1)


def _jax_forward(pallas_flat, v, x):
    return np.asarray(jax.jit(
        lambda v, x: junet.UNet(pallas_flat=pallas_flat, **KW).apply(
            v, x, train=False))(v, jnp.asarray(x)))


def _case(shape, rows, fused_step):
    """Variables, a batch, the JAX forwards of both executors and steps
    (the fused step only with ``fused_step``; the spy records which of
    ``rows`` the fused runs reach), and the port's step (with the
    upconv launches it makes) and eval forward, ``pallas_flat=True``."""
    rng = np.random.default_rng(61)
    x, y = _batch(rng, shape)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    v = _randomize(junet.init_unet(m_xla, shape), rng)
    crit = jloss.CEDiceLoss(1.0, 1.0)
    out = dict(v=v, shape=shape, xla=_jax_step(m_xla, v, x, y, crit),
               y_xla=_jax_forward(False, v, x))
    with pytest.MonkeyPatch.context() as mp:
        out["seen"] = _spy_pallas(mp, rows)
        out["y_fused"] = _jax_forward(True, v, x)
        if fused_step:
            out["fused"] = _jax_step(junet.UNet(pallas_flat=True, **KW), v,
                                     x, y, crit)
    m = _port_model(v, pallas_flat=True, **KW)
    out["plan"] = m.plan(shape)
    with torch.no_grad():      # before the step updates the statistics
        out["y_port"] = m.eval()(torch.from_numpy(x)).numpy()
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        fn = fused.upconv_bnact

        def counted(*a, **k):
            calls.append((tuple(a[0].shape), a[1] is not None))
            return fn(*a, **k)
        mp.setattr(fused, "upconv_bnact", counted)
        out["port"] = _port_step(m, v, x, y, ploss.CEDiceLoss(1.0, 1.0))
    out["calls"] = set(calls)
    return out


def _check_step(port, ref, what):
    if what == "loss":
        assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    elif what == "grads":
        _assert_trees(port[1], ref[1])
    else:
        _assert_trees(port[2], ref[2])


def _check_forward(out, ref):
    y = out["y_port"]
    assert y.shape == ref.shape == out["shape"][:-1] + (2,)
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


# ---------------------------------------------------------------------------
# Row 24, (2, 2, 2): the carried C=128 activation into the C=64 level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def row24():
    return _case(ROW24_SHAPE, {"upconv222_f64in"}, fused_step=False)


def test_jax_fused_forward_reaches_row_24_222(row24):
    assert row24["seen"] == {"upconv222_f64in"}


def test_port_row24_plan_and_upconv_launches(row24):
    """L0, L1 and L2 on the kernels: up_0 takes L3's dense output, up_1
    the carried C=128 activation (kd=2, with the prologue), up_2 the
    carried C=64 one."""
    assert row24["plan"] == [True, True, True, False]
    assert row24["calls"] == {((2, 1, 2, 2, 256), False),
                              ((2, 2, 4, 4, 128), True),
                              ((2, 4, 8, 8, 64), True)}


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
def test_port_row24_forward_matches_jax(row24, executor):
    _check_forward(row24, row24["y_fused" if executor == "pallas_flat=True"
                                else "y_xla"])


@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_row24_train_step_matches_jax(row24, what):
    """Against the XLA executor; JAX's backward of the (2, 2, 2) carry
    (``_upconv_f64in_bwd_call``) is held against the port's plain K7 in
    tests/test_torch_sf64.py."""
    _check_step(row24["port"], row24["xla"], what)


# ---------------------------------------------------------------------------
# Rows 11/12: the (1, 2, 2) upconv from L1's dense output into C=32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows11():
    return _case(ROWS11_SHAPE, {"upconv_bn_flat", "_upconv_bwd"},
                 fused_step=True)


def test_jax_fused_step_reaches_rows_11_12(rows11):
    assert rows11["seen"] == {"upconv_bn_flat", "_upconv_bwd"}


def test_port_rows11_12_plan_and_upconv_launches(rows11):
    """L1 declines (odd depth 3 under the (2, 2, 2) pool); the L0
    decoder's upconv takes its dense 64-channel output, no prologue."""
    assert rows11["plan"] == [True, False, False, False]
    assert rows11["calls"] == {((2, 3, 6, 8, 64), False)}


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
def test_port_rows11_12_forward_matches_jax(rows11, executor):
    _check_forward(rows11, rows11["y_fused" if executor == "pallas_flat=True"
                                  else "y_xla"])


@pytest.mark.parametrize("executor", ["pallas_flat=True",
                                      "pallas_flat=False"])
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_port_rows11_12_train_step_matches_jax(rows11, executor, what):
    _check_step(rows11["port"], rows11["fused" if executor ==
                                       "pallas_flat=True" else "xla"], what)


# ---------------------------------------------------------------------------
# JAX gates that the port does not carry over
# ---------------------------------------------------------------------------

_KW2D = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
             dim=2, normalization="batch")
# gate -> (model kwargs, input shape, the JAX decline reason at level 0
# (None: JAX takes the kernels, tiled), the port's plan)
GATES = {
    "auto-backend": (KW, (1, 4, 12, 16, 1), "backend is not TPU",
                     [True, True, False, False]),
    "w8": (KW, (1, 4, 12, 20, 1), "not 8-aligned",
           [True, True, False, False]),
    "rows-bound": (KW, (1, 2, 216, 64, 1), "VMEM working set too large",
                   [True, True, False, False]),
    "2d-h-tiling": (_KW2D, (1, 400, 32, 1), None, [True, True, False]),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_dropped_tpu_gate_keeps_jax_result(gate):
    """``auto-backend``: JAX's 'auto' runs every level on XLA off the
    TPU, the port's 'auto' its kernels. ``w8``: L0 W=20 is even but not
    8-aligned. ``rows-bound``: L0's per-chunk rows (216 x 17) exceed the
    C=32 executor's eval bound of 3400. At each, JAX declines L0 with
    the reason named, and the port's eval forward (kernel plan) equals
    JAX's. ``2d-h-tiling``: a 2D image whose L0 rows exceed the bound;
    JAX runs the kernels on H-slabs with halos (``pallas_flat=True``,
    interpret mode), the port on the whole image, and both agree."""
    kw, shape, reason, plan = GATES[gate]
    rng = np.random.default_rng(67)
    v = _randomize(junet.init_unet(junet.UNet(pallas_flat=False, **kw),
                                   shape), rng)
    x = rng.normal(size=shape).astype(np.float32)
    auto = gate == "auto-backend"
    jm = junet.UNet(pallas_flat="auto" if auto else True, **kw)
    planar = kw.get("dim", 3) == 2 or 0 in kw.get("planar_blocks", ())
    D, H, W = (1,) + shape[1:3] if kw.get("dim", 3) == 2 else shape[1:4]
    if reason is None:
        assert jm._plan_tile2d(H, W, train=False) not in (0, H)
    else:
        assert reason in jm._fused_decline_reason(planar, 32, H, W, D, True,
                                                  train=False)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    m = _port_model(v, **kw) if auto else \
        _port_model(v, pallas_flat=True, **kw)
    assert m.plan(shape) == plan
    with torch.no_grad():
        y = m.eval()(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


def test_carry_width_gate_never_binds_between_kernel_levels():
    """JAX keeps a C=128 (or 64) decoder carry in flat form only if
    ``(W // 2) % 2 == 0`` at the level it feeds. ``W // 2`` is the
    deeper level's width, which the kernel plan already requires to be
    even, so under every plan where both levels run the kernels the
    condition holds and the port's carry is JAX's."""
    m = UNet(device="meta", pallas_flat=True, **KW)
    for d in (2, 4, 6):
        for h in range(2, 40, 2):
            for w in range(2, 40, 2):
                kernels = m.plan((1, d, h, w, 1))
                ws = [w]
                for i in range(m.n_blocks - 1):
                    ws.append(-(-ws[-1] // 2))
                for i in range(m.n_blocks - 1):
                    if kernels[i] and kernels[i + 1]:
                        assert (ws[i] // 2) % 2 == 0, (d, h, w, i)
