"""The network input's gradient: the port's ``UNet(input_grad=...)``
against the JAX package's ``UNet(input_grad=...)`` on the CPU in
float32, the gradient of one training step's loss with respect to the
input (``jax.grad`` on the JAX side, in Pallas interpret mode under
``pallas_flat=True``; ``x.grad`` on the port's, whose kernel ops take
their plain versions on the CPU).

JAX gives the input a zero gradient where it runs its fused first conv
(``_Conv1FusedFlat``: a one-channel input of W <= 128 on its C=32
executor, not H-tiled) with ``input_grad=False``, and the real one
everywhere else. Both sides of that predicate:

- the headline structure (n_blocks=4, start_filts=32, planar L0, batch
  norm with random statistics and affine parameters) at (2, 4, 12, 16,
  1): zeros under False, the real gradient under True, and JAX reaches
  ``_conv1_bwd`` in both;
- a one-level model, whose only level the port runs on the library ops
  (JAX on its fused executor): zeros under False;
- the 2D model at W = 136 > 128 (JAX's C=32 executor runs L0, with its
  conv1 on XLA, ``_Im2colConv``) and the start_filts=64 model (JAX's
  C=64 executor takes the input itself, ``_FusedConv64(cin_real=1)``),
  two levels deep: the real gradient under False.

The predicate itself (``UNet._conv1_input_grad``, and the 2D H-tiling
plan it copies) against the JAX UNet's own methods over a grid of
shapes; row 13's plain backward with ``input_grad=True`` against
``jax.vjp`` of ``conv1_bnstats_flat`` is in tests/test_torch_kernels.py.

Tolerance: each gradient within 1e-3 of its own scale plus 1e-6
(tests/test_torch_train.py's leaf tolerance; the two frameworks sum in
other orders through the whole network).
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
from test_torch_kernels import _spy_pallas
from test_torch_train import (LEAF_ATOL, LEAF_TOL, _batch, _port_model,
                              _randomize)

KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
# The cases outside the predicate, two levels deep (the predicate reads
# L0 alone; a shallower model keeps interpret mode's compile short).
SF64 = dict(KW, n_blocks=2, start_filts=64)
KW2D = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
            dim=2, normalization="batch")


def _jax_input_grad(kw, input_grad, v, x, y):
    """d loss / d x of one JAX training step under pallas_flat=True."""
    model = junet.UNet(pallas_flat=True, input_grad=input_grad, **kw)
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(x):
        out, _ = model.apply(v, x, train=True, mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32)
    return np.asarray(jax.jit(jax.grad(loss_fn))(jnp.asarray(x)))


def _port_input_grad(kw, input_grad, v, x, y):
    m = _port_model(v, pallas_flat=True, input_grad=input_grad, **kw)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ploss.CEDiceLoss(1.0, 1.0)(m.train()(xt),
                                      torch.from_numpy(y).long())
    loss.backward()
    return xt.grad.numpy(), m._conv1_input_grad(x.shape)


def _close(port, ref):
    assert port.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    err = float(np.max(np.abs(port - ref)))
    assert err <= LEAF_TOL * scale + LEAF_ATOL, (err, scale)


def _case(kw, shape, seed):
    rng = np.random.default_rng(seed)
    x, y = _batch(rng, shape)
    v = _randomize(junet.init_unet(junet.UNet(pallas_flat=False, **kw),
                                   shape), rng)
    return v, x, y


@pytest.fixture(scope="module")
def headline():
    return _case(KW, (2, 4, 12, 16, 1), 71)


@pytest.mark.parametrize("input_grad", [False, True])
def test_headline_input_grad_matches_jax(headline, input_grad, monkeypatch):
    """W = 16 <= 128: JAX's fused conv1 (row 13) runs and gives zeros
    under False, dx under True; so does the port."""
    v, x, y = headline
    seen = _spy_pallas(monkeypatch, {"_conv1_bwd"})
    ref = _jax_input_grad(KW, input_grad, v, x, y)
    assert seen == {"_conv1_bwd"}
    got, real = _port_input_grad(KW, input_grad, v, x, y)
    assert real == input_grad
    if input_grad:
        _close(got, ref)
    else:
        assert not np.any(ref) and not np.any(got)


@pytest.mark.parametrize("kw,shape", [(SF64, (2, 2, 8, 16, 1)),
                                      (KW2D, (1, 8, 136, 1))],
                         ids=["sf64", "2D-W136"])
def test_input_grad_outside_the_fused_conv1_is_real(kw, shape, monkeypatch):
    """Outside JAX's fused conv1 (the C=64 executor; the 2D model at
    W > 128) the input's gradient is the real one under the default
    ``input_grad=False``, in JAX and in the port. (The other gates of the
    predicate, W % 8 and the row bound among them, are held against JAX's
    own methods below: at such shapes JAX's float32 gradients run through
    its fast-variance batch norm, e.g. 1% off a float64 reference at
    (2, 2, 12, 20) with two levels, where the port's are within 1e-6.)"""
    v, x, y = _case(kw, shape, 72)
    seen = _spy_pallas(monkeypatch, {"_conv1_bwd"})
    ref = _jax_input_grad(kw, False, v, x, y)
    assert seen == set()
    got, real = _port_input_grad(kw, False, v, x, y)
    assert real
    _close(got, ref)


def test_library_first_level_input_grad_matches_jax():
    """A one-level model: the port runs its only (bottom) level on the
    library ops, JAX runs it on its fused C=32 executor with the fused
    conv1, so under False both give the input a zero gradient."""
    kw = dict(KW, n_blocks=1)
    v, x, y = _case(kw, (1, 2, 8, 16, 1), 73)
    ref = _jax_input_grad(kw, False, v, x, y)
    got, real = _port_input_grad(kw, False, v, x, y)
    assert UNet(device="cpu", pallas_flat=True, **kw).level_kinds(
        x.shape) == ["library"]
    assert not real and not np.any(ref) and not np.any(got)


# (H, W) of a training input: around W = 128, the W % 8 gate, the row
# bound H * ((W + 4) // 4) <= 3000, and the 2D H-tiling of tall images.
PREDICATE_HW = [(h, w) for h in (2, 12, 30, 88, 90, 92, 96, 100, 180, 360)
                for w in (8, 16, 20, 64, 120, 128, 130, 136)]


@pytest.mark.parametrize("dim", [2, 3])
def test_predicate_is_jaxs(dim):
    """``UNet._conv1_input_grad`` (False: the input's gradient is zero)
    against the JAX UNet's own decision at a grid of shapes: its
    ``_flat_fused_ok`` for L0 at the slab height its ``_plan_tile2d``
    gives, the 2D H-tiling, and the one-channel, W <= 128 test of
    elektronn3_tpu/models/unet.py:896-899 (pallas_flat=True, training).
    Also JAX's ``_plan_tile2d`` against the port's ``_jax_tiles_2d``."""
    kw = dict(KW2D, n_blocks=4) if dim == 2 else KW
    jm = junet.UNet(pallas_flat=True, **kw)
    pm = UNet(device="cpu", pallas_flat=True, **kw)
    seen = set()
    for h, w in PREDICATE_HW:
        tile0 = 0
        if dim == 2:
            t = jm._plan_tile2d(h, w, True)
            tile0 = t if t and t < h else 0
            assert pm._jax_tiles_2d(h, w) == bool(tile0), (h, w)
        gh = tile0 or h
        fused_conv1 = (jm._flat_fused_ok(True, 32, gh, w, train=True)
                       and w <= 128 and not tile0)
        shape = (2, h, w, 1) if dim == 2 else (2, 4, h, w, 1)
        assert pm._conv1_input_grad(shape) == (not fused_conv1), (h, w)
        seen.add((fused_conv1, bool(tile0)))
    # Both sides of the predicate, and (2D) tiled shapes, are on the grid.
    assert seen >= ({(True, False), (False, False)}
                    | ({(False, True)} if dim == 2 else set()))


def test_predicate_auto_mode_and_configs():
    """Under 'auto' JAX engages its fused executor for bf16 alone (on a
    TPU), so the gradient is zero for a bf16 model and real for a float32
    one; ``input_grad=True``, three input channels, start_filts=64, a
    non-planar L0, ``pallas_flat=False`` and a smooth activation all give
    the real gradient."""
    shape = (2, 4, 12, 16, 1)

    def real(**kw):
        return UNet(device="cpu", **{**KW, **kw})._conv1_input_grad(shape)
    assert not real(dtype=torch.bfloat16)
    assert real()
    assert not real(pallas_flat=True)
    assert real(pallas_flat=True, input_grad=True)
    assert real(pallas_flat=True, start_filts=64)
    assert real(pallas_flat=True, planar_blocks=())
    assert real(pallas_flat=False, dtype=torch.bfloat16)
    assert real(pallas_flat=True, activation="silu")
    assert UNet(device="cpu", pallas_flat=True, **{**KW, "in_channels": 3}
                )._conv1_input_grad(shape[:-1] + (3,))


@pytest.mark.parametrize("value", ["yes", 1, None, "auto"])
def test_input_grad_must_be_a_bool(value):
    with pytest.raises(ValueError, match="input_grad must be True or False"):
        UNet(device="cpu", input_grad=value)


def test_one_channel_input_with_a_gradient_runs():
    """A one-channel input with ``requires_grad=True`` used to make the
    training forward raise (K4's C_in % 32 contract); it runs now, on
    every level plan, and the parameters get the same gradients whatever
    ``input_grad`` says."""
    x0 = torch.randn(1, 8, 32, 32, 1, generator=torch.Generator()
                     .manual_seed(3))
    grads = {}
    for ig in (False, True):
        m = UNet(device="cpu", pallas_flat=True, input_grad=ig, **KW)
        x = x0.clone().requires_grad_(True)
        m.train()(x).float().square().mean().backward()
        grads[ig] = (x.grad, m.down_convs[0].conv1.weight.grad)
    assert not grads[False][0].any() and grads[True][0].abs().sum() > 0
    assert torch.allclose(grads[False][1], grads[True][1], rtol=1e-5,
                          atol=1e-6)
