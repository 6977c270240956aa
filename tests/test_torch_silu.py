"""The port's semi-fused flat executor (the UNet's 'flat' levels) against
the JAX package's, on the CPU in float32, and the N * D repair of K1/K4.

- Model level: ``UNet(n_blocks=3, start_filts=32, activation='silu',
  pallas_flat=True)`` with batch norm (random statistics and affine
  parameters) at input (2, 4, 16, 16, 1), with ``planar_blocks=(0,)``
  (the headline structure: L0 (4 x 16 x 16, C=32) and its decoder level
  flat, L1 (C=64, kd=3) and the bottom L2 (C=128) on the library) and
  ``(0, 1)`` (L1 planar at C=64: a flat C=64 level with its 64+64
  merge). JAX's ``pallas_flat=True`` runs the same levels on its flat
  executor (``flat_conv3`` and ``_wgrad`` in interpret mode, the spy
  sees them), the port on ``ops/flat_conv.flat_conv3`` (K1/K4/K5's
  plain versions). The bottom level's batch norm holds 64 and 128
  voxels (a handful of voxels there makes the step's gradients differ
  between executors by rounding alone; see tests/test_torch_sf64.py).
  Bounds of tests/test_torch_train.py: the eval forward within 2e-4,
  the training step's output within 2e-4, its loss within 1e-5
  relative, every gradient and new running statistic within 1e-3 of its
  scale + 1e-6; one bf16 eval forward within 5e-2 of max|ref|. The
  converter carries JAX's flat tree both ways exactly. ``level_kinds``
  says 'flat' exactly where JAX's ``_flat_level_ok`` holds, and
  'library' under 'auto', 'batchp' and ``pallas_flat=False``.
- N * D: the shape (2, 32768, 2, 2, 1) puts 65,536 (n, depth) slabs
  on L0's kernel level under 'auto', which K1's contract refused; it now
  runs and equals ``pallas_flat=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.models.torch_import import load_torch_state_dict
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from test_torch_kernels import _spy_pallas
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,
                              _port_model, _randomize)

SHAPE = (2, 4, 16, 16, 1)
BASE = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
            normalization="batch", activation="silu")
CONFIGS = {"planar0": (0,), "planar01": (0, 1)}
ROWS = {"conv_flat", "_wgrad"}
FWD_TOL = 2e-4


def _kw(config, **extra):
    return dict(BASE, planar_blocks=CONFIGS[config], **extra)


def _jax_train(model, v, x, y, crit):
    """(loss, grads, new batch_stats, logits) of one JAX training step."""
    def loss_fn(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32), \
            (mut["batch_stats"], out)
    (loss, (bs, out)), g = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    return float(loss), g, bs, np.asarray(out)


def _port_train(m, v, x, y):
    """The same for the port's model, both trees in flax layout; also
    the shapes of the conv_bnact calls (K1) the step made."""
    calls = []
    real = fused.conv_bnact

    def counted(xs, inv, *a, **k):
        calls.append((tuple(tuple(t.shape) for t in xs), inv is None))
        return real(xs, inv, *a, **k)
    m.train()
    m.zero_grad()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "conv_bnact", counted)
        out = m(torch.from_numpy(x))
        loss = ploss.CEDiceLoss(1.0, 1.0)(out, torch.from_numpy(y).long())
        loss.backward()
    grads = flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, v, ("params",))
    bs = flax_from_state_dict(m.state_dict(), v, ("batch_stats",))
    return (float(loss.detach()), grads["params"], bs["batch_stats"],
            out.detach().numpy(), calls)


@pytest.fixture(scope="module")
def runs():
    """Per config: the JAX flat executor's eval forward and training
    step (each computed once: its interpret-mode gradient takes most of
    this file's time) and the port's, from the same variables."""
    res = {}
    for i, config in enumerate(CONFIGS):
        kw = _kw(config)
        rng = np.random.default_rng(83 + i)
        x, y = _batch(rng, SHAPE)
        v = _randomize(junet.init_unet(junet.UNet(pallas_flat=False, **kw),
                                       SHAPE), rng)
        jm = junet.UNet(pallas_flat=True, **kw)
        with pytest.MonkeyPatch.context() as mp:
            seen = _spy_pallas(mp, ROWS)
            y_eval = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
            step = _jax_train(jm, v, x, y, jloss.CEDiceLoss(1.0, 1.0))
        pm = _port_model(v, pallas_flat=True, **kw).eval()
        with torch.no_grad():
            p_eval = pm(torch.from_numpy(x)).numpy()
        res[config] = dict(v=v, x=x, seen=seen, jm=jm, y_eval=y_eval,
                           step=step, p_eval=p_eval,
                           p_step=_port_train(pm, v, x, y))
    return res


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_silu_flat_step_reaches_rows_26_27(runs, config):
    assert runs[config]["seen"] == ROWS


@pytest.mark.parametrize("config", list(CONFIGS))
def test_port_silu_forward_matches_jax(runs, config):
    ref, got = runs[config]["y_eval"], runs[config]["p_eval"]
    assert got.shape == ref.shape == SHAPE[:-1] + (2,)
    assert np.max(np.abs(got - ref)) <= FWD_TOL, np.max(np.abs(got - ref))


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("what", ["output", "loss", "grads", "batch_stats"])
def test_port_silu_train_step_matches_jax(runs, config, what):
    loss, grads, bs, out = runs[config]["step"]
    ploss_, pgrads, pbs, pout, _ = runs[config]["p_step"]
    if what == "output":
        assert np.max(np.abs(pout - out)) <= FWD_TOL
    elif what == "loss":
        assert abs(ploss_ - loss) <= LOSS_RTOL * abs(loss)
    elif what == "grads":
        _assert_trees(pgrads, grads)
    else:
        _assert_trees(pbs, bs)


@pytest.mark.parametrize("config,convs", [
    ("planar0", [((2, 4, 16, 16, 32),), ((2, 4, 16, 16, 32),) * 2,
                 ((2, 4, 16, 16, 32),)]),
    ("planar01", [((2, 4, 16, 16, 32),), ((2, 4, 8, 8, 64),),
                  ((2, 4, 8, 8, 64),) * 2, ((2, 4, 8, 8, 64),),
                  ((2, 4, 16, 16, 32),) * 2, ((2, 4, 16, 16, 32),)])])
def test_port_silu_step_runs_flat_conv3_on_k1(runs, config, convs):
    """Each flat level's conv2 and its decoder's merge conv and conv2 go
    through ``conv_bnact`` with the identity prologue (K1, K4, K5 on the
    card), in forward order; nothing else does."""
    calls = runs[config]["p_step"][4]
    assert [c[0] for c in calls] == convs
    assert all(c[1] for c in calls)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_converter_round_trip_silu_flat_tree_is_exact(runs, config):
    """JAX's flat executor keeps the XLA path's parameter tree
    (``conv1``, ``conv2``, ``upconv``, ``BatchNorm_<n>``): the tree goes
    to the port and back bit for bit."""
    kw = _kw(config)
    v = jax.device_get(runs[config]["v"])
    flat_shapes = jax.eval_shape(
        lambda: junet.init_unet(junet.UNet(pallas_flat=True, **kw), SHAPE))
    assert jax.tree_util.tree_map(np.shape, flat_shapes) == \
        jax.tree_util.tree_map(np.shape, v)
    sd = state_dict_from_flax(v, UNet(device="cpu", **kw))
    back = load_torch_state_dict(sd, junet.UNet(pallas_flat=True, **kw),
                                 variables=v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        assert np.array_equal(np.asarray(a), np.asarray(flat_b[path])), path


@pytest.mark.parametrize("config", list(CONFIGS))
def test_level_kinds_flat_where_jax_flat_level_ok(runs, config):
    """'flat' exactly where JAX's ``_flat_level_ok`` holds (its fused
    executors decline every silu level), 'library' elsewhere and under
    'auto', 'batchp' and ``pallas_flat=False``; ``plan`` (the kernel
    levels) stays all False."""
    jm = runs[config]["jm"]
    kinds = UNet(device="meta", **_kw(config, pallas_flat=True)) \
        .level_kinds(SHAPE)
    hw = [SHAPE[2] >> i for i in range(BASE["n_blocks"])]
    jax_flat = [jm._flat_level_ok(i in CONFIGS[config],
                                  BASE["start_filts"] * 2 ** i, h, h)
                for i, h in enumerate(hw)]
    assert kinds == ["flat" if f else "library" for f in jax_flat]
    assert kinds[0] == "flat"
    for extra in (dict(pallas_flat="auto"), dict(pallas_flat=False),
                  dict(pallas_flat=True, normalization="batchp")):
        m = UNet(device="meta", **dict(_kw(config), **extra))
        assert m.level_kinds(SHAPE) == ["library"] * 3
        assert m.plan(SHAPE) == [False] * 3


@pytest.mark.parametrize("act", ["silu", "swish", "gelu", "tanh"])
def test_headline_level_kinds_by_activation(act):
    """The headline model at bench.py's shape: L0 flat for each
    activation without a kernel prologue, the kernel plan for relu
    unchanged, no flat level at an odd H, and none in 2D."""
    kw = dict(n_blocks=4, start_filts=32, planar_blocks=(0,),
              pallas_flat=True, device="meta")
    bench = (8, 44, 88, 88, 1)
    assert UNet(activation=act, **kw).level_kinds(bench) == \
        ["flat", "library", "library", "library"]
    assert UNet(activation=act, **kw).level_kinds((8, 44, 87, 88, 1)) == \
        ["library"] * 4
    assert UNet(activation="relu", **kw).level_kinds(bench) == \
        ["kernels", "kernels", "kernels", "library"]
    assert UNet(activation=act, dim=2, **kw).level_kinds((8, 64, 64, 1)) \
        == ["library"] * 4


def test_port_silu_bf16_forward_matches_jax(runs):
    """The first config in bfloat16 (eval): the JAX flat executor and the
    port's flat levels round at other points; within 5e-2 of max|ref|."""
    kw = _kw("planar0")
    v, x = runs["planar0"]["v"], runs["planar0"]["x"]
    ref = np.asarray(junet.UNet(pallas_flat=True, dtype=jnp.bfloat16, **kw)
                     .apply(v, jnp.asarray(x), train=False)
                     .astype(jnp.float32))
    pm = _port_model(v, pallas_flat=True, dtype=torch.bfloat16, **kw).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    err = np.max(np.abs(got.float().numpy() - ref))
    assert err <= 5e-2 * np.max(np.abs(ref)), err


def test_kernel_level_runs_past_65535_depth_slabs():
    """N * D = 65,536 on L0's kernel level under 'auto' (K1's contract
    refused N * D > 65535) equals the all-library plan."""
    m = UNet(n_blocks=2, planar_blocks=(0,), device="cpu",
             generator=torch.Generator().manual_seed(3)).eval()
    x = torch.randn((2, 32768, 2, 2, 1),
                    generator=torch.Generator().manual_seed(4))
    assert m.plan(x.shape) == [True, False]
    with torch.no_grad():
        y = m(x)
        m.pallas_flat = False
        ref = m(x)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 1e-4 * scale
