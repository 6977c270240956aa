"""The port's 2D U-Net (``UNet(dim=2)``) with group and instance norm on
the kernels' per-sample mode against the JAX package's, on the CPU in
float32: rows 16 and 17 (the C=64 executor's (1, 2, 2) pool and its
backward) and 19 and 20 (its (1, 2, 2) upconv from the library bottom's
dense output and its backward) of the kernel table in PERF.md, and the
C=32 rows the 2D model's first level runs, all per sample.

- The model of examples/train_simple2d.py cut to three levels
  (start_filts 32: L0 C=32 and L1 C=64 on the kernels, the C=128 bottom
  on the library) at input (2, 8, 16, 1) with 'group' and 'instance',
  random affine parameters, the port built with ``pallas_flat=True``:
  its levels (the same under 'auto'), its eval forward against JAX's
  ``pallas_flat=True`` forward (its training forward, the same function
  for a norm without running state; 2e-4, as tests/test_torch_2d.py),
  and one training step against JAX's fused step (loss within 1e-5
  relative, every gradient within 1e-3 of its leaf's scale + 1e-6, as
  tests/test_torch_train.py). A spy on ``pallas_call`` shows that JAX's
  step reached rows 16, 17, 19 and 20; the port's ops took (B, C)
  prologue vectors and gave per-sample statistics.
- The Predictor of the kernel plan, whole and tiled, against JAX's
  Predictor of its XLA executor on the same parameters (1e-4 of the
  probabilities), and the argmax output.
- ``vup=True`` on the 2D group model against ``vup=False``: the forward
  bit for bit, every gradient within 1e-4 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.ops import fused
from test_torch_2d import ROWS, TILED
from test_torch_group_norm import _close, _jax_tree, _seeded_port
from test_torch_kernels import _spy_pallas
from test_torch_train import LOSS_RTOL, _assert_trees, _batch
from test_torch_vup import _step

SHAPE = (2, 8, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32, dim=2)
NORMS = ("group", "instance")
KINDS = ["kernels", "kernels", "library"]


@pytest.fixture(scope="module")
def models():
    """For each norm: random parameters, JAX's ``pallas_flat=True``
    fused step and its forward (the spy recording rows 16, 17, 19 and
    20), and the port's eval forward and step (its kernel ops' calls
    recorded: the first input's shape and whether the prologue was per
    sample)."""
    rng = np.random.default_rng(41)
    x, y = _batch(rng, SHAPE)
    out = {"x": x, "y": y}
    crit = jloss.CEDiceLoss(1.0, 1.0)
    for i, norm in enumerate(NORMS):
        kw = dict(KW, normalization=norm)
        m0 = _seeded_port(80 + i, **kw)
        jf = junet.UNet(pallas_flat=True, **kw)
        v = jax.tree_util.tree_map(
            jnp.asarray, flax_from_state_dict(m0.state_dict(),
                                              _jax_tree(jf, SHAPE),
                                              ("params",)))

        def loss_fn(p):
            o = jf.apply({"params": p}, jnp.asarray(x), train=True)
            return crit(o, jnp.asarray(y)).astype(jnp.float32), o
        with pytest.MonkeyPatch.context() as mp:
            seen = _spy_pallas(mp, ROWS)
            (jl, y_jax), jg = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v["params"])
        m = UNet(device="cpu", pallas_flat=True, **kw)
        m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
        with torch.no_grad():
            y_port = m.eval()(torch.from_numpy(x)).numpy()
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for name in ("conv_bnact", "pool_bnact", "upconv_bnact"):
                def counted(*a, _fn=getattr(fused, name), _name=name, **k):
                    x0 = a[0][0] if _name == "conv_bnact" else a[0]
                    calls.append((_name, tuple(x0.shape),
                                  a[1] is not None and a[1].dim() == 2,
                                  k.get("want_stats", False)))
                    return _fn(*a, **k)
                mp.setattr(fused, name, counted)
            m.train()
            loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                              torch.from_numpy(y).long())
            loss.backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        kinds = {pf: UNet(device="meta", pallas_flat=pf, **kw)
                 .level_kinds(SHAPE) for pf in (True, "auto")}
        out[norm] = dict(
            v=v, seen=seen, y_jax=np.asarray(y_jax), y_port=y_port,
            jax_step=(float(jl), jg), port_step=(float(loss.detach()), grads),
            calls=calls, kinds=kinds)
    return out


@pytest.mark.parametrize("norm", NORMS)
def test_jax_2d_group_step_reaches_rows_16_17_19_20(models, norm):
    assert models[norm]["seen"] == ROWS


@pytest.mark.parametrize("norm", NORMS)
def test_port_2d_group_level_kinds(models, norm):
    """L0 and L1 on the kernels under ``pallas_flat=True`` and 'auto'
    alike: a group norm no longer sends a 2D level to the library."""
    assert models[norm]["kinds"] == {True: KINDS, "auto": KINDS}


@pytest.mark.parametrize("norm", NORMS)
def test_port_2d_group_forward_matches_jax(models, norm):
    r = models[norm]
    assert r["y_port"].shape == r["y_jax"].shape == SHAPE[:-1] + (2,)
    err = np.max(np.abs(r["y_port"] - r["y_jax"]))
    assert err <= 2e-4, err


@pytest.mark.parametrize("norm", NORMS)
def test_port_2d_group_step_matches_jax(models, norm):
    r = models[norm]
    (loss, grads), (jl, jg) = r["port_step"], r["jax_step"]
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl), (loss, jl)
    _assert_trees(flax_from_state_dict(grads, r["v"], ("params",))
                  ["params"], jg)


@pytest.mark.parametrize("norm", NORMS)
def test_port_2d_group_step_runs_per_sample_ops(models, norm):
    """On the D=1 view: 8 convs, every one asking for per-sample
    statistics and each with a prologue taking it per sample; the L0 and
    L1 pools with (B, C) prologues (the L1 pool at C=64, row 16); the
    up_1 upconv from the bottom's dense 128 channels (row 19) and the
    up_0 upconv from the carried C=64 activation with a (B, C)
    prologue."""
    calls = models[norm]["calls"]
    convs = [c for c in calls if c[0] == "conv_bnact"]
    assert len(convs) == 8 and len(calls) == 12
    assert all(c[3] == fused.PER_SAMPLE for c in convs)
    assert sum(c[2] for c in convs) == 6   # conv1 of L0 and L1: none
    assert ("pool_bnact", (2, 1, 8, 16, 32), True, False) in calls
    assert ("pool_bnact", (2, 1, 4, 8, 64), True, False) in calls
    assert ("upconv_bnact", (2, 1, 2, 4, 128), False,
            fused.PER_SAMPLE) in calls
    assert ("upconv_bnact", (2, 1, 4, 8, 64), True,
            fused.PER_SAMPLE) in calls


IMAGE = (1, 1, 32, 32)


@pytest.fixture(scope="module")
def predictors():
    """The port's kernel-plan group model and JAX's XLA one on the same
    parameters, and an image."""
    kw = dict(KW, normalization="group")
    m = _seeded_port(85, pallas_flat=True, **kw)
    jm = junet.UNet(pallas_flat=False, **kw)
    v = jax.tree_util.tree_map(
        np.asarray, flax_from_state_dict(m.state_dict(),
                                         _jax_tree(jm, (1, 32, 32, 1)),
                                         ("params",)))
    img = np.random.default_rng(9).normal(size=IMAGE).astype(np.float32)
    return m, jm, v, img


@pytest.mark.parametrize("mode", ["whole", "tiled"])
def test_predictor_2d_group_matches_jax(predictors, mode):
    m, jm, v, img = predictors
    kw = TILED if mode == "tiled" else {}
    assert m.level_kinds((3, 16, 16, 1) if kw else (1, 32, 32, 1)) == KINDS
    ref = np.asarray(JaxPredictor(jm, v, **kw).predict(img), np.float32)
    out = Predictor(m, **kw).predict(img)
    assert out.shape == ref.shape == (1, 2) + IMAGE[2:]
    assert np.max(np.abs(out - ref)) <= 1e-4


def test_predictor_2d_group_argmax_matches_jax(predictors):
    m, jm, v, img = predictors
    ref = JaxPredictor(jm, v, argmax_with_threshold=True,
                       **TILED).predict(img)
    out = Predictor(m, argmax_with_threshold=True, **TILED).predict(img)
    assert out.dtype == np.uint8 and out.shape == ref.shape == \
        (1, 1) + IMAGE[2:]
    probs = Predictor(m, **TILED).predict(img)
    ambiguous = np.abs(probs[:, 1:2] - 0.5) < 1e-5
    assert np.all((out == ref) | ambiguous)


def test_2d_vup_group_matches_vup_false():
    """The 2D group model with ``vup`` on (up_0's merge recomputes the
    upconv of L1's carry through the per-sample vup ops) and off: the
    training and eval forwards bit for bit, every gradient within 1e-4
    of its scale (conv biases before a group norm aside: their exact
    gradient is 0)."""
    rng = np.random.default_rng(93)
    shape = (2, 8, 12, 1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 2, size=shape[:-1])).long()
    runs = []
    for on in (False, True):
        m = _seeded_port(95, vup=on, pallas_flat=True,
                         **dict(KW, normalization="group"))
        yt, g = _step(m, x, t)
        with torch.no_grad():
            e = m.eval()(x)
        runs.append((yt, g, e))
    (y0, g0, e0), (y1, g1, e1) = runs
    assert torch.equal(y0, y1) and torch.equal(e0, e1)
    for n in g0:
        if n.endswith(".bias") and ".conv" in n and "conv_final" not in n:
            continue
        _close(g1[n], g0[n].numpy(), "float32")
