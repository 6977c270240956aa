"""The port's ``bn_update`` and ``recalibrate_bn`` against the JAX
package's ``bn_update``, on the CPU in float32.

A small UNet (n_blocks=2, start_filts=32, planar L0, batch norm with
random statistics and affine parameters) whose L0 runs the port's kernel
ops (their plain versions on the CPU); JAX at ``pallas_flat=False`` on
the converted parameters. Three batches of (2, 4, 12, 16, 1): every
running mean and variance within 1e-4 of its leaf's scale (the raw
statistics come back from the momentum update, which multiplies the
rounding of each by 10), over all batches and over the first two.
``recalibrate_bn`` returns a recalibrated copy and leaves the model as
it was; a model without batch norm comes back unchanged, and the model's
mode is restored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.training import optim as joptim
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.training import bn_update, recalibrate_bn

SHAPE = (2, 4, 12, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
TOL = 1e-4


def _randomize(variables, rng):
    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "keys"):
                out[k] = walk(v, kind)
                continue
            v = np.asarray(v)
            if kind == "params" and k == "bias":
                v = 0.1 * rng.normal(size=v.shape)
            elif k == "scale":
                v = rng.normal(size=v.shape)
            elif k == "mean":
                v = 0.2 * rng.normal(size=v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, size=v.shape)
            out[k] = jnp.asarray(v, jnp.float32)
        return out
    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(8)
    jmodel = junet.UNet(pallas_flat=False, **KW)
    v = jax.device_get(_randomize(junet.init_unet(jmodel, SHAPE), rng))
    loader = [{"inp": (1 + i) * rng.normal(size=SHAPE).astype(np.float32)}
              for i in range(3)]
    return jmodel, v, loader


def _port(v):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(v, m))
    return m.eval()


def _assert_stats(model, v, ref):
    got = _leaves(flax_from_state_dict(model.state_dict(), v,
                                       ("batch_stats",))["batch_stats"])
    ref = _leaves(ref)
    assert got.keys() == ref.keys() and len(ref) == 14
    for k in ref:
        err = float(np.max(np.abs(got[k] - ref[k])))
        assert err <= TOL * float(np.max(np.abs(ref[k]))), (k, err)


@pytest.mark.parametrize("max_batches", [None, 2])
def test_bn_update_matches_jax(setup, max_batches):
    jmodel, v, loader = setup
    ref = joptim.bn_update(loader, jmodel.apply, v["params"],
                           v["batch_stats"], max_batches=max_batches)
    model = _port(v)
    assert model.level_kinds(SHAPE)[0] == "kernels"
    assert bn_update(loader, model, max_batches=max_batches) is model
    assert not model.training
    _assert_stats(model, v, jax.device_get(ref))
    # the statistics did move
    before = _leaves(v["batch_stats"])
    after = _leaves(flax_from_state_dict(model.state_dict(), v,
                                         ("batch_stats",))["batch_stats"])
    assert all(np.max(np.abs(after[k] - before[k])) > 1e-3 for k in before)


def test_recalibrate_bn_returns_a_recalibrated_copy(setup):
    jmodel, v, loader = setup
    model = _port(v).train()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    copy = recalibrate_bn(model, loader)
    assert copy is not model and copy.training
    assert all(torch.equal(before[k], t)
               for k, t in model.state_dict().items())
    ref = _port(v)
    bn_update(loader, ref)
    a, b = copy.state_dict(), ref.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bn_update_leaves_a_group_norm_model_unchanged(setup):
    _, _, loader = setup
    model = UNet(device="cpu", **{**KW, "normalization": "group"})
    before = {k: t.clone() for k, t in model.state_dict().items()}
    assert bn_update(loader, model) is model
    assert all(torch.equal(before[k], t)
               for k, t in model.state_dict().items())
