"""The port's Noise2Void (``training/noise2void.py``) against the JAX
package's, on the CPU in float32.

- ``get_stratified_coords`` and ``prepare_sample`` (2D and 3D, one and
  two channels, a ``channels`` subset) give JAX's arrays, bit for bit,
  from one seed.
- ``Noise2VoidTrainer``: the same parameters (JAX's init converted; JAX
  at ``pallas_flat=False``, XLA only; a small UNet with a single input
  and output channel: n_blocks=2, start_filts=32, planar L0) under
  ``inject_hyperparams(optax.sgd)`` against ``torch.optim.SGD``, 6 fixed
  samples at batch 2, ``run(max_steps=3)``: one epoch (JAX repeats its
  order each epoch; the port's set is reindexed so that its first epoch
  visits JAX's order). Each step's masked loss within 1e-5 (relative),
  every parameter and running statistic within 1e-3 of its scale (1e-6
  absolute), ``step`` 3, and the validation loss (3 samples at batch 2,
  masked from its own ``default_rng(0)``) within 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.training import Noise2VoidTrainer as JN2V
from elektronn3_tpu.training import noise2void as jn2v
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.training import Noise2VoidTrainer
from elektronn3_tpu_torch.training import noise2void as pn2v
from test_torch_train import _assert_trees
from test_torch_trainer_multi import jax_order_view

KW = dict(in_channels=1, out_channels=1, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
SAMPLE = (1, 6, 12, 12)
LR = 0.05
RATIO = 0.02
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("shape, ratio", [((16, 20), 0.05),
                                          ((6, 12, 12), 0.02),
                                          ((5, 9, 7), 0.3)])
def test_stratified_coords_match_jax(shape, ratio):
    got = pn2v.get_stratified_coords(ratio, shape,
                                     np.random.default_rng(3))
    ref = jn2v.get_stratified_coords(ratio, shape,
                                     np.random.default_rng(3))
    assert len(got) == len(ref) == len(shape)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("shape, channels", [((1, 16, 20), None),
                                             ((2, 6, 12, 12), None),
                                             ((3, 6, 12, 12), (0, 2))])
def test_prepare_sample_matches_jax(shape, channels):
    """The same draws in the same order (per channel: coordinates, then
    shifts), so the same masked input, target and mask; a second call
    on the same generator too."""
    inp = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    rg, rj = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        got = pn2v.prepare_sample(inp, RATIO, channels, rg)
        ref = jn2v.prepare_sample(inp, RATIO, channels, rj)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    masked, target, mask = got
    assert set(np.unique(mask)) <= {0.0, 1.0} and mask.sum() > 0
    assert np.array_equal(masked[mask == 0], inp[mask == 0])
    if channels is not None:
        assert not mask[1].any()


class Raw:
    def __init__(self, n, seed):
        self.inp = np.random.default_rng(seed).normal(
            size=(n,) + SAMPLE).astype(np.float32)

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i]}


def _port_model(variables):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(variables, m))
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("n2v")
    train, valid = Raw(6, 0), Raw(3, 1)
    jtr = JN2V(junet.UNet(pallas_flat=False, **KW), criterion=None,
               optimizer=optax.inject_hyperparams(optax.sgd)(
                   learning_rate=LR),
               train_dataset=train, valid_dataset=valid, batch_size=2,
               n2v_ratio=RATIO, save_root=str(root), exp_name="jax",
               enable_tensorboard=False)
    variables = jax.device_get({"params": jtr.state.params,
                                "batch_stats": jtr.state.batch_stats})
    jstats = []
    jtrain = jtr._train

    def recorded(*a, **k):
        stats, misc = jtrain(*a, **k)
        jstats.append(stats)
        return stats, misc
    jtr._train = recorded
    jtr.run(max_steps=3)
    m = _port_model(variables)
    ptr = Noise2VoidTrainer(
        m, None, optimizer=torch.optim.SGD(m.parameters(), lr=LR),
        train_dataset=jax_order_view(train), valid_dataset=valid,
        batch_size=2, n2v_ratio=RATIO, save_root=str(root),
        exp_name="port", enable_tensorboard=False, nan_check_interval=1)
    ptr.run(max_steps=3)
    return dict(jtr=jtr, ptr=ptr, variables=variables, jstats=jstats)


def test_step_losses_match_jax(runs):
    got = np.array(runs["ptr"].last_stats["tr_loss"])
    ref = np.array(runs["jstats"][0]["tr_loss"])
    assert got.shape == ref.shape == (3,)
    assert np.all(np.abs(got - ref) <= LOSS_RTOL * np.abs(ref)), (got, ref)
    assert runs["ptr"].step == runs["jtr"].step == 3


@pytest.mark.parametrize("what", ["params", "batch_stats"])
def test_parameters_and_statistics_match_jax(runs, what):
    got = flax_from_state_dict(runs["ptr"].model.state_dict(),
                               runs["variables"])
    ref = jax.device_get({"params": runs["jtr"].state.params,
                          "batch_stats": runs["jtr"].state.batch_stats})
    _assert_trees(got[what], ref[what])


def test_validation_loss_matches_jax(runs):
    got = runs["ptr"].last_stats["val_loss"]
    ref = runs["jstats"][0].get("val_loss", runs["jtr"].best_val_loss)
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


def test_default_criterion_is_the_unmasked_mse(runs):
    out = torch.tensor([[1.0, 2.0]])
    assert float(runs["ptr"].criterion(out, torch.zeros(1, 2))) == 2.5
