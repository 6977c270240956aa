"""The port's ``TripletTrainer`` against the JAX package's, on the CPU in
float32.

A small 2D UNet (``dim=2``, n_blocks=2, start_filts=32, batch norm; its
L0 on the port's kernel ops' plain versions, JAX at
``pallas_flat=False``, XLA only) from the same random parameters
(biases, norm scales and statistics away from their init), 8 fixed
triplets of (1, 16, 16) images at batch 2 (JAX repeats its order each
epoch; the port's set is reindexed so that its first epoch visits JAX's
order), ``inject_hyperparams(optax.sgd)`` against ``torch.optim.SGD``,
``run(max_steps=4)``, one epoch, the default ``GAPTripletMarginLoss``
(margin 1, one embedding of 6 channels a triplet member). Each step's
loss within 1e-5 (relative), every parameter and running statistic
within 1e-3 of its scale (1e-6 absolute), ``step`` 4, the validation
loss (3 triplets at batch 2) within 1e-5. Then one step of the port
alone: its running statistics are three momentum updates, one a
forward in the order anchor, positive, negative (JAX chains its
``batch_stats`` through the three applies), equal to three training
forwards of a copy of the model, bit for bit; each forward's autograd
graph keeps its own saved tensors, so the step's gradient is the sum of
the three members' gradients taken one at a time (within 1e-5 of its
scale, 1e-7 absolute).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.training import TripletTrainer as JTriplet
from elektronn3_tpu.training.trainer import TrainState
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules.loss import GAPTripletMarginLoss
from elektronn3_tpu_torch.training import TripletTrainer
from test_torch_train import _assert_trees, _randomize
from test_torch_trainer_multi import jax_order_view

KW = dict(in_channels=1, out_channels=6, n_blocks=2, start_filts=32,
          normalization="batch", dim=2)
IMG = (1, 16, 16)
LR = 0.05
LOSS_RTOL = 1e-5


class Triplets:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.x = {k: rng.normal(size=(n,) + IMG).astype(np.float32)
                  for k in ("anchor", "pos", "neg")}
        self.x["pos"] = self.x["anchor"] + 0.1 * self.x["pos"]

    def __len__(self):
        return len(self.x["anchor"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.x.items()}


def _port_model(variables):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(variables, m))
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("triplet")
    train, valid = Triplets(8, 0), Triplets(3, 1)
    jtr = JTriplet(junet.UNet(pallas_flat=False, **KW), criterion=None,
                   optimizer=optax.inject_hyperparams(optax.sgd)(
                       learning_rate=LR),
                   example_input=np.zeros((1, 16, 16, 1), np.float32),
                   train_dataset=train, valid_dataset=valid, batch_size=2,
                   save_root=str(root), exp_name="jax",
                   enable_tensorboard=False)
    # host copies: the JAX step donates its state's buffers
    variables = jax.tree_util.tree_map(np.array, _randomize(jax.device_get(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        np.random.default_rng(2)))

    def device(tree):
        return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                      tree)
    jtr.state = TrainState(
        params=device(variables["params"]),
        batch_stats=device(variables["batch_stats"]),
        opt_state=jtr.state.opt_state, step=jtr.state.step)
    jstats = []
    jtrain = jtr._train

    def recorded(*a, **k):
        stats, misc = jtrain(*a, **k)
        jstats.append(stats)
        return stats, misc
    jtr._train = recorded
    jtr.run(max_steps=4)
    m = _port_model(variables)
    ptr = TripletTrainer(
        m, optimizer=torch.optim.SGD(m.parameters(), lr=LR),
        train_dataset=jax_order_view(train), valid_dataset=valid,
        batch_size=2, save_root=str(root), exp_name="port",
        enable_tensorboard=False, nan_check_interval=1)
    ptr.run(max_steps=4)
    return dict(jtr=jtr, ptr=ptr, variables=variables, jstats=jstats,
                train=train)


def test_step_losses_match_jax(runs):
    got = np.array(runs["ptr"].last_stats["tr_loss"])
    ref = np.array(runs["jstats"][0]["tr_loss"])
    assert got.shape == ref.shape == (4,)
    assert np.all(np.abs(got - ref) <= LOSS_RTOL * np.abs(ref)), (got, ref)
    assert runs["ptr"].step == runs["jtr"].step == 4


@pytest.mark.parametrize("what", ["params", "batch_stats"])
def test_parameters_and_statistics_match_jax(runs, what):
    """The running statistics after 4 steps are 12 momentum updates
    deep in both."""
    got = flax_from_state_dict(runs["ptr"].model.state_dict(),
                               runs["variables"])
    ref = jax.device_get({"params": runs["jtr"].state.params,
                          "batch_stats": runs["jtr"].state.batch_stats})
    _assert_trees(got[what], ref[what])


def test_validation_loss_matches_jax(runs):
    got = runs["ptr"].last_stats["val_loss"]
    ref = runs["jstats"][0]["val_loss"]
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


def test_one_step_three_updates_and_separate_graphs(runs, tmp_path):
    m = _port_model(runs["variables"])
    ref = copy.deepcopy(m)
    batch = {k: torch.from_numpy(np.moveaxis(v[:2], 1, -1))
             for k, v in runs["train"].x.items()}
    tr = TripletTrainer(m, optimizer=torch.optim.SGD(m.parameters(), lr=0.0),
                        save_root=str(tmp_path), exp_name="one",
                        enable_tensorboard=False)
    tr._train_batch(batch, None)
    ref.train()
    crit = GAPTripletMarginLoss()
    grads = {n: torch.zeros_like(p) for n, p in ref.named_parameters()}
    outs = [ref(batch[k]) for k in ("anchor", "pos", "neg")]
    for i in range(3):
        ref.zero_grad(set_to_none=True)
        part = [o if j == i else o.detach() for j, o in enumerate(outs)]
        crit(*part).backward(retain_graph=True)
        for n, p in ref.named_parameters():
            if p.grad is not None:
                grads[n] += p.grad
    for (n, b), (_, rb) in zip(m.named_buffers(), ref.named_buffers()):
        assert torch.equal(b, rb), n
    for n, p in m.named_parameters():
        g = grads[n]
        assert p.grad is not None, n
        scale = float(g.abs().max())
        # 1e-7: the float32 rounding of a gradient that is exactly 0
        # (conv_final's bias: the loss takes differences of embeddings)
        assert float((p.grad - g).abs().max()) <= 1e-5 * scale + 1e-7, n
