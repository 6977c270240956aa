"""The port's ``TrainerMulti`` (gradient accumulation, the ``cube_meta``
loss weight, ``loss_crop``) against the JAX package's, on the CPU in
float32, and the ``worker_type`` and ``knossos_preview_config`` that the
port's ``Trainer`` takes.

Both trainers start from the same parameters (JAX's init converted
into the port's model; JAX at ``pallas_flat=False``, XLA only; a small
UNet: n_blocks=2, start_filts=8, planar L0) and run
``inject_hyperparams(optax.sgd)`` against ``torch.optim.SGD`` at lr 0.05
(SGD shows a missing divide by the micro-batch count, Adam would hide
it) with ``optimizer_iterations=2`` micro-batches of 2, a ``loss_crop``
of (1, 2, 2) and a ``cube_meta`` whose mean weights each loss (one
sample's value NaN, read as 1). The set holds 10 samples: 5 micro-batches
an epoch, 2 steps and a tail of one micro-batch. JAX's loader draws its
order from numpy and the port's from torch's sampler, so the port's set
is JAX's in the order that makes its first epoch JAX's
(:func:`jax_order_view`); JAX repeats that order every epoch, so the two
are compared in the first: ``run(max_steps=2)``, the 4 micro-batch
losses within 1e-5 (relative), every parameter and running statistic
within 1e-3 of its scale (1e-6 absolute), ``step`` 2, and the
validation loss within 1e-5. Then the port alone, ``run(max_steps=3)``:
the tail's gradient is dropped when the epoch ends, so step 3, the first
of the next epoch, is SGD on the mean gradient of that epoch's first two
micro-batches only (each parameter within 1e-5 of its scale).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.training import TrainerMulti as JTrainerMulti
from elektronn3_tpu_torch.data import DataLoader
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import Trainer, TrainerMulti
from elektronn3_tpu_torch.training import _trainer_multi as multi
from elektronn3_tpu_torch.training import trainer as trainer_mod
from test_torch_train import _assert_trees

KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
SAMPLE = (1, 6, 12, 12)
BATCH = 2
N = 10
LR = 0.05
CROP = (1, 2, 2)
LOSS_RTOL = 1e-5


class Cubes:
    """Fixed (1, D, H, W) inputs, (D, H, W) targets and a per-sample
    ``cube_meta`` (sample 3's NaN)."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + SAMPLE).astype(np.float32)
        self.target = rng.integers(0, 2, (n,) + SAMPLE[1:]).astype(np.int32)
        self.meta = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
        self.meta[3 % n] = np.nan

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i],
                "cube_meta": self.meta[i]}


class Reindexed:
    def __init__(self, ds, index):
        self.ds, self.index = ds, index

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[int(self.index[i])]


class Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


def jax_order_view(ds, seed=0):
    """``ds`` re-indexed so that the port Trainer's first epoch (the
    port's ``DataLoader`` in torch's sampler order under
    ``Generator(seed)``) visits JAX's first-epoch order
    (``default_rng(seed).permutation``), for fixed samples."""
    n = len(ds)
    jp = np.random.default_rng(seed).permutation(n)
    tp = [int(b["i"][0]) for b in DataLoader(
        Indices(n), batch_size=1, num_workers=0, seed=seed,
        generator=torch.Generator().manual_seed(seed))]
    index = np.empty(n, np.int64)
    index[tp] = jp
    return Reindexed(ds, index)


def _port_model(variables):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(jax.device_get(variables), m))
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi")
    train, valid = Cubes(N, 0), Cubes(3, 1)
    crit_j = jloss.CEDiceLoss(1.0, 1.0)
    jtr = JTrainerMulti(
        junet.UNet(pallas_flat=False, **KW), crit_j,
        optimizer=optax.inject_hyperparams(optax.sgd)(learning_rate=LR),
        train_dataset=train, valid_dataset=valid, batch_size=BATCH,
        optimizer_iterations=2, loss_crop=CROP, save_root=str(root),
        exp_name="jax", enable_tensorboard=False, nan_check_interval=1)
    # a host copy: the JAX step donates its state's buffers
    variables = jax.device_get({"params": jtr.state.params,
                                "batch_stats": jtr.state.batch_stats})

    def port(exp, steps):
        m = _port_model(variables)
        tr = TrainerMulti(
            m, ploss.CEDiceLoss(1.0, 1.0),
            optimizer=torch.optim.SGD(m.parameters(), lr=LR),
            train_dataset=jax_order_view(train), valid_dataset=valid,
            batch_size=BATCH, optimizer_iterations=2, loss_crop=CROP,
            save_root=str(root), exp_name=exp, enable_tensorboard=False,
            nan_check_interval=1)
        tr.run(max_steps=steps)
        return tr

    jstats = []
    jtrain = jtr._train

    def recorded(*a, **k):
        stats, misc = jtrain(*a, **k)
        jstats.append(stats)
        return stats, misc
    jtr._train = recorded
    jtr.run(max_steps=2)
    ptr = port("port", 2)
    return dict(jtr=jtr, ptr=ptr, variables=variables, jstats=jstats,
                port=port)


def test_micro_batch_losses_match_jax(runs):
    """Every micro-batch's weighted loss of the epoch, the dropped
    tail's included."""
    got = np.array(runs["ptr"].last_stats["tr_loss"])
    ref = np.array(runs["jstats"][0]["tr_loss"])
    assert got.shape == ref.shape == (4,)
    assert np.all(np.abs(got - ref) <= LOSS_RTOL * np.abs(ref)), (got, ref)


def test_step_counts_optimizer_steps_only(runs):
    assert runs["ptr"].step == runs["jtr"].step == 2
    assert runs["ptr"].epoch == runs["jtr"].epoch == 1


@pytest.mark.parametrize("what", ["params", "batch_stats"])
def test_parameters_and_statistics_match_jax(runs, what):
    """Two SGD steps, each the mean of two micro-batches' cropped,
    weighted gradients: a missing divide doubles every update, a missing
    crop or weight moves them."""
    got = flax_from_state_dict(runs["ptr"].model.state_dict(),
                               runs["variables"])
    ref = jax.device_get({"params": runs["jtr"].state.params,
                          "batch_stats": runs["jtr"].state.batch_stats})
    _assert_trees(got[what], ref[what])


def test_validation_loss_matches_jax(runs):
    got = runs["ptr"].best_val_loss
    ref = runs["jtr"].best_val_loss
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


def test_cube_weight_and_crop():
    assert multi.cube_weight(None) == 1.0
    assert multi.cube_weight(np.array([[2.0], [np.nan], [np.inf]])) == \
        pytest.approx((2.0 + 1.0 + 1.0) / 3)
    out = torch.zeros(2, 6, 12, 12, 3)
    tgt = torch.zeros(2, 6, 12, 12)
    o, t = multi.crop_loss_region(out, tgt, CROP)
    assert o.shape == (2, 4, 8, 8, 3) and t.shape == (2, 4, 8, 8)
    assert multi.crop_loss_region(out, tgt, None)[0] is out


def test_tail_leaves_no_gradient_behind(runs):
    """Step 3 opens epoch 1: SGD on the mean gradient of that epoch's
    first two micro-batches, from the parameters after step 2."""
    three = runs["port"]("port3", 3)
    two = runs["ptr"]
    m = two.model
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    two.epoch = 1
    loader = two._loader()
    it = iter(loader)
    m.train()
    m.zero_grad(set_to_none=True)
    for _ in range(2):
        batch = next(it)
        inp, target = two._batch(batch)
        o, t = multi.crop_loss_region(m(inp), target, CROP)
        (two.criterion(o, t).float()
         * multi.cube_weight(batch["cube_meta"])).backward()
    with torch.no_grad():
        for p in m.parameters():
            p -= LR * p.grad / 2
    # parameters only: the tail's forward moved the running statistics
    got = dict(three.model.named_parameters())
    for k, v in m.named_parameters():
        scale = float(v.abs().max())
        assert float((got[k] - v).abs().max()) <= 1e-5 * scale + 1e-7, k
    m.load_state_dict(sd)


def test_trainer_takes_worker_type_and_knossos_config(tmp_path, monkeypatch):
    """The repaired fault: ``Trainer(worker_type=...)`` raised
    ``TypeError``. Now every loader it makes (training, unlabeled,
    validation) gets that type, and ``knossos_preview_config`` is
    kept."""
    made = []
    real = trainer_mod.DataLoader

    def spy(*a, **k):
        made.append(k.get("worker_type"))
        return real(*a, **k)
    monkeypatch.setattr(trainer_mod, "DataLoader", spy)
    m = UNet(device="cpu", **KW)
    cfg = {"dataset": "conf", "offset": (0, 0, 0), "size": (8, 8, 8)}
    tr = Trainer(m, ploss.CEDiceLoss(1.0, 1.0), train_dataset=Cubes(2, 0),
                 valid_dataset=Cubes(1, 1), unlabeled_dataset=Cubes(2, 2),
                 ss_criterion=lambda out: out.float().mean() * 0,
                 batch_size=2, worker_type="process",
                 knossos_preview_config=cfg, save_root=str(tmp_path),
                 exp_name="wt", enable_tensorboard=False)
    assert tr.worker_type == "process"
    assert tr.knossos_preview_config is cfg
    tr.run(max_steps=1)
    assert len(made) == 3 and set(made) == {"process"}
    with pytest.raises(ValueError, match="worker_type"):
        Trainer(m, ploss.CEDiceLoss(1.0, 1.0), train_dataset=Cubes(2, 0),
                batch_size=2, worker_type="fiber", save_root=str(tmp_path),
                exp_name="wt2", enable_tensorboard=False).run(max_steps=1)


def test_epochs_do_not_repeat_the_order(tmp_path):
    """The fault of JAX's three trainers that the port does not copy:
    they make a new ``DataLoader(seed=seed)`` every epoch, so every epoch
    repeats the first one's order. The port's Noise2Void, triplet and
    gradient-accumulation trainers take their loader from the Trainer's
    ``_loader``, whose seeds move on each epoch."""
    from elektronn3_tpu.data.pipeline import DataLoader as JDataLoader
    from elektronn3_tpu_torch.training import (
        Noise2VoidTrainer, TripletTrainer)
    ds = Indices(12)

    def order(loader):
        return [int(i) for b in loader for i in np.ravel(b["i"])]
    jax_epochs = [order(JDataLoader(ds, batch_size=4, num_workers=0, seed=0,
                                    channels_last=False))
                  for _ in range(2)]
    assert jax_epochs[0] == jax_epochs[1]
    for i, cls in enumerate((TrainerMulti, Noise2VoidTrainer,
                             TripletTrainer)):
        tr = cls(UNet(device="cpu", **KW), ploss.CEDiceLoss(),
                 train_dataset=ds,
                 batch_size=4, save_root=str(tmp_path), exp_name=f"t{i}",
                 enable_tensorboard=False)
        epochs = []
        for e in range(2):
            tr.epoch = e
            epochs.append(order(tr._loader()))
        assert sorted(epochs[0]) == sorted(epochs[1]) == list(range(12))
        assert epochs[0] != epochs[1], cls.__name__
