"""The port's ``Trainer`` (elektronn3_tpu_torch) against the JAX
package's, on the CPU in float32.

One run of each Trainer on the same small model (n_blocks=2,
start_filts=32, planar L0; the JAX parameters converted into the port's
model; JAX at ``pallas_flat=False``, so that only XLA compiles, the
port's L0 on its kernel ops' plain versions): a train set of exactly
``batch_size`` samples, so that each epoch is one step on the same batch
up to order; ``inject_hyperparams(optax.sgd)`` against
``torch.optim.SGD`` under the same ``CyclicLR``, set so that the rate
has a minimum after step 5; ``run(max_steps=6)`` with a validation set
of 3 patches at batch 2 (its last batch holds 1). The two must give the
same rate each step, ``tr_loss`` and ``val_loss`` each epoch within 1e-4
(relative), each streaming metric within 0.1 (of 100), the same
``_best`` and ``_minlr_step{k}`` snapshots, the same SWA average
(within 1e-4 of its scale) and the same TensorBoard scalar tags, read
back with tensorboard's ``EventAccumulator``.

Then the port alone: the histogram pass leaves every norm buffer as it
was, bit for bit; ``profile_steps`` writes a trace; the preview equals a
direct ``Predictor`` call and leaves the model's mode; ``load_state``
restores the scheduler's next rate and ``best_val_loss``; the loop
syncs with the host only in its batched NaN check (and, under a
plateau scheduler, once a step); ``ss_criterion`` in both conventions
against JAX's (a stub consistency criterion, one step); ``save_model``
and ``load_model``; ``preview_offset`` is the preview Predictor's
``offset``, and one the model does not shrink by raises there.
"""

import copy
import glob
import os
import pickle
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu.training import Trainer as JTrainer
from elektronn3_tpu.training import metrics as jmetrics
from elektronn3_tpu.training import schedulers as jsched
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import (
    CyclicLR, ReduceLROnPlateau, Trainer, load_model, metrics, save_model)
from elektronn3_tpu_torch.training import trainer as trainer_mod

KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
SAMPLE = (1, 4, 12, 16)
BATCH = 2
STEPS = 6
LOSS_RTOL = 1e-4
METRIC_ATOL = 0.1
SWA_TOL = 1e-4


class Patches(torch.utils.data.Dataset):
    """Seeded (1, D, H, W) inputs and (D, H, W) class targets."""

    def __init__(self, n, seed=0, shape=SAMPLE):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + shape).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + shape[1:]).astype(
            np.int32)

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


def _cyclic(mod):
    # rates: base, base, mid, max, mid, base, mid: a minimum after step 5
    return mod.CyclicLR(1e-3, 1e-2, step_size_up=2)


def _port_model(variables):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(jax.device_get(variables), m))
    return m


def _scalars(path):
    acc = EventAccumulator(path)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _no_images(trainer):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    train, valid = Patches(BATCH, 0), Patches(3, 1)
    jmodel = junet.UNet(pallas_flat=False, **KW)
    jtr = JTrainer(
        jmodel, jloss.CEDiceLoss(1.0, 1.0),
        optimizer=optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3),
        train_dataset=train, valid_dataset=valid,
        valid_metrics=jmetrics.default_metrics(), batch_size=BATCH,
        schedulers={"lr": _cyclic(jsched)}, save_root=str(root),
        exp_name="jax", sample_plotting_handler=_no_images,
        tb_hist_interval=0, nan_check_interval=4)
    jlrs = []
    jstep = jtr._train_step_jit

    def recording_step(state, inp, target, rng, lr, unlabeled=None):
        jlrs.append(float(lr))
        return jstep(state, inp, target, rng, lr, unlabeled)

    jtr._train_step_jit = recording_step
    variables = {"params": jtr.state.params,
                 "batch_stats": jtr.state.batch_stats}
    model = _port_model(variables)
    ptr = Trainer(
        model, ploss.CEDiceLoss(1.0, 1.0),
        optimizer=torch.optim.SGD(model.parameters(), lr=1e-3),
        train_dataset=train, valid_dataset=valid,
        valid_metrics=metrics.default_metrics(), batch_size=BATCH,
        schedulers={"lr": _cyclic(sys.modules[CyclicLR.__module__])},
        save_root=str(root), exp_name="port",
        sample_plotting_handler=_no_images, tb_hist_interval=0,
        nan_check_interval=4)
    plrs = []
    ptr.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: plrs.append(opt.param_groups[0]["lr"]))
    jtr.run(max_steps=STEPS)
    ptr.run(max_steps=STEPS)
    return dict(jtr=jtr, ptr=ptr, jlrs=jlrs, plrs=plrs, variables=variables,
                jscalars=_scalars(jtr.save_path),
                pscalars=_scalars(ptr.save_path))


def test_rate_each_step_matches_jax(runs):
    assert len(runs["plrs"]) == STEPS
    # JAX feeds the rate as a float32 array
    assert np.array_equal(np.float32(runs["plrs"]), np.float32(runs["jlrs"]))


def test_tensorboard_scalar_tags_match_jax(runs):
    assert set(runs["pscalars"]) == set(runs["jscalars"])
    assert {"stats/tr_loss_mean", "stats/val_loss", "stats/val_DSC",
            "misc/learning_rate", "misc/tr_speed"} <= set(runs["pscalars"])
    for tag, events in runs["jscalars"].items():
        assert [s for s, _ in runs["pscalars"][tag]] == \
            [s for s, _ in events] == list(range(1, STEPS + 1)), tag


@pytest.mark.parametrize("tag", ["stats/tr_loss_mean", "stats/val_loss"])
def test_losses_each_epoch_match_jax(runs, tag):
    got = np.array([v for _, v in runs["pscalars"][tag]])
    ref = np.array([v for _, v in runs["jscalars"][tag]])
    assert np.all(np.abs(got - ref) <= LOSS_RTOL * np.abs(ref)), (got, ref)


def test_streaming_metrics_each_epoch_match_jax(runs):
    for name in metrics.default_metrics():
        got = np.array([v for _, v in runs["pscalars"][f"stats/{name}"]])
        ref = np.array([v for _, v in runs["jscalars"][f"stats/{name}"]])
        assert np.all(np.abs(got - ref) <= METRIC_ATOL), (name, got, ref)


def _suffixes(path, ext):
    names = [os.path.basename(f) for f in glob.glob(f"{path}/state_dict*")]
    return {n[len("state_dict"):-len(ext)] for n in names}


def test_snapshots_match_jax(runs):
    jtr, ptr = runs["jtr"], runs["ptr"]
    suffixes = _suffixes(ptr.save_path, ".pth")
    assert suffixes == _suffixes(jtr.save_path, ".ckpt") == {
        "", "_initial", "_final", "_best", "_minlr_step6"}
    with open(f"{jtr.save_path}/state_dict_best.ckpt", "rb") as f:
        jbest = pickle.load(f)["info"]
    pbest = torch.load(f"{ptr.save_path}/state_dict_best.pth",
                       weights_only=False)["info"]
    assert pbest["step"] == jbest["step"]
    assert pbest["val_loss"] == pytest.approx(jbest["val_loss"],
                                              rel=LOSS_RTOL)
    assert ptr.best_val_loss == pytest.approx(jtr.best_val_loss,
                                              rel=LOSS_RTOL)
    assert sorted(os.path.basename(f) for f in
                  glob.glob(f"{ptr.save_path}/model*.pt")) == sorted(
        f"model{s}.pt" for s in suffixes)
    assert os.path.isfile(f"{ptr.save_path}/elektronn3_tpu_torch.log")


def test_swa_average_matches_jax(runs):
    jtr, ptr = runs["jtr"], runs["ptr"]
    assert ptr.swa.n_avg == jtr.swa.n_avg == 1
    got = flax_from_state_dict(ptr.swa.avg_params, runs["variables"],
                               ("params",))["params"]
    ref = jax.device_get(jtr.swa.avg_params)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_got) == len(flat_ref)
    for path, g in flat_got:
        r = np.asarray(flat_ref[path])
        err = float(np.max(np.abs(np.asarray(g) - r)))
        assert err <= SWA_TOL * float(np.max(np.abs(r))) + 1e-6, (path, err)


def test_load_state_restores_rate_and_best_val_loss(runs, tmp_path):
    ptr = runs["ptr"]
    model = UNet(device="cpu", generator=torch.Generator().manual_seed(7),
                 **KW)
    tr2 = Trainer(model, ploss.CEDiceLoss(1.0, 1.0),
                  optimizer=torch.optim.SGD(model.parameters(), lr=1e-3),
                  train_dataset=Patches(BATCH), schedulers={
                      "lr": _cyclic(sys.modules[CyclicLR.__module__])},
                  save_root=str(tmp_path), exp_name="resumed",
                  enable_tensorboard=False)
    tr2.load_state(f"{ptr.save_path}/state_dict_final.pth")
    assert tr2.step == STEPS
    assert tr2.lr_scheduler.get_lr() == ptr.lr_scheduler.get_lr()
    assert tr2.lr_scheduler.step() == copy.deepcopy(ptr.lr_scheduler).step()
    assert tr2.best_val_loss == ptr.best_val_loss
    a, b = ptr.model.state_dict(), tr2.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# --- the port alone ---------------------------------------------------------

def _small_model(seed=0, **kw):
    return UNet(device="cpu", generator=torch.Generator().manual_seed(seed),
                **{**KW, **kw})


def _norm_buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "norm" in k and ("running" in k or "num_batches" in k)}


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One epoch of the port's Trainer with every TensorBoard handler,
    a profiler window and a tiled preview, its handler keeping the
    preview."""
    previews = []
    tr = Trainer(
        _small_model(), ploss.CEDiceLoss(1.0, 1.0),
        train_dataset=Patches(4), valid_dataset=Patches(3, 1),
        valid_metrics={**metrics.default_metrics(),
                       "val_AUROC": metrics.AUROC()},
        batch_size=BATCH, save_root=str(tmp_path_factory.mktemp("full")),
        exp_name="full", profile_steps=(1, 2),
        preview_batch=np.random.default_rng(3).normal(
            size=(1, 1, 8, 32, 32)).astype(np.float32),
        preview_tile_shape=(4, 16, 16), preview_overlap_shape=(2, 4, 4),
        preview_interval=1, hparams={"lr": 1e-3},
        preview_plotting_handler=lambda t, inp, out: previews.append(
            (t.model.training, out)))
    tr.run(max_steps=2)
    return tr, previews


def test_histogram_pass_keeps_norm_buffers(full_run):
    tr, _ = full_run
    before = _norm_buffers(tr.model)
    assert before
    tr._tb_log_histograms()
    after = _norm_buffers(tr.model)
    assert all(torch.equal(before[k], after[k]) for k in before)
    # the pass's training forward does move them when nothing restores them
    inp, target, _ = tr._last_sample
    tr.model.train()
    with torch.no_grad():
        tr.model(inp)
    moved = _norm_buffers(tr.model)
    assert not all(torch.equal(before[k], moved[k]) for k in before)
    tr.model.load_state_dict({**tr.model.state_dict(), **before})


def test_tensorboard_logs_images_and_histograms(full_run):
    tr, _ = full_run
    acc = EventAccumulator(tr.save_path, size_guidance={"images": 0,
                                                        "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    assert {"train_samples/inp", "train_samples/pred", "val_samples/target",
            "val_samples/overlay"} <= set(tags["images"])
    assert "param/down_convs.0.conv1.weight" in tags["histograms"]
    assert "grad/down_convs.0.conv1.weight" in tags["histograms"]
    assert "stats/val_AUROC" in tags["scalars"]


def test_profile_steps_write_a_trace(full_run):
    tr, _ = full_run
    traces = glob.glob(f"{tr.save_path}/profile/*.json")
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0


def test_preview_equals_a_direct_predictor_call(full_run):
    tr, previews = full_run
    assert len(previews) == 1
    was_training, out = previews[0]
    assert was_training and tr.model.training
    ref = Predictor(tr.model, tile_shape=(4, 16, 16),
                    overlap_shape=(2, 4, 4)).predict(tr.preview_batch)
    tr.model.train()
    assert out.shape == (1, 2, 8, 32, 32)
    assert np.array_equal(out, ref)


def test_epoch_split_and_files(full_run):
    tr, _ = full_run
    assert set(tr.last_seconds) == {"train", "validate", "log", "preview",
                                    "checkpoint"}
    model, info = load_model(f"{tr.save_path}/model_final.pt", device="cpu")
    assert info["step"] == 2 and isinstance(model, UNet)
    a, b = tr.model.state_dict(), model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert model.n_blocks == KW["n_blocks"] and model.planar_blocks == (0,)


_SYNCS = ("item", "tolist", "cpu", "numpy", "__float__", "__bool__",
          "__int__")


@pytest.mark.parametrize("plateau", [False, True])
def test_loop_syncs_only_in_the_nan_check(tmp_path, monkeypatch, plateau):
    """Every call that reads a tensor on the host, from the training
    package's code, during an epoch of four steps checked every four: one
    stacked fetch; a plateau scheduler adds one a step."""
    scheds = {"lr": ReduceLROnPlateau(1e-3)} if plateau else {}
    tr = Trainer(_small_model(), ploss.CEDiceLoss(1.0, 1.0),
                 train_dataset=Patches(8), batch_size=BATCH,
                 save_root=str(tmp_path), exp_name="sync",
                 schedulers=scheds, enable_tensorboard=False,
                 nan_check_interval=4)
    pkg = os.path.dirname(trainer_mod.__file__)
    calls = []
    for name in _SYNCS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            frame = sys._getframe(1)
            if frame.f_code.co_filename.startswith(pkg):
                calls.append((frame.f_code.co_name, _name))
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    tr.start_time = trainer_mod.Timer()
    stats, _ = tr._train(max_steps=4, max_runtime=1e9)
    monkeypatch.undo()
    assert len(stats["tr_loss"]) == 4
    want = [("_fetch", "cpu"), ("_fetch", "tolist")]
    if plateau:
        want += [("step", "__float__")] * 4
    assert sorted(calls) == sorted(want)


def test_preview_offset_raises(tmp_path):
    """A valid-conv model's preview takes ``preview_offset`` as the
    Predictor's offset: the right one gives the direct Predictor's
    result, a wrong one (tiles that the model shrinks by another amount)
    raises in the preview."""
    model = _small_model(conv_mode="valid", start_filts=4)
    batch = np.random.default_rng(3).normal(size=(1, 1, 12, 32, 32)) \
        .astype(np.float32)
    for offset in ((2, 8, 8), (1, 8, 8)):
        tr = Trainer(model, ploss.CEDiceLoss(), train_dataset=Patches(2),
                     save_root=str(tmp_path), exp_name=f"off{offset[0]}",
                     enable_tensorboard=False, preview_batch=batch,
                     preview_tile_shape=(4, 8, 8), preview_offset=offset)
        if offset == (1, 8, 8):
            with pytest.raises(ValueError):
                tr._run_preview_inference()
            continue
        ref = Predictor(model, tile_shape=(4, 8, 8),
                        offset=offset).predict(batch)
        assert np.array_equal(tr._run_preview_inference(), ref)


def test_save_model_and_load_model_round_trip(tmp_path):
    model = _small_model(3, normalization="group", dtype=torch.bfloat16)
    save_model(model, str(tmp_path / "m.pt"), info={"step": 5})
    loaded, info = load_model(str(tmp_path / "m.pt"), device="cpu")
    assert info == {"step": 5}
    assert loaded.normalization == "group" and loaded.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 4, 12, 16, 1)).astype(np.float32))
    assert torch.equal(model.eval()(x), loaded.eval()(x))


# --- ss_criterion against JAX -----------------------------------------------

SS_KW = dict(KW, n_blocks=1)


def _jax_plain_ss(out_u):
    p = jax.nn.softmax(out_u.astype(np.float32), -1)
    return 0.5 * (p[..., 1] ** 2).mean()


class _JaxFlipConsistency:
    apply_fn = None

    def __call__(self, unlabeled, rng=None, apply_fn=None):
        a = jax.nn.softmax(apply_fn(unlabeled).astype(np.float32), -1)
        b = jax.nn.softmax(apply_fn(unlabeled[:, :, ::-1]).astype(
            np.float32), -1)[:, :, ::-1]
        return ((a - b) ** 2).mean()


def _port_plain_ss(out_u):
    return 0.5 * (torch.softmax(out_u.float(), -1)[..., 1] ** 2).mean()


class _PortFlipConsistency:
    apply_fn = None

    def __call__(self, unlabeled, apply_fn=None):
        a = torch.softmax(apply_fn(unlabeled).float(), -1)
        b = torch.softmax(apply_fn(unlabeled.flip(2)).float(), -1).flip(2)
        return ((a - b) ** 2).mean()


@pytest.mark.parametrize("convention", ["logits", "apply_fn"])
def test_ss_criterion_step_matches_jax(tmp_path, convention):
    jss, pss = {"logits": (_jax_plain_ss, _port_plain_ss),
                "apply_fn": (_JaxFlipConsistency(),
                             _PortFlipConsistency())}[convention]
    train, unlabeled = Patches(BATCH, 0), Patches(BATCH, 5)
    jtr = JTrainer(
        junet.UNet(pallas_flat=False, **SS_KW), jloss.CEDiceLoss(1.0, 1.0),
        train_dataset=train, unlabeled_dataset=unlabeled, ss_criterion=jss,
        batch_size=BATCH, save_root=str(tmp_path), exp_name="jax",
        enable_tensorboard=False)
    jloss_ = []
    jstep = jtr._train_step_jit

    def recording_step(*args):
        out = jstep(*args)
        jloss_.append(float(out[1]))
        return out

    jtr._train_step_jit = recording_step
    variables = jax.device_get({"params": jtr.state.params,
                                "batch_stats": jtr.state.batch_stats})

    def port_model():
        m = UNet(device="cpu", **SS_KW)
        m.load_state_dict(state_dict_from_flax(variables, m))
        return m

    ptr = Trainer(port_model(), ploss.CEDiceLoss(1.0, 1.0),
                  train_dataset=train,
                  unlabeled_dataset=unlabeled, ss_criterion=pss,
                  batch_size=BATCH, save_root=str(tmp_path), exp_name="port",
                  enable_tensorboard=False)
    jtr.run(max_steps=1)
    ptr.run(max_steps=1)
    got = ptr.last_stats["tr_loss"][0]
    plain = Trainer(port_model(), ploss.CEDiceLoss(1.0, 1.0),
                    train_dataset=train, batch_size=BATCH,
                    save_root=str(tmp_path), exp_name="plain",
                    enable_tensorboard=False)
    plain.run(max_steps=1)
    assert abs(got - jloss_[0]) <= LOSS_RTOL * abs(jloss_[0])
    # the semi-supervised term is there
    assert abs(got - plain.last_stats["tr_loss"][0]) > 100 * LOSS_RTOL * got


def test_each_run_keeps_its_log(tmp_path):
    runs = [Trainer(_small_model(), ploss.CEDiceLoss(),
                    train_dataset=Patches(2), save_root=str(tmp_path),
                    exp_name=name, enable_tensorboard=False)
            for name in ("a", "b")]
    logs = [(tmp_path / n / "elektronn3_tpu_torch.log").read_text()
            for n in ("a", "b")]
    assert f"Writing files to {runs[0].save_path}" in logs[0]
    assert f"Writing files to {runs[1].save_path}" in logs[1]
    assert runs[1].save_path not in logs[0]
    assert runs[0].save_path not in logs[1]


class _ChannelsLastBatches:
    """A loader-style iterable (no ``__getitem__``): channels-last
    batches, used by the Trainer as they come."""

    def __init__(self, ds):
        self.batch = {"inp": torch.from_numpy(ds.inp).movedim(1, -1),
                      "target": torch.from_numpy(ds.target).long()}

    def __iter__(self):
        yield self.batch


@pytest.mark.parametrize("how", ["loader", "mixed_precision"])
def test_loader_style_dataset_and_mixed_precision(tmp_path, how):
    """One step on the same batch: a loader-style iterable against the
    map-style dataset; ``mixed_precision`` against the same batch rounded
    to bfloat16 beforehand."""
    ds = Patches(BATCH)
    rounded = Patches(BATCH)
    rounded.inp = torch.from_numpy(ds.inp).bfloat16().float().numpy()
    runs = {"map": dict(train_dataset=ds),
            "loader": dict(train_dataset=_ChannelsLastBatches(ds)),
            "mixed_precision": dict(train_dataset=ds, mixed_precision=True),
            "rounded": dict(train_dataset=rounded)}
    ref_run = "map" if how == "loader" else "rounded"
    losses = {}
    for name in (how, ref_run):
        tr = Trainer(_small_model(), ploss.CEDiceLoss(1.0, 1.0),
                     batch_size=BATCH, save_root=str(tmp_path),
                     exp_name=name, enable_tensorboard=False, **runs[name])
        tr.run(max_steps=1)
        losses[name] = tr.last_stats["tr_loss"][0]
    assert abs(losses[how] - losses[ref_run]) <= 1e-6 * losses[ref_run]


def test_trainer_takes_jax_arguments():
    """JAX's Trainer arguments, all of them, in JAX's order (``mesh``
    and ``shard_strategy``: multi-GPU; ``worker_type`` and
    ``knossos_preview_config`` since the Noise2Void, triplet and
    gradient-accumulation trainers came); the exports of JAX's
    ``training`` package."""
    import inspect

    from elektronn3_tpu import training as jtraining
    from elektronn3_tpu_torch import training as ptraining
    jargs = list(inspect.signature(JTrainer.__init__).parameters)
    assert list(inspect.signature(Trainer.__init__).parameters) == jargs
    for name in ("Trainer", "NaNException", "Backup", "save_model",
                 "load_model", "SWA", "bn_update", "recalibrate_bn",
                 "metrics", "schedulers", "ConstantLR", "StepLR",
                 "ExponentialLR", "CosineAnnealingLR", "CyclicLR",
                 "ReduceLROnPlateau", "SGDR", "Noise2VoidTrainer",
                 "TripletTrainer", "TrainerMulti"):
        assert hasattr(jtraining, name) and hasattr(ptraining, name), name
    assert {"Padam", "LRScheduler", "train_step",
            "default_optimizer"} <= set(ptraining.__all__)
