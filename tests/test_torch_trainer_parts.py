"""The port's training parts against the JAX package's, on the CPU.

- Schedulers: each of the eight classes over 50 steps, the rates equal
  (``ReduceLROnPlateau`` on a fixed metric sequence), and a
  ``state_dict`` taken at step 25 and loaded into a fresh scheduler
  continuing as JAX's does.
- Metrics: ``confusion_matrix`` on tensors, each metric function and
  each ``Evaluator`` (in full, and streamed over batches through
  ``from_cm``) against JAX's on seeded numpy, with an ``ignore`` label,
  a class absent from the target and ``mean=False``, to 1e-9;
  ``auroc`` and ``average_precision`` (the port's own, on tensors)
  against JAX's (sklearn) with ties, to 1e-9; the cluster evaluators.
- ``Padam`` against JAX's ``padam`` over 10 steps, with and without
  ``weight_decay``, to 1e-6; ``SWA`` against JAX's on the same arrays.
- ``train_utils``, ``sma``, ``plot_hist`` and ``Backup`` against
  JAX's.
"""

import os
import tarfile

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elektronn3_tpu.training import metrics as jmetrics
from elektronn3_tpu.training import optim as joptim
from elektronn3_tpu.training import plotting as jplotting
from elektronn3_tpu.training import schedulers as jsched
from elektronn3_tpu.training import train_utils as jtu
from elektronn3_tpu.training.trainer import Backup as JBackup
from elektronn3_tpu_torch.training import (
    SWA, Backup, Padam, metrics, schedulers)
from elektronn3_tpu_torch.training import plotting, train_utils

TOL = 1e-9

SCHEDULERS = {
    "ConstantLR": ((0.01,), {}),
    "StepLR": ((0.1,), dict(step_size=7, gamma=0.5)),
    "ExponentialLR": ((0.1,), dict(gamma=0.93)),
    "CosineAnnealingLR": ((0.1,), dict(t_max=13, eta_min=1e-3)),
    "CyclicLR": ((1e-4, 1e-2), dict(step_size_up=6, step_size_down=4,
                                    mode="exp_range", gamma=0.97)),
    "ReduceLROnPlateau": ((0.1,), dict(factor=0.5, patience=2,
                                       min_lr=1e-3)),
    "SGDR": ((0.1,), dict(t_0=5, t_mult=2, eta_min=1e-4)),
}
# the plateau scheduler's metric: falls, then stalls in stretches
METRIC = [1.0 / (1 + i) if i < 10 or 20 <= i < 25 else 0.5
          for i in range(50)]


def _steps(sched, n, start=0):
    return [sched.step(METRIC[start + i]) for i in range(n)]


@pytest.mark.parametrize("name", list(SCHEDULERS) + ["triangular2"])
def test_scheduler_matches_jax_with_state_round_trip(name):
    args, kw = SCHEDULERS.get(name, ((1e-3, 1e-2), dict(
        step_size_up=3, mode="triangular2")))
    cls = "CyclicLR" if name == "triangular2" else name
    port = getattr(schedulers, cls)(*args, **kw)
    ref = getattr(jsched, cls)(*args, **kw)
    assert port.get_lr() == ref.get_lr()
    assert _steps(port, 25) == _steps(ref, 25)
    resumed = getattr(schedulers, cls)(*args, **kw)
    resumed.load_state_dict(port.state_dict())
    assert resumed.get_lr() == ref.get_lr()
    assert _steps(resumed, 25, 25) == _steps(ref, 25, 25)


def test_scheduler_base_class_matches_jax():
    port, ref = schedulers.LRScheduler(0.1), jsched.LRScheduler(0.1)
    assert port.get_lr() == ref.get_lr() == 0.1
    assert port.state_dict() == ref.state_dict()
    for s in (port, ref):
        with pytest.raises(NotImplementedError):
            s.step()


# --- metrics ----------------------------------------------------------------

C = 4


@pytest.fixture(scope="module")
def seg():
    """Seeded targets with an ignore label (255) and class 3 absent, and
    logits (some ties at the argmax, which both take as the first)."""
    rng = np.random.default_rng(11)
    target = rng.integers(0, 3, size=(3, 5, 7, 6))
    target[rng.random(target.shape) < 0.1] = 255
    logits = rng.integers(-2, 3, size=target.shape + (C,)).astype(
        np.float32)
    return target, logits


@pytest.mark.parametrize("ignore", [None, 255])
@pytest.mark.parametrize("nan_when_empty", [True, False])
def test_confusion_matrix_matches_jax(seg, ignore, nan_when_empty):
    target, logits = seg
    pred = logits.argmax(-1)
    got = metrics.confusion_matrix(torch.from_numpy(target),
                                   torch.from_numpy(pred), C,
                                   nan_when_empty=nan_when_empty,
                                   ignore=ignore)
    assert got.shape == (C, 4) and got.dtype == torch.float64
    ref = jmetrics.confusion_matrix(target, pred, C,
                                    nan_when_empty=nan_when_empty,
                                    ignore=ignore)
    np.testing.assert_array_equal(got.numpy(), ref)


FUNCS = ["precision", "recall", "accuracy", "dice_coefficient", "iou"]


@pytest.mark.parametrize("fn", FUNCS)
def test_metric_functions_match_jax(seg, fn):
    target, logits = seg
    pred = logits.argmax(-1)
    for mean in (True, False):
        for ignore in (None, 255):
            got = getattr(metrics, fn)(torch.from_numpy(target),
                                       torch.from_numpy(pred), C, mean=mean,
                                       ignore=ignore)
            ref = getattr(jmetrics, fn)(target, pred, C, mean=mean,
                                        ignore=ignore)
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


EVALUATORS = ["Accuracy", "Precision", "Recall", "DSC", "IoU"]


@pytest.mark.parametrize("ev", EVALUATORS)
@pytest.mark.parametrize("kw", [{}, {"ignore": 255}, {"index": 1},
                                {"index": 3}])
def test_evaluators_full_and_streamed_match_jax(seg, ev, kw):
    target, logits = seg
    port, ref = getattr(metrics, ev)(**kw), getattr(jmetrics, ev)(**kw)
    want = ref(target, logits)
    full = port(torch.from_numpy(target), torch.from_numpy(logits))
    np.testing.assert_allclose(full, want, rtol=TOL, atol=TOL)
    assert port.supports_streaming and ref.supports_streaming
    counts = sum(metrics.confusion_matrix(
        torch.from_numpy(target[i]), torch.from_numpy(logits[i]).argmax(-1),
        C, nan_when_empty=False, ignore=port.ignore)
        for i in range(len(target)))
    jcounts = sum(jmetrics.confusion_matrix(
        target[i], logits[i].argmax(-1), C, nan_when_empty=False,
        ignore=ref.ignore) for i in range(len(target)))
    np.testing.assert_allclose(port.from_cm(counts), ref.from_cm(jcounts),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.from_cm(counts), want, rtol=TOL,
                               atol=TOL)


def test_channel_metric_matches_jax(seg):
    target, logits = seg
    got = metrics.channel_metric(metrics.dice_coefficient, 1, C)(
        torch.from_numpy(target), torch.from_numpy(logits))
    ref = jmetrics.channel_metric(jmetrics.dice_coefficient, 1, C)(
        target, logits)
    assert abs(got - ref) <= TOL


@pytest.fixture(scope="module")
def scores():
    """Probabilities on a grid of 0.05 (many ties), class 3 absent."""
    rng = np.random.default_rng(12)
    target = rng.integers(0, 3, size=(4, 9, 11))
    probs = np.round(rng.random(target.shape + (C,)) * 20) / 20
    return target, probs


@pytest.mark.parametrize("fn", ["auroc", "average_precision"])
def test_ranking_metrics_with_ties_match_sklearn(scores, fn):
    target, probs = scores
    for mean in (True, False):
        got = getattr(metrics, fn)(torch.from_numpy(target),
                                   torch.from_numpy(probs), mean=mean)
        ref = getattr(jmetrics, fn)(target, probs, mean=mean)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # the absent class: AUROC NaN, AP 0, as sklearn
    per = getattr(metrics, fn)(target, probs, mean=False)
    assert (np.isnan(per[3]) if fn == "auroc" else per[3] == 0.0)


@pytest.mark.parametrize("ev", ["AUROC", "AveragePrecision"])
def test_probability_evaluators_match_jax(seg, ev):
    target, logits = seg
    # two classes: the probabilities' ties are the logit differences'
    target = np.where(target == 255, 0, target) % 2
    logits = logits[..., :2]
    got = getattr(metrics, ev)()(torch.from_numpy(target),
                                 torch.from_numpy(logits))
    ref = getattr(jmetrics, ev)()(target, logits)
    assert abs(got - ref) <= TOL


@pytest.mark.parametrize("ev", ["NMI", "AMI", "ARI", "SilhouetteScore"])
def test_cluster_evaluators_match_jax(seg, ev):
    target, logits = seg
    got = getattr(metrics, ev)()(torch.from_numpy(target),
                                 torch.from_numpy(logits))
    ref = getattr(jmetrics, ev)()(target, logits)
    assert abs(got - ref) <= TOL


def test_default_metrics_match_jax():
    got, ref = metrics.default_metrics(), jmetrics.default_metrics()
    assert {k: type(v).__name__ for k, v in got.items()} == \
        {k: type(v).__name__ for k, v in ref.items()}


# --- optimizers -------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_padam_matches_jax(weight_decay):
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(3, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(10)]
    tx = joptim.padam(1e-2, partial=0.125, weight_decay=weight_decay)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Padam([p], lr=1e-2, partial=0.125, weight_decay=weight_decay)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    assert np.max(np.abs(p.detach().numpy() - np.asarray(jp))) <= 1e-6
    assert np.max(np.abs(p.detach().numpy() - p0)) > 1e-3


def test_swa_matches_jax():
    rng = np.random.default_rng(5)
    sets = [{"w": rng.normal(size=(2, 3)).astype(np.float32),
             "b": rng.normal(size=(3,)).astype(np.float32)}
            for _ in range(3)]
    port, ref = SWA(), joptim.SWA()
    for s in sets:
        port.update_swa({k: torch.from_numpy(v) for k, v in s.items()})
        ref.update_swa({k: jnp.asarray(v) for k, v in s.items()})
    assert port.n_avg == ref.n_avg == 3
    for k in sets[0]:
        np.testing.assert_allclose(port.avg_params[k].numpy(),
                                   np.asarray(ref.avg_params[k]), rtol=1e-6)
    cur = {k: torch.from_numpy(v) for k, v in sets[2].items()}
    assert port.swap_swa_sgd(cur) is port.avg_params
    back = port.swap_swa_sgd(port.avg_params)
    assert all(torch.equal(back[k], cur[k]) for k in cur)


# --- utilities --------------------------------------------------------------

def test_train_utils_match_jax():
    vals = np.random.default_rng(6).normal(size=(150, 3))
    port = train_utils.AccumulationArray(right_shape=3, n_init=4)
    ref = jtu.AccumulationArray(right_shape=3, n_init=4)
    for v in vals:
        port.append(v)
        ref.append(v)
    assert len(port) == len(ref) == 150
    for f in ("mean", "sum", "max", "min"):
        np.testing.assert_array_equal(getattr(port, f)(), getattr(ref, f)())
    np.testing.assert_array_equal(port.ema, ref.ema)
    np.testing.assert_array_equal(port[10:20], ref[10:20])
    port.clear()
    assert len(port) == 0 and np.isnan(port.mean())
    h, jh = train_utils.HistoryTracker(), jtu.HistoryTracker()
    for v in vals[:5]:
        h.update_timeline(v)
        jh.update_timeline(v)
    np.testing.assert_array_equal(h.loss[:], jh.loss[:])
    for t in (3.0, 299.0, 301.0, 3999.0, 4001.0, 90000.0):
        assert train_utils.pretty_string_time(t) == \
            jtu.pretty_string_time(t)
    assert train_utils.Timer().t_passed >= 0


@pytest.mark.parametrize("n", [1, 3, 10, 60])
def test_sma_matches_jax(n):
    x = np.random.default_rng(7).normal(size=50)
    np.testing.assert_array_equal(plotting.sma(x, n), jplotting.sma(x, n))


def test_plot_hist_writes_a_png(tmp_path):
    timeline = np.stack([np.arange(40), np.linspace(1, 0, 40),
                         np.zeros(40)], 1)
    plotting.plot_hist(timeline, save_name=str(tmp_path / "h.png"),
                       loss_smoothing_len=5)
    assert (tmp_path / "h.png").stat().st_size > 0


def test_backup_matches_jax(tmp_path):
    script = tmp_path / "train.py"
    script.write_text("print('train')\n")
    for name, cls in (("port", Backup), ("jax", JBackup)):
        (tmp_path / name).mkdir()
        cls(str(script), str(tmp_path / name)).archive_backup()
    assert (tmp_path / "port" / "train.py.backup").read_bytes() == \
        (tmp_path / "jax" / "train.py.backup").read_bytes()
    with tarfile.open(tmp_path / "port" / "elektronn3_tpu_torch.tar.gz") as t:
        names = t.getnames()
    assert "elektronn3_tpu_torch/training/trainer.py" in names
    assert not any(n.endswith(".pyc") or "/_build/" in n for n in names)
    env = (tmp_path / "port" / "env_info.txt").read_text()
    assert f"torch {torch.__version__}" in env and "device" in env
    assert sorted(os.listdir(tmp_path / "port")) == [
        "elektronn3_tpu_torch.tar.gz", "env_info.txt", "train.py.backup"]
