"""The port's config layer (``config.py``) against the JAX package's, and
its debug and timing utilities (``utils/``), on the CPU.

- A ``TrainingConfig`` written by either package loads in the other and
  writes the same JSON again, key for key; the registry holds JAX's 16
  model names.
- ``build_trainer`` makes the port's ``Trainer`` with the config's
  ``worker_type`` in every loader it makes, its optimizer (the torch
  optimizer of optax's update; SGD's step equals optax's on the same
  gradient, to 1e-6 relative), its scheduler, and ``config.json`` in the
  run directory; two ``Trainer.run`` steps.
- The fault not copied: JAX's ``ModelConfig.build`` catches
  ``TypeError`` and builds a model that takes no ``dtype`` in float32
  when ``'bfloat16'`` was asked; the port raises ``ValueError``.
- ``find_live_arrays`` finds a tensor it is shown, largest first;
  ``device_memory_stats`` is ``{}`` without a card; ``sync_overhead_s``
  is a small positive time on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elektronn3_tpu import config as jcfg
from elektronn3_tpu_torch import config as pcfg
from elektronn3_tpu_torch.data import DataLoader
from elektronn3_tpu_torch.modules.loss import CEDiceLoss
from elektronn3_tpu_torch.training import Padam, Trainer
from elektronn3_tpu_torch.training import schedulers as psched
from elektronn3_tpu_torch.training import trainer as trainer_mod
from elektronn3_tpu_torch.utils import (
    device_memory_stats, find_live_arrays, sync_overhead_s)

UNET = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
            planar_blocks=(0,), dim=3)


def _config(mod, tmp_path):
    return mod.TrainingConfig(
        model=mod.ModelConfig("UNet", dict(UNET), dtype="bfloat16"),
        optimizer=mod.OptimizerConfig("sgd", lr=0.05,
                                      kwargs={"momentum": 0.9}),
        scheduler=mod.SchedulerConfig("step", {"step_size": 10,
                                               "gamma": 0.5}),
        batch_size=2, num_workers=0, worker_type="process", max_steps=2,
        save_root=str(tmp_path), exp_name="cfg", seed=3,
        trainer_kwargs={"enable_tensorboard": False})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_crosses_between_the_packages(tmp_path, direction):
    src, dst = (jcfg, pcfg) if direction == "jax_to_port" else (pcfg, jcfg)
    cfg = _config(src, tmp_path)
    path = str(tmp_path / "run.json")
    cfg.save(path)
    back = dst.TrainingConfig.load(path)
    assert back.to_json() == cfg.to_json()
    assert json.loads(back.to_json()) == json.loads(open(path).read())
    assert back.model.kwargs["planar_blocks"] == (0,)
    assert back.scheduler.name == "step" and back.model.dtype == "bfloat16"


def test_registry_holds_jaxs_names():
    assert set(pcfg._models()) == set(jcfg._models())
    assert len(pcfg._models()) == 16


def test_build_trainer_with_worker_type(tmp_path, monkeypatch):
    made = []
    real = trainer_mod.DataLoader

    def spy(*a, **k):
        made.append(k.get("worker_type"))
        return real(*a, **k)
    monkeypatch.setattr(trainer_mod, "DataLoader", spy)

    class Patches:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return {"inp": rng.normal(size=(1, 4, 12, 12)).astype(np.float32),
                    "target": rng.integers(0, 2, (4, 12, 12))}

    cfg = pcfg.TrainingConfig.from_json(_config(pcfg, tmp_path).to_json())
    cfg.model.dtype = "float32"
    tr = cfg.build_trainer(CEDiceLoss(), train_dataset=Patches(),
                           valid_dataset=Patches(), device="cpu")
    assert isinstance(tr, Trainer) and tr.worker_type == "process"
    assert isinstance(tr.optimizer, torch.optim.SGD)
    assert tr.optimizer.param_groups[0]["momentum"] == 0.9
    assert isinstance(tr.lr_scheduler, psched.StepLR)
    assert tr.seed == 3 and tr.batch_size == 2
    saved = pcfg.TrainingConfig.load(f"{tr.save_path}/config.json")
    assert saved.to_json() == cfg.to_json()
    tr.run(max_steps=cfg.max_steps)
    assert tr.step == 2
    assert made and set(made) == {"process"}


def test_bfloat16_model_config_builds_a_bfloat16_unet():
    m = pcfg.ModelConfig("UNet", dict(UNET), dtype="bfloat16").build("cpu")
    assert m.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        pcfg.ModelConfig("UNet", dict(UNET), dtype="float16").build("cpu")


class NoDtype(torch.nn.Module):
    def __init__(self, width=3):
        super().__init__()
        self.lin = torch.nn.Linear(width, width)


def test_dtype_fault_not_copied(monkeypatch):
    """JAX builds a model without a ``dtype`` parameter in float32 when
    bfloat16 is asked (its ``except TypeError``); the port refuses."""
    monkeypatch.setitem(pcfg.MODEL_REGISTRY, "NoDtype", NoDtype)
    pcfg._models()
    with pytest.raises(ValueError, match="no dtype"):
        pcfg.ModelConfig("NoDtype", {"width": 3}, dtype="bfloat16").build()
    m = pcfg.ModelConfig("NoDtype", {"width": 3}).build(device="cpu")
    assert m.lin.weight.dtype == torch.float32

    class Flax:   # the JAX side: a constructor without dtype
        def __init__(self, width=3):
            self.width = width
    jcfg._models()
    monkeypatch.setitem(jcfg.MODEL_REGISTRY, "NoDtype", Flax)
    built = jcfg.ModelConfig("NoDtype", {"width": 3},
                             dtype="bfloat16").build()
    assert isinstance(built, Flax)     # silently without bfloat16


@pytest.mark.parametrize("name, kwargs", [
    ("sgd", {"momentum": 0.9, "nesterov": True}), ("sgd", {}),
    ("adam", {"b1": 0.8, "eps": 1e-6}), ("adamw", {"weight_decay": 1e-2}),
    ("adamw", {}), ("padam", {"partial": 0.25})])
def test_optimizer_steps_match_optax(name, kwargs):
    """Three steps on the same gradients from the same parameters."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    tx = jcfg.OptimizerConfig(name, lr=0.01, kwargs=dict(kwargs)).build()
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = pcfg.OptimizerConfig(name, lr=0.01, kwargs=dict(kwargs)).build([p])
    if name == "padam":
        assert isinstance(opt, Padam)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
    ref = np.asarray(jp)
    err = float(np.abs(p.detach().numpy() - ref).max())
    assert err <= 1e-6 * float(np.abs(ref).max()) + 1e-7, err
    with pytest.raises(ValueError, match="takes no"):
        pcfg.OptimizerConfig(name, kwargs={"bogus": 1}).build([p])


def test_schedulers_match_jax():
    for name, kw in [("constant", {}), ("step", {"step_size": 2}),
                     ("exp", {"gamma": 0.9}),
                     ("cyclic", {"max_lr": 0.1, "step_size_up": 2}),
                     ("cosine", {"t_max": 5})]:
        js = jcfg.SchedulerConfig(name, dict(kw)).build(0.01)
        ps = pcfg.SchedulerConfig(name, dict(kw)).build(0.01)
        for _ in range(6):
            assert ps.get_lr() == pytest.approx(js.get_lr(), rel=1e-6), name
            js.step()
            ps.step()
    with pytest.raises(ValueError):
        pcfg.SchedulerConfig("nope").build(0.1)


def test_find_live_arrays_and_memory_stats():
    big = torch.zeros(1000, 257)
    found = find_live_arrays(min_bytes=1000 * 257 * 4)
    assert ((1000, 257), "torch.float32", 1000 * 257 * 4) in found
    sizes = [n for _, _, n in find_live_arrays()]
    assert sizes == sorted(sizes, reverse=True)
    assert find_live_arrays(min_bytes=1, device="cuda") == []
    assert device_memory_stats() == {}
    del big


def test_sync_overhead_is_a_small_positive_time():
    t = sync_overhead_s(probe_reps=3, device="cpu")
    assert 0.0 < t < 0.5
