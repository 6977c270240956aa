"""Serializable run configuration.

Counterpart of the JAX package's ``config.py``: a ``TrainingConfig``
goes to JSON and back, is written into the run directory, and builds
the model, optimizer, scheduler and ``Trainer`` it describes. The JSON
layout is JAX's, key for key, so a ``config.json`` written by either
package loads in the other; the names (models, optimizers, schedulers)
map to the port's classes.

Example::

    cfg = TrainingConfig(
        model=ModelConfig("UNet", dict(in_channels=1, out_channels=2,
                                       n_blocks=4, planar_blocks=(0,),
                                       dim=3), dtype="bfloat16"),
        optimizer=OptimizerConfig("adamw", lr=1e-3),
        batch_size=8, max_steps=2000)
    cfg.save("run.json")
    trainer = TrainingConfig.load("run.json").build_trainer(
        train_dataset=ds, criterion=crit)
    trainer.run(cfg.max_steps)

``OptimizerConfig.kwargs`` are optax's names (``b1``, ``b2``, ``eps``,
``weight_decay``, ``momentum``, ``nesterov``, ``partial``), taken by the
torch optimizer of the same update; optax's ``adamw`` weight decay
default, 1e-4, stays the default. A model is built with ``dtype`` only
where its constructor takes one; asking ``'bfloat16'`` of one that does
not is a ``ValueError`` (JAX builds it in float32 without a word).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

MODEL_REGISTRY: Dict[str, Any] = {}


def _models() -> Dict[str, Any]:
    """The model registry (name -> constructor), filled on first use."""
    if not MODEL_REGISTRY:
        from elektronn3_tpu_torch.models import (
            fcn, fcn_2d, msdnet, resunet, simple, tiramisu, unet,
            unet3d_lite, vnet)
        MODEL_REGISTRY.update({
            "UNet": unet.UNet,
            "ResUNet": resunet.ResUNet,
            "VNet": vnet.VNet,
            "FCN32s3d": fcn.fcn32s,
            "FCN16s3d": fcn.fcn16s,
            "FCN8s3d": fcn.fcn8s,
            "FCN32s": fcn_2d.FCN32s,
            "FCN16s": fcn_2d.FCN16s,
            "FCN8s": fcn_2d.FCN8s,
            "FCDenseNet": tiramisu.FCDenseNet,
            "MSDNet": msdnet.MSDNet,
            "UNet3dLite": unet3d_lite.UNet3dLite,
            "Simple3DNet": simple.Simple3DNet,
            "Extended3DNet": simple.Extended3DNet,
            "N3DNet": simple.N3DNet,
            "StackedConv2Scalar": simple.StackedConv2Scalar,
        })
    return MODEL_REGISTRY


OPTIMIZERS = ("adam", "adamw", "sgd", "padam")
DTYPES = ("float32", "bfloat16")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    return obj


def _canonical(obj):
    """Every sequence as a tuple (JSON has none), so that a config equals
    itself after a round trip."""
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(_canonical(v) for v in obj)
    return obj


@dataclasses.dataclass
class ModelConfig:
    name: str = "UNet"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"  # 'float32' | 'bfloat16'

    def __post_init__(self):
        self.kwargs = _canonical(self.kwargs)

    def build(self, device=None):
        """The model, on ``device`` where given (else its class's
        default: the card for the port's models)."""
        import torch
        from elektronn3_tpu_torch.training.trainer import _takes
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got "
                             f"{self.dtype!r}")
        cls = _models()[self.name]
        kw = dict(self.kwargs)
        if _takes(cls, "dtype"):
            kw["dtype"] = getattr(torch, self.dtype)
        elif self.dtype != "float32":
            raise ValueError(f"model {self.name!r} takes no dtype, so it "
                             f"cannot be built in {self.dtype}")
        if device is not None:
            if _takes(cls, "device"):
                kw["device"] = device
            else:
                return cls(**kw).to(device)
        return cls(**kw)


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-3
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, params):
        """The torch optimizer over ``params`` (a model's
        ``parameters()``) that makes optax's update of the same name."""
        import torch
        from elektronn3_tpu_torch.training.optim import Padam
        if self.name not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer {self.name!r}; "
                             f"choose from {OPTIMIZERS}")
        kw = dict(self.kwargs)
        betas = (kw.pop("b1", 0.9), kw.pop("b2", 0.999))
        if self.name == "sgd":
            opt = torch.optim.SGD(
                params, lr=self.lr, momentum=kw.pop("momentum", None) or 0.0,
                nesterov=kw.pop("nesterov", False))
        elif self.name == "adam":
            opt = torch.optim.Adam(params, lr=self.lr, betas=betas,
                                   eps=kw.pop("eps", 1e-8))
        elif self.name == "adamw":
            opt = torch.optim.AdamW(
                params, lr=self.lr, betas=betas, eps=kw.pop("eps", 1e-8),
                weight_decay=kw.pop("weight_decay", 1e-4))
        else:
            opt = Padam(params, lr=self.lr, betas=betas,
                        eps=kw.pop("eps", 1e-8),
                        partial=kw.pop("partial", 0.125),
                        weight_decay=kw.pop("weight_decay", 0.0))
        if kw:
            raise ValueError(f"optimizer {self.name!r} takes no "
                             f"{sorted(kw)}")
        return opt


@dataclasses.dataclass
class SchedulerConfig:
    name: str = "constant"  # constant | step | exp | cyclic | cosine
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, lr: float):
        from elektronn3_tpu_torch.training import schedulers as S
        table = {"constant": S.ConstantLR, "step": S.StepLR,
                 "exp": S.ExponentialLR, "cyclic": S.CyclicLR,
                 "cosine": S.CosineAnnealingLR}
        if self.name not in table:
            raise ValueError(f"Unknown scheduler {self.name!r}")
        kw = {k: v for k, v in self.kwargs.items()
              if k not in ("lr", "base_lr")}
        return table[self.name](
            self.kwargs.get("base_lr", self.kwargs.get("lr", lr)), **kw)


@dataclasses.dataclass
class TrainingConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    batch_size: int = 1
    num_workers: int = 0
    worker_type: str = "thread"
    max_steps: int = 500_000
    max_runtime: int = 3600 * 24 * 4
    save_root: Optional[str] = None
    exp_name: Optional[str] = None
    seed: int = 0
    trainer_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return _jsonable(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        d = dict(d)
        d["model"] = ModelConfig(**d.get("model", {}))
        d["optimizer"] = OptimizerConfig(**d.get("optimizer", {}))
        sched = d.get("scheduler")
        d["scheduler"] = SchedulerConfig(**sched) if sched else None
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TrainingConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- builders --------------------------------------------------------

    def build_model(self, device=None):
        return self.model.build(device)

    def build_trainer(self, criterion, train_dataset=None,
                      valid_dataset=None, device=None, **overrides):
        """The port's ``Trainer`` of this config (``overrides`` win over
        the config's ``trainer_kwargs``, which win over its fields); the
        config is written to ``config.json`` in its run directory."""
        from elektronn3_tpu_torch.training import Trainer
        model = self.build_model(device)
        schedulers = None
        if self.scheduler is not None:
            schedulers = {"lr": self.scheduler.build(self.optimizer.lr)}
        kw = dict(
            model=model,
            criterion=criterion,
            optimizer=self.optimizer.build(model.parameters()),
            train_dataset=train_dataset,
            valid_dataset=valid_dataset,
            batch_size=self.batch_size,
            num_workers=self.num_workers,
            worker_type=self.worker_type,
            lr=self.optimizer.lr,
            schedulers=schedulers,
            save_root=self.save_root,
            exp_name=self.exp_name,
            seed=self.seed,
            hparams=self._hparams(),
        )
        kw.update(self.trainer_kwargs)
        kw.update(overrides)
        trainer = Trainer(**kw)
        try:
            self.save(f"{trainer.save_path}/config.json")
        except OSError:
            pass
        return trainer

    def _hparams(self) -> Dict[str, Any]:
        """Flat scalar view for TensorBoard's ``add_hparams``."""
        flat = {
            "model": self.model.name,
            "optimizer": self.optimizer.name,
            "lr": self.optimizer.lr,
            "batch_size": self.batch_size,
            "seed": self.seed,
        }
        for k, v in self.model.kwargs.items():
            if isinstance(v, (int, float, str, bool)):
                flat[f"model/{k}"] = v
        return flat
