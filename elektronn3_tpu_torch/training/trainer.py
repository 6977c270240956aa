"""Supervised training loop.

Counterpart of the JAX package's ``training/trainer.py`` (reference
elektronn3/training/trainer.py), with its arguments:

- :func:`train_step` is the one training step, used by :class:`Trainer`
  and by any bench-style loop: the forward in training (the batch-norm
  running statistics update as the forward runs), the loss in float32,
  the backward and the optimizer step.
- The default optimizer matches the JAX Trainer's optax ``adamw`` at lr
  1e-3 with optax's weight decay of 1e-4 (``torch.optim.AdamW``'s own
  default, 0.01, is not that value).
- Batches come from ``data.pipeline.DataLoader`` over a map-style
  dataset of dicts ``{"inp": (C, *spatial), "target": (*spatial)}``
  (shuffled under ``seed``, each sample made under its own numpy seed,
  the last incomplete batch dropped; ``inp`` moved to channels-last, the
  layout of the models; pinned for the copy to the card), for example
  ``data.PatchCreator``, or from a loader-style iterable that yields
  channels-last batches itself.
- Losses stay on the device and are fetched, and checked for NaN, every
  ``nan_check_interval`` steps in one stacked copy: the loop's only
  host sync, but for a plateau-style scheduler, which reads the loss of
  every step.
- Schedulers (``schedulers.py``) step once a step; the ``'lr'`` one
  drives the optimizer's rate when the Trainer owns the schedule. A
  strict minimum of the rate writes a ``_minlr_step{k}`` snapshot and
  takes the parameters into :class:`~.optim.SWA`; :meth:`Trainer.
  apply_swa` swaps the average in and re-estimates the batch norms.
- Validation after each epoch (``valid_dataset``): the eval forward
  (the serving kernels) under ``torch.inference_mode``; the streaming
  metrics from (C, 4) confusion counts summed on the device, the others
  from the outputs kept on the device; a ``_best`` snapshot whenever
  ``val_loss`` improves.
- TensorBoard (if the ``tensorboard`` package is there; else a warning,
  as in JAX): the ``stats/*`` and ``misc/*`` scalars, sample images
  (matplotlib figures, where it is installed), parameter and gradient
  histograms (the gradient pass keeps the norm buffers as they were),
  preview images.
- Preview inference of ``preview_batch`` through the port's
  ``Predictor`` every ``preview_interval`` epochs. It runs with or
  without TensorBoard (JAX's runs only with a writer), so that a
  ``preview_plotting_handler`` sees it on a machine without one.
- Files in ``save_root/exp_name``: ``state_dict{suffix}.pth`` (model,
  optimizer, the rate scheduler's state, ``info``) for
  :meth:`Trainer.load_state`, ``model{suffix}.pt`` (:func:`save_model`:
  constructor arguments and weights, :func:`load_model` without the
  Trainer), the run's log ``elektronn3_tpu_torch.log``, TensorBoard
  events and a ``torch.profiler`` Chrome trace of the ``profile_steps``
  window under ``profile/``; on the ``_final`` and ``_best`` snapshots,
  given ``example_input``, also ``model{suffix}.pt2``, the deployment
  artifact (:func:`export_program`, JAX's StableHLO export), which
  :func:`load_program` and the ``Predictor`` load without the model's
  code.
- ``mesh`` (``parallel.make_mesh``): data parallelism over the mesh's
  first axis, one process a rank, JAX's ``shard_map`` step. See
  :func:`train_step`.

Subclasses change one batch's work (:meth:`Trainer._train_batch`) and
the loader's layout (:meth:`Trainer._loader`), and keep the loop: the
Noise2Void, triplet and gradient-accumulation trainers.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import functools
import importlib
import importlib.util
import inspect
import os
import shutil
import tarfile
import time
from math import inf
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from elektronn3_tpu_torch.data.pipeline import DataLoader
from elektronn3_tpu_torch.logger import change_log_file_to, logger
from elektronn3_tpu_torch.parallel.collectives import (
    all_gather, gather, psum, stats_group, sum_gradients)
from elektronn3_tpu_torch.parallel.distributed import process_index
from elektronn3_tpu_torch.parallel.mesh import Axis, Mesh, shard_rows
from elektronn3_tpu_torch.training.metrics import confusion_matrix
from elektronn3_tpu_torch.training.optim import (
    SWA, bn_update, kept_norm_buffers)
from elektronn3_tpu_torch.training.schedulers import ConstantLR, LRScheduler
from elektronn3_tpu_torch.training.train_utils import (
    Timer, pretty_string_time)


class NaNException(RuntimeError):
    """The loss diverged to NaN (reference trainer.py:48-51)."""


def default_optimizer(model: nn.Module, lr: float = 1e-3,
                      ) -> torch.optim.Optimizer:
    """AdamW as the JAX Trainer's ``optax.adamw(lr)``: betas (0.9,
    0.999), eps 1e-8, decoupled weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def _global_forward(model: nn.Module, inp: torch.Tensor,
                    dp: Optional[Axis], reference: bool = False,
                    ) -> torch.Tensor:
    """The logits of the global batch ``inp``. Under the data axis
    ``dp``: the model on this rank's rows with its batch-norm statistics
    summed over the axis, the logits all-gathered (every rank then holds
    the global batch's, and its gradient flows back to this rank's rows
    only). A tuple ``inp`` is the model's positional inputs (a
    classifier's image and scalar features), each of the batch's rows."""
    args = inp if isinstance(inp, tuple) else (inp,)
    kw = {"reference": True} if reference else {}
    if dp is None:
        return model(*args, **kw)
    with stats_group(dp):
        out = model(*(shard_rows(a, dp) for a in args), **kw)
    return all_gather(out, dp)


def _step(model: nn.Module, criterion: Callable,
          optimizer: torch.optim.Optimizer, inp: torch.Tensor,
          target: torch.Tensor, reference: bool = False,
          unlabeled: Optional[torch.Tensor] = None,
          ss_criterion: Optional[Callable] = None,
          ss_rng: Optional[torch.Generator] = None,
          dp: Optional[Axis] = None):
    """:func:`train_step` returning (loss, logits), both detached. With
    ``unlabeled`` and ``ss_criterion`` the loss adds the semi-supervised
    term in JAX's two conventions: a criterion with an ``apply_fn``
    attribute (``FixMatchSegLoss``) is called as ``ss_criterion(
    unlabeled, rng=ss_rng, apply_fn=f)`` with ``f`` the model in
    training mode (``rng`` only where its call takes one), any other on
    the unlabeled logits. ``dp``: the data axis (see :func:`train_step`);
    ``f`` is then the sharded, gathered forward of a global batch."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = _global_forward(model, inp, dp, reference)
    loss = criterion(out, target)
    if unlabeled is not None and ss_criterion is not None:
        fwd = model if dp is None \
            else functools.partial(_global_forward, model, dp=dp)
        if hasattr(ss_criterion, "apply_fn"):
            kw = {"rng": ss_rng} if _takes(ss_criterion, "rng") else {}
            loss = loss + ss_criterion(unlabeled, apply_fn=fwd, **kw)
        else:
            loss = loss + ss_criterion(fwd(unlabeled))
    loss = loss.float()
    loss.backward()
    sum_gradients(model.parameters(), dp)
    optimizer.step()
    return loss.detach(), out.detach()


def data_axis(mesh: Optional[Mesh]) -> Optional[Axis]:
    """The axis a mesh shards the batch over: its first (JAX's
    ``mesh.axis_names[0]``); None without a mesh."""
    return None if mesh is None else mesh.axis(mesh.axis_names[0])


def train_step(model: nn.Module, criterion: Callable,
               optimizer: torch.optim.Optimizer, inp: torch.Tensor,
               target: torch.Tensor, *,
               reference: bool = False,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One optimization step on a channels-last batch (a tuple ``inp``:
    the model's positional inputs); returns the loss
    as a detached float32 device tensor (no host sync). ``reference``
    runs the model with ``reference=True`` (the UNet's plain versions of
    its kernels, to time or check the kernels against).

    ``mesh``: data parallelism over its first axis, with JAX's
    ``shard_map`` semantics. ``inp`` and ``target`` are the GLOBAL batch
    on every rank; each rank runs the model on its block of rows with
    the batch-norm statistics of every level summed over the axis, the
    logits are all-gathered and every rank computes the loss of the
    global batch; after the backward the parameter gradients are
    all-reduced with a SUM (one flat buffer a dtype), which is the
    gradient of that global loss (the gradient of each rank's share
    sums to it; a DDP-style mean would divide it by the axis size, and
    per-rank losses averaged would change any loss that is not a mean
    over voxels, as Dice or a class-weighted cross entropy). So every
    rank steps to the same parameters and running statistics."""
    return _step(model, criterion, optimizer, inp, target, reference,
                 dp=data_axis(mesh))[0]


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _takes(fn: Callable, name: str) -> bool:
    """Whether ``fn`` takes a keyword argument ``name``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(p.kind == p.VAR_KEYWORD
                                 for p in params.values())


def _accepts_metric(step: Callable) -> bool:
    try:
        params = inspect.signature(step).parameters
    except (TypeError, ValueError):
        return False
    return "metric" in params or "metrics" in params


class Trainer:
    """Training loop with validation, schedules, snapshots, TensorBoard
    and preview inference.

    Args (the JAX Trainer's):
        model: a channels-last model (``elektronn3_tpu_torch.models.UNet``)
            on the device to train on.
        criterion: ``(logits, target) -> scalar`` loss.
        optimizer: a torch optimizer over the model's parameters, or
            None for :func:`default_optimizer` at ``lr``.
        device: if given, the model is moved there first.
        train_dataset, valid_dataset: map-style datasets of dicts with
            ``"inp"`` (C, *spatial) and ``"target"`` (*spatial) arrays;
            ``train_dataset`` may also be an iterable (no
            ``__getitem__``) of channels-last batches, used as it is.
        unlabeled_dataset, ss_criterion: semi-supervised training (see
            :func:`_step` for the two conventions); a criterion's draws
            (``FixMatchSegLoss``'s augmentations) come from one
            generator seeded ``seed``, passed as ``rng`` every step.
        valid_metrics: name -> evaluator ``(target, logits) -> value``
            (``metrics.py``; the streaming ones stream).
        save_root, exp_name: files go to ``save_root/exp_name``, which
            must not exist or be empty.
        example_input: a channels-last input, kept as ``example_input``
            (the JAX Trainer initializes its model from it; the port's
            model comes initialized); the ``_final`` and ``_best``
            snapshots export the model at its shape
            (``model{suffix}.pt2``, :func:`export_program`).
        batch_size, num_workers, worker_type: the DataLoaders' (every
            loader the Trainer makes: training, unlabeled, validation).
        lr: the rate of the default optimizer and of the default
            ``ConstantLR``.
        schedulers: name -> scheduler, each stepped once a step; the
            ``'lr'`` one drives the optimizer's rate. Without it a given
            optimizer keeps its own rate (logged as it was at the
            start).
        overlay_alpha: the segmentation overlay's alpha in images.
        enable_tensorboard, tensorboard_root_path: the writer, in the
            run directory or ``tensorboard_root_path/exp_name``.
        ignore_errors: log an exception in an epoch and go on.
        ipython_shell: drop into IPython on an exception or Ctrl-C.
        out_channels: the class count (``num_classes``).
        preview_batch, preview_interval, preview_tile_shape,
            preview_overlap_shape, preview_offset, inference_kwargs:
            preview inference of a channels-first numpy batch every
            ``preview_interval`` epochs with the port's
            ``Predictor(**inference_kwargs)``, tiled as given, with
            ``preview_offset`` as its ``offset`` (a valid-conv model's).
        extra_save_steps: steps after which a ``_step{k}`` snapshot is
            written.
        mixed_precision: the input rounded to bfloat16 (a bfloat16 model
            takes it so anyway).
        sample_plotting_handler, preview_plotting_handler: replace the
            default sample images (``handler(trainer)``) and preview
            images (``handler(trainer, inp, out)``).
        enable_videos: 3D samples as TensorBoard videos too.
        hparams: logged once with ``add_hparams``.
        knossos_preview_config: kept as ``knossos_preview_config`` for
            ``train_utils.create_preview_batch_from_knossos`` and
            ``handlers.write_to_kzip``; the loop itself reads it nowhere,
            as in JAX.
        tb_hist_interval: parameter and gradient histograms every N
            epochs; 0 never.
        seed: seeds the order of the batches and each sample's draws
            from numpy's global random state (sample ``i`` of epoch
            ``e`` under ``seed + e * len(dataset) + i``).
        tqdm_kwargs: for the progress bar, where ``tqdm`` is installed.
        profile_steps: (start, end): ``torch.profiler`` traces the steps
            after ``start`` up to ``end`` into ``save_path/profile``.
        nan_check_interval: steps between the batched loss fetches and
            NaN checks (1 checks every step).
        mesh: a ``parallel.Mesh``: data parallelism over its first axis
            (:func:`train_step`), one process a rank, every rank
            building the same Trainer. ``batch_size`` is the GLOBAL
            batch, as in JAX: every rank draws the same batches from
            ``seed`` and keeps its rows, so the samples are JAX's.
            Validation splits each batch over the ranks too (padded to
            equal parts; the streaming confusion counts all-reduced,
            the loss and the other metrics from the gathered logits);
            :meth:`apply_swa`'s ``bn_update`` sums its statistics over
            the ranks; random draws in the forward ('rrelu') come from
            a generator of each rank and step, JAX's ``fold_in`` of the
            axis index. Files, the log, TensorBoard, the profiler trace
            and preview inference come from rank 0 alone; the gradient
            histograms' pass runs on every rank.
        shard_strategy: 'auto', 'gspmd' or 'shard_map' (else
            ``ValueError``, with a mesh): JAX's two partitionings of its
            step. Both give the global batch's statistics, loss and
            gradient there, and the port has the one implementation
            above for all three.
    """

    def __init__(
            self,
            model: nn.Module,
            criterion: Callable,
            optimizer: Optional[torch.optim.Optimizer] = None,
            device=None,
            train_dataset=None,
            valid_dataset=None,
            unlabeled_dataset=None,
            ss_criterion: Optional[Callable] = None,
            valid_metrics: Optional[Dict[str, Callable]] = None,
            save_root: Optional[str] = None,
            exp_name: Optional[str] = None,
            example_input=None,
            batch_size: int = 1,
            num_workers: int = 0,
            worker_type: str = "thread",
            lr: float = 1e-3,
            schedulers: Optional[Dict[str, LRScheduler]] = None,
            overlay_alpha: float = 0.2,
            enable_tensorboard: bool = True,
            tensorboard_root_path: Optional[str] = None,
            ignore_errors: bool = False,
            ipython_shell: bool = False,
            out_channels: Optional[int] = None,
            preview_batch: Optional[np.ndarray] = None,
            preview_tile_shape: Optional[Tuple[int, ...]] = None,
            preview_overlap_shape: Optional[Tuple[int, ...]] = None,
            preview_offset: Optional[Tuple[int, ...]] = None,
            preview_interval: int = 5,
            inference_kwargs: Optional[Dict[str, Any]] = None,
            extra_save_steps: Sequence[int] = (),
            mixed_precision: bool = False,
            sample_plotting_handler: Optional[Callable] = None,
            preview_plotting_handler: Optional[Callable] = None,
            enable_videos: bool = False,
            hparams: Optional[Dict[str, Any]] = None,
            knossos_preview_config: Optional[Dict[str, Any]] = None,
            tb_hist_interval: int = 1,
            mesh: Optional[Mesh] = None,
            shard_strategy: str = "auto",
            seed: int = 0,
            tqdm_kwargs: Optional[Dict] = None,
            profile_steps: Optional[Tuple[int, int]] = None,
            nan_check_interval: int = 10,
    ):
        if nan_check_interval < 1:
            raise ValueError("nan_check_interval must be >= 1")
        self.mesh = mesh
        self.shard_strategy = shard_strategy
        self._dp = data_axis(mesh)
        if mesh is not None:
            if shard_strategy not in ("auto", "gspmd", "shard_map"):
                raise ValueError(
                    f"shard_strategy must be 'auto', 'gspmd' or "
                    f"'shard_map', got {shard_strategy!r}")
            if batch_size % self._dp.size:
                raise ValueError(
                    f"batch_size {batch_size} does not split over the "
                    f"{self._dp.size} ranks of axis {self._dp.name!r}")
        self._rank0 = process_index() == 0
        if device is not None:
            model.to(device)
        self.model = model
        self.criterion = criterion
        self.train_dataset = train_dataset
        self.valid_dataset = valid_dataset
        self.unlabeled_dataset = unlabeled_dataset
        self.ss_criterion = ss_criterion
        self.valid_metrics = valid_metrics or {}
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.worker_type = worker_type
        self.ignore_errors = ignore_errors
        self.ipython_shell = ipython_shell
        self.out_channels = self.num_classes = out_channels
        self.preview_batch = preview_batch
        self.preview_tile_shape = preview_tile_shape
        self.preview_overlap_shape = preview_overlap_shape
        self.preview_offset = preview_offset
        self.preview_interval = preview_interval
        self.inference_kwargs = dict(inference_kwargs or {})
        self.extra_save_steps = list(extra_save_steps)
        self.mixed_precision = mixed_precision
        self.sample_plotting_handler = sample_plotting_handler
        self.preview_plotting_handler = preview_plotting_handler
        self.enable_videos = enable_videos
        self.hparams = dict(hparams or {})
        self.knossos_preview_config = knossos_preview_config
        self.tb_hist_interval = tb_hist_interval
        self.seed = seed
        self.overlay_alpha = overlay_alpha
        self.tqdm_kwargs = dict(tqdm_kwargs or {})
        self.profile_steps = profile_steps
        self._profiler = None
        self._unlabeled_loader = None
        self._ss_rng = torch.Generator().manual_seed(seed)
        self.example_input = None if example_input is None \
            else np.asarray(example_input)
        self.device = _device_of(model)
        self.nan_check_interval = nan_check_interval

        self.step = 0
        self.epoch = 0
        self.terminate = False
        self._lr_nhood = []   # the last three rates, for LR minima
        self.best_val_loss = inf
        self.swa: Optional[SWA] = None
        self._timer = Timer()
        self.last_stats: Dict = {}    # the last epoch's stats and misc
        self.last_misc: Dict = {}
        self.last_seconds: Dict = {}  # its wall seconds by part
        self._last_sample = None      # (inp, target, logits) on the device
        self._last_val_sample = None

        # The Trainer drives the optimizer's rate only when it owns the
        # schedule: an 'lr' scheduler was given, or it built the
        # optimizer itself (JAX's _inject_lr).
        schedulers = dict(schedulers or {})
        self._inject_lr = "lr" in schedulers or optimizer is None
        self.optimizer = optimizer if optimizer is not None \
            else default_optimizer(model, lr)
        schedulers.setdefault("lr", ConstantLR(lr))
        self.schedulers: Dict[str, LRScheduler] = schedulers
        self.lr_scheduler: LRScheduler = schedulers["lr"]
        if not self._inject_lr:
            self.lr_scheduler = ConstantLR(
                float(self.optimizer.param_groups[0]["lr"]))

        if save_root is None:
            save_root = os.path.expanduser("~/e3tpu_training")
        self.save_root = os.path.expanduser(save_root)
        if exp_name is None:
            exp_name = model.__class__.__name__ + "__" + \
                datetime.datetime.now().strftime("%y-%m-%d_%H-%M-%S")
        self.exp_name = exp_name
        self.save_path = os.path.join(self.save_root, exp_name)
        self.tb = None
        # Known on every rank alike: the histograms' gradient pass runs
        # collectives on all of them when rank 0 writes its histograms.
        self._tb_enabled = enable_tensorboard and \
            importlib.util.find_spec("tensorboard") is not None
        # the default sample images are matplotlib figures
        self._can_plot = importlib.util.find_spec("matplotlib") is not None
        if not self._rank0:
            return
        if os.path.isdir(self.save_path) and os.listdir(self.save_path):
            raise RuntimeError(f"{self.save_path} already exists and is not "
                               "empty. Please choose a different exp_name.")
        os.makedirs(self.save_path, exist_ok=True)
        try:
            change_log_file_to(
                os.path.join(self.save_path, "elektronn3_tpu_torch.log"))
        except OSError:
            logger.exception("could not move the log file into the run")
        logger.info(f"Writing files to {self.save_path}")

        if self._tb_enabled:
            from torch.utils.tensorboard import SummaryWriter
            tb_path = self.save_path if tensorboard_root_path is None \
                else os.path.join(
                    os.path.expanduser(tensorboard_root_path), exp_name)
            self.tb = SummaryWriter(tb_path, flush_secs=20)
            if self.hparams:
                self.tb.add_hparams(hparam_dict=self.hparams,
                                    metric_dict={})
        elif enable_tensorboard:
            logger.warning("tensorboard not available; disabling TB logging.")
        if self.tb is not None and not self._can_plot \
                and sample_plotting_handler is None:
            logger.warning("matplotlib not available; TensorBoard gets no "
                           "sample images.")
        num_params = sum(p.numel() for p in model.parameters())
        logger.info(f"Model: {model.__class__.__name__} "
                    f"({num_params / 1e6:.2f}M params)"
                    + ("" if mesh is None else f", data-parallel over "
                       f"{self._dp.size} ranks of {mesh}"))

    # ------------------------------------------------------------------
    # Batches
    # ------------------------------------------------------------------

    def _map_loader(self, dataset, **kwargs) -> DataLoader:
        """The channels-last loader of a map-style dataset (pinned for a
        card): the JAX Trainer's ``DataLoader``, whose ``seed`` rule
        gives a seeded run the same batches again and keeps workers from
        repeating each other's draws."""
        return DataLoader(dataset, batch_size=self.batch_size,
                          num_workers=self.num_workers,
                          worker_type=self.worker_type,
                          pin_memory=self.device.type == "cuda", **kwargs)

    def _loader(self, **kwargs):
        """This epoch's loader: a loader-style training set itself, else
        the map-style set's ``DataLoader`` at epoch ``self.epoch``, in
        torch's sampler order under ``torch.Generator`` seed ``seed +
        epoch`` (``kwargs``: the loader's layout, as ``channels_last``)."""
        if hasattr(self.train_dataset, "__iter__") \
                and not hasattr(self.train_dataset, "__getitem__"):
            return self.train_dataset
        loader = self._map_loader(
            self.train_dataset, seed=self.seed,
            generator=torch.Generator().manual_seed(self.seed + self.epoch),
            **kwargs)
        loader.set_epoch(self.epoch)
        if len(loader) == 0:
            raise ValueError("the training dataset holds fewer samples than "
                             "one batch")
        return loader

    def _unlabeled_batches(self):
        """Unlabeled inputs without end, cycling one loader (as JAX
        does) that lives as long as the Trainer: each pass, in this epoch
        or a later one, is a new epoch of its draws."""
        if self._unlabeled_loader is None:
            self._unlabeled_loader = self._map_loader(
                self.unlabeled_dataset, seed=self.seed + 1)
        while True:
            for batch in self._unlabeled_loader:
                yield self._inp(batch["inp"])

    def _inp(self, inp) -> torch.Tensor:
        """A channels-last batch input on the device; bfloat16 under
        ``mixed_precision`` or for a bfloat16 model (JAX's input
        dtype)."""
        inp = torch.as_tensor(inp).to(self.device, non_blocking=True)
        if self.mixed_precision \
                or getattr(self.model, "dtype", None) == torch.bfloat16:
            inp = inp.to(torch.bfloat16)
        return inp

    def _batch(self, batch):
        inp = self._inp(batch["inp"])
        target = batch.get("target")
        if target is not None:
            target = torch.as_tensor(target).to(self.device,
                                                non_blocking=True)
        return inp, target

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def run(self, max_steps: int = 1,
            max_runtime: float = 3600 * 24 * 7) -> None:
        """Train until ``max_steps`` steps or ``max_runtime`` seconds,
        epoch by epoch, validating, logging, previewing and saving after
        each (reference Trainer.run, trainer.py:450-507)."""
        self.start_time = Timer()
        self._save_model(suffix="_initial", verbose=False)
        self._lr_nhood.clear()
        self._lr_nhood.append(self.lr_scheduler.get_lr())
        while not self.terminate:
            try:
                self._epoch(max_steps, max_runtime)
            except KeyboardInterrupt:
                if self.ipython_shell:
                    self._shell()
                break
            except Exception as e:
                logger.exception("Unhandled exception during training")
                if self.ignore_errors:
                    continue
                if self.ipython_shell:
                    self._shell()
                raise e
        self._stop_profiler()
        self._save_model(suffix="_final")
        if self.tb is not None:
            self.tb.close()

    def _epoch(self, max_steps: int, max_runtime: float) -> None:
        seconds = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            seconds[name] = now - t
            t = now

        stats, misc = self._train(max_steps, max_runtime)
        self.epoch += 1
        lap("train")
        if self.valid_dataset is not None:
            stats.update(self._validate())
        lap("validate")
        self._log_basic(stats, misc)
        self._log_to_tensorboard(stats, misc)
        lap("log")
        if self.preview_batch is not None and self._rank0 \
                and self.epoch % self.preview_interval == 0:
            try:
                self._run_preview_inference()
            except Exception:
                logger.exception("Preview inference failed")
        lap("preview")
        cur_val = stats.get("val_loss", np.nan)
        self._save_model(val_loss=cur_val, verbose=False)
        if cur_val < self.best_val_loss:
            self.best_val_loss = cur_val
            self._save_model(suffix="_best", verbose=False, val_loss=cur_val)
        lap("checkpoint")
        self.last_stats, self.last_misc = stats, misc
        self.last_seconds = seconds

    def _fetch(self, pending, stats) -> None:
        vals = torch.stack(pending).cpu().tolist()
        pending.clear()
        stats["tr_loss"].extend(vals)
        if any(np.isnan(v) for v in vals):
            raise NaNException("NaN loss detected! Aborting training.")

    def _train(self, max_steps: int, max_runtime: float):
        """One epoch over the loader (reference trainer.py:545-627)."""
        stats: Dict = {"tr_loss": []}
        misc: Dict = {}
        pending = []
        running_vx = 0
        t0 = time.perf_counter()
        loader = self._loader()
        unlabeled = self._unlabeled_batches() \
            if self.unlabeled_dataset is not None else None
        batches = loader
        try:
            from tqdm import tqdm
            batches = tqdm(loader, total=len(loader)
                           if hasattr(loader, "__len__") else None,
                           leave=False, dynamic_ncols=True, disable=None,
                           **self.tqdm_kwargs)
        except ImportError:
            pass
        for batch in batches:
            loss, voxels, stepped = self._train_batch(batch, unlabeled)
            pending.append(loss)
            if len(pending) >= self.nan_check_interval:
                self._fetch(pending, stats)
            running_vx += voxels
            if stepped:
                self.step += 1
                self._profile_window()
                self._scheduler_step(loss)
                if self.step in self.extra_save_steps:
                    self._save_model(suffix=f"_step{self.step}")
            if self.step >= max_steps:
                logger.info(f"max_steps ({max_steps}) reached. Terminating.")
                self.terminate = True
            if self.start_time.t_passed >= max_runtime:
                logger.info(f"max_runtime ({max_runtime} s) exceeded. "
                            "Terminating.")
                self.terminate = True
            if self.terminate:
                break
        if pending:
            self._fetch(pending, stats)
        t = time.perf_counter() - t0
        misc["tr_speed"] = max(len(stats["tr_loss"]), 1) / t
        misc["tr_speed_vx"] = running_vx / t / 1e6   # MVx/s
        misc["learning_rate"] = self.lr_scheduler.get_lr()
        stats["tr_loss_mean"] = float(np.mean(stats["tr_loss"])) \
            if stats["tr_loss"] else np.nan
        return stats, misc

    def _set_lr(self) -> None:
        """The rate of this step into the optimizer, where the Trainer
        owns the schedule."""
        if self._inject_lr:
            lr = self.lr_scheduler.get_lr()
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def _train_batch(self, batch, unlabeled):
        """One batch of the loop: (loss as a detached device tensor,
        voxels of the input, whether the optimizer stepped). Here one
        supervised step, and the batch kept for the sample images."""
        inp, target = self._batch(batch)
        self._set_lr()
        with self._rank_rng():
            loss, out = _step(
                self.model, self.criterion, self.optimizer, inp, target,
                unlabeled=None if unlabeled is None else next(unlabeled),
                ss_criterion=self.ss_criterion, ss_rng=self._ss_rng,
                dp=self._dp)
        self._last_sample = (inp, target, out)
        return loss, inp.numel(), True

    @contextlib.contextmanager
    def _rank_rng(self):
        """Under a data axis of several ranks, the forward's random draws
        ('rrelu') from the default generators of the CPU and this rank's
        card seeded by (``seed``, step, rank) and restored after: JAX's
        ``fold_in(rng, axis_index)``, so that the ranks' draws differ."""
        if self._dp is None or self._dp.size == 1:
            yield
            return
        cuda = self.device.type == "cuda"
        seed = int(np.random.SeedSequence(
            [self.seed, self.step, self._dp.index]).generate_state(1)[0])
        with torch.random.fork_rng(devices=[self.device] if cuda else []):
            torch.random.default_generator.manual_seed(seed)
            if cuda:
                torch.cuda.default_generators[
                    self.device.index or 0].manual_seed(seed)
            yield

    def _profile_window(self) -> None:
        """Start ``torch.profiler`` after step ``start``, stop it once
        ``end`` steps are done (reference trainer.py:610-622); rank 0
        alone."""
        if self.profile_steps is None or not self._rank0:
            return
        start, end = self.profile_steps
        if self.step == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif self.step >= end:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        start, end = self.profile_steps
        path = os.path.join(self.save_path, "profile")
        os.makedirs(path, exist_ok=True)
        trace = os.path.join(path, f"trace_steps{start}-{self.step}.json")
        self._profiler.export_chrome_trace(trace)
        self._profiler = None
        logger.info(f"Wrote profiler trace for steps {start}-{end} to "
                    f"{trace}")

    def _scheduler_step(self, loss: torch.Tensor) -> None:
        """Step every scheduler; one whose ``step`` takes a metric gets
        the step's loss as a device tensor (a plateau-style one reads
        it: a host sync). Then look for a minimum of the rate
        (reference trainer.py:629-705)."""
        for sched in self.schedulers.values():
            if _accepts_metric(sched.step):
                sched.step(loss)
            else:
                sched.step()
        self._lr_nhood.append(self.lr_scheduler.get_lr())
        if len(self._lr_nhood) > 3:
            self._lr_nhood.pop(0)
        self._handle_lr()

    def _handle_lr(self) -> None:
        """At a strict local minimum of the rate (a > b < c over the
        last three), write a ``_minlr_step{k}`` snapshot and take the
        parameters into SWA (snapshot ensembling)."""
        if len(self._lr_nhood) < 3:
            return
        a, b, c = self._lr_nhood[-3:]
        if a > b < c:
            self._save_model(suffix=f"_minlr_step{self.step}", verbose=False)
            if self.swa is None:
                self.swa = SWA()
            self.swa.update_swa(dict(self.model.named_parameters()))

    def _validate(self) -> Dict[str, float]:
        """Validation pass (reference trainer.py:707-776) in eval mode
        under ``torch.inference_mode``, in order, the last batch as it
        falls. The streaming evaluators take one (C, 4) count matrix a
        distinct ``ignore``, summed on the device; the others the
        outputs, concatenated on the device. The losses and counts are
        fetched once, after the last batch.

        Under a data axis each batch is padded (repeating its last row)
        to equal parts, each rank runs its part, and the logits are
        gathered without the padding: the loss and the non-streaming
        metrics are the global batch's on every rank; the counts come
        from each rank's own rows and are all-reduced once at the
        end."""
        loader = self._map_loader(self.valid_dataset, shuffle=False,
                                  seed=self.seed, drop_last=False)
        streaming = {name: ev for name, ev in self.valid_metrics.items()
                     if getattr(ev, "supports_streaming", False)}
        nonstreaming = {name: ev for name, ev in self.valid_metrics.items()
                        if name not in streaming}
        ignores = {ev.ignore for ev in streaming.values()}
        counts: Dict[Any, torch.Tensor] = {}
        losses, outs, targets = [], [], []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in loader:
                    inp, target = self._batch(batch)
                    out, own, rows = self._eval_forward(inp)
                    losses.append(self.criterion(out, target).float())
                    self._last_val_sample = (inp, target, out)
                    if target is None:
                        continue
                    if streaming:
                        pred = torch.argmax(own, -1)
                        for ign in ignores:
                            cm = confusion_matrix(
                                target[rows], pred, out.shape[-1],
                                nan_when_empty=False, ignore=ign)
                            counts[ign] = cm if ign not in counts \
                                else counts[ign] + cm
                    if nonstreaming:
                        outs.append(out)
                        targets.append(target)
                counts = {ign: psum(cm, self._dp)
                          for ign, cm in counts.items()}
        finally:
            self.model.train(was_training)
        vals = torch.stack(losses).cpu().tolist() if losses else []
        stats = {"val_loss": float(np.mean(vals)) if vals else np.nan}
        for name, ev in streaming.items():
            try:
                stats[name] = float(ev.from_cm(counts[ev.ignore]))
            except Exception:
                logger.exception(f"Evaluator {name} failed")
                stats[name] = np.nan
        if nonstreaming and outs:
            out_full, target_full = torch.cat(outs), torch.cat(targets)
            for name, ev in nonstreaming.items():
                try:
                    stats[name] = float(ev(target_full, out_full))
                except Exception:
                    logger.exception(f"Evaluator {name} failed")
                    stats[name] = np.nan
        return stats

    def _eval_forward(self, inp: torch.Tensor):
        """(logits of the global batch, this rank's logits, the slice of
        its rows) of an eval forward; see :meth:`_validate`."""
        n = inp.shape[0]
        if self._dp is None:
            out = self.model(inp)
            return out, out, slice(0, n)
        size, i = self._dp.size, self._dp.index
        m = -(-n // size)
        if m * size > n:
            inp = torch.cat([inp, inp[-1:].expand(
                (m * size - n,) + tuple(inp.shape[1:]))])
        own = self.model(shard_rows(inp, self._dp))
        lo, hi = min(i * m, n), min((i + 1) * m, n)
        return gather(own, self._dp)[:n], own[:hi - lo], slice(lo, hi)

    # ------------------------------------------------------------------
    # Logging
    # ------------------------------------------------------------------

    def _log_basic(self, stats, misc) -> None:
        """Console and log-file line (reference trainer.py:907-917), on
        rank 0."""
        if not self._rank0:
            return
        tr_loss = stats.get("tr_loss_mean", np.nan)
        val_loss = stats.get("val_loss", np.nan)
        lr = misc.get("learning_rate", np.nan)
        t = pretty_string_time(self._timer.t_passed)
        logger.info(
            f"step={self.step:07d} tr_loss={tr_loss:.3f} "
            f"val_loss={val_loss:.3f} lr={lr:.2e} "
            f"{misc.get('tr_speed', np.nan):.2f} it/s "
            f"{misc.get('tr_speed_vx', np.nan):.2f} MVx/s {t}")

    def _log_to_tensorboard(self, stats, misc) -> None:
        """Scalars, sample images and histograms (reference
        trainer.py:919-986). The other ranks run only their share of the
        histograms' gradient pass."""
        hist = self._tb_enabled and self.tb_hist_interval \
            and self.epoch % self.tb_hist_interval == 0
        # Every rank runs the gradient pass here, before anything that
        # rank 0 alone does or that swallows an exception: a rank that
        # skipped its collectives would pair the others' with its next
        # step's.
        grads = self._histogram_grads() \
            if hist and (self.tb is not None or self._dp is not None) \
            else None
        if self.tb is None:
            return
        for k, v in {**stats, **misc}.items():
            if isinstance(v, (int, float, np.floating)) \
                    and not isinstance(v, bool) and not np.isnan(v):
                self.tb.add_scalar(f"stats/{k}" if k in stats
                                   else f"misc/{k}", v, self.step)
        if self.sample_plotting_handler is not None:
            try:
                self.sample_plotting_handler(self)
            except Exception:
                logger.exception("sample_plotting_handler failed")
        elif self._can_plot:
            for sample, group in ((self._last_sample, "train_samples"),
                                  (self._last_val_sample, "val_samples")):
                if sample is None:
                    continue
                try:
                    from elektronn3_tpu_torch.training import handlers
                    inp, target, out = sample
                    handlers._tb_log_sample_images(self, {
                        "inp": _host(inp.movedim(-1, 1)),
                        "target": None if target is None else _host(target),
                        "out": _host(out.movedim(-1, 1))}, group=group)
                except Exception:
                    logger.exception("default sample plotting failed")
        if hist:
            try:
                self._tb_log_histograms(grads)
            except Exception:
                logger.exception("histogram logging failed")

    def _tb_log_histograms(self, grads=None) -> None:
        """Histograms of the parameters and of their gradients on the
        last training batch (reference trainer.py:977-986); ``grads`` is
        :meth:`_histogram_grads`'s result (None: run it here)."""
        for name, p in self.model.named_parameters():
            self.tb.add_histogram(f"param/{name}", _host(p), self.step)
        if grads is None:
            grads = self._histogram_grads()
        for name, g in grads:
            if g is not None:
                self.tb.add_histogram(f"grad/{name}", _host(g), self.step)

    def _histogram_grads(self):
        """(name, gradient) of the loss of the last training batch for
        each trainable parameter (summed over the data axis). The pass
        is a training-mode forward whose update of the batch norms'
        running statistics is undone (JAX discards its new
        ``batch_stats``); ``.grad`` is left alone."""
        if self._last_sample is None or self._last_sample[1] is None:
            return []
        inp, target, _ = self._last_sample
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        was_training = self.model.training
        with kept_norm_buffers(self.model):
            self.model.train()
            try:
                loss = self.criterion(
                    _global_forward(self.model, inp, self._dp),
                    target).float()
                grads = torch.autograd.grad(loss, [p for _, p in named],
                                            allow_unused=True)
            finally:
                self.model.train(was_training)
        return [(name, None if g is None else psum(g, self._dp))
                for (name, _), g in zip(named, grads)]

    def _run_preview_inference(self) -> np.ndarray:
        """Predict ``preview_batch`` with the port's Predictor (tiled by
        ``preview_tile_shape``/``preview_overlap_shape``, offset by
        ``preview_offset``; explicit
        ``inference_kwargs`` win), hand it to the preview handler or
        log its argmax, and return it (channels-first). The model's
        training mode is restored after (reference
        trainer.py:988-1003)."""
        from elektronn3_tpu_torch.inference import Predictor
        pkw = {k: v for k, v in self.inference_kwargs.items()
               if k != "apply_softmax"}
        if self.preview_tile_shape is not None:
            pkw.setdefault("tile_shape", self.preview_tile_shape)
        if self.preview_overlap_shape is not None:
            pkw.setdefault("overlap_shape", self.preview_overlap_shape)
        if self.preview_offset is not None:
            pkw.setdefault("offset", self.preview_offset)
        was_training = self.model.training
        try:
            out = Predictor(self.model, **pkw).predict(self.preview_batch)
        finally:
            self.model.train(was_training)
        if self.preview_plotting_handler is not None:
            self.preview_plotting_handler(self, self.preview_batch, out)
        elif self.tb is not None:
            pred = np.argmax(np.asarray(out), 1)
            img = pred[0, pred.shape[1] // 2] if pred.ndim == 4 else pred[0]
            self.tb.add_image("preview/pred", img[None].astype(np.float32)
                              / max(pred.max(), 1), self.step)
        return out

    # ------------------------------------------------------------------
    # Checkpoints (reference trainer.py:778-905)
    # ------------------------------------------------------------------

    def _save_model(self, suffix: str = "", verbose: bool = True,
                    val_loss=np.nan) -> str:
        """Write ``state_dict{suffix}.pth`` (model, optimizer, the rate
        scheduler's state and ``info``, for :meth:`load_state`),
        ``model{suffix}.pt`` (:func:`save_model`) and, for ``_final`` and
        ``_best`` with ``example_input`` set, ``model{suffix}.pt2``
        (:func:`export_program`; a failed export is logged and ends no
        run, as in JAX), on rank 0; returns the first's path."""
        path = os.path.join(self.save_path, f"state_dict{suffix}.pth")
        if not self._rank0:
            return path
        log = logger.info if verbose else logger.debug
        info = {
            "step": self.step,
            "epoch": self.epoch,
            "best_val_loss": float(self.best_val_loss),
            "val_loss": float(val_loss) if val_loss == val_loss else None,
            "inference_kwargs": self.inference_kwargs,
            "model_class": self.model.__class__.__name__,
        }
        torch.save({
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "lr_sched_state_dict": self.lr_scheduler.state_dict(),
            "info": info,
        }, path)
        log(f"Saved state_dict as {path}")
        model_path = os.path.join(self.save_path, f"model{suffix}.pt")
        save_model(self.model, model_path, info=info)
        log(f"Saved model as {model_path}")
        # The deployment artifact, on the terminal snapshots only (an
        # export traces the model anew), as JAX writes its StableHLO.
        if suffix in ("_final", "_best") and self.example_input is not None:
            try:
                program_path = os.path.join(self.save_path,
                                            f"model{suffix}.pt2")
                export_program(self.model, self.example_input.shape,
                               program_path)
                log(f"Saved the exported program as {program_path}")
            except Exception:
                logger.exception("torch.export of the model failed")
        return path

    def load_state(self, path: str) -> None:
        """Resume the model, the optimizer, the rate scheduler, the step
        and ``best_val_loss`` from a ``state_dict*.pth`` of
        :meth:`_save_model` (a trusted file: it is unpickled)."""
        blob = torch.load(path, map_location=self.device, weights_only=False)
        self.model.load_state_dict(blob["model_state_dict"])
        self.optimizer.load_state_dict(blob["optimizer_state_dict"])
        if "lr_sched_state_dict" in blob:
            self.lr_scheduler.load_state_dict(blob["lr_sched_state_dict"])
        info = blob["info"]
        self.step = info["step"]
        self.epoch = info["epoch"]
        self.best_val_loss = info.get("best_val_loss", inf)
        logger.info(f"Resumed training state from {path} (step {self.step}).")

    def apply_swa(self, bn_loader=None, max_batches: int = 10) -> None:
        """Swap the SWA average into the model's parameters (a second
        call swaps the former ones back) and, given ``bn_loader``,
        re-estimate the batch norms on at most ``max_batches`` of its
        batches (:func:`~.optim.bn_update`, over the Trainer's mesh;
        reference trainer.py:681-705)."""
        if self.swa is None or self.swa.avg_params is None:
            logger.warning("No SWA state accumulated yet.")
            return
        params = dict(self.model.named_parameters())
        new = self.swa.swap_swa_sgd(params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        if bn_loader is not None:
            bn_update(bn_loader, self.model, max_batches=max_batches,
                      mesh=self.mesh)

    def _shell(self):  # pragma: no cover
        import IPython
        IPython.embed(header="Dropping into IPython shell. "
                      "The Trainer is available as `self`.")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


class Backup:
    """Copies the training script and an archive of
    ``elektronn3_tpu_torch`` into the run directory, with the torch and
    CUDA versions and the device, so that a result can be reproduced
    (reference trainer.py:1006-1045)."""

    def __init__(self, script_path: Optional[str], save_path: str):
        self.script_path = script_path
        self.save_path = save_path

    def archive_backup(self) -> None:
        if self.script_path is not None and os.path.isfile(self.script_path):
            shutil.copyfile(
                self.script_path,
                os.path.join(self.save_path,
                             os.path.basename(self.script_path) + ".backup"))
        import elektronn3_tpu_torch
        pkg_dir = os.path.dirname(elektronn3_tpu_torch.__file__)
        with tarfile.open(os.path.join(self.save_path,
                                       "elektronn3_tpu_torch.tar.gz"),
                          "w:gz") as tar:
            tar.add(pkg_dir, arcname="elektronn3_tpu_torch",
                    filter=lambda ti: None if "_build" in ti.name.split("/")
                    or ti.name.endswith(".pyc") else ti)
        device = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "cpu"
        with open(os.path.join(self.save_path, "env_info.txt"), "w") as f:
            f.write(f"torch {torch.__version__}\n")
            f.write(f"cuda {torch.version.cuda}\n")
            f.write(f"device {device}\n")


_NOT_SAVED = ("self", "device", "generator")


def save_model(model: nn.Module, path: str,
               info: Optional[Dict] = None) -> None:
    """Write ``model`` as a file that :func:`load_model` rebuilds
    without the Trainer: its class, its constructor arguments (read back
    from the attributes of the same names, as the port's UNet keeps
    them; ``device`` and ``generator`` are not kept), its
    ``state_dict`` and ``info``."""
    cls = type(model)
    kwargs = {}
    for name, par in inspect.signature(cls.__init__).parameters.items():
        if name in _NOT_SAVED or par.kind in (par.VAR_POSITIONAL,
                                              par.VAR_KEYWORD):
            continue
        if hasattr(model, name):
            kwargs[name] = getattr(model, name)
        elif par.default is par.empty:
            raise ValueError(f"save_model: {cls.__name__} keeps no "
                             f"attribute {name!r} for its constructor")
    torch.save({"model_class": f"{cls.__module__}.{cls.__qualname__}",
                "model_kwargs": kwargs,
                "state_dict": model.state_dict(),
                "info": info or {},
                "format_version": 1}, path)


def export_program(model: nn.Module, input_shape: Sequence[int],
                   path: str) -> None:
    """Write the eval forward of ``model`` as a ``torch.export`` program
    (``torch.export.save``; suffix ``.pt2``), the counterpart of JAX's
    ``export_stablehlo``: :func:`load_program` runs it without the
    model's Python code. The export works on a copy, so the model's mode,
    plan, parameters and running statistics stay as they are. Like JAX,
    which exports the pure-XLA graph of its model, the copy runs
    ``pallas_flat=False`` where the model has the attribute: the library
    plan, every level on the library ops (JAX's fused executors do not
    export). Under ``normalization='batchp'`` those levels' eval batch
    norms stay kernel K9, the node ``e3tpu.bn_normalize`` (JAX's library
    levels keep their Pallas batch norm too). The input is one float32
    channels-last tensor of ``input_shape`` on the model's device: the
    program takes that fixed shape (JAX's ``ShapeDtypeStruct``) and runs
    on that kind of device."""
    model = copy.deepcopy(model)
    if hasattr(model, "pallas_flat"):
        model.pallas_flat = False
    model.eval()
    x = torch.zeros(tuple(input_shape), dtype=torch.float32,
                    device=_device_of(model))
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    # The zeros it was traced with are no part of the program (the
    # input's shape and dtype stay in its graph; JAX's artifact keeps
    # no input either): left in, they would be the file's largest entry.
    program.example_inputs = None
    torch.export.save(program, path)


def load_program(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program of :func:`export_program` as a callable from
    channels-last ``(N, *spatial, C)`` to ``(N, *spatial, C_out)``
    logits, at the exported shape (JAX's ``load_stablehlo``). Imports
    ``ops.pallas_bn`` alone of this package, which registers the operator
    a ``'batchp'`` program calls (K9)."""
    import elektronn3_tpu_torch.ops.pallas_bn  # noqa: F401  (the op)
    return torch.export.load(path).module()


def load_model(path: str, device=None) -> Tuple[nn.Module, Dict]:
    """(model, info) from a file of :func:`save_model` (a trusted file:
    it is unpickled). The model is built with its saved arguments, on
    ``device`` if given (else where its class builds by default: the
    card, for the UNet), and takes the saved weights."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    module, name = blob["model_class"].rsplit(".", 1)
    cls = getattr(importlib.import_module(module), name)
    kwargs = dict(blob["model_kwargs"])
    takes_device = "device" in inspect.signature(cls.__init__).parameters
    if device is not None and takes_device:
        kwargs["device"] = device
    model = cls(**kwargs)
    if device is not None and not takes_device:
        model.to(device)
    model.load_state_dict(blob["state_dict"])
    return model, blob.get("info", {})
