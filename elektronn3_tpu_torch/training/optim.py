"""Padam, stochastic weight averaging and batch-norm re-estimation.

Counterpart of the JAX package's ``training/optim.py``:

- :class:`Padam`: partially adaptive Adam (arXiv:1806.06763) with the
  reference's exact rule (elektronn3/training/padam.py:79-94), as a
  ``torch.optim.Optimizer``.
- :class:`SWA`: a float32 running average of parameters, updated where
  the caller chooses (the Trainer: at learning-rate minima), and a swap
  between it and the current parameters (reference swa.py:176-203).
- :func:`bn_update`: the batch norms' running statistics re-estimated as
  the exact mean of the statistics of a loader's batches (reference
  swa.py:269-313).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from elektronn3_tpu_torch.parallel.collectives import stats_group
from elektronn3_tpu_torch.parallel.mesh import shard_rows


class Padam(torch.optim.Optimizer):
    """Partially adaptive Adam:

    ``p -= lr * (sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)^(2 *
    partial) + weight_decay * p)``

    with ``m`` and ``v`` Adam's moments. ``partial`` in (0, 0.5]: 0.5 is
    Adam, toward 0 SGD with momentum. The decoupled weight decay is
    added after the scaling, as the JAX package's optax chain
    (``scale_by_padam``, ``add_decayed_weights``, the rate) orders it.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, partial: float = 0.125,
                 weight_decay: float = 0.0):
        if not 0.0 < partial <= 0.5:
            raise ValueError(f"partial must be in (0, 0.5], got {partial}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      partial=partial,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g = p.grad
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                scale = math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
                denom = (v.clamp_min(0).sqrt() + group["eps"]).pow(
                    2 * group["partial"])
                update = m / denom * scale
                if group["weight_decay"]:
                    update.add_(p, alpha=group["weight_decay"])
                p.sub_(update, alpha=group["lr"])
        return loss


class SWA:
    """Stochastic weight averaging of named parameters: call
    :meth:`update_swa` where the average should take the parameters
    (the reference examples' manual mode), then :meth:`swap_swa_sgd` to
    exchange the current parameters and the average."""

    def __init__(self):
        self.n_avg = 0
        self.avg_params: Optional[Dict[str, torch.Tensor]] = None
        self._swapped = False
        self._stash: Optional[Dict[str, torch.Tensor]] = None

    def update_swa(self, params: Dict[str, torch.Tensor]) -> None:
        """Take ``params`` (name -> tensor) into the cumulative average,
        in float32 (reference swa.py:176-180, 252-258)."""
        with torch.no_grad():
            if self.avg_params is None:
                self.avg_params = {k: p.detach().float().clone()
                                   for k, p in params.items()}
                self.n_avg = 1
                return
            n = self.n_avg
            self.avg_params = {
                k: (a * n + params[k].detach().float()) / (n + 1)
                for k, a in self.avg_params.items()}
            self.n_avg += 1

    def swap_swa_sgd(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The parameters to use next: the average, keeping a copy of
        ``params`` that a second call returns (reference
        swa.py:182-203)."""
        if self.avg_params is None:
            return params
        if not self._swapped:
            self._stash = {k: p.detach().clone() for k, p in params.items()}
            self._swapped = True
            return self.avg_params
        self._swapped = False
        out, self._stash = self._stash, None
        return out


def batch_norms(model: nn.Module) -> List[_BatchNorm]:
    """The batch-norm modules of ``model`` with running statistics
    ('batch' and 'batchp'); a group or instance norm has none."""
    return [m for m in model.modules()
            if isinstance(m, _BatchNorm) and m.track_running_stats]


@contextlib.contextmanager
def kept_norm_buffers(model: nn.Module) -> Iterator[None]:
    """Restore every batch norm's buffers (running mean, variance and
    count) after the block: a training-mode forward whose statistics
    update is to be discarded (the JAX package throws its new
    ``batch_stats`` away) updates them in place here."""
    saved = [(b, b.detach().clone()) for m in batch_norms(model)
             for b in m.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _batch_input(batch, device) -> torch.Tensor:
    """A loader batch's channels-last input on ``device``."""
    inp = batch["inp"] if isinstance(batch, dict) else batch
    return torch.as_tensor(inp).to(device)


def bn_update(loader, model: nn.Module,
              max_batches: Optional[int] = None,
              mesh=None) -> nn.Module:
    """Re-estimate the batch norms' running statistics as the mean of
    the statistics of ``loader``'s batches (dicts with a channels-last
    'inp', or the inputs themselves; at most ``max_batches``).

    Each batch runs a training-mode forward without gradients from the
    original buffers; the batch's raw statistics come back from the
    momentum update as ``raw = (new - (1 - m) * old) / m`` with the
    module's own momentum ``m`` (0.1 here is flax's 0.9), and are
    averaged cumulatively, the JAX package's method. Afterwards the
    buffers hold the averages and the model its former mode. A model
    without batch norm comes back unchanged. Updates ``model`` in place
    and returns it.

    With ``mesh`` (a ``parallel.Mesh``), every rank iterates the same
    global batches, runs the forward on its rows of each, and the batch
    norms sum their statistics over the mesh's first axis: every rank
    ends with the global batches' statistics (all ranks must call it)."""
    norms = batch_norms(model)
    if not norms:
        return model
    for m in norms:
        if m.momentum is None:
            raise ValueError("bn_update needs each batch norm's momentum; "
                             f"{m} has momentum=None")
    device = next(model.parameters()).device
    axis = None if mesh is None else mesh.axis(mesh.axis_names[0])
    orig = [(m.running_mean.detach().clone(), m.running_var.detach().clone())
            for m in norms]
    counts = [m.num_batches_tracked.detach().clone() for m in norms]
    was_training = model.training
    cma = None
    n = 0
    model.train()
    try:
        with torch.no_grad():
            for i, batch in enumerate(loader):
                if max_batches is not None and i >= max_batches:
                    break
                for m, (mean, var) in zip(norms, orig):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)
                inp = _batch_input(batch, device)
                if axis is None:
                    model(inp)
                else:
                    with stats_group(axis):
                        model(shard_rows(inp, axis))
                raw = [((m.running_mean.float() - (1 - m.momentum) * mean)
                        / m.momentum,
                        (m.running_var.float() - (1 - m.momentum) * var)
                        / m.momentum)
                       for m, (mean, var) in zip(norms, orig)]
                if cma is None:
                    cma = raw
                else:
                    cma = [((cm * n + rm) / (n + 1), (cv * n + rv) / (n + 1))
                           for (cm, cv), (rm, rv) in zip(cma, raw)]
                n += 1
            for m, stats, count in zip(norms, cma or orig, counts):
                m.running_mean.copy_(stats[0])
                m.running_var.copy_(stats[1])
                m.num_batches_tracked.copy_(count)
    finally:
        model.train(was_training)
    return model
