"""Full-batch GNN trainer: semi-supervised node classification on one
graph.

Counterpart of the JAX package's ``training/trainer_gnn.py`` (reference
elektronn3/training/trainer_gnn.py:30-375, GNNTrainer: one graph with
train and validation masks, early stopping, a t-SNE picture of the
embeddings), over ``modules.graph`` models. A graph is a dict of arrays
'x' (N, F), 'edge_index' (2, E), 'y' (N,), 'train_mask' and optionally
'val_mask' and 'test_mask', moved to the model's device once.

The loss is the mean negative log-likelihood over ``train_mask``; the
default optimizer is optax's ``adamw(lr, weight_decay)`` as torch's
``AdamW``. Dropout draws from torch's default generator (JAX's from its
key: the two cannot agree). ``visualize_embeddings`` needs scikit-learn
and matplotlib, imported when it runs.
"""

from __future__ import annotations

import copy
import os
from math import inf
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.logger import logger

MASKS = ("train_mask", "val_mask", "test_mask")


def visualize_embeddings(emb: np.ndarray, labels: np.ndarray,
                         path: Optional[str] = None):
    """A t-SNE scatter of node embeddings coloured by label, written to
    ``path`` where given (reference trainer_gnn.py:30-47)."""
    from sklearn.manifold import TSNE
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    z = TSNE(n_components=2, init="random",
             perplexity=min(30, len(emb) - 1)).fit_transform(emb)
    fig, ax = plt.subplots()
    sc = ax.scatter(z[:, 0], z[:, 1], c=labels, s=4, cmap="tab10")
    fig.colorbar(sc, ax=ax)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def graph_to_device(graph: Dict, device) -> Dict[str, torch.Tensor]:
    """The graph's arrays as tensors on ``device`` (indices as int64,
    masks as bool)."""
    out = {}
    for k, v in graph.items():
        t = torch.as_tensor(np.asarray(v))
        if k in ("edge_index", "y"):
            t = t.long()
        out[k] = t.to(device)
    return out


def masked_nll(logits: torch.Tensor, y: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean negative log-likelihood of ``y`` over ``mask`` (every
    node without one), in float32."""
    nll = F.cross_entropy(logits.float(), y, reduction="none")
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def default_gnn_optimizer(model, lr: float, weight_decay: float):
    """optax's ``adamw(lr, weight_decay=...)`` as torch's ``AdamW``."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


class GNNTrainer:
    """Full-batch semi-supervised node classification (reference
    trainer_gnn.py:49-375; early stopping :185-189): one step on the
    whole graph an epoch, then an eval forward; the parameters of the
    lowest validation loss (the training loss without a ``val_mask``)
    are kept, and the run stops after ``patience`` epochs without a new
    lowest. With ``save_root`` the best ``state_dict`` is written to
    ``save_root/exp_name/gnn_params.pt`` with a t-SNE picture beside it
    (where scikit-learn is installed)."""

    def __init__(self, model, graph: Dict[str, np.ndarray],
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 lr: float = 1e-2, weight_decay: float = 5e-4,
                 save_root: Optional[str] = None,
                 exp_name: str = "gnn", patience: int = 100,
                 enable_tensorboard: bool = False, seed: int = 0):
        for k in ("x", "edge_index", "y"):
            if k not in graph:
                raise ValueError(f"graph needs {k!r}")
        if "train_mask" not in graph:
            raise ValueError("graph needs a train_mask")
        self.model = model
        self.device = next(model.parameters()).device
        self.graph = graph_to_device(graph, self.device)
        self.patience = patience
        self.seed = seed
        self.optimizer = optimizer if optimizer is not None else \
            default_gnn_optimizer(model, lr, weight_decay)
        self.save_path = None
        if save_root is not None:
            self.save_path = os.path.join(os.path.expanduser(save_root),
                                          exp_name)
            os.makedirs(self.save_path, exist_ok=True)
        self.step = 0
        self.best_val_loss = inf
        self.best_params = copy.deepcopy(model.state_dict())

    def _train_step(self) -> torch.Tensor:
        """One optimizer step on the whole graph; the loss, detached."""
        g = self.graph
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits, _ = self.model(g["x"], g["edge_index"], train=True)
        loss = masked_nll(logits, g["y"], g["train_mask"])
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def _eval(self):
        """({'<split>_acc', '<split>_loss'} of each mask, embeddings) of
        the eval forward."""
        g = self.graph
        self.model.eval()
        logits, emb = self.model(g["x"], g["edge_index"], train=False)
        correct = (logits.argmax(-1) == g["y"]).float()
        out = {}
        for name in MASKS:
            if name in g:
                m = g[name].float()
                split = name.replace("_mask", "")
                out[f"{split}_acc"] = (correct * m).sum() / \
                    torch.clamp_min(m.sum(), 1.0)
                out[f"{split}_loss"] = masked_nll(logits, g["y"], g[name])
        return out, emb

    def run(self, epochs: int = 200) -> Dict[str, float]:
        bad = 0
        stats = {}
        for epoch in range(epochs):
            loss = self._train_step()
            self.step += 1
            evals, _ = self._eval()
            stats = {k: float(v) for k, v in evals.items()}
            stats["tr_loss"] = float(loss)
            val_loss = stats.get("val_loss", stats["tr_loss"])
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.best_params = copy.deepcopy(self.model.state_dict())
                bad = 0
            else:
                bad += 1
                if bad > self.patience:
                    logger.info(f"Early stopping at epoch {epoch}")
                    break
            if epoch % 50 == 0:
                logger.info(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in stats.items()))
        self.model.load_state_dict(self.best_params)
        if self.save_path:
            torch.save(self.best_params,
                       os.path.join(self.save_path, "gnn_params.pt"))
            _, emb = self._eval()
            try:
                visualize_embeddings(
                    emb.float().cpu().numpy(), self.graph["y"].cpu().numpy(),
                    os.path.join(self.save_path, "embeddings.png"))
            except Exception:
                logger.exception("embedding visualization failed")
        return stats
