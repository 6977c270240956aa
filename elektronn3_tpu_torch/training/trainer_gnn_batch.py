"""Multi-graph GNN trainer.

Counterpart of the JAX package's ``training/trainer_gnn_batch.py``
(reference elektronn3/training/trainer_gnn_batch.py:33-405): the
full-batch trainer's step over a sequence of graphs (dicts with 'x',
'edge_index', 'y'; every node labelled), one optimizer step a graph, and
an evaluation by accuracy and, where scikit-learn is installed, the
v-measure of a KMeans clustering of the embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from elektronn3_tpu_torch.logger import logger
from elektronn3_tpu_torch.training.trainer_gnn import (
    default_gnn_optimizer, graph_to_device, masked_nll)


class GNNTrainer:
    """Trainer over graphs: an epoch is one step on each graph in order
    (the mean negative log-likelihood of all its nodes); every 20
    epochs and at the end :meth:`evaluate` on ``valid_graphs`` (the
    training graphs without them)."""

    def __init__(self, model, graphs: Sequence[Dict[str, np.ndarray]],
                 valid_graphs: Optional[Sequence[Dict]] = None,
                 lr: float = 1e-2, weight_decay: float = 5e-4,
                 seed: int = 0):
        self.model = model
        self.device = next(model.parameters()).device
        self.graphs = [graph_to_device(g, self.device) for g in graphs]
        self.valid_graphs = None if valid_graphs is None else [
            graph_to_device(g, self.device) for g in valid_graphs]
        self.optimizer = default_gnn_optimizer(model, lr, weight_decay)
        self.seed = seed

    def _train_step(self, g) -> torch.Tensor:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits, _ = self.model(g["x"], g["edge_index"], train=True)
        loss = masked_nll(logits, g["y"])
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def run(self, epochs: int = 100) -> Dict[str, float]:
        stats = {}
        for epoch in range(epochs):
            losses = torch.stack([self._train_step(g) for g in self.graphs])
            stats["tr_loss"] = float(losses.mean())
            if epoch % 20 == 0:
                stats.update(self.evaluate())
                logger.info(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in stats.items()))
        stats.update(self.evaluate())
        return stats

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """``val_acc``, the mean accuracy over the validation graphs,
        and, where scikit-learn is installed, ``val_v_measure``: the mean
        v-measure of a KMeans (a cluster a label) of each graph's
        embeddings (reference trainer_gnn_batch.py eval)."""
        try:
            from sklearn.cluster import KMeans
            from sklearn.metrics import v_measure_score
        except ImportError:
            KMeans = None
        self.model.eval()
        accs, vms = [], []
        for g in self.valid_graphs or self.graphs:
            logits, emb = self.model(g["x"], g["edge_index"], train=False)
            y = g["y"].cpu().numpy()
            accs.append(float((logits.argmax(-1).cpu().numpy() == y).mean()))
            k = len(np.unique(y))
            if KMeans is not None and k >= 2 and emb.shape[0] > k:
                km = KMeans(n_clusters=k, n_init=3, random_state=0).fit(
                    emb.float().cpu().numpy())
                vms.append(float(v_measure_score(y, km.labels_)))
        out = {"val_acc": float(np.mean(accs))}
        if vms:
            out["val_v_measure"] = float(np.mean(vms))
        return out
