"""Neighbour-sampled minibatch GNN trainer.

Counterpart of the JAX package's ``training/trainer_gnn_minibatch.py``
(reference elektronn3/training/trainer_gnn_minibatch.py:60-666):

- each batch is a set of seed nodes, drawn with weights inverse to their
  class's frequency (``imbalanced_sampling``), and their k-hop sampled
  neighbourhood (:func:`sample_neighbors`, numpy on the host, JAX's
  algorithm and draws: one ``default_rng(seed)`` gives JAX's subgraphs);
- the loss is the mean negative log-likelihood of the seeds, plus, with
  ``embedding_loss``, 0.1 times a self-supervised term on the sampled
  edges (after ``edge_dropout``): connected nodes near, each edge's
  source and a permuted destination far;
- online probes (an ``SGDClassifier`` and a ``MiniBatchKMeans`` fitted
  on the seeds' embeddings each step) where scikit-learn is installed;
- :meth:`GNNTrainer.validate_sampled` on sampled validation batches and
  :meth:`GNNTrainer.evaluate` on the whole graph.

The step runs eager on the subgraph as sampled: JAX pads each subgraph
to power-of-two buckets with masked losses so that one compiled program
serves every batch; the port needs no padding, and its loss is JAX's
``_padded_loss`` of the same batch. The node features and labels live
on the model's device; only the sampled indices cross each step. The
embedding term's permutation comes from a ``torch.Generator`` seeded
``seed`` and permutes the real edges (JAX's permutes the padded edge
list, so a few of its negatives are the padding's dummy node).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.training.trainer_gnn import default_gnn_optimizer


def sample_neighbors(edge_index: np.ndarray, seeds: np.ndarray,
                     num_neighbors: Sequence[int],
                     rng: np.random.Generator):
    """k-hop neighbour sampling (torch_geometric's ``NeighborLoader``'s
    idea): (node ids, the subgraph's edge index in positions of the node
    ids, made symmetric, the seeds' positions). At each hop every node of
    the frontier keeps at most ``num_neighbors[hop]`` of its
    ``edge_index[1]`` neighbours, drawn without replacement."""
    row, col = edge_index
    order = np.argsort(row, kind="stable")
    row_s, col_s = row[order], col[order]
    starts = np.searchsorted(row_s, np.arange(row_s.max() + 2))

    nodes = list(seeds)
    node_set = {int(s): i for i, s in enumerate(seeds)}
    edges_src, edges_dst = [], []
    frontier = list(seeds)
    for fanout in num_neighbors:
        new_frontier = []
        for u in frontier:
            u = int(u)
            if u + 1 >= len(starts):
                continue
            nbrs = col_s[starts[u]:starts[u + 1]]
            if len(nbrs) > fanout:
                nbrs = rng.choice(nbrs, fanout, replace=False)
            for v in nbrs:
                v = int(v)
                if v not in node_set:
                    node_set[v] = len(nodes)
                    nodes.append(v)
                    new_frontier.append(v)
                edges_src.append(node_set[u])
                edges_dst.append(node_set[v])
        frontier = new_frontier
    nodes = np.asarray(nodes, np.int64)
    if edges_src:
        sub_ei = np.stack([np.asarray(edges_src), np.asarray(edges_dst)])
        sub_ei = np.concatenate([sub_ei, sub_ei[::-1]], axis=1)
    else:
        sub_ei = np.zeros((2, 0), np.int64)
    return nodes, sub_ei, np.arange(len(seeds))


class GNNTrainer:
    """Minibatch GNN trainer (see the module's docstring). ``graph``:
    'x' (N, F), 'edge_index' (2, E), 'y' (N,), optional 'train_mask'
    and 'val_mask' (every node without them)."""

    def __init__(self, model, graph: Dict[str, np.ndarray],
                 batch_size: int = 64,
                 num_neighbors: Sequence[int] = (10, 5),
                 lr: float = 1e-2, weight_decay: float = 5e-4,
                 imbalanced_sampling: bool = True,
                 embedding_loss: bool = False,
                 edge_dropout: float = 0.2,
                 seed: int = 0):
        self.model = model
        self.device = next(model.parameters()).device
        self.graph = {k: np.asarray(v) for k, v in graph.items()}
        self.batch_size = batch_size
        self.num_neighbors = tuple(num_neighbors)
        self.embedding_loss = embedding_loss
        self.edge_dropout = edge_dropout
        self.rng_np = np.random.default_rng(seed)
        self._perm_rng = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = default_gnn_optimizer(model, lr, weight_decay)
        self._x = torch.as_tensor(self.graph["x"]).to(self.device)
        self._y = torch.as_tensor(self.graph["y"]).long().to(self.device)

        y = self.graph["y"]
        train_mask = self.graph.get("train_mask", np.ones(len(y), bool))
        self.train_nodes = np.where(train_mask)[0]
        if imbalanced_sampling:
            counts = np.bincount(y[self.train_nodes])
            w = 1.0 / np.maximum(counts[y[self.train_nodes]], 1)
            self.seed_weights = w / w.sum()
        else:
            self.seed_weights = None
        self.n_seeds = min(self.batch_size, len(self.train_nodes))
        self.step = 0
        self.host_seconds = 0.0   # sampling and index copies, summed

        self._n_classes = int(y.max()) + 1
        try:
            from sklearn.cluster import MiniBatchKMeans
            from sklearn.linear_model import SGDClassifier
            self._sgd_probe = SGDClassifier(loss="log_loss",
                                            random_state=seed)
            self._km_probe = MiniBatchKMeans(
                n_clusters=self._n_classes, n_init=3, random_state=seed) \
                if self._n_classes >= 2 else None
        except ImportError:
            self._sgd_probe = None
            self._km_probe = None

    # -- one batch -------------------------------------------------------

    def _sample_batch(self, seeds, edge_dropout: float):
        """(node ids, subgraph edge index) on the device, sampled as JAX
        samples them (edge dropout first, from the same generator)."""
        t0 = time.perf_counter()
        ei = self.graph["edge_index"]
        if edge_dropout > 0:
            keep = self.rng_np.random(ei.shape[1]) > edge_dropout
            ei = ei[:, keep]
        nodes, sub_ei, _ = sample_neighbors(ei, seeds, self.num_neighbors,
                                            self.rng_np)
        nodes = torch.from_numpy(nodes).to(self.device, non_blocking=True)
        sub_ei = torch.from_numpy(sub_ei).long().to(self.device,
                                                    non_blocking=True)
        self.host_seconds += time.perf_counter() - t0
        return nodes, sub_ei

    def loss(self, nodes: torch.Tensor, sub_ei: torch.Tensor,
             train: bool):
        """(loss, logits, embeddings) of a sampled batch: the seeds' mean
        negative log-likelihood (the seeds are its first ``n_seeds``
        nodes) and, with ``embedding_loss``, the embedding term."""
        logits, emb = self.model(self._x[nodes], sub_ei, train=train)
        loss = F.cross_entropy(logits[:self.n_seeds].float(),
                               self._y[nodes[:self.n_seeds]])
        if self.embedding_loss and sub_ei.shape[1]:
            src, dst = sub_ei
            perm = torch.randperm(dst.shape[0], generator=self._perm_rng,
                                  device=dst.device)
            e = emb.float()
            pos = (e[src] * e[dst]).sum(-1)
            neg = (e[src] * e[dst[perm]]).sum(-1)
            loss = loss + 0.1 * (F.softplus(-pos) + F.softplus(neg)).mean()
        return loss, logits, emb

    def _draw_seeds(self) -> np.ndarray:
        return self.rng_np.choice(self.train_nodes, self.n_seeds,
                                  replace=False, p=self.seed_weights)

    def train_step(self):
        """One sampled step; (loss, the seeds' embeddings, the seeds),
        the first two detached on the device."""
        seeds = self._draw_seeds()
        nodes, sub_ei = self._sample_batch(seeds, self.edge_dropout)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, _, emb = self.loss(nodes, sub_ei, True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), emb[:self.n_seeds].detach(), seeds

    # -- training loop ---------------------------------------------------

    def run(self, max_steps: int = 100) -> Dict[str, float]:
        losses = []
        while self.step < max_steps:
            loss, seed_emb, seeds = self.train_step()
            losses.append(loss)
            if self._sgd_probe is not None:
                z = seed_emb.float().cpu().numpy()
                self._sgd_probe.partial_fit(
                    z, self.graph["y"][seeds],
                    classes=np.arange(self._n_classes))
                if self._km_probe is not None:
                    self._km_probe.partial_fit(z)
            self.step += 1
        stats = {"tr_loss": float(torch.stack(losses[-20:]).mean())
                 if losses else float("nan")}
        stats.update(self.evaluate())
        stats.update(self.validate_sampled())
        return stats

    # -- evaluation ------------------------------------------------------

    @torch.no_grad()
    def validate_sampled(self, max_batches: int = 16) -> Dict[str, float]:
        """Sampled validation (reference _validate, :436-506): the
        validation nodes, shuffled, in chunks of ``n_seeds`` (the last
        one filled up by repeating, the repeats left out of the
        metrics), each with its sampled subgraph (no edge dropout); the
        probes' predictions where they were fitted."""
        y = self.graph["y"]
        mask = self.graph.get("val_mask", np.ones(len(y), bool))
        val_nodes = np.where(mask)[0]
        if len(val_nodes) == 0:
            return {}
        self.rng_np.shuffle(val_nodes)
        self.model.eval()
        losses, accs, sgd_accs, km_targets, km_preds = [], [], [], [], []
        for i in range(0, len(val_nodes), self.n_seeds):
            chunk = val_nodes[i:i + self.n_seeds]
            if len(chunk) < self.n_seeds:
                chunk = np.concatenate(
                    [chunk, np.resize(chunk, self.n_seeds - len(chunk))])
            nodes, sub_ei = self._sample_batch(chunk, 0.0)
            loss, logits, emb = self.loss(nodes, sub_ei, False)
            n_valid = min(len(val_nodes) - i, self.n_seeds)
            pred = logits[:n_valid].argmax(-1).cpu().numpy()
            tgt = y[chunk[:n_valid]]
            losses.append(float(loss))
            accs.append((pred == tgt).mean())
            z = emb[:n_valid].float().cpu().numpy()
            if self._sgd_probe is not None \
                    and hasattr(self._sgd_probe, "coef_"):
                sgd_accs.append((self._sgd_probe.predict(z) == tgt).mean())
            if self._km_probe is not None \
                    and hasattr(self._km_probe, "cluster_centers_"):
                km_targets.append(tgt)
                km_preds.append(self._km_probe.predict(z))
            if i // self.n_seeds + 1 >= max_batches:
                break
        out = {"val_loss_sampled": float(np.mean(losses)),
               "val_acc_sampled": float(np.mean(accs))}
        if sgd_accs:
            out["val_sgd_acc"] = float(np.mean(sgd_accs))
        if km_preds:
            from sklearn.metrics import v_measure_score
            out["val_km_v_measure"] = float(v_measure_score(
                np.concatenate(km_targets), np.concatenate(km_preds)))
        return out

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Whole-graph eval: ``val_acc`` and, where scikit-learn is
        installed, the v-measure of a MiniBatchKMeans of the embeddings
        (reference :436-530)."""
        self.model.eval()
        ei = torch.as_tensor(self.graph["edge_index"]).long().to(self.device)
        logits, emb = self.model(self._x, ei, train=False)
        pred = logits.argmax(-1).cpu().numpy()
        y = self.graph["y"]
        mask = self.graph.get("val_mask", np.ones(len(y), bool))
        out = {"val_acc": float((pred[mask] == y[mask]).mean())}
        try:
            from sklearn.cluster import MiniBatchKMeans
            from sklearn.metrics import v_measure_score
            k = len(np.unique(y))
            if k >= 2:
                km = MiniBatchKMeans(n_clusters=k, n_init=3,
                                     random_state=0).fit(
                    emb.float().cpu().numpy())
                out["val_v_measure"] = float(v_measure_score(y, km.labels_))
        except Exception:
            pass
        return out
