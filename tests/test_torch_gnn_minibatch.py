"""The port's minibatch and multi-graph GNN trainers
(``training/trainer_gnn_minibatch.py``, ``trainer_gnn_batch.py``) against
the JAX package's, on the CPU in float32, at dropout 0.

Seeded synthetic graphs (``test_torch_gnn_trainers.make_graph``); the
port model holds the parameters of the JAX trainer's own init.

- ``sample_neighbors`` gives JAX's nodes and edges from one seed.
- The port's loss of a sampled batch, unpadded, equals JAX's
  ``_padded_loss`` of the same batch padded (1e-5 relative), in
  training and eval, for each conv.
- 4 steps with edge dropout (the same draws) against JAX's steps (each
  loss within 1e-4, then the parameters within 1e-4 of their scale);
  ``validate_sampled`` and ``evaluate`` (losses within 1e-4, accuracies
  equal).
- The embedding term against its formula on the port's own
  permutation; a ``run``.
- Multi-graph: 3 graphs, 2 epochs, the training loss (1e-4 relative)
  and the final parameters; ``val_acc`` equal.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elektronn3_tpu.modules import graph as jg
from elektronn3_tpu.training import trainer_gnn_batch as jbatch
from elektronn3_tpu.training import trainer_gnn_minibatch as jmini
from elektronn3_tpu_torch.training import trainer_gnn_batch as pbatch
from elektronn3_tpu_torch.training import trainer_gnn_minibatch as pmini
from test_torch_gnn_trainers import (
    LOSS_RTOL, _assert_params, _port_gnn, make_graph)


@pytest.fixture(autouse=True)
def _one_thread():
    """scikit-learn's probes and KMeans on one thread: beside the
    suite's other workers their thread pools would take every core."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("fanout", [(3, 2), (10, 5), (1,)])
def test_sample_neighbors_matches_jax(fanout):
    g = make_graph(3, n=200, e=1500)
    seeds = np.random.default_rng(0).choice(200, 16, replace=False)
    got = pmini.sample_neighbors(g["edge_index"], seeds, fanout,
                                 np.random.default_rng(9))
    ref = jmini.sample_neighbors(g["edge_index"], seeds, fanout,
                                 np.random.default_rng(9))
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def _mini_pair(conv, embedding_loss=False, edge_dropout=0.2):
    g = make_graph(4, n=300, f=8, e=2400)
    jm = jg.GNN(hidden=16, out_channels=3, conv=conv, dropout=0.0)
    kw = dict(batch_size=32, num_neighbors=(4, 3), lr=0.02,
              embedding_loss=embedding_loss, edge_dropout=edge_dropout,
              seed=5)
    jtr = jmini.GNNTrainer(jm, g, **kw)
    pm = _port_gnn(jtr.params, 8, conv)
    return g, jtr, pmini.GNNTrainer(pm, g, **kw)


@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_minibatch_loss_equals_padded_loss(conv):
    """No padded node or edge reaches a degree, a count or a softmax:
    the port's loss of the sampled subgraph is JAX's of it padded to its
    power-of-two buckets."""
    g, jtr, ptr = _mini_pair(conv)
    seeds = ptr._draw_seeds()
    jtr.rng_np = np.random.default_rng(11)
    ptr.rng_np = np.random.default_rng(11)
    x, ei, y, mask = jtr._sample_batch(seeds, 0.2)
    nodes, sub_ei = ptr._sample_batch(seeds, 0.2)
    assert ei.shape[1] > sub_ei.shape[1] or x.shape[0] > nodes.shape[0]
    padded_loss = jax.jit(jtr._padded_loss, static_argnums=(6,))
    for train in (True, False):
        ref, (jlog, _) = padded_loss(jtr.params, x, ei, y, mask,
                                     jax.random.PRNGKey(0), train)
        got, logits, _ = ptr.loss(nodes, sub_ei, train)
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
        n = nodes.shape[0]
        err = float(np.abs(logits.detach().numpy()
                           - np.asarray(jlog)[:n]).max())
        assert err <= 1e-5 * float(np.abs(np.asarray(jlog)[:n]).max())


def test_minibatch_steps_match_jax():
    g, jtr, ptr = _mini_pair("sage")
    jlosses, plosses = [], []
    for _ in range(4):
        seeds = jtr.rng_np.choice(jtr.train_nodes, jtr.n_seeds,
                                  replace=False, p=jtr.seed_weights)
        x, ei, y, mask = jtr._sample_batch(seeds, jtr.edge_dropout)
        jtr.params, jtr.opt_state, loss, _ = jtr._train_step_jit(
            jtr.params, jtr.opt_state, x, ei, y, mask, jax.random.PRNGKey(0))
        jlosses.append(float(loss))
        plosses.append(float(ptr.train_step()[0]))
    assert np.allclose(plosses, jlosses, rtol=LOSS_RTOL, atol=0)
    _assert_params(ptr.model, jtr.params)
    got, ref = ptr.validate_sampled(max_batches=3), \
        jtr.validate_sampled(max_batches=3)
    assert {"val_loss_sampled", "val_acc_sampled"} <= set(got)
    for k in ("val_loss_sampled", "val_acc_sampled"):
        assert got[k] == pytest.approx(ref[k], rel=LOSS_RTOL), k
    got, ref = ptr.evaluate(), jtr.evaluate()
    assert got["val_acc"] == pytest.approx(ref["val_acc"], abs=1e-6)


def test_minibatch_run_and_embedding_term():
    g, _, ptr = _mini_pair("gcn", embedding_loss=True)
    seeds = ptr._draw_seeds()
    nodes, sub_ei = ptr._sample_batch(seeds, 0.0)
    gen_state = ptr._perm_rng.get_state()
    loss, logits, emb = ptr.loss(nodes, sub_ei, True)
    ptr._perm_rng.set_state(gen_state)
    perm = torch.randperm(sub_ei.shape[1], generator=ptr._perm_rng)
    src, dst = sub_ei
    e = emb.detach()
    term = (F.softplus(-(e[src] * e[dst]).sum(-1))
            + F.softplus((e[src] * e[dst[perm]]).sum(-1))).mean()
    nll = F.cross_entropy(logits[:ptr.n_seeds].detach(),
                          ptr._y[nodes[:ptr.n_seeds]])
    assert float(loss) == pytest.approx(float(nll + 0.1 * term), rel=1e-6)
    stats = ptr.run(max_steps=3)
    assert ptr.step == 3 and np.isfinite(stats["tr_loss"])
    assert {"val_acc", "val_loss_sampled", "val_acc_sampled"} <= set(stats)
    assert ptr.host_seconds > 0


def test_multi_graph_trainer_matches_jax():
    graphs = [make_graph(s, n=30 + 5 * s, masks=False) for s in range(3)]
    jm = jg.GNN(hidden=16, out_channels=3, conv="sage", dropout=0.0)
    jtr = jbatch.GNNTrainer(jm, graphs, lr=0.02)
    pm = _port_gnn(jtr.params, 10, "sage")
    ptr = pbatch.GNNTrainer(pm, graphs, lr=0.02)
    got, ref = ptr.run(2), jtr.run(2)
    assert abs(got["tr_loss"] - ref["tr_loss"]) <= \
        LOSS_RTOL * abs(ref["tr_loss"])
    assert got["val_acc"] == pytest.approx(ref["val_acc"], abs=1e-6)
    assert set(got) == set(ref)
    _assert_params(ptr.model, jtr.params)
