"""The port's full-batch GNN trainer (``training/trainer_gnn.py``)
against the JAX
package's, on the CPU in float32, at dropout 0 (dropout cannot draw
JAX's numbers; ``test_torch_graph.py`` checks it by itself).

Seeded synthetic graphs; each port model holds the parameters of the
JAX trainer's own init (converted with ``models.convert``); optax's
``adamw`` against torch's ``AdamW``.

- Full batch (a graph of 60 nodes, 10 features, 3 classes, train,
  validation and test masks), GCN, SAGE and GAT: 5 epochs, every
  epoch's stats (losses within 1e-4 relative, accuracies equal) and the
  best parameters (within 1e-4 of their scale); early stopping after
  ``patience`` epochs without a lower validation loss stops both at the
  same epoch; the port's files (``gnn_params.pt``, the t-SNE picture).

The multi-graph trainer's test is in ``test_torch_gnn_minibatch.py``.
"""

import jax
import numpy as np
import pytest

from elektronn3_tpu.modules import graph as jg
from elektronn3_tpu.training import trainer_gnn as jfull
from elektronn3_tpu_torch.models import (
    flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import graph as pg
from elektronn3_tpu_torch.training import trainer_gnn as pfull

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4


def make_graph(seed, n=60, f=10, classes=3, e=240, masks=True):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = (rng.normal(size=(n, f)) + y[:, None] * 0.5).astype(np.float32)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int64)
    g = {"x": x, "edge_index": ei, "y": y.astype(np.int64)}
    if masks:
        split = rng.permutation(n)
        for name, idx in (("train_mask", split[:n // 2]),
                          ("val_mask", split[n // 2:3 * n // 4]),
                          ("test_mask", split[3 * n // 4:])):
            m = np.zeros(n, bool)
            m[idx] = True
            g[name] = m
    return g


def _port_gnn(params, f, conv, hidden=16, out=3, layers=2):
    m = pg.GNN(f, hidden=hidden, out_channels=out, num_layers=layers,
               conv=conv, dropout=0.0, device="cpu")
    m.load_state_dict(state_dict_from_flax(
        {"params": jax.device_get(params)}, m))
    return m


def _assert_params(model, params):
    got = flax_from_state_dict(model.state_dict(),
                               {"params": jax.device_get(params)},
                               ("params",), model=model)["params"]
    for (path, g), (_, r) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.device_get(params))):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= PARAM_TOL * scale, \
            jax.tree_util.keystr(path)


def _stats_close(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k.endswith("_acc"):
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
        else:
            assert abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), \
                (k, got[k], ref[k])


@pytest.fixture(autouse=True)
def _one_thread():
    """scikit-learn's t-SNE and KMeans on one thread: beside the suite's
    other workers their thread pools would take every core."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_full_batch_trainer_matches_jax(conv):
    g = make_graph(1)
    jm = jg.GNN(hidden=16, out_channels=3, conv=conv, dropout=0.0)
    jtr = jfull.GNNTrainer(jm, g, lr=0.02, patience=100)
    pm = _port_gnn(jtr.params, 10, conv)
    ptr = pfull.GNNTrainer(pm, g, lr=0.02, patience=100)
    for _ in range(5):
        _stats_close(ptr.run(1), jtr.run(1))
    _assert_params(ptr.model, jtr.params)
    assert ptr.best_val_loss == pytest.approx(jtr.best_val_loss,
                                              rel=LOSS_RTOL)


def test_full_batch_trainer_writes_its_files(tmp_path):
    """With ``save_root``: the best parameters as ``gnn_params.pt`` (the
    model's state after the run) and the embeddings' t-SNE picture."""
    import torch
    g = make_graph(1)
    pm = pg.GNN(10, hidden=16, out_channels=3, dropout=0.0, device="cpu")
    ptr = pfull.GNNTrainer(pm, g, lr=0.02, save_root=str(tmp_path),
                           exp_name="run")
    ptr.run(3)
    saved = torch.load(tmp_path / "run" / "gnn_params.pt")
    assert all(torch.equal(saved[k], v) for k, v in pm.state_dict().items())
    assert (tmp_path / "run" / "embeddings.png").is_file()


def test_full_batch_early_stopping_matches_jax():
    """A rate so large that the validation loss rises: both stop after
    ``patience`` epochs without a new lowest, at the same step, and keep
    the best parameters."""
    g = make_graph(2)
    jm = jg.GNN(hidden=16, out_channels=3, conv="gcn", dropout=0.0)
    jtr = jfull.GNNTrainer(jm, g, lr=0.5, patience=2)
    pm = _port_gnn(jtr.params, 10, "gcn")
    ptr = pfull.GNNTrainer(pm, g, lr=0.5, patience=2)
    _stats_close(ptr.run(40), jtr.run(40))
    assert ptr.step == jtr.step < 40
    _assert_params(ptr.model, jtr.best_params)
