"""The port's graph layers (``modules/graph.py``) against the JAX
package's flax modules, on the CPU in float32.

A seeded random graph (40 nodes, 12 features, 150 directed edges, two
isolated nodes and a duplicate edge) and the same parameters (flax's
init converted with ``models.convert``): the forward of ``GCNConv``,
``SAGEConv`` and ``GATConv`` (1 and 3 heads) and of a ``GNN`` of each
kind (3 layers, dropout 0 or eval) within 1e-5 of the output's scale,
the gradient of every parameter and of the input within 1e-4 of its
scale; the converter's round trip flax -> torch -> flax bit for bit;
``add_self_loops``, ``gcn_norm`` and the segment maximum against JAX's.
Dropout cannot draw JAX's numbers: its keep rate and its 1 / (1 - p)
scaling are checked by themselves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.modules import graph as jg
from elektronn3_tpu_torch.models import (
    flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import graph as pg

N, F_IN, E = 40, 12, 150
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def random_graph(seed=0, n=N, f=F_IN, e=E):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = rng.integers(0, n - 2, size=(2, e))      # nodes n-2, n-1 isolated
    ei[:, -1] = ei[:, 0]                          # a duplicate edge
    return x, ei.astype(np.int64)


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _pair(jmod, pmod, x, ei):
    """flax variables of ``jmod`` (init at seed 1) and ``pmod`` holding
    them."""
    v = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(ei))
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"]})
    pmod.load_state_dict(state_dict_from_flax(v, pmod))
    return v, pmod


CONVS = {
    "gcn": (lambda: jg.GCNConv(8), lambda: pg.GCNConv(F_IN, 8)),
    "sage": (lambda: jg.SAGEConv(8), lambda: pg.SAGEConv(F_IN, 8)),
    "gat": (lambda: jg.GATConv(8), lambda: pg.GATConv(F_IN, 8)),
    "gat3": (lambda: jg.GATConv(5, heads=3),
             lambda: pg.GATConv(F_IN, 5, heads=3)),
}


@pytest.mark.parametrize("kind", list(CONVS))
def test_conv_forward_and_gradients_match_flax(kind):
    x, ei = random_graph(2)
    jmod, pmod = CONVS[kind][0](), CONVS[kind][1]()
    v, pmod = _pair(jmod, pmod, x, ei)
    jout = jax.jit(jmod.apply)(v, jnp.asarray(x), jnp.asarray(ei))
    ct = np.random.default_rng(3).normal(size=jout.shape)

    def loss(params, xx):
        return jnp.sum(jmod.apply({"params": params}, xx, jnp.asarray(ei))
                       * ct)
    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"],
                                                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = pmod(xt, torch.from_numpy(ei))
    _close(out.detach(), jout, FWD_TOL, "forward")
    (out * torch.from_numpy(ct).float()).sum().backward()
    _close(xt.grad, jgx, GRAD_TOL, "input gradient")
    grads = flax_from_state_dict(
        {n: p.grad for n, p in pmod.named_parameters()}, {"params": jgp},
        ("params",), model=pmod)["params"]
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        ref = jgp
        for k in path:
            ref = ref[k.key]
        _close(g, ref, GRAD_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_gnn_matches_flax_and_converts_exactly(conv):
    x, ei = random_graph(4)
    jm = jg.GNN(hidden=16, out_channels=5, num_layers=3, conv=conv,
                dropout=0.5)
    pm = pg.GNN(F_IN, hidden=16, out_channels=5, num_layers=3, conv=conv,
                dropout=0.5, device="cpu")
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(ei))
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"]})
    sd = state_dict_from_flax(v, pm)
    pm.load_state_dict(sd)
    back = flax_from_state_dict(pm.state_dict(), v, ("params",), model=pm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)))
    assert set(v["params"]) == {"conv_0", "conv_1", "conv_2"}

    def loss(params):
        logits, emb = jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(ei), train=False)
        return jnp.sum(logits ** 2) + jnp.sum(jnp.tanh(emb)), (logits, emb)
    (_, (jl, je)), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    logits, emb = pm(torch.from_numpy(x), torch.from_numpy(ei), train=False)
    _close(logits.detach(), jl, FWD_TOL, "logits")
    _close(emb.detach(), je, FWD_TOL, "embeddings")
    ((logits ** 2).sum() + torch.tanh(emb).sum()).backward()
    got = flax_from_state_dict({n: p.grad for n, p in pm.named_parameters()},
                               {"params": jgrad}, ("params",), model=pm)
    for (path, g), (_, r) in zip(
            jax.tree_util.tree_leaves_with_path(got["params"]),
            jax.tree_util.tree_leaves_with_path(jgrad)):
        _close(g, r, GRAD_TOL, jax.tree_util.keystr(path))
    pm.eval()
    l2, _ = pm(torch.from_numpy(x), torch.from_numpy(ei))
    assert torch.equal(l2, logits)        # eval mode: no dropout


def test_helpers_match_jax():
    x, ei = random_graph(5)
    ej = jg.add_self_loops(jnp.asarray(ei), N)
    ep = pg.add_self_loops(torch.from_numpy(ei), N)
    assert np.array_equal(ep.numpy(), np.asarray(ej))
    _close(pg.gcn_norm(ep, N).numpy(), jg.gcn_norm(ej, N), 1e-6, "gcn_norm")
    data = np.random.default_rng(6).normal(size=(ei.shape[1], 3))
    seg = ei[0]
    got = pg.segment_max(torch.from_numpy(data), torch.from_numpy(seg), N)
    ref = np.asarray(jax.ops.segment_max(jnp.asarray(data, jnp.float32),
                                         jnp.asarray(seg), num_segments=N))
    has = np.isin(np.arange(N), seg)
    assert np.allclose(got.numpy()[has], ref[has], rtol=1e-6)


def test_dropout_keep_rate_and_scale():
    """Dropout on the hidden layers: about 1 - p of the activations kept
    (p = 0.5 over 3 * 4000 * 32 draws: within 1%), each kept one scaled
    by 1 / (1 - p), nothing dropped in eval; the draws follow torch's
    seed."""
    torch.manual_seed(0)
    m = pg.GNN(8, hidden=32, out_channels=2, num_layers=2, conv="sage",
               dropout=0.5, device="cpu")
    with torch.no_grad():
        m.conv_0.lin_self.weight.fill_(0.1)
        m.conv_0.lin_neigh.weight.zero_()
        m.conv_0.lin_self.bias.zero_()
    x = torch.ones(4000, 8)
    ei = torch.zeros(2, 0, dtype=torch.long)
    kept = []
    with torch.no_grad():
        _, full = m(x, ei, train=False)
        for seed in range(3):
            torch.manual_seed(seed)
            _, emb = m(x, ei, train=True)
            torch.manual_seed(seed)
            _, again = m(x, ei, train=True)
            assert torch.equal(emb, again)
            on = emb != 0
            assert torch.equal(emb[on], 2 * full[on])
            kept.append(float(on.float().mean()))
    assert abs(np.mean(kept) - 0.5) < 0.01
    assert torch.allclose(full, torch.full_like(full, 0.8))
