"""Graph neural network layers.

Counterpart of the JAX package's ``modules/graph.py``: GCN (Kipf &
Welling, arXiv:1609.02907), GraphSAGE-mean (arXiv:1706.02216) and
single-layer GAT (arXiv:1710.10903) convolutions and a node-classifying
``GNN``, over plain tensors: a graph is ``x`` (N, F) and ``edge_index``
(2, E), messages flowing from ``edge_index[1]`` to ``edge_index[0]``.

Segment sums are ``index_add_`` and GAT's segment maximum is
``scatter_reduce(..., "amax")``, ATen's scatter kernels (on CUDA
``index_add_`` sums with atomics, so float32 results vary in the last
bits from run to run). Parameters are float32 and cast to ``dtype`` at
use (``layers.Dense``, flax's ``Dense(dtype=...)``). The submodules
carry flax's names (``Dense_0``, ``lin_self``, ``lin_neigh``,
``conv_{i}``; ``bias``, ``a_src``, ``a_dst``), so ``models.convert``
maps them by path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import Dense, resolve_device


def add_self_loops(edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``edge_index`` with an edge (i, i) for every node appended."""
    loops = torch.arange(num_nodes, device=edge_index.device,
                         dtype=edge_index.dtype)
    return torch.cat([edge_index, torch.stack([loops, loops])], dim=1)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The sum of the rows of ``data`` by ``segment_ids`` (JAX's
    ``jax.ops.segment_sum``; 0 for an empty segment)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The maximum of the rows of ``data`` by ``segment_ids``; an empty
    segment's is the dtype's lowest value (JAX's ``segment_max`` gives
    -inf there; no caller reads an empty segment)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        torch.finfo(data.dtype).min)
    idx = segment_ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def gcn_norm(edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The symmetric D^-1/2 A D^-1/2 weight of each edge (self-loops
    already added), the degree counted over ``edge_index[0]``."""
    row, col = edge_index
    deg = segment_sum(torch.ones(row.shape[0], device=row.device), row,
                      num_nodes)
    dinv = torch.rsqrt(torch.clamp_min(deg, 1e-12))
    return dinv[row] * dinv[col]


class GCNConv(nn.Module):
    """X' = D^-1/2 (A + I) D^-1/2 X W + b."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, use_bias=False,
                             dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, edge_index):
        n = x.shape[0]
        ei = add_self_loops(edge_index, n)
        h = self.Dense_0(x)
        w = gcn_norm(ei, n).to(h.dtype)
        row, col = ei
        out = segment_sum(h[col] * w[:, None], row, n)
        return out + self.bias.to(out.dtype)


class SAGEConv(nn.Module):
    """X' = W1 X + W2 mean_j X_j (the mean over each node's incoming
    messages; 0 for a node without any)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.lin_self = Dense(in_features, features, dtype=dtype,
                              device=device)
        self.lin_neigh = Dense(in_features, features, dtype=dtype,
                               device=device)

    def forward(self, x, edge_index):
        n = x.shape[0]
        row, col = edge_index
        summed = segment_sum(x[col], row, n)
        count = segment_sum(x.new_ones(row.shape[0]), row, n)
        mean = summed / torch.clamp_min(count, 1.0)[:, None]
        return self.lin_self(x) + self.lin_neigh(mean)


class GATConv(nn.Module):
    """Multi-head graph attention, one layer: a softmax over each node's
    incoming edges (self-loops added) of leaky-relu(0.2) scores, the
    heads concatenated."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.features = features
        self.heads = heads
        self.Dense_0 = Dense(in_features, features * heads, use_bias=False,
                             dtype=dtype, device=device)
        self.a_src = nn.Parameter(
            0.1 * torch.randn(heads, features, device=device))
        self.a_dst = nn.Parameter(
            0.1 * torch.randn(heads, features, device=device))

    def forward(self, x, edge_index):
        n = x.shape[0]
        row, col = add_self_loops(edge_index, n)
        h = self.Dense_0(x).reshape(n, self.heads, self.features)
        alpha_src = (h * self.a_src.to(h.dtype)).sum(-1)   # (N, H)
        alpha_dst = (h * self.a_dst.to(h.dtype)).sum(-1)
        e = F.leaky_relu(alpha_src[row] + alpha_dst[col], 0.2)   # (E, H)
        e = torch.exp(e - segment_max(e, row, n)[row])
        denom = segment_sum(e, row, n)
        att = e / torch.clamp_min(denom[row], 1e-12)
        out = segment_sum(h[col] * att[..., None], row, n)
        return out.reshape(n, self.heads * self.features)


CONVS = {"gcn": GCNConv, "sage": SAGEConv, "gat": GATConv}


class GNN(nn.Module):
    """Node classification: ``num_layers`` convolutions of ``conv``
    ('gcn', 'sage' or 'gat'), relu and dropout between them; returns
    (logits, embeddings), the embeddings being the last hidden layer's
    output (the input where ``num_layers`` is 1). ``in_channels`` is the
    node features' width (flax infers it at init). Built on the card
    unless ``device`` says otherwise."""

    def __init__(self, in_channels: int, hidden: int = 64,
                 out_channels: int = 2, num_layers: int = 2,
                 conv: str = "gcn", dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"Unknown conv {conv!r}")
        device = resolve_device(device, "GNN")
        self.in_channels = in_channels
        self.hidden = hidden
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.conv = conv
        self.dropout = dropout
        self.dtype = dtype
        widths = [in_channels] + [hidden] * (num_layers - 1) + [out_channels]
        for i in range(num_layers):
            self.add_module(f"conv_{i}", CONVS[conv](
                widths[i], widths[i + 1], dtype=dtype, device=device))

    def forward(self, x, edge_index, *, train=None):
        """``train``: dropout on (default: the module's training mode)."""
        train = self.training if train is None else train
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"conv_{i}")(x, edge_index))
            x = F.dropout(x, self.dropout, training=train)
        logits = getattr(self, f"conv_{self.num_layers - 1}")(x, edge_index)
        return logits, x
