"""Axial self-attention for n-dimensional channels-last images, and the
reversible transformer built from it.

Counterpart of the JAX package's ``modules/axial_attention.py``
(reference elektronn3/modules/axial_attention.py, lucidrains-derived:
SelfAttention :123-151, AxialPositionalEmbedding :99-120, AxialAttention
:154-181, AxialImageTransformer :184-219, ReversibleBlock/Sequence
:257-351).

- Each axial pass is one batched attention over (batch x other axes,
  axis length, C): the axis is moved next to the channels and the rest
  flattened, as in JAX. The logits are a float32 matmul, the softmax is
  float32 and is cast to ``v``'s dtype before the second matmul, as
  JAX's ``einsum(..., preferred_element_type=float32)`` and softmax do.
- The reversible sequence is a ``torch.autograd.Function``
  (:class:`_ReversibleFunction`) that keeps only the outputs: its
  backward rebuilds each block's inputs from its outputs (``x2 = y2 -
  g(y1)``, ``x1 = y1 - f(x2)``) and takes the blocks' vector-Jacobian
  products there, as JAX's ``jax.custom_vjp`` does. The blocks'
  parameters are explicit inputs of the function, so their gradients
  come back through autograd (and reach ``parallel``'s gradient sum).

Module names are flax's (``to_q``, ``axial_0``, ``f_layers_0``,
``Rezero_0``, ``emb_0``), so ``convert.py`` maps the state_dict onto the
flax tree by path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from elektronn3_tpu_torch.modules.layers import Conv, Dense, named_child


class SelfAttention(nn.Module):
    """Multi-head self-attention over (B, T, dim) sequences: ``to_q``
    and ``to_kv`` without bias, ``to_out`` with (JAX's
    ``SelfAttention``)."""

    def __init__(self, dim: int, heads: int = 8,
                 dim_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.heads = heads
        self.dim_heads = dim_heads or dim // heads
        hidden = self.dim_heads * heads
        self.to_q = Dense(dim, hidden, use_bias=False, dtype=dtype,
                          device=device)
        self.to_kv = Dense(dim, 2 * hidden, use_bias=False, dtype=dtype,
                           device=device)
        self.to_out = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, dh = self.heads, self.dim_heads
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        b, n, _ = q.shape

        def split_heads(t):
            return t.reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * dh ** -0.5
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * dh)
        return self.to_out(out)


class AxialPositionalEmbedding(nn.Module):
    """Additive per-axis positional embeddings ``emb_{i}`` of shape (1,
    ..., shape[i] at axis i + 1, ..., dim), standard normal at first
    (JAX's ``AxialPositionalEmbedding``)."""

    def __init__(self, dim: int, shape: Sequence[int],
                 device: Optional[torch.device] = None):
        super().__init__()
        self.dim = dim
        self.shape = tuple(shape)
        for i, s in enumerate(self.shape):
            size = [1] * (len(self.shape) + 2)
            size[i + 1] = s
            size[-1] = dim
            self.register_parameter(f"emb_{i}", nn.Parameter(
                torch.randn(size, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.shape)):
            x = x + getattr(self, f"emb_{i}").to(x.dtype)
        return x


class AxialAttention(nn.Module):
    """Axial attention over channels-last (N, *spatial, dim) images: one
    :class:`SelfAttention` (``axial_{ax}``) a spatial axis, the results
    summed (``sum_axial_out``) or applied in turn (JAX's
    ``AxialAttention``)."""

    def __init__(self, dim: int, num_dimensions: int = 2, heads: int = 8,
                 dim_heads: Optional[int] = None,
                 sum_axial_out: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_dimensions = num_dimensions
        self.sum_axial_out = sum_axial_out
        for ax in range(num_dimensions):
            named_child(self, f"axial_{ax}", SelfAttention(
                dim, heads, dim_heads, dtype, device))

    def _along_axis(self, attn: nn.Module, t: torch.Tensor,
                    axis: int) -> torch.Tensor:
        tp = t.movedim(axis + 1, -2)
        lead = tp.shape[:-2]
        out = attn(tp.reshape((-1,) + tp.shape[-2:]))
        return out.reshape(lead + out.shape[-2:]).movedim(-2, axis + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.num_dimensions + 2:
            raise ValueError(f"Expected (N, *spatial[{self.num_dimensions}]"
                             f", C), got {tuple(x.shape)}")
        attns = [getattr(self, f"axial_{ax}")
                 for ax in range(self.num_dimensions)]
        if self.sum_axial_out:
            out = 0.0
            for ax, attn in enumerate(attns):
                out = out + self._along_axis(attn, x, ax)
            return out
        out = x
        for ax, attn in enumerate(attns):
            out = self._along_axis(attn, out, ax)
        return out


class Rezero(nn.Module):
    """``mod(x) * g`` with a learned scalar ``g``, zero at first (JAX's
    ``Rezero``). With ``mod=None`` the module holds only ``g`` and
    :meth:`scale` applies it (the non-reversible transformer, whose flax
    tree keeps the sub-layers beside their ``Rezero_{k}``)."""

    def __init__(self, mod: Optional[nn.Module] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.mod = mod
        self.g = nn.Parameter(torch.zeros((), device=device))

    def scale(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.g.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale(self.mod(x))


class _ConvFF(nn.Module):
    """3^d conv to ``expansion * dim`` channels, relu, 3^d conv back
    ('SAME'; JAX's ``_ConvFF``)."""

    def __init__(self, dim: int, num_dimensions: int = 2,
                 expansion: int = 4, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        k = (3,) * num_dimensions
        self.Conv_0 = Conv(dim, dim * expansion, k, dtype=dtype,
                           device=device)
        self.Conv_1 = Conv(dim * expansion, dim, k, dtype=dtype,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.Conv_0(x)))


class _ReversibleFunction(torch.autograd.Function):
    """``y1 = x1 + f(x2); y2 = x2 + g(y1)`` over the blocks, saving only
    (y1, y2); the backward rebuilds each block's inputs from its outputs
    and takes its vector-Jacobian products there (JAX's
    ``_rev_sequence`` custom vjp). ``params`` are every block's
    parameters in order (f's, then g's, block by block), passed as
    inputs so that their gradients are this function's outputs."""

    @staticmethod
    def forward(ctx, x1, x2, blocks, *params):
        ctx.blocks = blocks
        with torch.no_grad():
            for f, g in blocks:
                x1 = x1 + f(x2)
                x2 = x2 + g(x1)
        ctx.save_for_backward(x1, x2)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2 = ctx.saved_tensors
        dparams: List[Tuple[Optional[torch.Tensor], ...]] = []
        for f, g in reversed(ctx.blocks):
            fp, gp = list(f.parameters()), list(g.parameters())
            with torch.enable_grad():
                y1d = y1.detach().requires_grad_(True)
                g_out = g(y1d)
                x2 = (y2 - g_out).detach().requires_grad_(True)
                f_out = f(x2)
            x1 = (y1 - f_out).detach()
            dg = torch.autograd.grad(g_out, [y1d] + gp, dy2,
                                     allow_unused=True)
            dy1 = dy1 + dg[0]
            df = torch.autograd.grad(f_out, [x2] + fp, dy1,
                                     allow_unused=True)
            dx2 = dy2 + df[0]
            dparams.append(tuple(df[1:]) + tuple(dg[1:]))
            y1, y2, dy2 = x1, x2.detach(), dx2
        grads = [g for block in reversed(dparams) for g in block]
        return (dy1, dy2, None) + tuple(grads)


class ReversibleSequence(nn.Module):
    """Reversible residual sequence over (f, g) block pairs
    (``f_layers_{i}``, ``g_layers_{i}``; JAX's ``ReversibleSequence``):
    the channels split into halves (x1, x2), ``y1 = x1 + f(x2); y2 = x2
    + g(y1)`` a block, the halves concatenated. Where autograd records,
    :class:`_ReversibleFunction` runs it and keeps no activation;
    elsewhere the blocks run as they are."""

    def __init__(self, blocks: Sequence[Tuple[nn.Module, nn.Module]]):
        super().__init__()
        self.n_blocks = len(blocks)
        for i, (f, g) in enumerate(blocks):
            named_child(self, f"f_layers_{i}", f)
            named_child(self, f"g_layers_{i}", g)

    def blocks(self) -> List[Tuple[nn.Module, nn.Module]]:
        return [(getattr(self, f"f_layers_{i}"),
                 getattr(self, f"g_layers_{i}"))
                for i in range(self.n_blocks)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=-1)
        blocks = self.blocks()
        params = [p for f, g in blocks
                  for p in list(f.parameters()) + list(g.parameters())]
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in params)):
            y1, y2 = _ReversibleFunction.apply(x1, x2, blocks, *params)
        else:
            for f, g in blocks:
                x1 = x1 + f(x2)
                x2 = x2 + g(x1)
            y1, y2 = x1, x2
        return torch.cat([y1, y2], dim=-1)


class AxialImageTransformer(nn.Module):
    """``depth`` layers of (axial attention, conv feed-forward), each
    behind a :class:`Rezero`, over channels-last images (JAX's
    ``AxialImageTransformer``). ``reversible``: the input doubled along
    the channels through a :class:`ReversibleSequence`
    (``ReversibleSequence_0``), the two halves of its output averaged;
    otherwise ``x + attn(x)``, ``x + ff(x)`` in turn (``AxialAttention_
    {i}``, ``_ConvFF_{i}`` and ``Rezero_{2i}``, ``Rezero_{2i + 1}``, as
    flax names them there)."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_heads: Optional[int] = None, num_dimensions: int = 2,
                 reversible: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.dim = dim
        self.depth = depth
        self.heads = heads
        self.dim_heads = dim_heads
        self.num_dimensions = num_dimensions
        self.reversible = reversible
        self.dtype = dtype

        def attn():
            return AxialAttention(dim, num_dimensions, heads, dim_heads,
                                  dtype=dtype, device=device)

        def ff():
            return _ConvFF(dim, num_dimensions, dtype=dtype, device=device)

        if reversible:
            self.ReversibleSequence_0 = ReversibleSequence(
                [(Rezero(attn(), device), Rezero(ff(), device))
                 for _ in range(depth)])
        else:
            for i in range(depth):
                named_child(self, f"AxialAttention_{i}", attn())
                named_child(self, f"_ConvFF_{i}", ff())
                named_child(self, f"Rezero_{2 * i}", Rezero(device=device))
                named_child(self, f"Rezero_{2 * i + 1}",
                            Rezero(device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reversible:
            out = self.ReversibleSequence_0(torch.cat([x, x], dim=-1))
            o1, o2 = out.chunk(2, dim=-1)
            return (o1 + o2) / 2
        for i in range(self.depth):
            x = x + getattr(self, f"Rezero_{2 * i}").scale(
                getattr(self, f"AxialAttention_{i}")(x))
            x = x + getattr(self, f"Rezero_{2 * i + 1}").scale(
                getattr(self, f"_ConvFF_{i}")(x))
        return x
