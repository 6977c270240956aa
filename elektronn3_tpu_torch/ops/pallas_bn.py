"""Standalone batch norm (training and eval) on channels-last tensors,
with hand-written Hopper kernels.

PyTorch counterpart of the JAX package's ``ops/pallas_bn.py``, the op
behind the opt-in ``normalization='batchp'``. The operand is the
activation seen as rows, ``(R, C)`` with channels minor (R = N * D * H *
W), and four kernels (``csrc/batch_norm.cu``) make two passes over it
each way, with the per-channel glue between them as small torch ops on
C-vectors (:func:`fold_forward`, :func:`fold_backward`), as JAX keeps it
in XLA between its ``pallas_call``s:

- :func:`batch_norm_train` forward: K8 ``bn_stats`` (float32 sum and
  sum of squares per channel; row 29 of the kernel table in PERF.md,
  ``_bn_stats``), then ``mean = s / R``, ``var = max(q / R - mean^2,
  0)``, ``inv = rsqrt(var + eps)``, ``scale = gamma * inv``, ``shift =
  beta - mean * scale``, then K9 ``bn_normalize`` (``y = x * scale +
  shift``; row 30, ``_bn_normalize``);
- its backward (row 31, ``_bn_bwd``): K10 ``bn_bwd_reduce`` (``sum g``
  and ``sum g * xhat``, ``xhat = (x - mean) * inv``), then ``a = gamma *
  inv``, ``b = -gamma * inv^2 * sum(g xhat) / R``, ``c = -gamma * inv *
  sum(g) / R - b * mean``, then K11 ``bn_bwd_dx`` (``dx = a g + b x +
  c``). The cotangents of the returned statistics are ignored, as in
  JAX: they feed only the running statistics;
- :func:`batch_norm_inference`: K9 with the running statistics, ``inv =
  rsqrt(var + eps)`` with NO clamp of ``var``.

Each kernel has a wrapper ``*_kernel`` and a plain PyTorch version
``*_plain`` beside it (same signature, same rounding points: float32
arithmetic, one rounding of ``y`` to ``x``'s dtype and of ``dx`` to
``g``'s). The ops take the plain versions for a CPU tensor or with
``reference=True``, the kernels for a CUDA tensor; nothing falls back
from one to the other. Every wrapper checks the kernels' contract on
every device first: a contiguous (R, C) operand, R >= 1, C % 8 == 0 and
C <= 2048, float32 or bfloat16. Kernel launches count in
:data:`elektronn3_tpu_torch.ops.fused.LAUNCHES`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elektronn3_tpu_torch.ops import _build
from elektronn3_tpu_torch.ops.fused import (
    LAUNCHES, _DTYPE_ID, _check_cuda, _check_dtype, _needs_grad, _plain,
    _stream, _vec)

MAX_C = 2048         # a reduction block holds 8 channels per thread
_MAX_BLOCKS = 1024   # reduction blocks at most (partials to sum)
_MIN_ITERS = 4       # rows each thread of a reduction block reads, at least


def _check_rows(t: torch.Tensor, what: str) -> None:
    """The kernels' contract for an (R, C) operand, on every device."""
    _check_dtype(t, what)
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (R, C) tensor, got "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    r, c = t.shape
    if r < 1 or c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"{what}: (R, C) = {(r, c)} needs R >= 1 and C a "
                         f"multiple of 8 in [8, {MAX_C}]")


def reduce_plan(rows: int, c: int) -> Tuple[int, int]:
    """(blocks, rows per block) of K8 and K10: a function of the shape
    alone, so the sums have the same bits on every run. A block of c / 8
    channel groups reads 256 // (c / 8) rows at once, each thread at
    least ``_MIN_ITERS`` of its rows, with at most ``_MAX_BLOCKS``
    blocks."""
    rpp = 256 // (c // 8)
    per = -(-rows // _MAX_BLOCKS)
    rows_per_block = rpp * max(_MIN_ITERS, -(-per // rpp))
    return -(-rows // rows_per_block), rows_per_block


# ---------------------------------------------------------------------------
# K8 bn_stats, K9 bn_normalize (forward; row 29, row 30)
# ---------------------------------------------------------------------------

def bn_stats_plain(x2d: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: (2, C) float32, [sum x, sum x^2] per channel."""
    xf = x2d.float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def bn_stats_kernel(x2d: torch.Tensor) -> torch.Tensor:
    """K8 on a CUDA tensor, as :func:`bn_stats_plain`."""
    _check_rows(x2d, "bn_stats")
    _check_cuda(x2d, "bn_stats")
    r, c = x2d.shape
    nblocks, rpb = reduce_plan(r, c)
    dev = x2d.device
    partial = torch.empty((nblocks, 2, c), dtype=torch.float32, device=dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().e3_bn_stats(
            _DTYPE_ID[x2d.dtype], x2d.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), r, c, nblocks, rpb, _stream(dev))
    _build.check(rc, "bn_stats")
    LAUNCHES["bn_stats"] += 1
    return sums


def bn_normalize_plain(x2d: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``x * scale + shift`` in float32 (multiply,
    then add), rounded once to ``x``'s dtype."""
    return (x2d.float() * scale + shift).to(x2d.dtype)


def bn_normalize_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor) -> torch.Tensor:
    """K9 on a CUDA tensor, as :func:`bn_normalize_plain`."""
    _check_rows(x2d, "bn_normalize")
    _check_cuda(x2d, "bn_normalize")
    r, c = x2d.shape
    dev = x2d.device
    scale, shift = _vec(scale, c, 0.0, dev), _vec(shift, c, 0.0, dev)
    y = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        rc = _build.library().e3_bn_normalize(
            _DTYPE_ID[x2d.dtype], x2d.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), y.data_ptr(), r, c, _stream(dev))
    _build.check(rc, "bn_normalize")
    LAUNCHES["bn_normalize"] += 1
    return y


# ---------------------------------------------------------------------------
# K10 bn_bwd_reduce, K11 bn_bwd_dx (backward; row 31)
# ---------------------------------------------------------------------------

def bn_bwd_reduce_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                        mean: torch.Tensor, inv: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of K10: (2, C) float32, [sum g, sum g * xhat] with
    ``xhat = (x - mean) * inv``."""
    gf = g2d.float()
    xhat = (x2d.float() - mean) * inv
    return torch.stack([gf.sum(0), (gf * xhat).sum(0)])


def bn_bwd_reduce_kernel(g2d: torch.Tensor, x2d: torch.Tensor,
                         mean: torch.Tensor, inv: torch.Tensor
                         ) -> torch.Tensor:
    """K10 on CUDA tensors, as :func:`bn_bwd_reduce_plain`."""
    _check_pair(g2d, x2d, "bn_bwd_reduce")
    r, c = x2d.shape
    dev = x2d.device
    mean, inv = _vec(mean, c, 0.0, dev), _vec(inv, c, 0.0, dev)
    nblocks, rpb = reduce_plan(r, c)
    partial = torch.empty((nblocks, 2, c), dtype=torch.float32, device=dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().e3_bn_bwd_reduce(
            _DTYPE_ID[x2d.dtype], g2d.data_ptr(), x2d.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), r, c, nblocks, rpb, _stream(dev))
    _build.check(rc, "bn_bwd_reduce")
    LAUNCHES["bn_bwd_reduce"] += 1
    return sums


def bn_bwd_dx_plain(g2d: torch.Tensor, x2d: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: ``a * g + b * x + c`` in float32, rounded
    once to ``g``'s dtype."""
    return (a * g2d.float() + b * x2d.float() + c).to(g2d.dtype)


def bn_bwd_dx_kernel(g2d: torch.Tensor, x2d: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K11 on CUDA tensors, as :func:`bn_bwd_dx_plain`."""
    _check_pair(g2d, x2d, "bn_bwd_dx")
    r, ch = x2d.shape
    dev = x2d.device
    a, b, c = (_vec(v, ch, 0.0, dev) for v in (a, b, c))
    dx = torch.empty_like(g2d)
    with torch.cuda.device(dev):
        rc = _build.library().e3_bn_bwd_dx(
            _DTYPE_ID[x2d.dtype], g2d.data_ptr(), x2d.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), dx.data_ptr(), r, ch,
            _stream(dev))
    _build.check(rc, "bn_bwd_dx")
    LAUNCHES["bn_bwd_dx"] += 1
    return dx


def _check_pair(g2d: torch.Tensor, x2d: torch.Tensor, what: str) -> None:
    """K10 and K11 read ``g`` and ``x`` side by side: one shape, dtype
    and device."""
    for t in (g2d, x2d):
        _check_rows(t, what)
        _check_cuda(t, what)
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype \
            or g2d.device != x2d.device:
        raise ValueError(f"{what}: g {tuple(g2d.shape)} {g2d.dtype} and x "
                         f"{tuple(x2d.shape)} {x2d.dtype} must match")


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` (channels last) as its contiguous (R, C) view, checked."""
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous channels-last "
                         f"tensor, got {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    x2d = x.view(-1, x.shape[-1])
    _check_rows(x2d, what)
    return x2d


def _scale_shift(gamma: torch.Tensor, beta: torch.Tensor,
                 mean: torch.Tensor, inv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's per-channel ``scale = gamma * inv``, ``shift = beta - mean *
    scale``."""
    scale = gamma.float() * inv
    return scale, beta.float() - mean * scale


def fold_forward(sums: torch.Tensor, rows: int, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, ...]:
    """The glue from K8 to K9 (JAX's ``_bn_fwd_impl``): from K8's (2, C)
    sums over ``rows`` rows, ``(mean, var, inv, scale, shift)`` with
    ``var = max(E[x^2] - mean^2, 0)`` and ``inv = rsqrt(var + eps)``."""
    mean = sums[0] / rows
    var = torch.clamp_min(sums[1] / rows - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    return (mean, var, inv) + _scale_shift(gamma, beta, mean, inv)


def fold_backward(sums: torch.Tensor, rows: int, gamma: torch.Tensor,
                  mean: torch.Tensor, inv: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The glue from K10 to K11 (JAX's ``_bn_bwd``): from K10's (2, C)
    sums ``(dbeta, dgamma)``, the ``(a, b, c)`` of ``dx = a g + b x + c``,
    which is ``gamma inv (g - dbeta / R - xhat dgamma / R)`` folded per
    channel."""
    a = gamma.float() * inv
    b = -a * inv * sums[1] / rows
    return a, b, -a * sums[0] / rows - b * mean


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eps, reference, x, gamma, beta):
        x2d = _rows(x, "batch_norm_train")
        ctx.plain = _plain(x, reference)
        stats = bn_stats_plain if ctx.plain else bn_stats_kernel
        normalize = bn_normalize_plain if ctx.plain else bn_normalize_kernel
        mean, var, _, scale, shift = fold_forward(stats(x2d), x2d.shape[0],
                                                  gamma, beta, eps)
        y = normalize(x2d, scale, shift).view(x.shape)
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, var = ctx.saved_tensors
        reduce_, dx_ = ((bn_bwd_reduce_plain, bn_bwd_dx_plain) if ctx.plain
                        else (bn_bwd_reduce_kernel, bn_bwd_dx_kernel))
        x2d = x.view(-1, x.shape[-1])
        g2d = gy.to(x.dtype).contiguous().view(x2d.shape)
        inv = torch.rsqrt(var + ctx.eps)
        sums = reduce_(g2d, x2d, mean, inv)
        a, b, c = fold_backward(sums, x2d.shape[0], gamma, mean, inv)
        dx = dx_(g2d, x2d, a, b, c).view(x.shape)
        return (None, None, dx, sums[1].to(gamma.dtype),
                sums[0].to(gamma.dtype))


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5, *,
                     reference: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode batch norm of a contiguous channels-last tensor over
    every axis but the last: returns ``(y, mean, var)``, ``y`` in ``x``'s
    dtype, the float32 batch mean and the biased variance clamped at 0
    (``E[x^2] - mean^2``). Differentiable in ``x``, ``gamma`` and
    ``beta`` through ``y``; ``mean`` and ``var`` are not differentiable
    (running-statistics semantics). ``reference`` runs the plain
    versions on any device."""
    return _BatchNormTrain.apply(eps, reference, x, gamma, beta)


def batch_norm_inference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, eps: float = 1e-5, *,
                         reference: bool = False) -> torch.Tensor:
    """Eval-mode batch norm from running statistics: one K9 pass with
    ``inv = rsqrt(var + eps)`` (``var`` not clamped, as in JAX),
    ``scale = gamma * inv``, ``shift = beta - mean * scale``. Not
    differentiable: it raises if a gradient is wanted."""
    x2d = _rows(x, "batch_norm_inference")
    if _needs_grad(x, gamma, beta):
        raise ValueError("batch_norm_inference is not differentiable (eval "
                         "runs without autograd)")
    scale, shift = _scale_shift(gamma, beta, mean.float(),
                                torch.rsqrt(var.float() + eps))
    normalize = bn_normalize_plain if _plain(x, reference) \
        else bn_normalize_kernel
    return normalize(x2d, scale, shift).view(x.shape)
