"""Standalone batch norm (training and eval) on channels-last tensors,
with hand-written Hopper kernels.

PyTorch counterpart of the JAX package's ``ops/pallas_bn.py``, the op
behind the opt-in ``normalization='batchp'``. The operand is the
activation seen as rows, ``(R, C)`` with channels minor (R = N * D * H *
W), and four kernels (``csrc/batch_norm.cu``) make two passes over it
each way. JAX keeps the per-channel glue between its ``pallas_call``s in
XLA, which fuses it; here the two reductions apply it in their own last
step, so each pass is one launch:

- :func:`batch_norm_train` forward: K8 ``bn_stats`` (row 29 of the
  kernel table in PERF.md, ``_bn_stats``) gives ``(5, C)`` float32:
  ``mean = s / R``, ``var = max(q / R - mean^2, 0)``, ``inv = rsqrt(var
  + eps)``, ``scale = gamma * inv``, ``shift = beta - mean * scale``
  from the sums ``s``, ``q`` of x and x^2, and applies the running
  update when given the buffers; then K9 ``bn_normalize`` (``y = x *
  scale + shift``; row 30, ``_bn_normalize``) reads ``scale`` and
  ``shift`` from that output;
- its backward (row 31, ``_bn_bwd``): K10 ``bn_bwd_reduce`` gives
  ``(5, C)`` float32 ``a = gamma * inv``, ``b = -a * inv * sum(g xhat) /
  R``, ``c = -a * sum(g) / R - b * mean``, ``dgamma = sum(g xhat)``,
  ``dbeta = sum(g)`` with ``xhat = (x - mean) * inv``, ``inv = rsqrt(var
  + eps)``; then K11 ``bn_bwd_dx`` (``dx = a g + b x + c``) reads ``a``,
  ``b``, ``c`` from that output. The
  cotangents of the returned statistics are ignored, as in JAX: they
  feed only the running statistics;
- :func:`batch_norm_inference`: K9 with the running statistics, ``inv =
  rsqrt(var + eps)`` with NO clamp of ``var``, through the operator
  ``e3tpu::bn_normalize`` (:data:`OP`), so that ``torch.export`` keeps
  K9 in an exported eval forward (``training.trainer.export_program``).

Each kernel has a wrapper ``*_kernel`` and a plain PyTorch version
``*_plain`` beside it (same signature, same rounding points: float32
arithmetic in the same order, one rounding of ``y`` to ``x``'s dtype and
of ``dx`` to ``g``'s). The ops take the plain versions for a CPU tensor
or with ``reference=True``, the kernels for a CUDA tensor; nothing falls
back from one to the other. Every wrapper checks the kernels' contract
on every device first: a contiguous (R, C) operand, R >= 1, C % 8 == 0
and C <= 2048, float32 or bfloat16. Kernel launches count in
:data:`elektronn3_tpu_torch.ops.fused.LAUNCHES`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from elektronn3_tpu_torch.ops import _build
from elektronn3_tpu_torch.ops.fused import (
    LAUNCHES, _DTYPE_ID, _check_cuda, _check_dtype, _needs_grad, _plain)

MAX_C = 2048           # a block holds 8 channels per thread
CLUSTER = 8            # blocks of a cluster in a grid plan
BLOCKS_PER_SM = 1      # a grid plan's blocks per SM, at most
MIN_ROWS_PER_THREAD = 16   # rows each thread of a grid plan reads, about
# R x C (elements) up to which one cluster streams the rows: it needs no
# ticket and no partials. On an H100 (bn_reduce_sweep.py) one cluster
# of 8 blocks matched the grid at 2^18 elements, beat it at 2^19 (6.9
# against 7.7 us, bf16 K8) and lost at 2^20 (9.9 against 7.6).
SINGLE_CLUSTER_MAX = 1 << 19

# (running mean, running var, momentum): buffers K8 updates in place.
Running = Tuple[torch.Tensor, torch.Tensor, float]

_SMS: Dict[int, int] = {}
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


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


def _cuda_rows(t: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """:func:`_check_rows` and :func:`_check_cuda` of a wrapper's (R, C)
    operand, the common case in a few attribute reads (a call is
    host-bound below about a million elements): (R, C, device index)."""
    if t.dtype in _DTYPE_ID and t.is_cuda and t.dim() == 2 \
            and t.is_contiguous() and not t.data_ptr() % 16:
        r, c = t.shape
        if r >= 1 and not c % 8 and 8 <= c <= MAX_C:
            return r, c, t.get_device()
    _check_rows(t, what)
    _check_cuda(t, what)
    raise AssertionError("unreachable")


def _f32_vec(v: torch.Tensor, c: int, idx: int, what: str) -> torch.Tensor:
    """A per-channel float32 operand the kernel reads as it is: (C,),
    contiguous, on the operand's device (a parameter, a buffer, a row of
    K8's or K10's output)."""
    if v.dtype is not torch.float32 or not v.is_cuda or v.dim() != 1 \
            or v.shape[0] != c or not v.is_contiguous() \
            or v.get_device() != idx:
        raise ValueError(f"{what}: expected a contiguous float32 ({c},) "
                         f"vector on cuda:{idx}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return v


def _param(v: torch.Tensor, c: int, idx: int, what: str) -> torch.Tensor:
    """gamma or beta as the kernel reads it: float32 (the models'
    parameters are, and pass as they are)."""
    if v.dtype is not torch.float32:
        v = v.detach().float()
    return _f32_vec(v, c, idx, what)


def max_clusters(sms: int) -> int:
    """Clusters of a grid plan at most, on a card of ``sms`` SMs."""
    return max(1, sms * BLOCKS_PER_SM // CLUSTER)


def reduce_plan(rows: int, c: int, sms: int) -> Tuple[int, int, int]:
    """(cluster size, clusters, rows per block) of K8 and K10, a function
    of (R, C) and the card's SM count alone, so the sums have the same
    bits on every run and in both dtypes: every sum's order follows from
    it. A block of c / 8 channel groups reads 256 // (c / 8) rows at
    once; block b streams rows [b * rpb, (b + 1) * rpb). Up to
    ``SINGLE_CLUSTER_MAX`` elements one cluster of up to ``CLUSTER``
    blocks streams them all (a power of 2, each thread ``MIN_ROWS_PER_
    THREAD`` rows or more where there are enough); above, clusters of
    ``CLUSTER``, up to ``BLOCKS_PER_SM`` blocks an SM (one: every
    cluster resident at once), whose last to finish sums the cluster
    partials."""
    rpp = 256 // (c // 8)
    want = -(-rows // (rpp * MIN_ROWS_PER_THREAD))
    if rows * c <= SINGLE_CLUSTER_MAX:
        cs, ncl = 1, 1
        while cs < min(want, CLUSTER):
            cs *= 2
    else:
        cs = CLUSTER
        ncl = max(1, min(-(-want // CLUSTER), max_clusters(sms)))
    per = -(-rows // (cs * ncl))
    return cs, ncl, rpp * -(-per // rpp)


def _reduction(idx: int, rows: int, c: int) -> Tuple[int, int, int, int,
                                                      int]:
    """(cluster size, clusters, rows per block, workspace pointer or 0,
    current stream) of a K8 or K10 call on device ``idx``. The workspace
    (a 16-byte ticket, 0 between calls because the last cluster resets
    it, then the cluster partials) is allocated once per device and
    stream, at the first call whose plan needs one."""
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    stream = torch._C._cuda_getCurrentRawStream(idx)
    cs, ncl, rpb = reduce_plan(rows, c, sms)
    ws = 0
    if ncl > 1:
        buf = _WORKSPACE.get((idx, stream))
        if buf is None or buf.numel() < 4 + 2 * c * ncl:
            buf = _WORKSPACE[(idx, stream)] = torch.zeros(
                4 + 2 * MAX_C * max(ncl, max_clusters(sms)),
                dtype=torch.float32, device=torch.device("cuda", idx))
        ws = buf.data_ptr()
    return cs, ncl, rpb, ws, stream


def _launch(name: str, idx: int, *args) -> None:
    """Call the C entry point ``e3_<name>`` (its last argument the
    stream) with device ``idx`` current, raise on its error code and
    count the launch."""
    fn = getattr(_build.library(), "e3_" + name)
    if idx == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args)
    if rc:
        _build.check(rc, name)
    LAUNCHES[name] += 1


def update_running(running: Running, mean: torch.Tensor,
                   var: torch.Tensor) -> None:
    """``ra = (1 - m) * ra + m * batch`` in float32 for the running mean
    and variance, in place and without autograd (flax's momentum update;
    K8 applies the same on the card)."""
    ra_mean, ra_var, m = running
    with torch.no_grad():
        for buf, val in ((ra_mean, mean), (ra_var, var)):
            buf.copy_((1.0 - m) * buf.float() + m * val.detach().float())


# ---------------------------------------------------------------------------
# K8 bn_stats, K9 bn_normalize (forward; row 29, row 30)
# ---------------------------------------------------------------------------

def bn_stats_plain(x2d: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float,
                   running: Optional[Running] = None) -> torch.Tensor:
    """Plain version of K8: (5, C) float32 [mean, var, inv, scale, shift]
    of the rows (JAX's ``_bn_fwd_impl`` from its ``_bn_stats`` sums), and
    the running update when ``running`` is given."""
    xf = x2d.float()
    r = x2d.shape[0]
    mean = xf.sum(0) / r
    var = torch.clamp_min((xf * xf).sum(0) / r - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale, shift = _scale_shift(gamma, beta, mean, inv)
    if running is not None:
        update_running(running, mean, var)
    return torch.stack([mean, var, inv, scale, shift])


def bn_stats_kernel(x2d: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float,
                    running: Optional[Running] = None) -> torch.Tensor:
    """K8 on a CUDA tensor, as :func:`bn_stats_plain`: one launch; the
    running buffers (float32 (C,) on the device) are updated in place."""
    r, c, idx = _cuda_rows(x2d, "bn_stats")
    gamma = _param(gamma, c, idx, "bn_stats gamma")
    beta = _param(beta, c, idx, "bn_stats beta")
    ra_mean = ra_var = None
    m = 0.0
    if running is not None:
        ra_mean, ra_var, m = running
        ra_mean = _f32_vec(ra_mean, c, idx, "bn_stats running mean").data_ptr()
        ra_var = _f32_vec(ra_var, c, idx, "bn_stats running var").data_ptr()
    cs, ncl, rpb, ws, stream = _reduction(idx, r, c)
    out = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    _launch("bn_stats", idx, _DTYPE_ID[x2d.dtype], x2d.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), eps, ra_mean, ra_var, m,
            1.0 - m, ws, out.data_ptr(), r, c, cs, ncl, rpb, stream)
    return out


def bn_normalize_plain(x2d: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``x * scale + shift`` in float32 (multiply,
    then add), rounded once to ``x``'s dtype."""
    return (x2d.float() * scale + shift).to(x2d.dtype)


def bn_normalize_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor) -> torch.Tensor:
    """K9 on a CUDA tensor, as :func:`bn_normalize_plain`; ``scale`` and
    ``shift`` float32 (C,) on the device (rows of K8's output)."""
    r, c, idx = _cuda_rows(x2d, "bn_normalize")
    scale = _f32_vec(scale, c, idx, "bn_normalize scale")
    shift = _f32_vec(shift, c, idx, "bn_normalize shift")
    y = torch.empty_like(x2d)
    _launch("bn_normalize", idx, _DTYPE_ID[x2d.dtype], x2d.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.data_ptr(), r, c,
            torch._C._cuda_getCurrentRawStream(idx))
    return y


# K9 as the operator ``e3tpu::bn_normalize``, registered when this module
# is imported: the CUDA kernel for a CUDA tensor, the plain version for a
# CPU one, and a fake implementation (an empty tensor of ``x2d``'s shape
# and dtype) for ``torch.export``, which traces with fake tensors and so
# keeps the op as one node of the exported graph instead of calling
# ``data_ptr()`` on them. A program that holds the node loads once this
# module is imported (``training.trainer.load_program`` does so). Both
# implementations look the function up by its name at each call, as the
# other callers here do, so that a spy set on the module (chip_smoke.py's
# shape recorder) sees the operator's calls too.
OP = "e3tpu::bn_normalize"
torch.library.define(OP, "(Tensor x2d, Tensor scale, Tensor shift) -> Tensor")
torch.library.impl(OP, "cpu", lambda *a: bn_normalize_plain(*a))
torch.library.impl(OP, "cuda", lambda *a: bn_normalize_kernel(*a))


@torch.library.register_fake(OP)
def _bn_normalize_fake(x2d: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x2d)


# ---------------------------------------------------------------------------
# K10 bn_bwd_reduce, K11 bn_bwd_dx (backward; row 31)
# ---------------------------------------------------------------------------

def bn_bwd_reduce_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                        mean: torch.Tensor, var: torch.Tensor,
                        gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of K10: (5, C) float32 [a, b, c, dgamma, dbeta],
    ``dx = a g + b x + c`` being ``gamma inv (g - dbeta / R - xhat dgamma
    / R)`` folded per channel (JAX's ``_bn_bwd``), ``dgamma = sum g *
    xhat``, ``dbeta = sum g``, ``xhat = (x - mean) * inv``, ``inv =
    rsqrt(var + eps)``."""
    gf = g2d.float()
    r = x2d.shape[0]
    inv = torch.rsqrt(var + eps)
    xhat = (x2d.float() - mean) * inv
    dbeta, dgamma = gf.sum(0), (gf * xhat).sum(0)
    a = gamma.float() * inv
    b = -a * inv * dgamma / r
    return torch.stack([a, b, -a * dbeta / r - b * mean, dgamma, dbeta])


def bn_bwd_reduce_kernel(g2d: torch.Tensor, x2d: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor,
                         gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """K10 on CUDA tensors, as :func:`bn_bwd_reduce_plain`: one launch;
    ``mean`` and ``var`` float32 (C,) on the device (rows of K8's
    output)."""
    r, c, idx = _check_pair(g2d, x2d, "bn_bwd_reduce")
    mean = _f32_vec(mean, c, idx, "bn_bwd_reduce mean")
    var = _f32_vec(var, c, idx, "bn_bwd_reduce var")
    gamma = _param(gamma, c, idx, "bn_bwd_reduce gamma")
    cs, ncl, rpb, ws, stream = _reduction(idx, r, c)
    out = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    _launch("bn_bwd_reduce", idx, _DTYPE_ID[x2d.dtype], g2d.data_ptr(),
            x2d.data_ptr(), mean.data_ptr(), var.data_ptr(),
            gamma.data_ptr(), eps, ws, out.data_ptr(), r, c, cs, ncl, rpb,
            stream)
    return out


def bn_bwd_dx_plain(g2d: torch.Tensor, x2d: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: ``a * g + b * x + c`` in float32, rounded
    once to ``g``'s dtype."""
    return (a * g2d.float() + b * x2d.float() + c).to(g2d.dtype)


def bn_bwd_dx_kernel(g2d: torch.Tensor, x2d: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K11 on CUDA tensors, as :func:`bn_bwd_dx_plain`; ``a``, ``b``,
    ``c`` float32 (C,) on the device (rows of K10's output)."""
    r, ch, idx = _check_pair(g2d, x2d, "bn_bwd_dx")
    a, b, c = (_f32_vec(v, ch, idx, "bn_bwd_dx") for v in (a, b, c))
    dx = torch.empty_like(g2d)
    _launch("bn_bwd_dx", idx, _DTYPE_ID[x2d.dtype], g2d.data_ptr(),
            x2d.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            dx.data_ptr(), r, ch, torch._C._cuda_getCurrentRawStream(idx))
    return dx


def _check_pair(g2d: torch.Tensor, x2d: torch.Tensor, what: str
                ) -> Tuple[int, int, int]:
    """K10 and K11 read ``g`` and ``x`` side by side: one shape, dtype
    and device. Returns (R, C, device index)."""
    rc = _cuda_rows(x2d, what)
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype \
            or g2d.device != x2d.device:
        raise ValueError(f"{what}: g {tuple(g2d.shape)} {g2d.dtype} and x "
                         f"{tuple(x2d.shape)} {x2d.dtype} must match")
    _cuda_rows(g2d, what)
    return rc


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


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eps, reference, running, x, gamma, beta):
        x2d = _rows(x, "batch_norm_train")
        ctx.plain = _plain(x, reference)
        ctx.set_materialize_grads(False)   # mean and var take none
        stats, normalize = ((bn_stats_plain, bn_normalize_plain) if ctx.plain
                            else (bn_stats_kernel, bn_normalize_kernel))
        f = stats(x2d, gamma, beta, eps, running)
        y = normalize(x2d, f[3], f[4]).view(x.shape)
        mean, var = f[0], f[1]
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        if gy is None:
            return None, None, None, None, None, None
        x, gamma, mean, var = ctx.saved_tensors
        reduce_, dx_ = ((bn_bwd_reduce_plain, bn_bwd_dx_plain) if ctx.plain
                        else (bn_bwd_reduce_kernel, bn_bwd_dx_kernel))
        x2d = x.view(-1, x.shape[-1])
        g2d = gy.to(x.dtype).contiguous().view(x2d.shape)
        f = reduce_(g2d, x2d, mean, var, gamma, ctx.eps)
        dx = dx_(g2d, x2d, f[0], f[1], f[2]).view(x.shape)
        return (None, None, None, dx, f[3].to(gamma.dtype),
                f[4].to(gamma.dtype))


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5, *,
                     reference: bool = False,
                     running: Optional[Running] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode batch norm of a contiguous channels-last tensor over
    every axis but the last: returns ``(y, mean, var)``, ``y`` in ``x``'s
    dtype, the float32 batch mean and the biased variance clamped at 0
    (``E[x^2] - mean^2``). Differentiable in ``x``, ``gamma`` and
    ``beta`` through ``y``; ``mean`` and ``var`` are not differentiable
    (running-statistics semantics). ``running`` (running mean, running
    var, momentum m) gets ``ra = (1 - m) * ra + m * batch`` for the mean
    and the clamped variance, in place (in K8 on the card). ``reference``
    runs the plain versions on any device."""
    return _BatchNormTrain.apply(eps, reference, running, x, gamma, beta)


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
    normalize = bn_normalize_plain if reference \
        else torch.ops.e3tpu.bn_normalize
    return normalize(x2d, scale, shift).view(x.shape)
