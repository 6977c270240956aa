"""Fused U-Net level ops on NDHWC tensors, with hand-written Hopper
kernels.

Counterpart of the JAX package's ``ops/flat_fused.py`` and
``ops/flat_fused64.py``. There the 32- and 64-channel executors are
separate because of TPU lane packing (128-lane rows holding 4 or 2
w-positions); on a GPU the activations stay plain contiguous NDHWC and
one op covers both. What carries over is the fusion contract
(flat_fused.py:11-40):

- a level's activation is carried RAW, as the conv output plus the
  per-channel (inv, shift) of its batch norm (:class:`FusedActs`);
- the consumer applies ``act(x * inv + shift)`` (the "prologue") as it
  loads its input, so no normalized tensor is ever written;
- in training a conv also returns the per-channel float32 (sum, sumsq)
  of its stored, dtype-rounded output (``want_stats``), from which the
  batch norm of the next consumer is computed;
- group and instance norm take their statistics per batch sample (JAX's
  ``want_stats='per_sample'``, in training and in eval): the prologue
  vectors are then (N, C), one row a sample, and the statistics (N, C)
  (:data:`PER_SAMPLE`), summed in a fixed order (the same bits on every
  run and for every batch size); the backward kernels take (N, C)
  statistics cotangents and give (N, C) prologue gradients (dinv,
  dshift), also summed in a fixed order, while dW and db stay global;
- each op is a ``torch.autograd.Function`` whose backward is the merged
  backward of the JAX kernels: the statistics cotangent is folded into
  the incoming one on load, ``dy_tot = dy + ds + 2 * y * dq``, and one
  pass gives the input grads, the prologue grads (dinv, dshift) and the
  weight and bias grads.

Kernels (``csrc/``), forward and backward, with the rows of the TPU
kernel table in PERF.md each one stands for:

- :func:`conv_bnact`: K1 ``conv_bnact`` (prologue + (kd, 3, 3) 'same'
  conv over one or two inputs + bias [+ statistics]; rows 1, 3, 4);
  backward K4 ``conv_bnact_dgrad`` (dx, dinv, dshift) and K5
  ``conv_bnact_wgrad`` (dW, db; rows 8, 14), or, for the network
  input (one input of at most :data:`CONV1_MAX_CIN` channels), row 13's
  ``conv1_bwd`` (dW, db and, when asked, dx in one pass);
- :func:`pool_bnact`: K2 ``pool_bnact`` (prologue + (1, 2, 2) / (2, 2, 2)
  max pool; rows 2, 5, 16), which also returns the raw input as the
  level's skip; backward K6 ``pool_bnact_bwd`` (rows 10, 15, 17), with
  the skip's cotangent summed into dx;
- :func:`upconv_bnact`: K3 ``upconv_bnact`` (optional prologue + stride
  equals kernel transposed conv + bias [+ statistics]; rows 6, 7, 11,
  19, 24); backward K7 ``upconv_bnact_bwd`` (rows 12, 18, 20, 21, 25).

A 2D model reaches the same ops on its D=1 view: a 2D level's conv is
the kd=1 conv, its pool the (1, 2, 2) window and its upconv the
(1, 2, 2) kernel, with N * D = N. Rows 16/17 (the C=64 executor's
(1, 2, 2) pool) and 19/20 (its (1, 2, 2) upconv from a dense input)
are those shapes at C=64; their TPU lane packing is not carried over.
The C=64 executor's C=128 form (a C=128 level: its convs at C_out=128
over 2 or 4 lane chunks, its pool, and the upconv of a carried C=128 or
256 activation, rows 24/25) is the same ops at those channel counts;
rows 11/12 (the C=32 executor's upconv from a dense 64-channel input)
are K3/K7 from a dense input into 32 channels.

K1's and K3's bf16 forwards run tensor-core bodies (``csrc/conv_tc.cu``,
``csrc/upconv_tc.cu``) on weights the wrappers pack once per call in
bf16; K1 over the network input (one input of 1 to 4 channels) runs row
3's streaming kernel (``csrc/conv1_fwd.cu``) in both dtypes; and so do
K4's, K5's and K7's bf16 backwards (``csrc/dgrad_tc.cu``
on the flipped weight :func:`pack_dgrad_weight` packs,
``csrc/wgrad_tc.cu``, ``csrc/upconv_bwd_tc.cu``; K7's dgrad reads K3's
packed weight); float32 runs CUDA-core bodies, and the network input's
backward (C_in of 1 to 4) row 13's kernel (``csrc/conv1_bwd.cu``) in
both dtypes, from :func:`conv_bnact`'s backward only (K4's and K5's
wrappers refuse it). :func:`conv_body`, :func:`upconv_body`,
:func:`dgrad_body`, :func:`wgrad_body`, :func:`conv1_body` and
:func:`upconv_bwd_body` name the body a launch takes;
:data:`BODY_LAUNCHES` counts the launches by body.

Each kernel has a wrapper ``*_kernel`` and a plain PyTorch version
``*_plain`` beside it (same signature, same rounding points). Each op's
autograd Function picks one pair for forward and backward from its
input's device: a CPU tensor goes to the plain versions, a CUDA tensor
to the kernels, which raise if they cannot launch. No path falls back
from one to the other. ``reference=True`` selects the plain versions
on any device (to hold a whole model against them on the card). Every
op checks its kernels' shape contract first, on every device, so a CPU
call refuses what the card refuses.

Rounding follows the JAX kernels: the prologue runs in float32 on the
stored value; the prologued operand and the weights are rounded to the
activation dtype before the multiply; accumulation and the bias add are
float32; the output is rounded once to the activation dtype. Backward
(``_fused_conv_bwd_kernel``, flat_fused.py:517-661): ``dy_tot`` is
float32 and the bias grad is summed from it; ``dy_tot`` is rounded to
the activation dtype before the dgrad and wgrad products; the wgrad
operand is the recomputed prologued input rounded to the dtype;
``gm = g * act'(x * inv + shift)`` is float32, ``dinv = sum(gm * x)``,
``dshift = sum(gm)`` and ``dx = gm * inv`` rounded once; halo voxels
carry no gradient. A max-pool tie routes the gradient to every tied
element (flat_fused.py:42-45), not to one as torch's pool does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.ops import _build

LEAKY_SLOPE = 0.1  # matches modules/layers.py leaky activation
# ``want_stats`` of the per-sample mode (group and instance norm): the
# statistics as (N, C), one row a sample. A prologue vector of shape
# (N, C) is per sample too. The kernels take a prologue row a sample by a
# stride (0 for the batch form); their per-sample statistics are partial
# rows of each block, summed in a fixed order (``csrc/ps_reduce.cuh``), so
# that a group norm's forward gives the same bits on every run and for
# every batch size. The backward kernels take (N, C) statistics
# cotangents by a sample stride too and give (N, C) dinv and dshift for
# an (N, C) prologue, summed the same way (a group norm carries them back
# through its statistics into every voxel of the level below), while
# their dW and db stay global. The batch variants keep their code.
PER_SAMPLE = "per_sample"
_ACT_ID = {"linear": 0, "relu": 1, "leaky": 2}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper, K1-K7 and row 13's here, K8-K11 of
# ops/pallas_bn.py and the vup path's five of ops/vup.py. Each wrapper
# adds one where it launches its kernel and nowhere else; plain-version
# calls do not count.
LAUNCHES = {"conv_bnact": 0, "pool_bnact": 0, "upconv_bnact": 0,
            "conv_bnact_dgrad": 0, "conv_bnact_wgrad": 0, "conv1_bwd": 0,
            "pool_bnact_bwd": 0, "upconv_bnact_bwd": 0, "bn_stats": 0,
            "bn_normalize": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0,
            "conv_vup": 0, "conv_vup_dgrad": 0, "conv_vup_wgrad": 0,
            "upconv_stats": 0, "upconv_stats_bwd": 0}
# The same launches of K1, K3, K4, K5, K7, row 13's and the two vup
# entries with two bodies (ops/vup.py) by the body each took (row 13's:
# 'conv1', or 'conv1+dx' with the input gradient): {(kernel, body): n}.
BODY_LAUNCHES: Dict[Tuple[str, str], int] = {}
# The launches of K1-K7 and row 13's in the per-sample mode (an (N, C)
# prologue, per-sample statistics or (N, C) statistics cotangents):
# {kernel: n}, counted beside LAUNCHES.
PS_LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BODY_LAUNCHES.clear()
    PS_LAUNCHES.clear()


def _count(kernel: str, body: Optional[str] = None,
           per_sample: bool = False) -> None:
    """One launch of ``kernel`` (on ``body``; in the per-sample
    mode)."""
    LAUNCHES[kernel] += 1
    if body is not None:
        key = (kernel, body)
        BODY_LAUNCHES[key] = BODY_LAUNCHES.get(key, 0) + 1
    if per_sample:
        PS_LAUNCHES[kernel] = PS_LAUNCHES.get(kernel, 0) + 1


class FusedActs(NamedTuple):
    """A level's activation in fused form: the RAW conv output (NDHWC)
    plus the per-channel float32 (inv, shift) prologue its consumer
    applies on load. Counterpart of ``FlatActs``/``FlatActs64``."""
    raw: torch.Tensor
    inv: torch.Tensor
    shift: torch.Tensor


def act_fwd(pre: torch.Tensor, act: str) -> torch.Tensor:
    """Prologue activation (flat_fused.py ``_act_fwd``). ``torch.relu``
    passes the gradient where ``pre > 0``, as ``_act_deriv`` does."""
    if act == "relu":
        return torch.relu(pre)
    if act == "leaky":
        return torch.where(pre > 0, pre, LEAKY_SLOPE * pre)
    if act == "linear":
        return pre
    raise NotImplementedError(act)


def act_grad(pre: torch.Tensor, act: str) -> torch.Tensor:
    """``act'(pre)`` in float32 (flat_fused.py ``_act_deriv``)."""
    if act == "relu":
        return (pre > 0).float()
    if act == "leaky":
        return torch.where(pre > 0, 1.0, LEAKY_SLOPE)
    if act == "linear":
        return torch.ones_like(pre)
    raise NotImplementedError(act)


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A prologue vector shaped to broadcast over channels-last ``x``: a
    (C,) vector as it is, a per-sample (N, C) one as (N, 1, ..., 1, C)."""
    if v.dim() == 1:
        return v
    return v.view(v.shape[0], *(1,) * (x.dim() - 2), v.shape[1])


def _pre(x: torch.Tensor, inv: Optional[torch.Tensor],
         shift: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    return xf if inv is None else xf * _bc(inv, x) + _bc(shift, x)


def prologue(x: torch.Tensor, inv: Optional[torch.Tensor],
             shift: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """``act(x * inv + shift)`` in float32 over the channel (last) axis,
    ``inv`` and ``shift`` (C,) or per sample (N, C); ``inv is None``
    means the identity norm."""
    return act_fwd(_pre(x, inv, shift), act)


def materialize(acts: FusedActs, act: str) -> torch.Tensor:
    """Apply a carried prologue and round to the activation dtype
    (``materialize_flat_acts``): the seam where a kernel level feeds a
    plain-torch consumer."""
    return prologue(acts.raw, acts.inv, acts.shift, act).to(acts.raw.dtype)


def head_bnact(acts: FusedActs, act: str, weight: torch.Tensor,
               bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Prologue, then the 1x1 conv head as one GEMM, logits in
    ``out_dtype`` (``head_bnact_from_flat``; XLA in JAX, plain torch
    here, differentiated by autograd). The prologued operand stays
    float32; weight and bias arrive in the model dtype and are widened
    to float32. Autograd gives ``_head_bwd``'s (flat_fused.py:1796)
    rounding points: float32 throughout, ``dx`` rounded once."""
    a = prologue(acts.raw, acts.inv, acts.shift, act)
    w2 = weight.reshape(weight.shape[0], -1).float()
    return (a @ w2.t() + bias.float()).to(out_dtype)


def channel_stats(y: torch.Tensor, per_sample: bool = False,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (sum, sumsq) of a stored channels-last
    tensor (flat_fused.py ``channel_stats_dense``): (C,) each, or with
    ``per_sample`` (N, C), the sums of each sample."""
    yf = y.float()
    dims = tuple(range(1 if per_sample else 0, y.dim() - 1))
    return yf.sum(dims), (yf * yf).sum(dims)


def _want(want_stats) -> Tuple[bool, bool]:
    """(statistics wanted, per sample) of a ``want_stats`` argument:
    False, True or :data:`PER_SAMPLE`."""
    if want_stats is not False and want_stats is not True \
            and want_stats != PER_SAMPLE:
        raise ValueError(f"want_stats must be False, True or "
                         f"{PER_SAMPLE!r}, got {want_stats!r}")
    return bool(want_stats), want_stats == PER_SAMPLE


def _check_per_sample(x: torch.Tensor, c: int,
                      inv: Optional[torch.Tensor],
                      shift: Optional[torch.Tensor], want_stats,
                      what: str) -> None:
    """Check an op's prologue vectors, (c,) or per sample (N, c) for the
    N of ``x`` (``shift`` with ``inv``), and its ``want_stats``."""
    _want(want_stats)
    if (inv is None) != (shift is None):
        raise ValueError(f"{what}: inv and shift go together")
    if inv is not None:
        n = x.shape[0]
        for v in (inv, shift):
            if v.shape not in ((c,), (n, c)):
                raise ValueError(f"{what}: prologue vector shape "
                                 f"{tuple(v.shape)} is neither ({c},) nor "
                                 f"({n}, {c})")
        if inv.shape != shift.shape:
            raise ValueError(f"{what}: inv {tuple(inv.shape)} and shift "
                             f"{tuple(shift.shape)} differ")


def _dy_tot(dy: Optional[torch.Tensor], y: torch.Tensor,
            ds: Optional[torch.Tensor], dq: Optional[torch.Tensor],
            ) -> torch.Tensor:
    """``dy + ds + 2 * y * dq`` in float32 (``dy_tot``; a missing
    cotangent is zero); ``ds`` and ``dq`` (C,) or per sample (N, C)."""
    t = torch.zeros(y.shape, dtype=torch.float32, device=y.device) \
        if dy is None else dy.float()
    if ds is not None:
        t = t + _bc(ds, y)
    if dq is not None:
        t = t + 2.0 * y.float() * _bc(dq, y)
    return t


def _sum_vox(t: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
    """Sums over the voxels of a channels-last tensor: (C,), or with
    ``per_sample`` (N, C), each sample's."""
    return t.sum(tuple(range(1 if per_sample else 0, t.dim() - 1)))


def _ps(inv: Optional[torch.Tensor]) -> bool:
    """Whether a prologue vector is per sample, (N, C)."""
    return inv is not None and inv.dim() == 2


def _ps_fwd(inv: Optional[torch.Tensor], want_stats) -> bool:
    """Whether a forward launch is in the per-sample mode: an (N, C)
    prologue or per-sample statistics."""
    return _ps(inv) or _want(want_stats)[1]


def _pro_sums(gm: torch.Tensor, x: torch.Tensor,
              inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dinv, dshift) = (sum gm * x, sum gm) over the voxels, per
    sample for an (N, C) ``inv``."""
    ps = _ps(inv)
    return _sum_vox(gm * x.float(), ps), _sum_vox(gm, ps)


def _plain(t: torch.Tensor, reference: bool) -> bool:
    return reference or t.device.type == "cpu"


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPE_ID:
        raise ValueError(f"{what}: dtype {t.dtype} has no kernel "
                         "(float32 or bfloat16)")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    _check_dtype(t, what)
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous NDHWC tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")


def _vec(v: Optional[torch.Tensor], c: int, fill: float,
         device: torch.device, n: Optional[int] = None) -> torch.Tensor:
    """A float32 prologue vector for a kernel: (c,), or, where ``n`` is
    given, also the per-sample (n, c) form; None gives (c,) of
    ``fill``."""
    if v is None:
        return torch.full((c,), fill, dtype=torch.float32, device=device)
    if v.shape != (c,) and (n is None or v.shape != (n, c)):
        raise ValueError(f"prologue vector shape {tuple(v.shape)} != ({c},)"
                         + ("" if n is None else f" or ({n}, {c})"))
    v = v.detach().to(device=device, dtype=torch.float32).contiguous()
    # The tensor-core bodies read 8 floats at a time (16-byte vectors).
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _ns(v: Optional[torch.Tensor]) -> int:
    """The sample stride (in floats) of a kernel's prologue vector: its
    row length for the per-sample (N, C) form, 0 for (C,) or None."""
    return v.shape[1] if v is not None and v.dim() == 2 else 0


def _stat_bufs(want_stats, n: int, c: int, dev: torch.device, parts):
    """A kernel's statistics outputs, or a backward kernel's (dinv,
    dshift): (s, q, workspace). (c,) each, zeroed (one fill), and no
    workspace for the batch form; in the per-sample mode s and q are the
    rows of one (n, 2, c) output that the kernel's deterministic
    reduction writes, and the workspace holds its ``parts()`` partial
    rows a sample and the first pass's chunks (``ps_workspace_floats``);
    (None, None, None) without statistics."""
    want, ps = _want(want_stats)
    if not want:
        return None, None, None
    if not ps:
        s, q = torch.zeros((2, c), dtype=torch.float32, device=dev)
        return s, q, None
    out = torch.empty((n, 2, c), dtype=torch.float32, device=dev)
    ws = torch.empty(_build.library().e3_ps_workspace_floats(n, parts(),
                                                             2 * c),
                     dtype=torch.float32, device=dev)
    return out[:, 0], out[:, 1], ws


def _stat_cts(ds: Optional[torch.Tensor], dq: Optional[torch.Tensor],
              c: int, device: torch.device, n: Optional[int] = None):
    """The statistics cotangents for a kernel: both None (no statistics
    cotangent), or both (c,) float32 vectors (per sample (n, c) where
    ``n`` is given and the present one is) with a missing one zero."""
    if ds is None and dq is None:
        return None, None
    shape = (ds if ds is not None else dq).shape
    return tuple(
        torch.zeros(shape, dtype=torch.float32, device=device) if v is None
        else _vec(v, c, 0.0, device, n) for v in (ds, dq))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _run(name: str, dev: torch.device, *args) -> None:
    """Call the C entry point ``e3_<name>`` with ``args`` and the current
    stream of ``dev`` (made the current device only when it is not), and
    raise on its error code: the lean launch of row 3 and K6, whose
    calls are short enough for the host's share to show."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    fn = getattr(_build.library(), "e3_" + name)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, stream)
    _build.check(rc, name)


def _cuda_grad(dy: Optional[torch.Tensor], y: torch.Tensor,
               what: str) -> torch.Tensor:
    g = torch.zeros_like(y) if dy is None else dy.to(y.dtype).contiguous()
    _check_cuda(g, what)
    return g


# ---------------------------------------------------------------------------
# K1 conv_bnact (forward), K4 conv_bnact_dgrad and K5 conv_bnact_wgrad
# (backward)
# ---------------------------------------------------------------------------

# The network input's channel counts that row 13's kernel takes
# (``csrc/conv1_bwd.cu``): a one-input conv of 1 to 4 channels.
CONV1_MAX_CIN = 4


def _conv1(cins: Sequence[int]) -> bool:
    """Whether a conv over inputs of ``cins`` channels has row 13's
    backward: one input of at most :data:`CONV1_MAX_CIN` channels."""
    return len(cins) == 1 and cins[0] <= CONV1_MAX_CIN


def conv1_body(cins: Sequence[int], input_grad: bool) -> Optional[str]:
    """The body :func:`conv_bnact`'s backward runs for the network input
    (row 13's kernel, ``csrc/conv1_bwd.cu``, both dtypes): ``'conv1+dx'``
    when the input or prologue gradient is wanted, ``'conv1'`` (dW and db
    alone) when not; None for any other inputs (K4 and K5)."""
    if not _conv1(cins):
        return None
    return "conv1+dx" if input_grad else "conv1"


def _conv_contract(xs: Sequence[torch.Tensor], weight: torch.Tensor,
                   dgrad: bool, grad: bool = False) -> None:
    """The shape contract of K1 and of the backward (``grad``: some
    gradient is wanted; ``dgrad``: an input or prologue gradient): one
    or two NDHWC inputs of one shape and dtype; a (C_out, sum C_i, kd, 3,
    3) weight with kd in {1, 3} and C_out % 32 == 0; any C_i (the
    CUDA-core bodies stage a per-channel tail). One input of at most
    :data:`CONV1_MAX_CIN` channels takes row 3's forward and row 13's
    backward, which need C_out <= 256. Any other input gradient is K4's,
    at any C_i (its wrapper pads an input of C_i % 32 != 0 to whole
    32-channel blocks)."""
    if len(xs) not in (1, 2):
        raise ValueError(f"conv_bnact takes 1 or 2 inputs, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        _check_dtype(x, "conv_bnact")
        if x.dim() != 5 or x.shape[:4] != x0.shape[:4] \
                or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("conv_bnact inputs must share (N, D, H, W), "
                             "dtype and device")
    cins = [x.shape[4] for x in xs]
    cout, cin, kd, kh, kw = weight.shape
    if cin != sum(cins) or kd not in (1, 3) or (kh, kw) != (3, 3):
        raise ValueError(f"conv_bnact weight {tuple(weight.shape)} does not "
                         f"fit inputs with channels {cins}")
    if cout % 32:
        raise ValueError(f"conv_bnact: C_out % 32 required, got {cout}")
    if _conv1(cins) and cout > 256:
        raise ValueError(f"conv_bnact: row 3's forward and row 13's "
                         f"backward (C_in <= {CONV1_MAX_CIN}) need C_out <= "
                         f"256, got {cout}")


def conv_bnact_fwd_plain(xs: Sequence[torch.Tensor],
                         inv: Optional[torch.Tensor],
                         shift: Optional[torch.Tensor],
                         weight: torch.Tensor, bias: torch.Tensor, act: str,
                         want_stats: bool = False):
    """Plain version of K1: returns (y, s, q), the statistics None
    unless ``want_stats`` ((N, C_out) each for :data:`PER_SAMPLE`).
    The concat is materialized here; the kernel reads the inputs side
    by side."""
    dtype = xs[0].dtype
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    a = prologue(x, inv, shift, act).to(dtype).float()
    kd = weight.shape[2]
    y = F.conv3d(a.permute(0, 4, 1, 2, 3), weight.to(dtype).float(),
                 bias.float(), padding=(kd // 2, 1, 1))
    y = y.permute(0, 2, 3, 4, 1).to(dtype).contiguous()
    want, ps = _want(want_stats)
    s, q = channel_stats(y, ps) if want else (None, None)
    return y, s, q


def conv_bnact_dgrad_gm(xs: Sequence[torch.Tensor],
                        inv: Optional[torch.Tensor],
                        shift: Optional[torch.Tensor],
                        weight: torch.Tensor, y: torch.Tensor,
                        dy: Optional[torch.Tensor],
                        ds: Optional[torch.Tensor],
                        dq: Optional[torch.Tensor], act: str
                        ) -> torch.Tensor:
    """K4's float32 ``gm = g * act'(x * inv + shift)`` over the concat
    of ``xs``, g the gradient of the prologued input: the step before
    K4's epilogue multiplies by ``inv`` and rounds."""
    dtype = xs[0].dtype
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    kd = weight.shape[2]
    g = _dy_tot(dy, y, ds, dq).to(dtype).float().permute(0, 4, 1, 2, 3)
    gin = torch.nn.grad.conv3d_input(
        (x.shape[0], x.shape[4]) + tuple(x.shape[1:4]),
        weight.to(dtype).float(), g, padding=(kd // 2, 1, 1))
    return gin.permute(0, 2, 3, 4, 1) * act_grad(_pre(x, inv, shift), act)


def conv_bnact_dgrad_plain(xs: Sequence[torch.Tensor],
                           inv: Optional[torch.Tensor],
                           shift: Optional[torch.Tensor],
                           weight: torch.Tensor, y: torch.Tensor,
                           dy: Optional[torch.Tensor],
                           ds: Optional[torch.Tensor],
                           dq: Optional[torch.Tensor], act: str):
    """Plain version of K4, written out (not autograd through the
    forward): (dxs, dinv, dshift), dinv and dshift None when ``inv`` is
    None, (N, C) for a per-sample ``inv``; ``ds``/``dq`` (C_out,) or
    (N, C_out)."""
    dtype = xs[0].dtype
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    gm = conv_bnact_dgrad_gm(xs, inv, shift, weight, y, dy, ds, dq, act)
    dinv = dshift = None
    if inv is not None:
        dinv, dshift = _pro_sums(gm, x, inv)
        gm = gm * _bc(inv, x)
    dxs = torch.split(gm.to(dtype), [xx.shape[-1] for xx in xs], dim=-1)
    return [d.contiguous() for d in dxs], dinv, dshift


def conv_bnact_wgrad_plain(xs: Sequence[torch.Tensor],
                           inv: Optional[torch.Tensor],
                           shift: Optional[torch.Tensor],
                           weight: torch.Tensor, y: torch.Tensor,
                           dy: Optional[torch.Tensor],
                           ds: Optional[torch.Tensor],
                           dq: Optional[torch.Tensor], act: str):
    """Plain version of K5: float32 (dW, db), dW of ``weight``'s shape,
    from the recomputed prologued input rounded to the dtype; db sums
    every sample's voxels, in the per-sample mode too."""
    dtype = xs[0].dtype
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    kd = weight.shape[2]
    t = _dy_tot(dy, y, ds, dq)
    g = t.to(dtype).float().permute(0, 4, 1, 2, 3)
    a = prologue(x, inv, shift, act).to(dtype).float().permute(0, 4, 1, 2, 3)
    dw = torch.nn.grad.conv3d_weight(a, weight.shape, g,
                                     padding=(kd // 2, 1, 1))
    return dw, _sum_vox(t)


def conv_body(dtype: torch.dtype, cins: Sequence[int]) -> str:
    """The body K1's forward runs: ``'conv1'`` (row 3's streaming kernel
    of ``csrc/conv1_fwd.cu``) for the network input, one input of at
    most :data:`CONV1_MAX_CIN` channels, in either dtype; else ``'tc'``
    (the tensor-core implicit GEMM of ``csrc/conv_tc.cu``) for bfloat16
    when every input's channel count is a multiple of 16, else
    ``'cuda-core'`` (the float32 FMA body of ``csrc/conv_bnact.cuh``:
    float32, whose tests hold 1e-4 of the scale, and other counts)."""
    if _conv1(cins):
        return "conv1"
    return _tc_or_cuda_core(dtype, cins)


def _tc_or_cuda_core(dtype: torch.dtype, cins: Sequence[int]) -> str:
    """``'tc'`` for bfloat16 when every input's channel count is a
    multiple of 16, else ``'cuda-core'``."""
    if dtype == torch.bfloat16 and all(c % 16 == 0 for c in cins):
        return "tc"
    return "cuda-core"


def pack_conv_weight(weight: torch.Tensor, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """K1's tensor-core weight operand: the (C_out, C_in, kd, 3, 3)
    weight rounded to ``dtype`` (exact: the weights are values of the
    activation dtype) as (kd, C_in / 16, 3, 3, C_out, 16), so that one
    16-channel step's 9 taps are one contiguous run of rows of 16
    input channels."""
    cout, cin, kd = weight.shape[:3]
    out = torch.empty((kd, cin // 16, 3, 3, cout, 16), dtype=dtype,
                      device=device)
    return out.copy_(weight.detach().reshape(cout, cin // 16, 16, kd, 3, 3)
                     .permute(3, 1, 4, 5, 0, 2))


def pack_dgrad_weight(weight: torch.Tensor, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """K4's tensor-core weight operand: the (C_out, C_in, kd, 3, 3)
    weight flipped in its three taps and transposed, (C_in, C_out, kd, 3,
    3), so that the dgrad is K1's 'same' conv of dy_tot with it, packed as
    :func:`pack_conv_weight` packs K1's: (kd, C_out / 16, 3, 3, C_in,
    16)."""
    return pack_conv_weight(weight.detach().flip(2, 3, 4).transpose(0, 1),
                            dtype, device)


def _prologue_ptrs(inv, shift, act, c, dev, n=None):
    """The tensor-core bodies' prologue vectors: (None, None) for the
    identity prologue (no ``inv`` and a linear activation: the body
    skips the pass), else the two (c,) float32 vectors, or (n, c) where
    ``n`` is given and they are per sample."""
    if inv is None and act == "linear":
        return None, None
    return _vec(inv, c, 1.0, dev, n), _vec(shift, c, 0.0, dev, n)


def conv_bnact_fwd_kernel(xs, inv, shift, weight, bias, act, want_stats):
    """K1 on CUDA tensors: (y, s, q) as :func:`conv_bnact_fwd_plain`,
    on the body :func:`conv_body` picks; in every body a per-sample
    prologue is a sample stride, and per-sample statistics are the
    blocks' partial rows summed in a fixed order."""
    x0 = xs[0]
    for x in xs:
        _check_cuda(x, "conv_bnact")
    n, d, h, w = x0.shape[:4]
    cins = [x.shape[4] for x in xs]
    cout, cin, kd = weight.shape[:3]
    dev = x0.device
    dtype = x0.dtype
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, d, h, w, cout), dtype=dtype, device=dev)
    body = conv_body(dtype, cins)
    if body == "conv1":
        return _conv1_fwd(x0, inv, shift, weight, b, act, want_stats, y)
    lib = _build.library()
    s, q, ws = _stat_bufs(
        want_stats, n, cout, dev,
        lambda: lib.e3_conv_bnact_tc_ps_parts(d, h, w, cout) if body == "tc"
        else lib.e3_conv_bnact_ps_parts(d, h, w))
    x1 = xs[1] if len(xs) > 1 else None
    if body == "tc":
        inv_v, shift_v = _prologue_ptrs(inv, shift, act, cin, dev, n)
        wp = pack_conv_weight(weight, dtype, dev)
        with torch.cuda.device(dev):
            rc = lib.e3_conv_bnact_tc(
                len(xs), x0.data_ptr(), cins[0], _ptr(x1),
                cins[1] if x1 is not None else 0, _ptr(inv_v),
                _ptr(shift_v), _ns(inv_v), wp.data_ptr(), b.data_ptr(),
                y.data_ptr(), _ptr(s), _ptr(q), _ptr(ws), n, d, h, w, cout,
                kd, _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_bnact (tensor-core body)")
        _count("conv_bnact", "tc", _ps_fwd(inv, want_stats))
        return y, s, q
    inv = _vec(inv, cin, 1.0, dev, n)
    shift = _vec(shift, cin, 0.0, dev, n)
    # Input 1's vectors start c0 floats in; a per-sample row is cin long.
    invs = torch.split(inv, cins, dim=-1)
    shifts = torch.split(shift, cins, dim=-1)
    wt = weight.detach().to(device=dev, dtype=dtype).float() \
        .permute(2, 3, 4, 1, 0).contiguous()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_bnact(
            _DTYPE_ID[dtype], len(xs),
            x0.data_ptr(), cins[0], invs[0].data_ptr(), shifts[0].data_ptr(),
            _ptr(x1), cins[1] if x1 is not None else 0,
            invs[1].data_ptr() if x1 is not None else None,
            shifts[1].data_ptr() if x1 is not None else None,
            _ns(inv), wt.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(s),
            _ptr(q), _ptr(ws), n, d, h, w, cout, kd, _ACT_ID[act],
            _stream(dev))
    _build.check(rc, "conv_bnact")
    _count("conv_bnact", "cuda-core", _ps_fwd(inv, want_stats))
    return y, s, q


def _conv1_fwd(x, inv, shift, weight, b, act, want_stats, y):
    """Row 3's kernel (K1's 'conv1' body, ``csrc/conv1_fwd.cu``) into
    ``y``: it takes the float32 (C_out, C_in, kd, 3, 3) weight as it is
    and rounds it to the dtype itself, and the statistics come from one
    zeroed (2, C_out) buffer, so a call launches one fill and the kernel
    (per sample: the kernel and its reduction, no fill)."""
    n, d, h, w, cin = x.shape
    cout, _, kd = weight.shape[:3]
    dev = x.device
    inv_v, shift_v = _prologue_ptrs(inv, shift, act, cin, dev, n)
    wt = weight.detach().to(device=dev, dtype=torch.float32).contiguous()
    s, q, ws = _stat_bufs(
        want_stats, n, cout, dev,
        lambda: _build.library().e3_conv1_fwd_ps_parts(d, h, w))
    _run("conv1_fwd", dev, _DTYPE_ID[x.dtype], x.data_ptr(), cin,
         _ptr(inv_v), _ptr(shift_v), _ns(inv_v), wt.data_ptr(),
         b.data_ptr(), y.data_ptr(), _ptr(s), _ptr(q), _ptr(ws), n, d, h, w,
         cout, kd, _ACT_ID[act])
    _count("conv_bnact", "conv1", _ps_fwd(inv, want_stats))
    return y, s, q


def _conv_bwd_args(xs, inv, shift, weight, y, dy, ds, dq, what):
    """A conv backward kernel's arguments on the card: the gradient, the
    statistics cotangents (C_out,) or (N, C_out), the prologue vectors
    (C_in,) or (N, C_in) and the weight rounded to the dtype."""
    for x in xs:
        _check_cuda(x, what)
    dev = xs[0].device
    n = xs[0].shape[0]
    cin = weight.shape[1]
    ds, dq = _stat_cts(ds, dq, weight.shape[0], dev, n)
    return (_cuda_grad(dy, y, what), ds, dq, _vec(inv, cin, 1.0, dev, n),
            _vec(shift, cin, 0.0, dev, n),
            weight.detach().to(device=dev, dtype=xs[0].dtype).float())


def _ps_launch(inv: Optional[torch.Tensor],
               ds: Optional[torch.Tensor]) -> bool:
    """Whether a backward launch is in the per-sample mode: an (N, C)
    prologue or (N, C) statistics cotangents."""
    return _ps(inv) or _ps(ds)



def dgrad_body(dtype: torch.dtype) -> str:
    """The body K4 runs: ``'tc'`` (the tensor-core implicit GEMM of
    ``csrc/dgrad_tc.cu``) for bfloat16 and ``'cuda-core'`` (the float32
    FMA body of ``csrc/conv_bnact_bwd.cu``) for float32, both with each
    C_in % 32 == 0 (the network input's dx is row 13's,
    :func:`conv1_body`)."""
    return "tc" if dtype == torch.bfloat16 else "cuda-core"


def _dgrad_padded(xs, inv, shift, weight, y, dy, ds, dq, act):
    """K4 on inputs of any C_i: each input's channels zero-padded up to a
    multiple of 32 (the weight's input columns with zeros, ``inv`` with
    ones, ``shift`` with zeros, each row of a per-sample one), K4 on that
    copy, then dxs, dinv and dshift sliced back. The padded channels
    reach no kept output: their weight columns are zero, and their own
    dx, dinv and dshift are dropped."""
    dev = xs[0].device
    cins = [x.shape[4] for x in xs]
    xs_p, keep, off = [], [], 0
    for x, c in zip(xs, cins):
        xs_p.append(F.pad(x, (0, -c % 32)))
        keep.append(torch.arange(off, off + c, device=dev))
        off += c + (-c % 32)
    idx = torch.cat(keep)
    w = weight.detach()
    w_p = w.new_zeros((w.shape[0], off, *w.shape[2:])).index_copy_(1, idx, w)
    inv_p = shift_p = None
    # (C,) or per-sample (N, C) vectors: each row padded alike.
    if inv is not None:
        inv_p = inv.new_ones(inv.shape[:-1] + (off,)).index_copy_(
            -1, idx, inv.detach())
    if shift is not None:
        shift_p = shift.new_zeros(shift.shape[:-1] + (off,)).index_copy_(
            -1, idx, shift.detach())
    dxs, dinv, dshift = conv_bnact_dgrad_kernel(xs_p, inv_p, shift_p, w_p, y,
                                                dy, ds, dq, act)
    dxs = [dx[..., :c].contiguous() for dx, c in zip(dxs, cins)]
    if dinv is None:
        return dxs, None, None
    return dxs, dinv[..., idx], dshift[..., idx]


def conv_bnact_dgrad_kernel(xs, inv, shift, weight, y, dy, ds, dq, act):
    """K4: (dxs, dinv, dshift) of :func:`conv_bnact` from the output
    cotangent ``dy`` and the statistics cotangents ``ds``, ``dq`` (each
    may be None), as :func:`conv_bnact_dgrad_plain`, on the body
    :func:`dgrad_body` picks. In the per-sample mode ``ds``/``dq`` and
    the prologue are (N, C) rows by a sample stride, and dinv, dshift
    (N, C_in) come from each block's partial row (no block spans two
    samples), summed in a fixed order. K4 writes 32-channel blocks of
    dx: inputs of C_in % 32 != 0 run on a zero-padded copy
    (:func:`_dgrad_padded`; the network input's one to four channels are
    row 13's, :func:`conv1_bwd_kernel`, which this wrapper refuses)."""
    cins = [x.shape[4] for x in xs]
    if _conv1(cins):
        raise ValueError(f"conv_bnact_dgrad: one input of at most "
                         f"{CONV1_MAX_CIN} channels is conv1_bwd_kernel's")
    if any(c % 32 for c in cins):
        return _dgrad_padded(xs, inv, shift, weight, y, dy, ds, dq, act)
    body = dgrad_body(xs[0].dtype)
    g, ds, dq, inv_v, shift_v, wq = _conv_bwd_args(
        xs, inv, shift, weight, y, dy, ds, dq, "conv_bnact_dgrad")
    x0 = xs[0]
    n, d, h, w = x0.shape[:4]
    cout, cin, kd = weight.shape[:3]
    x1 = xs[1] if len(xs) > 1 else None
    dev = x0.device
    dxs = [torch.empty_like(x) for x in xs]
    lib = _build.library()
    dinv, dshift, ws = _stat_bufs(
        PER_SAMPLE if _ps(inv) else True, n, cin, dev,
        lambda: lib.e3_conv_bnact_dgrad_tc_ps_parts(d, h, w, cin)
        if body == "tc" else lib.e3_conv_bnact_ps_parts(d, h, w))
    if body == "tc":
        inv_t, shift_t = _prologue_ptrs(inv, shift, act, cin, dev, n)
        wp = pack_dgrad_weight(weight, x0.dtype, dev)
        # The pre-pass's scratch (and the db it sums, unused here) at kd =
        # 3, where each dy and y slab would be read by three planes'
        # blocks (at kd = 1 by at most two: the blocks over C_in <= 256).
        e = edb = None
        if ds is not None and kd == 3:
            e = torch.empty_like(g)
            edb = torch.zeros(cout, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.e3_conv_bnact_dgrad_tc(
                len(xs), g.data_ptr(), y.data_ptr(), _ptr(ds), _ptr(dq),
                _ns(ds), _ptr(e), _ptr(edb), cout, wp.data_ptr(),
                x0.data_ptr(), cins[0], _ptr(x1),
                cins[1] if x1 is not None else 0, _ptr(inv_t),
                _ptr(shift_t), _ns(inv_t), dxs[0].data_ptr(),
                dxs[1].data_ptr() if x1 is not None else None,
                dinv.data_ptr(), dshift.data_ptr(), _ptr(ws), n, d, h, w,
                kd, _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_bnact_dgrad (tensor-core body)")
    else:
        # K1's 'same' conv of dy_tot with the flipped, transposed
        # weights: (kd, 3, 3, C_out, C_in).
        wt = wq.flip(2, 3, 4).permute(2, 3, 4, 0, 1).contiguous()
        with torch.cuda.device(dev):
            rc = lib.e3_conv_bnact_dgrad(
                _DTYPE_ID[x0.dtype], len(xs), g.data_ptr(), y.data_ptr(),
                _ptr(ds), _ptr(dq), _ns(ds), cout, wt.data_ptr(),
                x0.data_ptr(), cins[0], _ptr(x1),
                cins[1] if x1 is not None else 0, inv_v.data_ptr(),
                shift_v.data_ptr(), _ns(inv_v), dxs[0].data_ptr(),
                dxs[1].data_ptr() if x1 is not None else None,
                dinv.data_ptr(), dshift.data_ptr(), _ptr(ws), n, d, h, w,
                kd, _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_bnact_dgrad")
    _count("conv_bnact_dgrad", body, _ps_launch(inv, ds))
    if inv is None:
        return dxs, None, None
    return dxs, dinv, dshift


def wgrad_body(dtype: torch.dtype, cins: Sequence[int]) -> str:
    """The body K5 runs for inputs of ``cins`` channels: ``'tc'`` (the
    tensor-core split-K implicit GEMM of ``csrc/wgrad_tc.cu``) for
    bfloat16 when every input's channel count is a multiple of 16, else
    ``'cuda-core'`` (the float32 FMA body of ``csrc/conv_bnact_bwd.cu``:
    float32, whose tests hold 1e-4 of the scale, and other counts). The
    network input's dW is row 13's (:func:`conv1_body`)."""
    return _tc_or_cuda_core(dtype, cins)


def conv_bnact_wgrad_kernel(xs, inv, shift, weight, y, dy, ds, dq, act):
    """K5: float32 (dW, db), dW in ``weight``'s shape, as
    :func:`conv_bnact_wgrad_plain`, on the body :func:`wgrad_body`
    picks (per-sample prologue and ``ds``/``dq`` rows by a sample
    stride; dW and db global). Not the network input's
    (:func:`conv1_bwd_kernel`)."""
    if _conv1([x.shape[4] for x in xs]):
        raise ValueError(f"conv_bnact_wgrad: one input of at most "
                         f"{CONV1_MAX_CIN} channels is conv1_bwd_kernel's")
    body = wgrad_body(xs[0].dtype, [x.shape[4] for x in xs])
    g, ds, dq, inv_v, shift_v, _ = _conv_bwd_args(
        xs, inv, shift, weight, y, dy, ds, dq, "conv_bnact_wgrad")
    x0 = xs[0]
    n, d, h, w = x0.shape[:4]
    cins = [x.shape[4] for x in xs]
    cout, cin, kd = weight.shape[:3]
    x1 = xs[1] if len(xs) > 1 else None
    dwt = torch.zeros((kd, 3, 3, cin, cout), dtype=torch.float32,
                      device=x0.device)
    db = torch.zeros(cout, dtype=torch.float32, device=x0.device)
    lib = _build.library()
    if body == "tc":
        inv_v, shift_v = _prologue_ptrs(inv, shift, act, cin, x0.device, n)
        # The pre-pass's scratch, where the blocks would otherwise read
        # dy and y more than twice (32-channel slices x kd > 2).
        e = torch.empty_like(g) if ds is not None and kd * sum(
            -(-c // 32) for c in cins) > 2 else None
        with torch.cuda.device(x0.device):
            rc = lib.e3_conv_bnact_wgrad_tc(
                len(xs), x0.data_ptr(), cins[0], _ptr(x1),
                cins[1] if x1 is not None else 0, _ptr(inv_v),
                _ptr(shift_v), _ns(inv_v), g.data_ptr(), y.data_ptr(),
                _ptr(ds), _ptr(dq), _ns(ds), _ptr(e), cout, dwt.data_ptr(),
                db.data_ptr(), n, d, h, w, kd, _ACT_ID[act],
                _stream(x0.device))
        _build.check(rc, "conv_bnact_wgrad (tensor-core body)")
    else:
        with torch.cuda.device(x0.device):
            rc = lib.e3_conv_bnact_wgrad(
                _DTYPE_ID[x0.dtype], len(xs), x0.data_ptr(), cins[0],
                _ptr(x1), cins[1] if x1 is not None else 0, inv_v.data_ptr(),
                shift_v.data_ptr(), _ns(inv_v), g.data_ptr(), y.data_ptr(),
                _ptr(ds), _ptr(dq), _ns(ds), cout, dwt.data_ptr(),
                db.data_ptr(), n, d, h, w, kd, _ACT_ID[act],
                _stream(x0.device))
        _build.check(rc, "conv_bnact_wgrad")
    _count("conv_bnact_wgrad", body, _ps_launch(inv, ds))
    return dwt.permute(4, 3, 0, 1, 2), db


def conv1_bwd_plain(xs, inv, shift, weight, y, dy, ds, dq, act,
                    input_grad=True):
    """Plain version of row 13's kernel: (dxs, dinv, dshift, dW, db), the
    plain K5 and, with ``input_grad``, the plain K4 composed (the first
    three None without it)."""
    dw, db = conv_bnact_wgrad_plain(xs, inv, shift, weight, y, dy, ds, dq,
                                    act)
    if not input_grad:
        return None, None, None, dw, db
    return (*conv_bnact_dgrad_plain(xs, inv, shift, weight, y, dy, ds, dq,
                                    act), dw, db)


def conv1_bwd_kernel(xs, inv, shift, weight, y, dy, ds, dq, act,
                     input_grad=True):
    """Row 13's kernel (``csrc/conv1_bwd.cu``): the backward of a conv
    over the network input (one input of at most :data:`CONV1_MAX_CIN`
    channels), dW and db and, with ``input_grad``, dx, dinv and dshift
    from one pass over dy and y, as :func:`conv1_bwd_plain`. In the
    per-sample mode ``ds``/``dq`` and the prologue are (N, C) rows, and
    dinv, dshift (N, C_in) the sums of each tile (one sample's) in a
    fixed order."""
    if not _conv1([x.shape[4] for x in xs]):
        raise ValueError(f"conv1_bwd: one input of at most {CONV1_MAX_CIN}"
                         f" channels, got {[x.shape[4] for x in xs]}")
    g, ds, dq, inv_v, shift_v, wq = _conv_bwd_args(
        xs, inv, shift, weight, y, dy, ds, dq, "conv1_bwd")
    x0 = xs[0]
    n, d, h, w, cin = x0.shape
    cout, _, kd = weight.shape[:3]
    dev = x0.device
    dwt = torch.zeros((kd, 3, 3, cin, cout), dtype=torch.float32,
                      device=dev)
    db = torch.zeros(cout, dtype=torch.float32, device=dev)
    dx = wt = None
    lib = _build.library()
    dinv, dshift, ws = _stat_bufs(
        PER_SAMPLE if input_grad and _ps(inv) else True, n, cin, dev,
        lambda: lib.e3_conv1_bwd_ps_parts(d, h, w))
    if input_grad:
        dx = torch.empty_like(x0)
        wt = wq.permute(2, 3, 4, 1, 0).contiguous()
    with torch.cuda.device(dev):
        rc = lib.e3_conv1_bwd(
            _DTYPE_ID[x0.dtype], x0.data_ptr(), cin, inv_v.data_ptr(),
            shift_v.data_ptr(), _ns(inv_v), g.data_ptr(), y.data_ptr(),
            _ptr(ds), _ptr(dq), _ns(ds), cout, _ptr(wt), dwt.data_ptr(),
            db.data_ptr(), _ptr(dx), dinv.data_ptr(), dshift.data_ptr(),
            _ptr(ws), n, d, h, w, kd, _ACT_ID[act], _stream(dev))
    _build.check(rc, "conv1_bwd")
    _count("conv1_bwd", conv1_body([cin], input_grad), _ps_launch(inv, ds))
    dw = dwt.permute(4, 3, 0, 1, 2)
    if not input_grad:
        return None, None, None, dw, db
    if inv is None:
        return [dx], None, None, dw, db
    return [dx], dinv, dshift, dw, db


class _ConvBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, want_stats, reference, input_grad, x0, x1, inv,
                shift, weight, bias):
        xs = [x0] if x1 is None else [x0, x1]
        ctx.plain = _plain(x0, reference)
        fwd = conv_bnact_fwd_plain if ctx.plain else conv_bnact_fwd_kernel
        y, s, q = fwd(xs, inv, shift, weight, bias, act, want_stats)
        ctx.save_for_backward(x0, x1, inv, shift, weight, y)
        ctx.act = act
        ctx.input_grad = input_grad
        ctx.bias_dtype = bias.dtype
        ctx.set_materialize_grads(False)
        return (y, s, q) if want_stats else y

    @staticmethod
    def backward(ctx, dy, ds=None, dq=None):
        """Row 13's kernel for the network input (dW, db and, when its
        gradient is wanted, dx in one pass); else K4 when an input or
        prologue gradient is wanted, and K5. Without ``input_grad`` the
        inputs' gradients are zeros and no dgrad runs for them."""
        x0, x1, inv, shift, weight, y = ctx.saved_tensors
        xs = [x0] if x1 is None else [x0, x1]
        args = (xs, inv, shift, weight, y, dy, ds, dq, ctx.act)
        want = ctx.input_grad and any(ctx.needs_input_grad[4:6]) \
            or any(ctx.needs_input_grad[6:8])
        dxs = dinv = dshift = None
        if conv1_body([x.shape[4] for x in xs], want) is not None:
            bwd = conv1_bwd_plain if ctx.plain else conv1_bwd_kernel
            dxs, dinv, dshift, dw, db = bwd(*args, want)
        else:
            if ctx.plain:
                dgrad, wgrad = conv_bnact_dgrad_plain, conv_bnact_wgrad_plain
            else:
                dgrad, wgrad = conv_bnact_dgrad_kernel, conv_bnact_wgrad_kernel
            if want:
                dxs, dinv, dshift = dgrad(*args)
            dw, db = wgrad(*args)
        if not ctx.input_grad:
            dxs = [torch.zeros_like(x) if need else None for x, need in
                   zip(xs, ctx.needs_input_grad[4:6])]
        dx0, dx1 = (list(dxs) + [None])[:2] if dxs is not None \
            else (None, None)
        return (None, None, None, None, dx0, dx1, dinv, dshift,
                dw.to(weight.dtype), db.to(ctx.bias_dtype))


def conv_bnact(xs: Sequence[torch.Tensor], inv: Optional[torch.Tensor],
               shift: Optional[torch.Tensor], weight: torch.Tensor,
               bias: torch.Tensor, act: str, *, want_stats=False,
               reference: bool = False, input_grad: bool = True):
    """Prologue + (kd, 3, 3) 'same' conv + bias over NDHWC inputs.

    Args:
        xs: one or two (N, D, H, W, C_i) tensors of one dtype (a merge
            conv's inputs in concat order).
        inv, shift: (sum C_i,) float32 prologue vectors, or per sample
            (N, sum C_i), or None for the identity norm.
        weight: (C_out, sum C_i, kd, 3, 3) conv weight, kd in {1, 3}; it
            is rounded to the inputs' dtype at use, and its gradient
            comes back in its own dtype.
        bias: (C_out,) bias, added in float32.
        act: 'relu', 'leaky' or 'linear'.
        want_stats: also return the per-channel float32 (sum, sumsq) of
            the stored output: True for (C_out,) each, :data:`PER_SAMPLE`
            for (N, C_out).
        reference: run the plain versions whatever the device.
        input_grad: False gives ``xs`` a zero gradient without computing
            one (JAX's fused first conv under ``UNet(input_grad=False)``,
            ``_conv1_bwd``).
    Returns:
        (N, D, H, W, C_out) raw conv output in the inputs' dtype, or
        (y, s, q) with ``want_stats``. Differentiable in every tensor
        argument, in the per-sample mode too (the gradients of (N, C)
        vectors are (N, C)).
    """
    xs = list(xs)
    grad = _needs_grad(*xs, inv, shift, weight, bias)
    _conv_contract(xs, weight,
                   _needs_grad(*(xs if input_grad else ()), inv, shift),
                   grad)
    _check_per_sample(xs[0], weight.shape[1], inv, shift, want_stats,
                      "conv_bnact")
    return _ConvBnAct.apply(act, want_stats, reference, input_grad, xs[0],
                            xs[1] if len(xs) > 1 else None, inv, shift,
                            weight, bias)


# ---------------------------------------------------------------------------
# K2 pool_bnact (forward) and K6 pool_bnact_bwd (backward)
# ---------------------------------------------------------------------------

def _pool_contract(x: torch.Tensor, window: Tuple[int, int, int],
                   grad: bool) -> None:
    """K2's shape contract: an NDHWC tensor whose pooled dims divide by
    the window, C % 8 == 0. K6 sums its prologue gradients per block
    for one group of 8 channels per thread, so it also needs C <= 512
    with C / 8 dividing 256."""
    _check_dtype(x, "pool_bnact")
    if x.dim() != 5:
        raise ValueError(f"pool_bnact: expected NDHWC, got {tuple(x.shape)}")
    n, d, h, w, c = x.shape
    if window not in ((1, 2, 2), (2, 2, 2)) or d % window[0] or h % 2 \
            or w % 2 or c % 8:
        raise ValueError(f"pool_bnact: window {window} on {tuple(x.shape)} "
                         "needs even pooled dims and C % 8 == 0")
    if grad and (c > 512 or 256 % (c // 8)):
        raise ValueError(f"pool_bnact backward (K6): C={c} needs C <= 512 "
                         "and C / 8 dividing 256")


def pool_bnact_fwd_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                         shift: Optional[torch.Tensor], act: str,
                         window: Tuple[int, int, int]) -> torch.Tensor:
    """Plain version of K2."""
    a = prologue(x, inv, shift, act)
    y = F.max_pool3d(a.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def pool_bnact_bwd_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                         shift: Optional[torch.Tensor], act: str,
                         window: Tuple[int, int, int],
                         dpool: torch.Tensor,
                         dskip: Optional[torch.Tensor] = None):
    """Plain version of K6: (dx, dinv, dshift). The window maxima are
    recomputed from the prologued float32 values and the cotangent goes
    to EVERY element equal to its window's max. ``dskip`` is the
    cotangent of the level's skip (the raw ``x`` itself), added in
    float32 before the one rounding of dx (JAX's ``with_skip``,
    flat_fused.py ``_pool_bwd_kernel``); None adds nothing. dinv and
    dshift are (N, C) for a per-sample ``inv``."""
    n, d, h, w, c = x.shape
    kd = window[0]
    pre = _pre(x, inv, shift)
    a = act_fwd(pre, act).view(n, d // kd, kd, h // 2, 2, w // 2, 2, c)
    sel = a == a.amax(dim=(2, 4, 6), keepdim=True)
    dp = dpool.float().view(n, d // kd, 1, h // 2, 1, w // 2, 1, c)
    dpre = (dp * sel).view(n, d, h, w, c) * act_grad(pre, act)
    dx = dpre if inv is None else dpre * _bc(inv, x)
    if dskip is not None:
        dx = dx + dskip.float()
    if inv is None:
        return dx.to(x.dtype), None, None
    return (dx.to(x.dtype), *_pro_sums(dpre, x, inv))


def pool_bnact_fwd_kernel(x, inv, shift, act, window):
    """K2 on CUDA tensors, as :func:`pool_bnact_fwd_plain` (a per-sample
    prologue by its sample stride)."""
    _check_cuda(x, "pool_bnact")
    n, d, h, w, c = x.shape
    dev = x.device
    inv = _vec(inv, c, 1.0, dev, n)
    shift = _vec(shift, c, 0.0, dev, n)
    y = torch.empty((n, d // window[0], h // 2, w // 2, c), dtype=x.dtype,
                    device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_pool_bnact(
            _DTYPE_ID[x.dtype], x.data_ptr(), inv.data_ptr(),
            shift.data_ptr(), _ns(inv), y.data_ptr(), n, d, h, w, c,
            window[0], _ACT_ID[act], _stream(dev))
    _build.check(rc, "pool_bnact")
    _count("pool_bnact", per_sample=_ps(inv))
    return y


def pool_bnact_bwd_kernel(x, inv, shift, act, window, dpool, dskip=None):
    """K6: (dx, dinv, dshift), as :func:`pool_bnact_bwd_plain`, with the
    skip's cotangent ``dskip`` (or None) summed in the kernel; for an
    (N, C) prologue the grid is (block of a sample, sample) and dinv,
    dshift (N, C) the blocks' partial rows summed in a fixed order."""
    _check_cuda(x, "pool_bnact backward")
    n, d, h, w, c = x.shape
    dev = x.device
    inv_v = _vec(inv, c, 1.0, dev, n)
    shift_v = _vec(shift, c, 0.0, dev, n)
    dp = dpool.to(x.dtype).contiguous()
    _check_cuda(dp, "pool_bnact backward")
    if dskip is not None:
        dskip = dskip.to(x.dtype).contiguous()
        _check_cuda(dskip, "pool_bnact backward (skip cotangent)")
        if dskip.shape != x.shape:
            raise ValueError(f"pool_bnact backward: skip cotangent "
                             f"{tuple(dskip.shape)} != {tuple(x.shape)}")
    dx = torch.empty_like(x)
    dinv, dshift, ws = _stat_bufs(
        PER_SAMPLE if _ps(inv) else True, n, c, dev,
        lambda: _build.library().e3_pool_bnact_bwd_ps_parts(d, h, w, c,
                                                           window[0]))
    _run("pool_bnact_bwd", dev, _DTYPE_ID[x.dtype], x.data_ptr(),
         inv_v.data_ptr(), shift_v.data_ptr(), _ns(inv_v), dp.data_ptr(),
         _ptr(dskip), dx.data_ptr(), dinv.data_ptr(), dshift.data_ptr(),
         _ptr(ws), n, d, h, w, c, window[0], _ACT_ID[act])
    _count("pool_bnact_bwd", per_sample=_ps(inv))
    if inv is None:
        return dx, None, None
    return dx, dinv, dshift


class _PoolBnAct(torch.autograd.Function):
    """(pooled, skip): the skip is ``x`` itself, a view without a copy,
    so that the level's two consumers of ``x`` meet in one backward (JAX's
    ``pool_bnact_flat_skip``)."""

    @staticmethod
    def forward(ctx, act, window, reference, x, inv, shift):
        ctx.save_for_backward(x, inv, shift)
        ctx.act, ctx.window = act, window
        ctx.plain = _plain(x, reference)
        ctx.set_materialize_grads(False)
        fwd = pool_bnact_fwd_plain if ctx.plain else pool_bnact_fwd_kernel
        return fwd(x, inv, shift, act, window), x.view_as(x)

    @staticmethod
    def backward(ctx, dpool, dskip):
        x, inv, shift = ctx.saved_tensors
        if dpool is None:
            pooled = (x.shape[0], x.shape[1] // ctx.window[0],
                      x.shape[2] // 2, x.shape[3] // 2, x.shape[4])
            dpool = x.new_zeros(pooled)
        bwd = pool_bnact_bwd_plain if ctx.plain else pool_bnact_bwd_kernel
        dx, dinv, dshift = bwd(x, inv, shift, ctx.act, ctx.window, dpool,
                               dskip)
        return None, None, None, dx, dinv, dshift


def pool_bnact(x: torch.Tensor, inv: Optional[torch.Tensor],
               shift: Optional[torch.Tensor], act: str,
               window: Tuple[int, int, int], *,
               reference: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prologue, then a max pool over ``window`` ((1, 2, 2) or
    (2, 2, 2), stride = window) of an NDHWC tensor whose pooled dims
    divide evenly. Returns (pooled, skip): the pooled tensor in ``x``'s
    dtype, and the raw ``x`` itself (a view, no copy) as the level's
    skip, whose cotangent K6 adds into dx before its one rounding (JAX's
    ``pool_bnact_flat_skip``), so the level's input takes one gradient
    and no separate add. ``inv``/``shift`` are (C,), per sample (N, C)
    (their gradients then (N, C) too), or None."""
    window = tuple(window)
    _pool_contract(x, window, _needs_grad(x, inv, shift))
    _check_per_sample(x, x.shape[-1], inv, shift, False, "pool_bnact")
    return _PoolBnAct.apply(act, window, reference, x, inv, shift)


# ---------------------------------------------------------------------------
# K3 upconv_bnact (forward) and K7 upconv_bnact_bwd (backward)
# ---------------------------------------------------------------------------

def _upconv_contract(x: torch.Tensor, weight: torch.Tensor,
                     grad: bool) -> None:
    """K3's shape contract: an NDHWC input, a (C_in, C_out, 1|2, 2, 2)
    weight with C_in % 16 == 0 and C_out % 32 == 0. K7 works in groups
    of 32 input channels, so a gradient needs C_in % 32 == 0."""
    _check_dtype(x, "upconv_bnact")
    if x.dim() != 5:
        raise ValueError(f"upconv_bnact: expected NDHWC, got "
                         f"{tuple(x.shape)}")
    wcin, cout, kd, kh, kw = weight.shape
    if wcin != x.shape[4] or kd not in (1, 2) or (kh, kw) != (2, 2) \
            or wcin % 16 or cout % 32:
        raise ValueError(f"upconv_bnact: weight {tuple(weight.shape)} on "
                         f"{tuple(x.shape)} needs C_in % 16, C_out % 32 and "
                         "a (1|2, 2, 2) kernel")
    if grad and wcin % 32:
        raise ValueError(f"upconv_bnact backward (K7): C_in % 32 required, "
                         f"got {wcin}")


def upconv_bnact_fwd_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                           shift: Optional[torch.Tensor],
                           weight: torch.Tensor, bias: torch.Tensor,
                           act: str, want_stats: bool = False):
    """Plain version of K3: (y, s, q)."""
    dtype = x.dtype
    a = prologue(x, inv, shift, act).to(dtype).float()
    y = F.conv_transpose3d(a.permute(0, 4, 1, 2, 3),
                           weight.to(dtype).float(), bias.float(),
                           stride=tuple(weight.shape[2:]))
    y = y.permute(0, 2, 3, 4, 1).to(dtype).contiguous()
    want, ps = _want(want_stats)
    s, q = channel_stats(y, ps) if want else (None, None)
    return y, s, q


def upconv_bnact_bwd_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                           shift: Optional[torch.Tensor],
                           weight: torch.Tensor, y: torch.Tensor,
                           dy: Optional[torch.Tensor],
                           ds: Optional[torch.Tensor],
                           dq: Optional[torch.Tensor], act: str,
                           input_grad: bool = True):
    """Plain version of K7: (dx, dinv, dshift, dW, db). Each input
    voxel feeds kd * 4 output voxels, one per weight tap, so both
    products are per-voxel GEMMs over (tap, C_out). dinv and dshift are
    (N, C_in) for a per-sample ``inv``."""
    dtype = x.dtype
    n, d, h, w, cin = x.shape
    cout, kd = weight.shape[1], weight.shape[2]
    t = _dy_tot(dy, y, ds, dq)
    db = _sum_vox(t)
    g = t.to(dtype).float().view(n, d, kd, h, 2, w, 2, cout)
    wq = weight.to(dtype).float()
    a = prologue(x, inv, shift, act).to(dtype).float()
    dw = torch.einsum("ndhwi,ndahbwco->ioabc", a, g)
    if not input_grad:
        return None, None, None, dw, db
    da = torch.einsum("ndahbwco,ioabc->ndhwi", g, wq)
    gm = da * act_grad(_pre(x, inv, shift), act)
    if inv is None:
        return gm.to(dtype), None, None, dw, db
    return ((gm * _bc(inv, x)).to(dtype), *_pro_sums(gm, x, inv), dw, db)


def upconv_body(dtype: torch.dtype) -> str:
    """The body K3's forward runs: ``'tc'`` (the tensor-core GEMM of
    ``csrc/upconv_tc.cu``) for bfloat16, ``'cuda-core'`` (the float32
    FMA body of ``csrc/upconv_bnact.cu``) for float32, whose tests hold
    1e-4 of the scale. The contract's C_in % 16 and C_out % 32 fit both."""
    return "tc" if dtype == torch.bfloat16 else "cuda-core"


def pack_upconv_weight(weight: torch.Tensor, dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
    """K3's tensor-core weight operand: the (C_in, C_out, kd, 2, 2)
    weight rounded to ``dtype`` (exact) as (C_in / 16, kd * 4 * C_out,
    16), the GEMM columns in (a, b, c, C_out) order and each column's 16
    input channels of one k16 step contiguous."""
    cin, cout, kd = weight.shape[:3]
    out = torch.empty((cin // 16, kd * 4 * cout, 16), dtype=dtype,
                      device=device)
    out.view(cin // 16, kd, 2, 2, cout, 16).copy_(
        weight.detach().reshape(cin // 16, 16, cout, kd, 2, 2)
        .permute(0, 3, 4, 5, 2, 1))
    return out


def upconv_bnact_fwd_kernel(x, inv, shift, weight, bias, act, want_stats):
    """K3 on CUDA tensors: (y, s, q) as :func:`upconv_bnact_fwd_plain`,
    on the body :func:`upconv_body` picks. In the per-sample mode both
    bodies index their grid by (block of a sample, sample), so no block
    spans two samples, and sum their statistics in a fixed order."""
    _check_cuda(x, "upconv_bnact")
    n, d, h, w, cin = x.shape
    cout, kd = weight.shape[1], weight.shape[2]
    dev = x.device
    dtype = x.dtype
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, kd * d, 2 * h, 2 * w, cout), dtype=dtype, device=dev)
    lib = _build.library()
    tc = upconv_body(dtype) == "tc"
    s, q, ws = _stat_bufs(
        want_stats, n, cout, dev,
        lambda: lib.e3_upconv_bnact_tc_ps_parts(d, h, w) if tc
        else lib.e3_upconv_bnact_ps_parts(d, h, w, kd))
    if tc:
        inv_v, shift_v = _prologue_ptrs(inv, shift, act, cin, dev, n)
        wp = pack_upconv_weight(weight, dtype, dev)
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_bnact_tc(
                x.data_ptr(), _ptr(inv_v), _ptr(shift_v), _ns(inv_v),
                wp.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(s), _ptr(q),
                _ptr(ws), n, d, h, w, cin, cout, kd, _ACT_ID[act],
                _stream(dev))
        _build.check(rc, "upconv_bnact (tensor-core body)")
        _count("upconv_bnact", "tc", _ps_fwd(inv, want_stats))
        return y, s, q
    inv = _vec(inv, cin, 1.0, dev, n)
    shift = _vec(shift, cin, 0.0, dev, n)
    wt = weight.detach().to(device=dev, dtype=dtype).float() \
        .permute(2, 3, 4, 0, 1).contiguous()
    with torch.cuda.device(dev):
        rc = lib.e3_upconv_bnact(
            _DTYPE_ID[dtype], x.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            _ns(inv), wt.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(s),
            _ptr(q), _ptr(ws), n, d, h, w, cin, cout, kd, _ACT_ID[act],
            _stream(dev))
    _build.check(rc, "upconv_bnact")
    _count("upconv_bnact", "cuda-core", _ps_fwd(inv, want_stats))
    return y, s, q


def upconv_bwd_body(dtype: torch.dtype) -> str:
    """The bodies K7 runs: ``'tc'`` (the tensor-core dgrad and wgrad
    GEMMs of ``csrc/upconv_bwd_tc.cu``) for bfloat16, ``'cuda-core'``
    (the float32 FMA bodies of ``csrc/upconv_bnact.cu``) for float32,
    whose tests hold 1e-4 of the scale. The vup path's chain keeps the
    CUDA-core bodies in both dtypes (``ops/vup.py``)."""
    return "tc" if dtype == torch.bfloat16 else "cuda-core"


def upconv_bnact_bwd_kernel(x, inv, shift, weight, y, dy, ds, dq, act,
                            input_grad=True, body=None):
    """K7: (dx, dinv, dshift, dW, db), as
    :func:`upconv_bnact_bwd_plain`, on ``body`` (by default the one
    :func:`upconv_bwd_body` picks; ``'cuda-core'`` runs the CUDA-core
    bodies in either dtype, which need C_in % 32 == 0). In the per-sample
    mode ``ds``/``dq`` and the prologue are (N, C) rows by a sample
    stride; with an (N, C) prologue the dgrad's grid is (block of a
    sample, sample), and dinv, dshift (N, C_in) its blocks' partial rows
    summed in a fixed order."""
    _check_cuda(x, "upconv_bnact backward")
    n, d, h, w, cin = x.shape
    cout, kd = weight.shape[1], weight.shape[2]
    dev = x.device
    dtype = x.dtype
    body = body or upconv_bwd_body(dtype)
    if body not in ("tc", "cuda-core") or (body == "tc"
                                           and dtype != torch.bfloat16):
        raise ValueError(f"upconv_bnact backward: no {body!r} body for "
                         f"{dtype}")
    g = _cuda_grad(dy, y, "upconv_bnact backward")
    ds, dq = _stat_cts(ds, dq, cout, dev, n)
    dx = torch.empty_like(x) if input_grad else None
    dwt = torch.zeros((kd, 2, 2, cin, cout), dtype=torch.float32,
                      device=dev)
    db = torch.zeros(cout, dtype=torch.float32, device=dev)
    lib = _build.library()
    dinv, dshift, ws = _stat_bufs(
        PER_SAMPLE if input_grad and _ps(inv) else True, n, cin, dev,
        lambda: lib.e3_upconv_bnact_bwd_tc_ps_parts(d, h, w)
        if body == "tc" else lib.e3_upconv_bnact_bwd_ps_parts(d, h, w))
    if body == "tc":
        inv_v, shift_v = _prologue_ptrs(inv, shift, act, cin, dev, n)
        wp = pack_upconv_weight(weight, dtype, dev)
        e = torch.empty_like(g) if ds is not None else None   # pre-pass
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_bnact_bwd_tc(
                x.data_ptr(), _ptr(inv_v), _ptr(shift_v), _ns(inv_v),
                wp.data_ptr(), g.data_ptr(), y.data_ptr(), _ptr(ds),
                _ptr(dq), _ns(ds), _ptr(e), _ptr(dx), dinv.data_ptr(),
                dshift.data_ptr(), _ptr(ws), dwt.data_ptr(), db.data_ptr(),
                n, d, h, w, cin, cout, kd, _ACT_ID[act], _stream(dev))
        _build.check(rc, "upconv_bnact_bwd (tensor-core bodies)")
    else:
        inv_v = _vec(inv, cin, 1.0, dev, n)
        shift_v = _vec(shift, cin, 0.0, dev, n)
        wt = weight.detach().to(device=dev, dtype=dtype).float() \
            .permute(2, 3, 4, 0, 1).contiguous()
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_bnact_bwd(
                _DTYPE_ID[dtype], x.data_ptr(), inv_v.data_ptr(),
                shift_v.data_ptr(), _ns(inv_v), wt.data_ptr(), g.data_ptr(),
                y.data_ptr(), _ptr(ds), _ptr(dq), _ns(ds), _ptr(dx),
                dinv.data_ptr(), dshift.data_ptr(), _ptr(ws),
                dwt.data_ptr(), db.data_ptr(), n, d, h, w, cin, cout, kd,
                _ACT_ID[act], _stream(dev))
        _build.check(rc, "upconv_bnact_bwd")
    _count("upconv_bnact_bwd", body, _ps_launch(inv, ds))
    if inv is None or not input_grad:
        dinv = dshift = None
    return dx, dinv, dshift, dwt.permute(3, 4, 0, 1, 2), db


class _UpconvBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, want_stats, reference, x, inv, shift, weight,
                bias):
        ctx.plain = _plain(x, reference)
        fwd = upconv_bnact_fwd_plain if ctx.plain \
            else upconv_bnact_fwd_kernel
        y, s, q = fwd(x, inv, shift, weight, bias, act, want_stats)
        ctx.save_for_backward(x, inv, shift, weight, y)
        ctx.act = act
        ctx.bias_dtype = bias.dtype
        ctx.set_materialize_grads(False)
        return (y, s, q) if want_stats else y

    @staticmethod
    def backward(ctx, dy, ds=None, dq=None):
        x, inv, shift, weight, y = ctx.saved_tensors
        bwd = upconv_bnact_bwd_plain if ctx.plain \
            else upconv_bnact_bwd_kernel
        dx, dinv, dshift, dw, db = bwd(
            x, inv, shift, weight, y, dy, ds, dq, ctx.act,
            any(ctx.needs_input_grad[3:6]))
        return (None, None, None, dx, dinv, dshift, dw.to(weight.dtype),
                db.to(ctx.bias_dtype))


def upconv_bnact(x: torch.Tensor, inv: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], weight: torch.Tensor,
                 bias: torch.Tensor, act: str, *, want_stats=False,
                 reference: bool = False):
    """Optional prologue, then a transposed conv whose kernel equals its
    stride, (1, 2, 2) or (2, 2, 2), plus bias.

    Args:
        x: (N, D, H, W, C_in) NDHWC input (raw deeper-level output when
            a prologue is given).
        inv, shift: (C_in,) float32 prologue vectors, per sample
            (N, C_in), or None.
        weight: (C_in, C_out, kd, 2, 2) torch ConvTranspose3d weight.
        bias: (C_out,).
        want_stats: also return the output's per-channel float32
            (sum, sumsq): True for (C_out,) each, :data:`PER_SAMPLE` for
            (N, C_out).
    Returns:
        (N, kd * D, 2 H, 2 W, C_out) in ``x``'s dtype, or (y, s, q).
        Differentiable in every tensor argument, in the per-sample mode
        too.
    """
    _upconv_contract(x, weight, _needs_grad(x, inv, shift, weight, bias))
    _check_per_sample(x, x.shape[-1], inv, shift, want_stats,
                      "upconv_bnact")
    return _UpconvBnAct.apply(act, want_stats, reference, x, inv, shift,
                              weight, bias)
