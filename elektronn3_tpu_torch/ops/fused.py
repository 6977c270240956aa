"""Fused U-Net level ops on NDHWC tensors, with hand-written Hopper
kernels.

Counterpart of the JAX package's ``ops/flat_fused.py`` and
``ops/flat_fused64.py``. There the 32- and 64-channel executors are
separate because of TPU lane packing (128-lane rows holding 4 or 2
w-positions); on a GPU the activations stay plain contiguous NDHWC and
one op covers both. What carries over is the fusion contract:

- a level's activation is carried RAW, as the conv output plus the
  per-channel (inv, shift) of its batch norm (:class:`FusedActs`);
- the consumer applies ``act(x * inv + shift)`` (the "prologue") as it
  loads its input, so no normalized tensor is ever written.

Three kernels (``csrc/``) cover the seven TPU kernels on the inference
path:

- :func:`conv_bnact` (K1): prologue + (kd, 3, 3) 'same' conv over one or
  two inputs (the concat merge) + bias;
- :func:`pool_bnact` (K2): prologue + (1, 2, 2) / (2, 2, 2) max pool;
- :func:`upconv_bnact` (K3): optional prologue + stride-equals-kernel
  transposed conv + bias.

Each op dispatches on its input's device: a CPU tensor goes to the
plain PyTorch version beside it (same signature, same rounding points),
a CUDA tensor to the kernel, which raises if it cannot launch. No path
falls back from one to the other. ``reference=True`` selects the plain
version explicitly (used to hold a kernel against it on the card).

Rounding follows the JAX kernels: the prologue runs in float32 on the
stored value; the prologued operand and the weights are rounded to the
activation dtype before the multiply; accumulation and the bias add are
float32; the output is rounded once to the activation dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.ops import _build

LEAKY_SLOPE = 0.1  # matches modules/layers.py leaky activation
_ACT_ID = {"linear": 0, "relu": 1, "leaky": 2}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper. Each wrapper adds one where it launches
# its kernel and nowhere else; plain-version calls do not count.
LAUNCHES = {"conv_bnact": 0, "pool_bnact": 0, "upconv_bnact": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class FusedActs(NamedTuple):
    """A level's activation in fused form: the RAW conv output (NDHWC)
    plus the per-channel float32 (inv, shift) prologue its consumer
    applies on load. Counterpart of ``FlatActs``/``FlatActs64``."""
    raw: torch.Tensor
    inv: torch.Tensor
    shift: torch.Tensor


def act_fwd(pre: torch.Tensor, act: str) -> torch.Tensor:
    """Prologue activation (flat_fused.py ``_act_fwd``)."""
    if act == "relu":
        return torch.clamp_min(pre, 0.0)
    if act == "leaky":
        return torch.where(pre > 0, pre, LEAKY_SLOPE * pre)
    if act == "linear":
        return pre
    raise NotImplementedError(act)


def prologue(x: torch.Tensor, inv: Optional[torch.Tensor],
             shift: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """``act(x * inv + shift)`` in float32 over the channel (last) axis;
    ``inv is None`` means the identity norm."""
    xf = x.float()
    if inv is not None:
        xf = xf * inv + shift
    return act_fwd(xf, act)


def materialize(acts: FusedActs, act: str) -> torch.Tensor:
    """Apply a carried prologue and round to the activation dtype
    (``materialize_flat_acts``): the seam where a kernel level feeds a
    plain-torch consumer."""
    return prologue(acts.raw, acts.inv, acts.shift, act).to(acts.raw.dtype)


def head_bnact(acts: FusedActs, act: str, weight: torch.Tensor,
               bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Prologue, then the 1x1 conv head as one GEMM, logits in
    ``out_dtype`` (``head_bnact_from_flat``; XLA in JAX, plain torch
    here). The prologued operand stays float32; weight and bias arrive
    in the model dtype and are widened to float32."""
    a = prologue(acts.raw, acts.inv, acts.shift, act)
    w2 = weight.reshape(weight.shape[0], -1).float()
    return (a @ w2.t() + bias.float()).to(out_dtype)


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_ID:
        raise ValueError(f"{what}: dtype {t.dtype} has no kernel "
                         "(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous NDHWC tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")


def _vec(v: Optional[torch.Tensor], c: int, fill: float,
         device: torch.device) -> torch.Tensor:
    if v is None:
        return torch.full((c,), fill, dtype=torch.float32, device=device)
    if v.shape != (c,):
        raise ValueError(f"prologue vector shape {tuple(v.shape)} != ({c},)")
    return v.to(device=device, dtype=torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K1 conv_bnact
# ---------------------------------------------------------------------------

def conv_bnact_plain(xs: Sequence[torch.Tensor], inv: Optional[torch.Tensor],
                     shift: Optional[torch.Tensor], weight: torch.Tensor,
                     bias: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of :func:`conv_bnact`. The concat is materialized
    here; the kernel reads the inputs side by side."""
    dtype = xs[0].dtype
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    a = prologue(x, inv, shift, act).to(dtype).float()
    kd = weight.shape[2]
    y = F.conv3d(a.permute(0, 4, 1, 2, 3), weight.to(dtype).float(),
                 bias.float(), padding=(kd // 2, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(dtype).contiguous()


def conv_bnact(xs: Sequence[torch.Tensor], inv: Optional[torch.Tensor],
               shift: Optional[torch.Tensor], weight: torch.Tensor,
               bias: torch.Tensor, act: str, *,
               reference: bool = False) -> torch.Tensor:
    """Prologue + (kd, 3, 3) 'same' conv + bias over NDHWC inputs.

    Args:
        xs: one or two (N, D, H, W, C_i) tensors of one dtype (a merge
            conv's inputs in concat order).
        inv, shift: (sum C_i,) float32 prologue vectors, or None for the
            identity norm.
        weight: (C_out, sum C_i, kd, 3, 3) conv weight, kd in {1, 3}.
        bias: (C_out,) bias, added in float32.
        act: 'relu', 'leaky' or 'linear'.
        reference: run the plain version whatever the device.
    Returns:
        (N, D, H, W, C_out) raw conv output in the inputs' dtype.
    """
    if reference or xs[0].device.type == "cpu":
        return conv_bnact_plain(xs, inv, shift, weight, bias, act)
    if len(xs) not in (1, 2):
        raise ValueError(f"conv_bnact takes 1 or 2 inputs, got {len(xs)}")
    x0 = xs[0]
    for x in xs:
        _check_cuda(x, "conv_bnact")
        if x.dim() != 5 or x.shape[:4] != x0.shape[:4] \
                or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("conv_bnact inputs must share (N, D, H, W), "
                             "dtype and device")
    n, d, h, w = x0.shape[:4]
    cins = [x.shape[4] for x in xs]
    cout, cin, kd, kh, kw = weight.shape
    if cin != sum(cins) or kd not in (1, 3) or (kh, kw) != (3, 3):
        raise ValueError(f"conv_bnact weight {tuple(weight.shape)} does not "
                         f"fit inputs with channels {cins}")
    if cout % 32 or any(c != 1 and c % 8 for c in cins):
        raise ValueError(f"conv_bnact: C_out % 32 and each C_in in 1 or "
                         f"% 8 required, got {cout}, {cins}")
    if n * d > 65535:
        raise ValueError(f"conv_bnact: N * D = {n * d} > 65535")
    dev = x0.device
    dtype = x0.dtype
    inv = _vec(inv, cin, 1.0, dev)
    shift = _vec(shift, cin, 0.0, dev)
    invs = torch.split(inv, cins)
    shifts = torch.split(shift, cins)
    wt = weight.detach().to(device=dev, dtype=dtype).float() \
        .permute(2, 3, 4, 1, 0).contiguous()
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, d, h, w, cout), dtype=dtype, device=dev)
    x1 = xs[1] if len(xs) > 1 else None
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_bnact(
            _DTYPE_ID[dtype], len(xs),
            x0.data_ptr(), cins[0], invs[0].data_ptr(), shifts[0].data_ptr(),
            _ptr(x1), cins[1] if x1 is not None else 0,
            invs[1].data_ptr() if x1 is not None else None,
            shifts[1].data_ptr() if x1 is not None else None,
            wt.data_ptr(), b.data_ptr(), y.data_ptr(),
            n, d, h, w, cout, kd, _ACT_ID[act],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "conv_bnact")
    LAUNCHES["conv_bnact"] += 1
    return y


# ---------------------------------------------------------------------------
# K2 pool_bnact
# ---------------------------------------------------------------------------

def pool_bnact_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                     shift: Optional[torch.Tensor], act: str,
                     window: Tuple[int, int, int]) -> torch.Tensor:
    """Plain version of :func:`pool_bnact`."""
    a = prologue(x, inv, shift, act)
    y = F.max_pool3d(a.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def pool_bnact(x: torch.Tensor, inv: Optional[torch.Tensor],
               shift: Optional[torch.Tensor], act: str,
               window: Tuple[int, int, int], *,
               reference: bool = False) -> torch.Tensor:
    """Prologue, then a max pool over ``window`` ((1, 2, 2) or
    (2, 2, 2), stride = window) of an NDHWC tensor whose pooled dims
    divide evenly. Returns the pooled tensor in ``x``'s dtype; the raw
    ``x`` itself is the level's skip."""
    window = tuple(window)
    if reference or x.device.type == "cpu":
        return pool_bnact_plain(x, inv, shift, act, window)
    _check_cuda(x, "pool_bnact")
    n, d, h, w, c = x.shape
    if window not in ((1, 2, 2), (2, 2, 2)) or d % window[0] or h % 2 \
            or w % 2 or c % 8:
        raise ValueError(f"pool_bnact: window {window} on {tuple(x.shape)} "
                         "needs even pooled dims and C % 8 == 0")
    dev = x.device
    inv = _vec(inv, c, 1.0, dev)
    shift = _vec(shift, c, 0.0, dev)
    y = torch.empty((n, d // window[0], h // 2, w // 2, c), dtype=x.dtype,
                    device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_pool_bnact(
            _DTYPE_ID[x.dtype], x.data_ptr(), inv.data_ptr(),
            shift.data_ptr(), y.data_ptr(), n, d, h, w, c, window[0],
            _ACT_ID[act], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pool_bnact")
    LAUNCHES["pool_bnact"] += 1
    return y


# ---------------------------------------------------------------------------
# K3 upconv_bnact
# ---------------------------------------------------------------------------

def upconv_bnact_plain(x: torch.Tensor, inv: Optional[torch.Tensor],
                       shift: Optional[torch.Tensor], weight: torch.Tensor,
                       bias: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version of :func:`upconv_bnact`."""
    dtype = x.dtype
    a = prologue(x, inv, shift, act).to(dtype).float()
    y = F.conv_transpose3d(a.permute(0, 4, 1, 2, 3),
                           weight.to(dtype).float(), bias.float(),
                           stride=tuple(weight.shape[2:]))
    return y.permute(0, 2, 3, 4, 1).to(dtype).contiguous()


def upconv_bnact(x: torch.Tensor, inv: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], weight: torch.Tensor,
                 bias: torch.Tensor, act: str, *,
                 reference: bool = False) -> torch.Tensor:
    """Optional prologue, then a transposed conv whose kernel equals its
    stride, (1, 2, 2) or (2, 2, 2), plus bias.

    Args:
        x: (N, D, H, W, C_in) NDHWC input (raw deeper-level output when
            a prologue is given).
        inv, shift: (C_in,) float32 prologue vectors, or None.
        weight: (C_in, C_out, kd, 2, 2) torch ConvTranspose3d weight.
        bias: (C_out,).
    Returns:
        (N, kd * D, 2 H, 2 W, C_out) in ``x``'s dtype.
    """
    if reference or x.device.type == "cpu":
        return upconv_bnact_plain(x, inv, shift, weight, bias, act)
    _check_cuda(x, "upconv_bnact")
    n, d, h, w, cin = x.shape
    wcin, cout, kd, kh, kw = weight.shape
    if wcin != cin or kd not in (1, 2) or (kh, kw) != (2, 2) \
            or cin % 16 or cout % 32:
        raise ValueError(f"upconv_bnact: weight {tuple(weight.shape)} on "
                         f"{tuple(x.shape)} needs C_in % 16, C_out % 32 and "
                         "a (1|2, 2, 2) kernel")
    dev = x.device
    dtype = x.dtype
    inv = _vec(inv, cin, 1.0, dev)
    shift = _vec(shift, cin, 0.0, dev)
    wt = weight.detach().to(device=dev, dtype=dtype).float() \
        .permute(2, 3, 4, 0, 1).contiguous()
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, kd * d, 2 * h, 2 * w, cout), dtype=dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_upconv_bnact(
            _DTYPE_ID[dtype], x.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            wt.data_ptr(), b.data_ptr(), y.data_ptr(), n, d, h, w, cin, cout,
            kd, _ACT_ID[act], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "upconv_bnact")
    LAUNCHES["upconv_bnact"] += 1
    return y
