"""The vup path on NDHWC tensors: a decoder merge conv whose first
input, the (1, 2, 2) upconv of the deeper level's carried activation,
is recomputed where it is read and never stored.

Counterpart of the JAX package's ``ops/flat_fused.py::
conv_bnact_flat_vup`` (row 1's ``pallas_call`` in its vup mode, and
``_conv_vup_bwd``, row 9 of the kernel table in PERF.md) and
``ops/flat_fused64.py::upconv122_stats_from_flat64`` (row 22, with its
backward ``_upconv122_stats_bwd``, row 23). In the headline UNet the L0
decoder's merge conv reads the upconv of the L1 carry; with vup that
upconv output u (twice the carry's bytes) exists in neither the forward
nor the backward:

- :func:`conv_vup`: the merge conv over [u, skip], where u is
  recomputed from the carry (raw values plus the carry's prologue
  vectors ``invc``/``shiftc`` and activation ``act_c``) and the upconv
  weight and bias. Its statistics are those of the merge conv's output;
- :func:`upconv_stats`: the per-channel float32 (sum, sumsq) of the
  rounded u, for u's batch norm in training (none in eval);
- backward: the merge conv's gradient into u is chained through the
  upconv taps and the carry's prologue into the carry, with JAX's
  rounding points (flat_fused.py:568-620): ``da = gm * inv0`` in
  float32, ``dbu`` summed from it, ``E = round(da)`` into the taps,
  ``dprec = (E Wu^T) * act_c'(prec)``, ``dinvc``/``dshiftc`` its sums,
  ``dcarry = round(dprec * invc)``. The statistics pass's backward runs
  the same chain on ``ds + 2 u dq``. The carry's gradient is the sum of
  the two, which autograd forms as JAX's does.

The plain versions compose ``fused.upconv_bnact_fwd_plain`` and the
conv's plain versions, so the plain forward is bitwise the materializing
path's. The kernels (``csrc/conv_vup.cu``, vup instantiations in
``conv_bnact_bwd.cu``, ``upconv_bnact.cu`` and ``wgrad_tc.cu``, and
``upconv_stats_bwd_tc.cu``) recompute u through the two recomputes of
``csrc/upconv_vup.cuh``: ``upconv_value8`` on the CUDA cores, and a
tensor-core tile GEMM in the bf16 bodies of ``vup_bwd_body``:

- ``conv_vup`` (K1's body): the forward;
- ``conv_vup_dgrad`` (K4's body, then K7's dgrad and wgrad bodies as
  the chain): the merge conv's input gradients, with E going through a
  scratch of u's shape in the activation dtype (JAX rounds E to it too;
  the scratch lives for the call, and no two coexist);
- ``conv_vup_wgrad`` (bf16: K5's tensor-core body, u recomputed per
  tile on the tensor cores; float32: K5's CUDA-core body): the merge
  conv's dW and db;
- ``upconv_stats`` (row 22): one pass of the recompute;
- ``upconv_stats_bwd`` (row 23; bf16: one tensor-core kernel whose E
  stays in shared memory; float32: one pass forms ``round(ds + 2 u dq)``
  into the same kind of scratch, then the chain).

As in ``ops/fused.py``, a CPU tensor runs the plain versions, a CUDA
tensor the kernels (which raise if they cannot launch), and
``reference=True`` the plain versions on any device; each op checks the
kernels' shape contract first, on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from elektronn3_tpu_torch.ops import _build
from elektronn3_tpu_torch.ops.fused import (
    LAUNCHES, _ACT_ID, _DTYPE_ID, _check_cuda, _check_dtype, _count,
    _cuda_grad, _plain, _ptr, _stat_cts, _stream, _vec, channel_stats,
    conv_bnact_dgrad_gm, conv_bnact_fwd_plain, conv_bnact_wgrad_plain,
    pack_upconv_weight, upconv_bnact_bwd_plain, upconv_bnact_fwd_plain)


def _vup_contract(carry: torch.Tensor, wu: torch.Tensor,
                  skip: Optional[torch.Tensor],
                  weight: Optional[torch.Tensor]) -> None:
    """The kernels' shape contract: an NDHWC carry (N, D, H2, W2, C_c)
    with C_c % 32 == 0; a (C_c, C_u, 1, 2, 2) upconv weight with
    C_u % 32 == 0; for the merge conv, a skip (N, D, 2 H2, 2 W2, C_s)
    of the carry's dtype and device with C_s % 32 == 0, and a
    (C_out, C_u + C_s, 1, 3, 3) weight with C_out % 32 == 0."""
    _check_dtype(carry, "vup")
    if carry.dim() != 5:
        raise ValueError(f"vup: expected an NDHWC carry, got "
                         f"{tuple(carry.shape)}")
    cc = carry.shape[4]
    if wu.dim() != 5 or wu.shape[0] != cc or tuple(wu.shape[2:]) != \
            (1, 2, 2) or cc % 32 or wu.shape[1] % 32:
        raise ValueError(f"vup: upconv weight {tuple(wu.shape)} on a carry "
                         f"{tuple(carry.shape)} needs a (1, 2, 2) kernel, "
                         "C_carry % 32 and C_up % 32")
    if weight is None:
        return
    if skip is None:
        raise ValueError("conv_vup: the merge conv needs a skip input (the "
                         "encoder's activation beside the recomputed upconv)")
    n, d, h2, w2 = carry.shape[:4]
    if skip.dim() != 5 or tuple(skip.shape[:4]) != (n, d, 2 * h2, 2 * w2) \
            or skip.dtype != carry.dtype or skip.device != carry.device \
            or skip.shape[4] % 32:
        raise ValueError(f"conv_vup: skip {tuple(skip.shape)} {skip.dtype} "
                         f"does not fit the carry {tuple(carry.shape)} "
                         f"{carry.dtype} (twice its H and W, C % 32)")
    cout, cin, kd, kh, kw = weight.shape
    if cin != wu.shape[1] + skip.shape[4] or (kd, kh, kw) != (1, 3, 3) \
            or cout % 32:
        raise ValueError(f"conv_vup: weight {tuple(weight.shape)} does not "
                         f"fit inputs of {wu.shape[1]} + {skip.shape[4]} "
                         "channels (a (1, 3, 3) kernel, C_out % 32)")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _upconv_plain(carry, invc, shiftc, wu, bu, act_c):
    return upconv_bnact_fwd_plain(carry, invc, shiftc, wu, bu, act_c)[0]


def upconv_stats_plain(carry, invc, shiftc, wu, bu, act_c):
    """Plain version of row 22: the float32 (sum, sumsq) of the rounded
    upconv output."""
    return channel_stats(_upconv_plain(carry, invc, shiftc, wu, bu, act_c))


def upconv_stats_bwd_plain(carry, invc, shiftc, wu, bu, ds, dq, act_c):
    """Plain version of row 23: (dcarry, dinvc, dshiftc, dwu, dbu) from
    the statistics cotangents: K7's plain backward on the recomputed
    output with no output cotangent."""
    y = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    return upconv_bnact_bwd_plain(carry, invc, shiftc, wu, y, None, ds, dq,
                                  act_c)


def conv_vup_fwd_plain(carry, invc, shiftc, wu, bu, skip, inv, shift,
                       weight, bias, act, act_c, want_stats=False):
    """Plain version of the vup forward: the materializing path's plain
    upconv and merge conv, composed. Returns (y, s, q)."""
    u = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    return conv_bnact_fwd_plain([u, skip], inv, shift, weight, bias, act,
                                want_stats)


def conv_vup_dgrad_plain(carry, invc, shiftc, wu, bu, skip, inv, shift,
                         weight, y, dy, ds, dq, act, act_c):
    """Plain version of the vup merge conv's input gradients, row 9's
    chain written out: (dcarry, dinvc, dshiftc, dwu, dbu, dskip, dinv,
    dshift). ``da = gm * inv0`` stays float32 into K7's plain backward,
    which sums ``dbu`` from it and rounds it (E) before the taps."""
    u = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    xs = [u, skip]
    gm = conv_bnact_dgrad_gm(xs, inv, shift, weight, y, dy, ds, dq, act)
    cu = u.shape[-1]
    dims = tuple(range(gm.dim() - 1))
    x = torch.cat(xs, dim=-1).float()
    dinv = dshift = None
    if inv is not None:
        dinv, dshift = (gm * x).sum(dims), gm.sum(dims)
        gm = gm * inv
    da = gm[..., :cu].contiguous()
    dskip = gm[..., cu:].to(skip.dtype).contiguous()
    dcarry, dinvc, dshiftc, dwu, dbu = upconv_bnact_bwd_plain(
        carry, invc, shiftc, wu, u, da, None, None, act_c)
    return dcarry, dinvc, dshiftc, dwu, dbu, dskip, dinv, dshift


def conv_vup_wgrad_plain(carry, invc, shiftc, wu, bu, skip, inv, shift,
                         weight, y, dy, ds, dq, act, act_c):
    """Plain version of the vup merge conv's (dW, db), float32."""
    u = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    return conv_bnact_wgrad_plain([u, skip], inv, shift, weight, y, dy, ds,
                                  dq, act)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------

def _carry_args(carry, invc, shiftc, wu, bu, what):
    """The carry's operands as the kernels take them: the carry, its
    prologue vectors, the upconv weight as (1, 2, 2, C_c, C_u) float32
    values of the activation dtype, the float32 bias."""
    _check_cuda(carry, what)
    dev = carry.device
    cc, cu = wu.shape[0], wu.shape[1]
    wt = wu.detach().to(device=dev, dtype=carry.dtype).float() \
        .permute(2, 3, 4, 0, 1).contiguous()
    return (_vec(invc, cc, 1.0, dev), _vec(shiftc, cc, 0.0, dev), wt,
            bu.detach().to(device=dev, dtype=torch.float32).contiguous(),
            cc, cu)


def _carry_ptrs(carry, invc_v, shiftc_v, wt, b):
    return carry.data_ptr(), invc_v.data_ptr(), shiftc_v.data_ptr(), \
        wt.data_ptr(), b.data_ptr()


def upconv_stats_kernel(carry, invc, shiftc, wu, bu, act_c):
    """Row 22 on a CUDA carry: (s, q) as :func:`upconv_stats_plain`."""
    invc_v, shiftc_v, wt, b, cc, cu = _carry_args(carry, invc, shiftc, wu,
                                                  bu, "upconv_stats")
    dev = carry.device
    s = torch.zeros(cu, dtype=torch.float32, device=dev)
    q = torch.zeros(cu, dtype=torch.float32, device=dev)
    n, d, h, w = carry.shape[:4]
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_upconv_stats(
            _DTYPE_ID[carry.dtype], *_carry_ptrs(carry, invc_v, shiftc_v, wt,
                                                 b),
            s.data_ptr(), q.data_ptr(), n, d, h, w, cc, cu, _ACT_ID[act_c],
            _stream(dev))
    _build.check(rc, "upconv_stats")
    LAUNCHES["upconv_stats"] += 1
    return s, q


# The (C_carry, C_up) of the tensor-core bodies of rows 23 and 9's
# weight gradient: template cases of csrc/upconv_stats_bwd_tc.cu and
# csrc/wgrad_tc.cu.
VUP_TC_CC = (32, 64, 96, 128)
VUP_TC_CU = (32, 64)


def vup_bwd_body(dtype: torch.dtype, cc: int, cu: int) -> str:
    """The body ``upconv_stats_bwd`` (row 23) and ``conv_vup_wgrad``
    (row 9's weight gradient) run: ``'tc'`` (``csrc/
    upconv_stats_bwd_tc.cu``: one tensor-core kernel, E in shared
    memory; ``csrc/wgrad_tc.cu``: K5's tensor-core body with u
    recomputed per tile on the tensor cores) for bfloat16 with C_carry
    in :data:`VUP_TC_CC` and C_up in :data:`VUP_TC_CU`, else
    ``'cuda-core'`` (``csrc/upconv_bnact.cu``'s pass and K7's CUDA-core
    bodies, ``csrc/conv_bnact_bwd.cu``'s K5 with ``VUP``): float32, whose
    tests hold 1e-4 of the scale, and any other shape."""
    if dtype == torch.bfloat16 and cc in VUP_TC_CC and cu in VUP_TC_CU:
        return "tc"
    return "cuda-core"


def _body(body, dtype, cc, cu, what):
    body = body or vup_bwd_body(dtype, cc, cu)
    if body not in ("tc", "cuda-core") or (
            body == "tc" and vup_bwd_body(dtype, cc, cu) != "tc"):
        raise ValueError(f"{what}: no {body!r} body for {dtype} at "
                         f"C_carry {cc}, C_up {cu}")
    return body


def upconv_stats_bwd_kernel(carry, invc, shiftc, wu, bu, ds, dq, act_c,
                            body=None):
    """Row 23: (dcarry, dinvc, dshiftc, dwu, dbu) as
    :func:`upconv_stats_bwd_plain`, on ``body`` (by default the one
    :func:`vup_bwd_body` picks; ``'cuda-core'`` runs it in either
    dtype). ``'tc'``: one kernel recomputes the upconv output y on the
    tensor cores, forms E = round(ds + 2 y dq) in shared memory, sums
    dbu from the float32 value and runs the dgrad and wgrad GEMMs on E.
    ``'cuda-core'``: one pass writes E into a scratch of y's shape in
    the activation dtype and sums dbu; the chain (K7's CUDA-core bodies
    on E) gives the rest."""
    invc_v, shiftc_v, wt, b, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "upconv_stats backward")
    body = _body(body, carry.dtype, cc, cu, "upconv_stats backward")
    dev = carry.device
    ds, dq = _stat_cts(ds, dq, cu, dev)
    if ds is None:
        ds = dq = torch.zeros(cu, dtype=torch.float32, device=dev)
    n, d, h, w = carry.shape[:4]
    dcarry = torch.empty_like(carry)
    dinvc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dshiftc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    dbu = torch.zeros(cu, dtype=torch.float32, device=dev)
    lib = _build.library()
    if body == "tc":
        wp = pack_upconv_weight(wu, carry.dtype, dev)
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_stats_bwd_tc(
                carry.data_ptr(), invc_v.data_ptr(), shiftc_v.data_ptr(),
                wp.data_ptr(), b.data_ptr(), ds.data_ptr(), dq.data_ptr(),
                dcarry.data_ptr(), dinvc.data_ptr(), dshiftc.data_ptr(),
                dwt.data_ptr(), dbu.data_ptr(), n, d, h, w, cc, cu,
                _ACT_ID[act_c], _stream(dev))
        _build.check(rc, "upconv_stats_bwd (tensor-core body)")
    else:
        e = torch.empty((n, d, 2 * h, 2 * w, cu), dtype=carry.dtype,
                        device=dev)
        db_e = torch.zeros(cu, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_stats_bwd(
                _DTYPE_ID[carry.dtype], *_carry_ptrs(carry, invc_v, shiftc_v,
                                                     wt, b),
                ds.data_ptr(), dq.data_ptr(), e.data_ptr(),
                dcarry.data_ptr(), dinvc.data_ptr(), dshiftc.data_ptr(),
                dwt.data_ptr(), dbu.data_ptr(), db_e.data_ptr(), n, d, h, w,
                cc, cu, _ACT_ID[act_c], _stream(dev))
        _build.check(rc, "upconv_stats_bwd")
    _count("upconv_stats_bwd", body)
    if invc is None:
        dinvc = dshiftc = None
    return dcarry, dinvc, dshiftc, dwt.permute(3, 4, 0, 1, 2), dbu


def _merge_args(carry, skip, inv, shift, weight, what):
    _check_cuda(skip, what)
    cin = weight.shape[1]
    dev = carry.device
    inv_v, shift_v = _vec(inv, cin, 1.0, dev), _vec(shift, cin, 0.0, dev)
    return inv_v, shift_v, weight.detach().to(device=dev,
                                              dtype=carry.dtype).float()


def conv_vup_fwd_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                        weight, bias, act, act_c, want_stats=False):
    """The vup forward on CUDA tensors: (y, s, q) as
    :func:`conv_vup_fwd_plain`."""
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup")
    inv_v, shift_v, wq = _merge_args(carry, skip, inv, shift, weight,
                                     "conv_vup")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    cout = weight.shape[0]
    wt = wq.permute(2, 3, 4, 1, 0).contiguous()
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, d, h, w, cout), dtype=carry.dtype, device=dev)
    s = q = None
    if want_stats:
        s = torch.zeros(cout, dtype=torch.float32, device=dev)
        q = torch.zeros(cout, dtype=torch.float32, device=dev)
    invs, shifts = torch.split(inv_v, [cu, cs]), torch.split(shift_v, [cu, cs])
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_vup(
            _DTYPE_ID[carry.dtype], carry.data_ptr(), cc, invc_v.data_ptr(),
            shiftc_v.data_ptr(), wt_u.data_ptr(), b_u.data_ptr(), cu,
            _ACT_ID[act_c], skip.data_ptr(), cs, invs[0].data_ptr(),
            shifts[0].data_ptr(), invs[1].data_ptr(), shifts[1].data_ptr(),
            wt.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(s), _ptr(q),
            n, d, h, w, cout, _ACT_ID[act], _stream(dev))
    _build.check(rc, "conv_vup")
    LAUNCHES["conv_vup"] += 1
    return y, s, q


# The body of K7 that the chain runs, in both dtypes: e3_conv_vup_chain
# (inside conv_vup_dgrad) and the 'cuda-core' body of e3_upconv_stats_bwd
# call K7's CUDA-core bodies (launch_upconv_bwd in csrc/upconv_bnact.cu)
# by name, whatever fused.upconv_bwd_body picks for upconv_bnact.
CHAIN_BODY = "cuda-core"


def _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, dwt,
           act_c):
    """K7's CUDA-core bodies on E (the upconv output's rounded cotangent,
    (n, d, 2 h, 2 w, C_u)) into dcarry, dinvc, dshiftc and dwt (zeroed by
    the caller); K7's sum of E goes to a scratch, as JAX sums dbu from the
    float32 cotangent instead."""
    n, d, h, w, cc = carry.shape
    cu = e.shape[-1]
    dev = carry.device
    db_e = torch.zeros(cu, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_vup_chain(
            _DTYPE_ID[carry.dtype], carry.data_ptr(), invc_v.data_ptr(),
            shiftc_v.data_ptr(), wt_u.data_ptr(), e.data_ptr(),
            dcarry.data_ptr(), dinvc.data_ptr(), dshiftc.data_ptr(),
            dwt.data_ptr(), db_e.data_ptr(), n, d, h, w, cc, cu,
            _ACT_ID[act_c], _stream(dev))
    _build.check(rc, "conv_vup_dgrad (chain)")


def vup_chain_kernel(carry, invc, shiftc, wu, e, act_c):
    """The chain alone on a given E: (dcarry, dinvc, dshiftc, dwu) as
    :func:`fused.upconv_bnact_bwd_kernel` with ``body=CHAIN_BODY`` gives
    them for the carry, E as dy and no statistics cotangent."""
    invc_v, shiftc_v, wt_u, _, cc, cu = _carry_args(
        carry, invc, shiftc, wu, torch.zeros(wu.shape[1]), "vup chain")
    _check_cuda(e, "vup chain")
    dev = carry.device
    dcarry = torch.empty_like(carry)
    dinvc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dshiftc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, dwt,
           act_c)
    return dcarry, dinvc, dshiftc, dwt.permute(3, 4, 0, 1, 2)


def conv_vup_dgrad_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                          weight, y, dy, ds, dq, act, act_c):
    """Row 9's input gradients on CUDA tensors, as
    :func:`conv_vup_dgrad_plain`: K4's vup body writes E (the upconv
    output's cotangent, rounded) into a scratch of the upconv output's
    shape in the activation dtype, with dskip, dinv and dshift; the
    chain (K7's bodies on E) gives dcarry, dinvc, dshiftc and dwu; dbu
    is ``inv0 * dshift0``, the sum of ``gm * inv0`` (K4 sums gm)."""
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup_dgrad")
    inv_v, shift_v, wq = _merge_args(carry, skip, inv, shift, weight,
                                     "conv_vup_dgrad")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    cout = weight.shape[0]
    g = _cuda_grad(dy, y, "conv_vup_dgrad")
    ds, dq = _stat_cts(ds, dq, cout, dev)
    wt = wq.flip(2, 3, 4).permute(2, 3, 4, 0, 1).contiguous()
    e = torch.empty((n, d, h, w, cu), dtype=carry.dtype, device=dev)
    dskip = torch.empty_like(skip)
    dinv = torch.zeros(cu + cs, dtype=torch.float32, device=dev)
    dshift = torch.zeros(cu + cs, dtype=torch.float32, device=dev)
    dcarry = torch.empty_like(carry)
    dinvc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dshiftc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_vup_dgrad(
            _DTYPE_ID[carry.dtype], g.data_ptr(), y.data_ptr(), _ptr(ds),
            _ptr(dq), cout, wt.data_ptr(), carry.data_ptr(), cc, invc_v.data_ptr(),
            shiftc_v.data_ptr(), wt_u.data_ptr(), b_u.data_ptr(), cu,
            _ACT_ID[act_c], skip.data_ptr(), cs, inv_v.data_ptr(),
            shift_v.data_ptr(), e.data_ptr(), dskip.data_ptr(),
            dinv.data_ptr(), dshift.data_ptr(), n, d, h, w, _ACT_ID[act],
            _stream(dev))
    _build.check(rc, "conv_vup_dgrad")
    _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, dwt,
           act_c)
    LAUNCHES["conv_vup_dgrad"] += 1
    dbu = inv_v[:cu] * dshift[:cu]
    if invc is None:
        dinvc = dshiftc = None
    if inv is None:
        dinv = dshift = None
    return (dcarry, dinvc, dshiftc, dwt.permute(3, 4, 0, 1, 2), dbu, dskip,
            dinv, dshift)


def conv_vup_wgrad_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                          weight, y, dy, ds, dq, act, act_c, body=None):
    """K5's vup body: float32 (dW, db) as :func:`conv_vup_wgrad_plain`,
    on ``body`` (by default the one :func:`vup_bwd_body` picks;
    ``'cuda-core'`` runs K5's CUDA-core body in either dtype)."""
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup_wgrad")
    inv_v, shift_v, _ = _merge_args(carry, skip, inv, shift, weight,
                                    "conv_vup_wgrad")
    body = _body(body, carry.dtype, cc, cu, "conv_vup_wgrad")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    cout = weight.shape[0]
    g = _cuda_grad(dy, y, "conv_vup_wgrad")
    ds, dq = _stat_cts(ds, dq, cout, dev)
    dwt = torch.zeros((1, 3, 3, cu + cs, cout), dtype=torch.float32,
                      device=dev)
    db = torch.zeros(cout, dtype=torch.float32, device=dev)
    lib = _build.library()
    if body == "tc":
        wp = pack_upconv_weight(wu, carry.dtype, dev)
        # K5's pre-pass scratch, where the blocks would otherwise read dy
        # and y more than twice (32-channel slices > 2 at kd = 1).
        e = torch.empty_like(g) if ds is not None and \
            -(-cu // 32) + -(-cs // 32) > 2 else None
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_wgrad_tc(
                carry.data_ptr(), cc, invc_v.data_ptr(), shiftc_v.data_ptr(),
                wp.data_ptr(), b_u.data_ptr(), cu, _ACT_ID[act_c],
                skip.data_ptr(), cs, inv_v.data_ptr(), shift_v.data_ptr(),
                g.data_ptr(), y.data_ptr(), _ptr(ds), _ptr(dq), _ptr(e),
                cout, dwt.data_ptr(), db.data_ptr(), n, d, h, w,
                _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_vup_wgrad (tensor-core body)")
    else:
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_wgrad(
                _DTYPE_ID[carry.dtype], carry.data_ptr(), cc,
                invc_v.data_ptr(), shiftc_v.data_ptr(), wt_u.data_ptr(),
                b_u.data_ptr(), cu, _ACT_ID[act_c], skip.data_ptr(), cs,
                inv_v.data_ptr(), shift_v.data_ptr(), g.data_ptr(),
                y.data_ptr(), _ptr(ds), _ptr(dq), cout, dwt.data_ptr(),
                db.data_ptr(), n, d, h, w, _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_vup_wgrad")
    _count("conv_vup_wgrad", body)
    return dwt.permute(4, 3, 0, 1, 2), db


# ---------------------------------------------------------------------------
# Autograd ops
# ---------------------------------------------------------------------------

class _ConvVup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, act_c, want_stats, reference, carry, invc, shiftc,
                wu, bu, skip, inv, shift, weight, bias):
        ctx.plain = _plain(carry, reference)
        fwd = conv_vup_fwd_plain if ctx.plain else conv_vup_fwd_kernel
        y, s, q = fwd(carry, invc, shiftc, wu, bu, skip, inv, shift, weight,
                      bias, act, act_c, want_stats)
        # The upconv output is not saved: the backward recomputes it.
        ctx.save_for_backward(carry, invc, shiftc, wu, bu, skip, inv, shift,
                              weight, y)
        ctx.act, ctx.act_c = act, act_c
        ctx.bias_dtype = bias.dtype
        ctx.set_materialize_grads(False)
        return (y, s, q) if want_stats else y

    @staticmethod
    def backward(ctx, dy, ds=None, dq=None):
        saved = ctx.saved_tensors
        carry, invc, shiftc, wu, bu, skip, inv, shift, weight, y = saved
        if ctx.plain:
            dgrad, wgrad = conv_vup_dgrad_plain, conv_vup_wgrad_plain
        else:
            dgrad, wgrad = conv_vup_dgrad_kernel, conv_vup_wgrad_kernel
        args = (*saved, dy, ds, dq, ctx.act, ctx.act_c)
        grads = [None] * 8
        if any(ctx.needs_input_grad[4:12]):
            grads = list(dgrad(*args))
            grads[3] = grads[3].to(wu.dtype)
            grads[4] = grads[4].to(bu.dtype)
        dw, db = wgrad(*args)
        return (None, None, None, None, *grads, dw.to(weight.dtype),
                db.to(ctx.bias_dtype))


class _UpconvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act_c, reference, carry, invc, shiftc, wu, bu):
        ctx.plain = _plain(carry, reference)
        fwd = upconv_stats_plain if ctx.plain else upconv_stats_kernel
        s, q = fwd(carry, invc, shiftc, wu, bu, act_c)
        ctx.save_for_backward(carry, invc, shiftc, wu, bu)
        ctx.act_c = act_c
        ctx.set_materialize_grads(False)
        return s, q

    @staticmethod
    def backward(ctx, ds, dq):
        carry, invc, shiftc, wu, bu = ctx.saved_tensors
        if ds is None and dq is None:
            return (None,) * 7
        bwd = upconv_stats_bwd_plain if ctx.plain else upconv_stats_bwd_kernel
        dcarry, dinvc, dshiftc, dwu, dbu = bwd(carry, invc, shiftc, wu, bu,
                                               ds, dq, ctx.act_c)
        return (None, None, dcarry, dinvc, dshiftc, dwu.to(wu.dtype),
                dbu.to(bu.dtype))


def conv_vup(carry: torch.Tensor, invc: Optional[torch.Tensor],
             shiftc: Optional[torch.Tensor], wu: torch.Tensor,
             bu: torch.Tensor, skip: Optional[torch.Tensor],
             inv: Optional[torch.Tensor], shift: Optional[torch.Tensor],
             weight: torch.Tensor, bias: torch.Tensor, act: str, act_c: str,
             *, want_stats: bool = False, reference: bool = False):
    """The decoder merge conv over [u, skip], u the (1, 2, 2) upconv of
    the carry, recomputed and never stored (JAX's
    ``conv_bnact_flat_vup``).

    Args:
        carry: (N, D, H/2, W/2, C_c) raw output of the deeper kernel
            level (the carry of :class:`~elektronn3_tpu_torch.ops.fused.
            FusedActs`).
        invc, shiftc: (C_c,) float32 prologue of the carry, or None.
        wu, bu: the upconv's (C_c, C_u, 1, 2, 2) torch ConvTranspose3d
            weight and (C_u,) bias; the weight is rounded to the carry's
            dtype at use, the bias is added in float32.
        skip: (N, D, H, W, C_s) the merge's second input.
        inv, shift: (C_u + C_s,) float32 prologue of the merge conv's
            inputs in concat order (u's batch norm first), or None.
        weight, bias: the merge conv's (C_out, C_u + C_s, 1, 3, 3) weight
            and (C_out,) bias, as :func:`fused.conv_bnact` takes them.
        act: the merge conv's prologue activation; act_c: the carry's.
        want_stats: also return the merge output's float32 (sum, sumsq).
        reference: run the plain versions whatever the device.
    Returns:
        (N, D, H, W, C_out) in the carry's dtype, or (y, s, q).
        Differentiable in every tensor argument.
    Raises:
        ValueError: no skip input, or shapes outside the contract.
    """
    _vup_contract(carry, wu, skip, weight)
    return _ConvVup.apply(act, act_c, want_stats, reference, carry, invc,
                          shiftc, wu, bu, skip, inv, shift, weight, bias)


def upconv_stats(carry: torch.Tensor, invc: Optional[torch.Tensor],
                 shiftc: Optional[torch.Tensor], wu: torch.Tensor,
                 bu: torch.Tensor, act: str, *, reference: bool = False):
    """Per-channel float32 (sum, sumsq) of the rounded (1, 2, 2) upconv
    of the carry (arguments as :func:`conv_vup`), without storing that
    output (JAX's ``upconv122_stats_from_flat64``). Differentiable in
    every tensor argument (row 23)."""
    _vup_contract(carry, wu, None, None)
    return _UpconvStats.apply(act, reference, carry, invc, shiftc, wu, bu)
