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
path's. Each kernel recomputes u; :func:`vup_body` picks, from (dtype,
C_carry, C_up), one body for all five entries, so a model step never
mixes two recomputes:

- ``'tc'`` (bf16 at the template cases :data:`VUP_TC_CC` x
  :data:`VUP_TC_CU`): every entry recomputes u on the tensor cores with
  ``vup_mma`` (``csrc/upconv_vup.cuh``), whose values are K3's stored
  bf16 output bit for bit:

  - ``conv_vup``: K1's tensor-core body (``csrc/conv_tc.cu``) with u's
    halo slab staged once per tile from the recompute, so y is bitwise
    K1's output over K3's u;
  - ``conv_vup_dgrad``: one kernel (``csrc/conv_vup_tc.cu``): K4's GEMM,
    the recompute, the epilogue forming E in shared memory and row 23's
    chain GEMMs on it;
  - ``conv_vup_wgrad``: K5's tensor-core body (``csrc/wgrad_tc.cu``),
    u recomputed per tile;
  - ``upconv_stats`` and ``upconv_stats_bwd`` (rows 22 and 23): one
    kernel each (``csrc/upconv_stats_bwd_tc.cu``), E of row 23 in
    shared memory;

- ``'cuda-core'`` (float32, and any other shape): ``upconv_value8``
  voxel by voxel, K3's float32 bits: K1's and K4's CUDA-core bodies
  with ``VUP`` (``csrc/conv_vup.cu``; the dgrad writes E into a scratch
  of u's shape in the activation dtype, JAX rounds E to it too, and
  ``csrc/upconv_bnact.cu``'s chain, K7's CUDA-core bodies, takes it into
  the carry), K5's with ``VUP``, and ``upconv_bnact.cu``'s passes for
  rows 22 and 23.

Each entry's wrapper takes ``body='cuda-core'`` to run that body in bf16
too (the card tests hold the two against each other).

Group and instance norm run the path in JAX's per-sample mode
(``want_stats='per_sample'``, flat_fused.py:968, flat_fused64.py:2930):
the carry's prologue ``invc``/``shiftc``, the merge's ``inv``/``shift``
and the statistics cotangents may be (N, C) rows, one a sample; the
statistics (the merge conv's, row 22's) then come as (N, C), and the
gradients of (N, C) vectors as (N, C). A launch in that mode reads every
vector as (N, C) rows by its sample stride (a (C,) one repeated), and
its per-sample sums (statistics, dinv, dshift, dinvc, dshiftc) come from
each block's partial row, summed in a fixed order by
``csrc/ps_reduce.cu``: the same bits on every run and for every batch
size. dW, db, dWu and dbu stay global. ``fused.PS_LAUNCHES`` counts those
launches.

As in ``ops/fused.py``, a CPU tensor runs the plain versions, a CUDA
tensor the kernels (which raise if they cannot launch), and
``reference=True`` the plain versions on any device; each op checks the
kernels' shape contract first, on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.ops import _build
from elektronn3_tpu_torch.ops.fused import (
    _ACT_ID, _DTYPE_ID, _bc, _check_cuda, _check_dtype, _check_per_sample,
    _count, _cuda_grad, _ns, _plain, _pro_sums, _ps, _ptr, _stat_bufs,
    _stat_cts, _stream, _vec, _want, channel_stats, conv_bnact_dgrad_gm,
    conv_bnact_fwd_plain, conv_bnact_wgrad_plain, pack_conv_weight,
    pack_dgrad_weight, pack_upconv_weight, upconv_bnact_bwd_plain,
    tape_stats, upconv_bnact_fwd_plain, PER_SAMPLE)


def _vup_contract(carry: torch.Tensor, wu: torch.Tensor,
                  skip: Optional[torch.Tensor],
                  weight: Optional[torch.Tensor],
                  invc: Optional[torch.Tensor] = None,
                  shiftc: Optional[torch.Tensor] = None,
                  inv: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  want_stats=False) -> None:
    """The kernels' shape contract: an NDHWC carry (N, D, H2, W2, C_c)
    with C_c % 32 == 0; a (C_c, C_u, 1, 2, 2) upconv weight with
    C_u % 32 == 0; for the merge conv, a skip (N, D, 2 H2, 2 W2, C_s)
    of the carry's dtype and device with C_s % 32 == 0, and a
    (C_out, C_u + C_s, 1, 3, 3) weight with C_out % 32 == 0. The
    carry's prologue ``invc``/``shiftc`` is (C_c,) or per sample
    (N, C_c), the merge's ``inv``/``shift`` (C_u + C_s,) or (N, C_u +
    C_s), as ``fused._check_per_sample`` holds them."""
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
    _check_per_sample(carry, cc, invc, shiftc,
                      want_stats if weight is None else False,
                      "vup (the carry's prologue)")
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
    _check_per_sample(skip, cin, inv, shift, want_stats,
                      "conv_vup (the merge's prologue)")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _upconv_plain(carry, invc, shiftc, wu, bu, act_c):
    return upconv_bnact_fwd_plain(carry, invc, shiftc, wu, bu, act_c)[0]


def upconv_stats_plain(carry, invc, shiftc, wu, bu, act_c, want_stats=True):
    """Plain version of row 22: the float32 (sum, sumsq) of the rounded
    upconv output, (C_u,) each, or (N, C_u) for ``want_stats`` of
    :data:`~elektronn3_tpu_torch.ops.fused.PER_SAMPLE`."""
    return channel_stats(_upconv_plain(carry, invc, shiftc, wu, bu, act_c),
                         _want_ps(want_stats))


def _want_ps(want_stats) -> bool:
    """Whether row 22's ``want_stats`` (True or PER_SAMPLE, as JAX's)
    asks for per-sample sums."""
    want, ps = _want(want_stats)
    if not want:
        raise ValueError("upconv_stats: want_stats must be True or "
                         f"{PER_SAMPLE!r}")
    return ps


def upconv_stats_bwd_plain(carry, invc, shiftc, wu, bu, ds, dq, act_c):
    """Plain version of row 23: (dcarry, dinvc, dshiftc, dwu, dbu) from
    the statistics cotangents ((C_u,) or per sample (N, C_u)): K7's
    plain backward on the recomputed output with no output cotangent
    (dinvc, dshiftc (N, C_c) for a per-sample ``invc``)."""
    y = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    return upconv_bnact_bwd_plain(carry, invc, shiftc, wu, y, None, ds, dq,
                                  act_c)


def conv_vup_fwd_plain(carry, invc, shiftc, wu, bu, skip, inv, shift,
                       weight, bias, act, act_c, want_stats=False):
    """Plain version of the vup forward: the materializing path's plain
    upconv and merge conv, composed. Returns (y, s, q), the statistics
    (N, C_out) for ``want_stats`` of PER_SAMPLE."""
    u = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    return conv_bnact_fwd_plain([u, skip], inv, shift, weight, bias, act,
                                want_stats)


def conv_vup_dgrad_plain(carry, invc, shiftc, wu, bu, skip, inv, shift,
                         weight, y, dy, ds, dq, act, act_c):
    """Plain version of the vup merge conv's input gradients, row 9's
    chain written out: (dcarry, dinvc, dshiftc, dwu, dbu, dskip, dinv,
    dshift). ``da = gm * inv0`` stays float32 into K7's plain backward,
    which sums ``dbu`` from it and rounds it (E) before the taps. Per
    sample: dinv, dshift each sample's voxels' sums for an (N, C)
    ``inv`` (``ds``/``dq`` may be (N, C_out)), dinvc, dshiftc (N, C_c)
    for an (N, C_c) ``invc``; dwu and dbu sum every sample."""
    u = _upconv_plain(carry, invc, shiftc, wu, bu, act_c)
    xs = [u, skip]
    gm = conv_bnact_dgrad_gm(xs, inv, shift, weight, y, dy, ds, dq, act)
    cu = u.shape[-1]
    x = torch.cat(xs, dim=-1)
    dinv = dshift = None
    if inv is not None:
        dinv, dshift = _pro_sums(gm, x, inv)
        gm = gm * _bc(inv, x)
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

def _rows(v, c, fill, dev, n, ps):
    """A prologue vector or statistics cotangent for a kernel: (c,) (the
    batch form; None as ``fill``), or in the per-sample mode (``ps``)
    (n, c) float32 rows, a (c,) one repeated."""
    v = _vec(v, c, fill, dev, n)
    if ps and v.dim() == 1:
        v = v.expand(n, c).contiguous()
    return v


def _as_input(g: Optional[torch.Tensor], v: Optional[torch.Tensor]):
    """The gradient of a kernel's (n, c) rows as the input ``v`` had
    them: None for None, (n, c) for a per-sample ``v``, the sum over the
    samples for a (c,) ``v`` (repeated into the rows)."""
    if v is None or g is None:
        return None
    return g if v.dim() == 2 or g.dim() == 1 else g.sum(0)


def _ws(n, parts, width, dev):
    """A per-sample reduction's workspace (``csrc/ps_reduce.cuh``)."""
    return torch.empty(_build.library().e3_ps_workspace_floats(n, parts,
                                                               width),
                       dtype=torch.float32, device=dev)


def _carry_args(carry, invc, shiftc, wu, bu, what, ps=False):
    """The carry's operands as the kernels take them: the carry, its
    prologue vectors ((C_c,), or (N, C_c) rows in the per-sample mode),
    the upconv weight as (1, 2, 2, C_c, C_u) float32 values of the
    activation dtype, the float32 bias."""
    _check_cuda(carry, what)
    dev = carry.device
    n = carry.shape[0]
    cc, cu = wu.shape[0], wu.shape[1]
    wt = wu.detach().to(device=dev, dtype=carry.dtype).float() \
        .permute(2, 3, 4, 0, 1).contiguous()
    return (_rows(invc, cc, 1.0, dev, n, ps), _rows(shiftc, cc, 0.0, dev, n,
                                                   ps), wt,
            bu.detach().to(device=dev, dtype=torch.float32).contiguous(),
            cc, cu)


def upconv_stats_kernel(carry, invc, shiftc, wu, bu, act_c, want_stats=True,
                        body=None):
    """Row 22 on a CUDA carry: (s, q) as :func:`upconv_stats_plain`, on
    ``body`` (by default :func:`vup_body`'s; ``'cuda-core'`` runs it in
    either dtype). Per sample (``want_stats`` PER_SAMPLE or an (N, C_c)
    ``invc``): each block's or group's partial rows, summed in a fixed
    order."""
    ps = _want_ps(want_stats) or _ps(invc)
    invc_v, shiftc_v, wt, b, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "upconv_stats", ps)
    body = _body(body, carry.dtype, cc, cu, "upconv_stats")
    dev = carry.device
    n, d, h, w = carry.shape[:4]
    lib = _build.library()
    s, q, ws = _stat_bufs(
        PER_SAMPLE if ps else True, n, cu, dev,
        lambda: (lib.e3_upconv_stats_tc_ps_parts if body == "tc"
                 else lib.e3_upconv_stats_ps_parts)(d, h, w))
    with torch.cuda.device(dev):
        if body == "tc":
            wp = pack_upconv_weight(wu, carry.dtype, dev)
            rc = lib.e3_upconv_stats_tc(
                carry.data_ptr(), invc_v.data_ptr(), shiftc_v.data_ptr(),
                _ns(invc_v), wp.data_ptr(), b.data_ptr(), s.data_ptr(),
                q.data_ptr(), _ptr(ws), n, d, h, w, cc, cu, _ACT_ID[act_c],
                _stream(dev))
        else:
            rc = lib.e3_upconv_stats(
                _DTYPE_ID[carry.dtype], carry.data_ptr(), invc_v.data_ptr(),
                shiftc_v.data_ptr(), _ns(invc_v), wt.data_ptr(),
                b.data_ptr(), s.data_ptr(), q.data_ptr(), _ptr(ws), n, d, h,
                w, cc, cu, _ACT_ID[act_c], _stream(dev))
    _build.check(rc, f"upconv_stats ({body} body)")
    _count("upconv_stats", body, ps)
    if ps and not _want_ps(want_stats):
        return s.sum(0), q.sum(0)
    return s, q


# The (C_carry, C_up) of the vup path's tensor-core bodies: template
# cases of csrc/conv_tc.cu's vup instantiation, csrc/conv_vup_tc.cu,
# csrc/upconv_stats_bwd_tc.cu and csrc/wgrad_tc.cu.
VUP_TC_CC = (32, 64, 96, 128)
VUP_TC_CU = (32, 64)


def vup_body(dtype: torch.dtype, cc: int, cu: int) -> str:
    """The body every vup entry runs at (dtype, C_carry, C_up): ``'tc'``
    (u recomputed on the tensor cores by ``vup_mma``, K3's stored bits;
    see the module's docstring for each entry's kernel) for bfloat16 with
    C_carry in :data:`VUP_TC_CC` and C_up in :data:`VUP_TC_CU`, else
    ``'cuda-core'`` (``upconv_value8``: float32, whose tests hold 1e-4 of
    the scale, and any other shape). One answer for all five entries, so
    a model step never mixes the two recomputes."""
    if dtype == torch.bfloat16 and cc in VUP_TC_CC and cu in VUP_TC_CU:
        return "tc"
    return "cuda-core"


def vup_tile(w: int, voxels: int) -> Tuple[int, int]:
    """(TH, TW) of an output tile of ``voxels`` (256, or 128 where K1
    takes 128 output channels a block) on a level of width ``w``, as the
    vup merge conv's tensor-core bodies take it: K1's and K4's rule (the
    tile width, 16 or 32, that wastes the fewest columns of a row; 32 on
    a tie), TH = voxels / TW. TH and TW are even, and tiles start at
    multiples of them, so a tile covers whole carry voxels: (TH / 2) x
    (TW / 2) of them, 64 at 256 voxels (row 23's tile)."""
    tw = 16 if -(-w // 16) * 16 < -(-w // 32) * 32 else 32
    return voxels // tw, tw


def conv_vup_voxels(cout: int) -> int:
    """Output voxels of a tile of ``conv_vup``'s tensor-core body: K1's
    (128 at C_out % 128 == 0, where a block takes 128 channels, else
    256)."""
    return 128 if cout % 128 == 0 else 256


# conv_vup_dgrad's tensor-core body: dx columns of a work item, and the
# output voxels of its tile.
VUP_DGRAD_COLS = 64
VUP_DGRAD_VOXELS = 256


def pack_vup_dgrad_weight(weight: torch.Tensor, dtype: torch.dtype,
                          device: torch.device) -> torch.Tensor:
    """The merge weight as ``conv_vup_dgrad``'s tensor-core body takes
    it: :func:`fused.pack_dgrad_weight`'s (kd, C_out / 16, 3, 3, C_in,
    16) with C_in padded with zeros to a multiple of
    :data:`VUP_DGRAD_COLS` (a work item's columns)."""
    cin = weight.shape[1]
    pad = -cin % VUP_DGRAD_COLS
    if pad:
        weight = F.pad(weight.detach(), (0, 0, 0, 0, 0, 0, 0, pad))
    return pack_dgrad_weight(weight, dtype, device)


def _body(body, dtype, cc, cu, what):
    body = body or vup_body(dtype, cc, cu)
    if body not in ("tc", "cuda-core") or (
            body == "tc" and vup_body(dtype, cc, cu) != "tc"):
        raise ValueError(f"{what}: no {body!r} body for {dtype} at "
                         f"C_carry {cc}, C_up {cu}")
    return body


def upconv_stats_bwd_kernel(carry, invc, shiftc, wu, bu, ds, dq, act_c,
                            body=None):
    """Row 23: (dcarry, dinvc, dshiftc, dwu, dbu) as
    :func:`upconv_stats_bwd_plain`, on ``body`` (by default the one
    :func:`vup_body` picks; ``'cuda-core'`` runs it in either
    dtype). ``'tc'``: one kernel recomputes the upconv output y on the
    tensor cores, forms E = round(ds + 2 y dq) in shared memory, sums
    dbu from the float32 value and runs the dgrad and wgrad GEMMs on E.
    ``'cuda-core'``: one pass writes E into a scratch of y's shape in
    the activation dtype and sums dbu; the chain (K7's CUDA-core bodies
    on E) gives the rest. Per sample ((N, C) ``ds``/``dq`` or ``invc``):
    dinvc, dshiftc from the partial rows, summed in a fixed order."""
    ps = _ps(invc) or _ps(ds) or _ps(dq)
    invc_v, shiftc_v, wt, b, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "upconv_stats backward", ps)
    body = _body(body, carry.dtype, cc, cu, "upconv_stats backward")
    dev = carry.device
    n, d, h, w = carry.shape[:4]
    ds, dq = _stat_cts(ds, dq, cu, dev, n)
    ds = _rows(ds, cu, 0.0, dev, n, ps)
    dq = _rows(dq, cu, 0.0, dev, n, ps)
    dcarry = torch.empty_like(carry)
    lib = _build.library()
    dinvc, dshiftc, ws = _stat_bufs(
        PER_SAMPLE if ps else True, n, cc, dev,
        lambda: (lib.e3_upconv_stats_tc_ps_parts if body == "tc"
                 else lib.e3_upconv_bnact_bwd_ps_parts)(d, h, w))
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    dbu = torch.zeros(cu, dtype=torch.float32, device=dev)
    if body == "tc":
        wp = pack_upconv_weight(wu, carry.dtype, dev)
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_stats_bwd_tc(
                carry.data_ptr(), invc_v.data_ptr(), shiftc_v.data_ptr(),
                _ns(invc_v), wp.data_ptr(), b.data_ptr(), ds.data_ptr(),
                dq.data_ptr(), _ns(ds), dcarry.data_ptr(), dinvc.data_ptr(),
                dshiftc.data_ptr(), _ptr(ws), dwt.data_ptr(),
                dbu.data_ptr(), n, d, h, w, cc, cu, _ACT_ID[act_c],
                _stream(dev))
        _build.check(rc, "upconv_stats_bwd (tensor-core body)")
    else:
        e = torch.empty((n, d, 2 * h, 2 * w, cu), dtype=carry.dtype,
                        device=dev)
        db_e = torch.zeros(cu, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.e3_upconv_stats_bwd(
                _DTYPE_ID[carry.dtype], carry.data_ptr(), invc_v.data_ptr(),
                shiftc_v.data_ptr(), _ns(invc_v), wt.data_ptr(),
                b.data_ptr(), ds.data_ptr(), dq.data_ptr(), _ns(ds),
                e.data_ptr(), dcarry.data_ptr(), dinvc.data_ptr(),
                dshiftc.data_ptr(), _ptr(ws), dwt.data_ptr(), dbu.data_ptr(),
                db_e.data_ptr(), n, d, h, w, cc, cu, _ACT_ID[act_c],
                _stream(dev))
        _build.check(rc, "upconv_stats_bwd")
    _count("upconv_stats_bwd", body, ps)
    return (dcarry, _as_input(dinvc, invc), _as_input(dshiftc, invc),
            dwt.permute(3, 4, 0, 1, 2), dbu)


def _merge_args(carry, skip, inv, shift, weight, what, ps=False):
    _check_cuda(skip, what)
    cin = weight.shape[1]
    dev = carry.device
    n = carry.shape[0]
    return (_rows(inv, cin, 1.0, dev, n, ps), _rows(shift, cin, 0.0, dev, n,
                                                   ps),
            weight.detach().to(device=dev, dtype=carry.dtype).float())


def conv_vup_fwd_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                        weight, bias, act, act_c, want_stats=False,
                        body=None):
    """The vup forward on CUDA tensors: (y, s, q) as
    :func:`conv_vup_fwd_plain`, on ``body`` (by default
    :func:`vup_body`'s; ``'cuda-core'`` runs it in either dtype). Per
    sample (an (N, C) prologue, or ``want_stats`` PER_SAMPLE): every
    prologue row by its sample stride, per-sample statistics from the
    blocks' partial rows."""
    ps = _want(want_stats)[1] or _ps(invc) or _ps(inv)
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup", ps)
    inv_v, shift_v, wq = _merge_args(carry, skip, inv, shift, weight,
                                     "conv_vup", ps)
    body = _body(body, carry.dtype, cc, cu, "conv_vup")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    cout = weight.shape[0]
    b = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, d, h, w, cout), dtype=carry.dtype, device=dev)
    lib = _build.library()
    s, q, ws = _stat_bufs(
        want_stats, n, cout, dev,
        lambda: lib.e3_conv_bnact_tc_ps_parts(d, h, w, cout)
        if body == "tc" else lib.e3_conv_bnact_ps_parts(d, h, w))
    if body == "tc":
        wup = pack_upconv_weight(wu, carry.dtype, dev)
        wp = pack_conv_weight(weight, carry.dtype, dev)
        tw = vup_tile(w, conv_vup_voxels(cout))[1]
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_tc(
                carry.data_ptr(), cc, invc_v.data_ptr(), shiftc_v.data_ptr(),
                _ns(invc_v), wup.data_ptr(), b_u.data_ptr(), cu,
                _ACT_ID[act_c], skip.data_ptr(), cs, inv_v.data_ptr(),
                shift_v.data_ptr(), _ns(inv_v), wp.data_ptr(), b.data_ptr(),
                y.data_ptr(), _ptr(s), _ptr(q), _ptr(ws), n, d, h, w, cout,
                _ACT_ID[act], tw, _stream(dev))
    else:
        wt = wq.permute(2, 3, 4, 1, 0).contiguous()
        # Input 1's vectors start cu floats in; a per-sample row is
        # cu + cs long.
        invs = torch.split(inv_v, [cu, cs], dim=-1)
        shifts = torch.split(shift_v, [cu, cs], dim=-1)
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup(
                _DTYPE_ID[carry.dtype], carry.data_ptr(), cc,
                invc_v.data_ptr(), shiftc_v.data_ptr(), _ns(invc_v),
                wt_u.data_ptr(), b_u.data_ptr(), cu, _ACT_ID[act_c],
                skip.data_ptr(), cs, invs[0].data_ptr(), shifts[0].data_ptr(),
                invs[1].data_ptr(), shifts[1].data_ptr(), _ns(inv_v),
                wt.data_ptr(), b.data_ptr(), y.data_ptr(), _ptr(s), _ptr(q),
                _ptr(ws), n, d, h, w, cout, _ACT_ID[act], _stream(dev))
    _build.check(rc, f"conv_vup ({body} body)")
    _count("conv_vup", body, ps)
    return y, s, q


# The body of K7 that the chain of the 'cuda-core' bodies runs, in both
# dtypes: e3_conv_vup_chain (inside conv_vup_dgrad) and e3_upconv_stats_bwd
# call K7's CUDA-core bodies (launch_upconv_bwd in csrc/upconv_bnact.cu)
# by name, whatever fused.upconv_bwd_body picks for upconv_bnact. (The
# 'tc' bodies run row 23's chain GEMMs, csrc/upconv_vup.cuh.)
CHAIN_BODY = "cuda-core"


def _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, ws,
           dwt, act_c):
    """K7's CUDA-core bodies on E (the upconv output's rounded cotangent,
    (n, d, 2 h, 2 w, C_u)) into dcarry, dinvc, dshiftc and dwt (zeroed by
    the caller; in the per-sample mode, (n, C_c) rows of ``invc_v`` and
    a workspace ``ws``, dinvc and dshiftc the rows of one (n, 2, C_c)
    output); K7's sum of E goes to a scratch, as JAX sums dbu from the
    float32 cotangent instead."""
    n, d, h, w, cc = carry.shape
    cu = e.shape[-1]
    dev = carry.device
    db_e = torch.zeros(cu, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.e3_conv_vup_chain(
            _DTYPE_ID[carry.dtype], carry.data_ptr(), invc_v.data_ptr(),
            shiftc_v.data_ptr(), _ns(invc_v), wt_u.data_ptr(), e.data_ptr(),
            dcarry.data_ptr(), dinvc.data_ptr(), dshiftc.data_ptr(),
            _ptr(ws), dwt.data_ptr(), db_e.data_ptr(), n, d, h, w, cc, cu,
            _ACT_ID[act_c], _stream(dev))
    _build.check(rc, "conv_vup_dgrad (chain)")


def vup_chain_kernel(carry, invc, shiftc, wu, e, act_c):
    """The chain alone on a given E: (dcarry, dinvc, dshiftc, dwu) as
    :func:`fused.upconv_bnact_bwd_kernel` with ``body=CHAIN_BODY`` gives
    them for the carry, E as dy and no statistics cotangent ((C_c,)
    prologue vectors)."""
    invc_v, shiftc_v, wt_u, _, cc, cu = _carry_args(
        carry, invc, shiftc, wu, torch.zeros(wu.shape[1]), "vup chain")
    _check_cuda(e, "vup chain")
    dev = carry.device
    dcarry = torch.empty_like(carry)
    dinvc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dshiftc = torch.zeros(cc, dtype=torch.float32, device=dev)
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, None,
           dwt, act_c)
    return dcarry, dinvc, dshiftc, dwt.permute(3, 4, 0, 1, 2)


def _vup_bwd_ps(invc, inv, ds, dq) -> bool:
    """Whether a vup backward launch is in the per-sample mode: an (N, C)
    prologue (the carry's or the merge's) or (N, C) statistics
    cotangents."""
    return _ps(invc) or _ps(inv) or _ps(ds) or _ps(dq)


def conv_vup_dgrad_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                          weight, y, dy, ds, dq, act, act_c, body=None):
    """Row 9's input gradients on CUDA tensors, as
    :func:`conv_vup_dgrad_plain`, on ``body`` (by default
    :func:`vup_body`'s; ``'cuda-core'`` runs it in either dtype).
    ``'tc'``: one kernel (``csrc/conv_vup_tc.cu``) runs K4's GEMM,
    recomputes u, forms E (the upconv output's cotangent, rounded) in
    shared memory with dskip, dinv and dshift, and chains E into dcarry,
    dinvc, dshiftc and dwu. ``'cuda-core'``: K4's vup body writes E into
    a scratch of the upconv output's shape in the activation dtype, and
    the chain (K7's CUDA-core bodies on E) gives the rest. Both: dbu is
    ``inv0 * dshift0``, the sum of ``gm * inv0`` (the kernels sum gm),
    summed over the samples in the per-sample mode, where dinv, dshift,
    dinvc and dshiftc come per sample from the partial rows."""
    ps = _vup_bwd_ps(invc, inv, ds, dq)
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup_dgrad", ps)
    inv_v, shift_v, wq = _merge_args(carry, skip, inv, shift, weight,
                                     "conv_vup_dgrad", ps)
    body = _body(body, carry.dtype, cc, cu, "conv_vup_dgrad")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    h2, w2 = carry.shape[2:4]
    cout = weight.shape[0]
    g = _cuda_grad(dy, y, "conv_vup_dgrad")
    ds, dq = _stat_cts(ds, dq, cout, dev, n)
    if ps and ds is not None:
        ds = _rows(ds, cout, 0.0, dev, n, True)
        dq = _rows(dq, cout, 0.0, dev, n, True)
    dskip = torch.empty_like(skip)
    dcarry = torch.empty_like(carry)
    dwt = torch.zeros((1, 2, 2, cc, cu), dtype=torch.float32, device=dev)
    lib = _build.library()
    mode = PER_SAMPLE if ps else True
    if body == "tc":
        parts = lambda: lib.e3_conv_vup_dgrad_tc_ps_parts(d, h, w)
        dinv, dshift, ws = _stat_bufs(mode, n, cu + cs, dev, parts)
        dinvc, dshiftc, wsc = _stat_bufs(mode, n, cc, dev, parts)
        if ds is None:   # the kernel always folds: zeros give dy_tot = dy
            ds = dq = _rows(None, cout, 0.0, dev, n, ps)
        wp = pack_vup_dgrad_weight(weight, carry.dtype, dev)
        wup = pack_upconv_weight(wu, carry.dtype, dev)
        tw = vup_tile(w, VUP_DGRAD_VOXELS)[1]
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_dgrad_tc(
                g.data_ptr(), y.data_ptr(), ds.data_ptr(), dq.data_ptr(),
                _ns(ds), cout, wp.data_ptr(), carry.data_ptr(), cc,
                invc_v.data_ptr(), shiftc_v.data_ptr(), _ns(invc_v),
                wup.data_ptr(), b_u.data_ptr(), cu, _ACT_ID[act_c],
                skip.data_ptr(), cs, inv_v.data_ptr(), shift_v.data_ptr(),
                _ns(inv_v), dcarry.data_ptr(), dinvc.data_ptr(),
                dshiftc.data_ptr(), _ptr(wsc), dwt.data_ptr(),
                dskip.data_ptr(), dinv.data_ptr(), dshift.data_ptr(),
                _ptr(ws), n, d, h, w, _ACT_ID[act], tw, _stream(dev))
        _build.check(rc, "conv_vup_dgrad (tc body)")
    else:
        dinv, dshift, ws = _stat_bufs(
            mode, n, cu + cs, dev,
            lambda: lib.e3_conv_bnact_ps_parts(d, h, w))
        dinvc, dshiftc, wsc = _stat_bufs(
            mode, n, cc, dev,
            lambda: lib.e3_upconv_bnact_bwd_ps_parts(d, h2, w2))
        wt = wq.flip(2, 3, 4).permute(2, 3, 4, 0, 1).contiguous()
        e = torch.empty((n, d, h, w, cu), dtype=carry.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_dgrad(
                _DTYPE_ID[carry.dtype], g.data_ptr(), y.data_ptr(),
                _ptr(ds), _ptr(dq), _ns(ds), cout,
                wt.data_ptr(), carry.data_ptr(), cc, invc_v.data_ptr(),
                shiftc_v.data_ptr(), _ns(invc_v), wt_u.data_ptr(),
                b_u.data_ptr(), cu, _ACT_ID[act_c], skip.data_ptr(), cs,
                inv_v.data_ptr(), shift_v.data_ptr(), _ns(inv_v),
                e.data_ptr(), dskip.data_ptr(), dinv.data_ptr(),
                dshift.data_ptr(), _ptr(ws), n, d, h, w, _ACT_ID[act],
                _stream(dev))
        _build.check(rc, "conv_vup_dgrad (cuda-core body)")
        _chain(carry, invc_v, shiftc_v, wt_u, e, dcarry, dinvc, dshiftc, wsc,
               dwt, act_c)
        del e
    _count("conv_vup_dgrad", body, ps)
    dbu = inv_v[..., :cu] * dshift[..., :cu]
    if ps:
        dbu = dbu.sum(0)
    return (dcarry, _as_input(dinvc, invc), _as_input(dshiftc, invc),
            dwt.permute(3, 4, 0, 1, 2), dbu, dskip, _as_input(dinv, inv),
            _as_input(dshift, inv))


def conv_vup_wgrad_kernel(carry, invc, shiftc, wu, bu, skip, inv, shift,
                          weight, y, dy, ds, dq, act, act_c, body=None):
    """K5's vup body: float32 (dW, db) as :func:`conv_vup_wgrad_plain`,
    on ``body`` (by default the one :func:`vup_body` picks;
    ``'cuda-core'`` runs K5's CUDA-core body in either dtype); per
    sample, the rows by their sample strides on instantiations of their
    own."""
    ps = _vup_bwd_ps(invc, inv, ds, dq)
    invc_v, shiftc_v, wt_u, b_u, cc, cu = _carry_args(
        carry, invc, shiftc, wu, bu, "conv_vup_wgrad", ps)
    inv_v, shift_v, _ = _merge_args(carry, skip, inv, shift, weight,
                                    "conv_vup_wgrad", ps)
    body = _body(body, carry.dtype, cc, cu, "conv_vup_wgrad")
    dev = carry.device
    n, d, h, w, cs = skip.shape
    cout = weight.shape[0]
    g = _cuda_grad(dy, y, "conv_vup_wgrad")
    ds, dq = _stat_cts(ds, dq, cout, dev, n)
    st_ns = 0
    if ps and ds is not None:
        ds = _rows(ds, cout, 0.0, dev, n, True)
        dq = _rows(dq, cout, 0.0, dev, n, True)
        st_ns = cout
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
                _ns(invc_v), wp.data_ptr(), b_u.data_ptr(), cu,
                _ACT_ID[act_c], skip.data_ptr(), cs, inv_v.data_ptr(),
                shift_v.data_ptr(), _ns(inv_v), g.data_ptr(), y.data_ptr(),
                _ptr(ds), _ptr(dq), st_ns, _ptr(e), cout, dwt.data_ptr(),
                db.data_ptr(), n, d, h, w, _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_vup_wgrad (tensor-core body)")
    else:
        with torch.cuda.device(dev):
            rc = lib.e3_conv_vup_wgrad(
                _DTYPE_ID[carry.dtype], carry.data_ptr(), cc,
                invc_v.data_ptr(), shiftc_v.data_ptr(), _ns(invc_v),
                wt_u.data_ptr(), b_u.data_ptr(), cu, _ACT_ID[act_c],
                skip.data_ptr(), cs, inv_v.data_ptr(), shift_v.data_ptr(),
                _ns(inv_v), g.data_ptr(), y.data_ptr(), _ptr(ds), _ptr(dq),
                st_ns, cout, dwt.data_ptr(), db.data_ptr(), n, d, h, w,
                _ACT_ID[act], _stream(dev))
        _build.check(rc, "conv_vup_wgrad")
    _count("conv_vup_wgrad", body, ps)
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
        tape_stats(s, q)
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
    def forward(ctx, act_c, want_stats, reference, carry, invc, shiftc, wu,
                bu):
        ctx.plain = _plain(carry, reference)
        fwd = upconv_stats_plain if ctx.plain else upconv_stats_kernel
        s, q = fwd(carry, invc, shiftc, wu, bu, act_c, want_stats)
        tape_stats(s, q)
        ctx.save_for_backward(carry, invc, shiftc, wu, bu)
        ctx.act_c = act_c
        ctx.set_materialize_grads(False)
        return s, q

    @staticmethod
    def backward(ctx, ds, dq):
        carry, invc, shiftc, wu, bu = ctx.saved_tensors
        if ds is None and dq is None:
            return (None,) * 8
        bwd = upconv_stats_bwd_plain if ctx.plain else upconv_stats_bwd_kernel
        dcarry, dinvc, dshiftc, dwu, dbu = bwd(carry, invc, shiftc, wu, bu,
                                               ds, dq, ctx.act_c)
        return (None, None, None, dcarry, dinvc, dshiftc, dwu.to(wu.dtype),
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
        invc, shiftc: (C_c,) float32 prologue of the carry, per sample
            (N, C_c), or None.
        wu, bu: the upconv's (C_c, C_u, 1, 2, 2) torch ConvTranspose3d
            weight and (C_u,) bias; the weight is rounded to the carry's
            dtype at use, the bias is added in float32.
        skip: (N, D, H, W, C_s) the merge's second input.
        inv, shift: (C_u + C_s,) float32 prologue of the merge conv's
            inputs in concat order (u's norm first), per sample
            (N, C_u + C_s), or None.
        weight, bias: the merge conv's (C_out, C_u + C_s, 1, 3, 3) weight
            and (C_out,) bias, as :func:`fused.conv_bnact` takes them.
        act: the merge conv's prologue activation; act_c: the carry's.
        want_stats: also return the merge output's float32 (sum, sumsq):
            True for (C_out,) each, PER_SAMPLE for (N, C_out).
        reference: run the plain versions whatever the device.
    Returns:
        (N, D, H, W, C_out) in the carry's dtype, or (y, s, q).
        Differentiable in every tensor argument, in the per-sample mode
        too (the gradients of (N, C) vectors are (N, C)).
    Raises:
        ValueError: no skip input, or shapes outside the contract.
    """
    _vup_contract(carry, wu, skip, weight, invc, shiftc, inv, shift,
                  want_stats)
    return _ConvVup.apply(act, act_c, want_stats, reference, carry, invc,
                          shiftc, wu, bu, skip, inv, shift, weight, bias)


def upconv_stats(carry: torch.Tensor, invc: Optional[torch.Tensor],
                 shiftc: Optional[torch.Tensor], wu: torch.Tensor,
                 bu: torch.Tensor, act: str, *, want_stats=True,
                 reference: bool = False):
    """Per-channel float32 (sum, sumsq) of the rounded (1, 2, 2) upconv
    of the carry (arguments as :func:`conv_vup`), without storing that
    output (JAX's ``upconv122_stats_from_flat64``): (C_u,) each, or with
    ``want_stats`` PER_SAMPLE (N, C_u), each sample's. Differentiable in
    every tensor argument (row 23)."""
    _vup_contract(carry, wu, None, None, invc, shiftc, want_stats=want_stats)
    _want_ps(want_stats)
    return _UpconvStats.apply(act, want_stats, reference, carry, invc,
                              shiftc, wu, bu)
