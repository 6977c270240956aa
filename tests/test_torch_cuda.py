"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card (marked ``cuda``; skips without a CUDA device).
Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small and ragged (odd H and W, partial tiles). Tolerances:
float32 1e-4 of the output's scale (TF32 off in the reference);
bfloat16 1e-2 of the scale plus one bfloat16 ulp of each stored value,
since the kernel and the reference sum in different orders before the
one rounding. The pool and its input gradient are exact. Sums over
voxels (statistics, dinv, dshift, dW, db) are float32 in both dtypes
and are summed in another order (atomics across blocks): 1e-3 of their
scale.
"""

import pytest
import torch

from elektronn3_tpu_torch.ops import fused


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_kernel(got, ref):
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    if bf16:
        _, e = torch.frexp(ref)
        bound = 1e-2 * scale + torch.ldexp(torch.ones_like(ref), e - 8)
    else:
        bound = 1e-4 * scale
    err = (got - ref).abs()
    assert bool(torch.all(err <= bound)), float(err.max())


def _assert_sum(got, ref, tol=1e-3):
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1e-6)
    err = float((got - ref).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol * scale, \
        (err, scale)


CONV_CASES = [
    ((1,), 1, "linear"), ((3,), 1, "linear"), ((32,), 1, "relu"),
    ((32, 32), 1, "relu"), ((32,), 3, "linear"), ((64,), 3, "leaky"),
    ((64, 64), 3, "relu")]


def _conv_case(dev, dtype, cins, kd, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(2, 5, 13, 37, c, generator=g).to(dev, dtype)
          for c in cins]
    cout = 64 if kd == 3 else 32
    w = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(sum(cins), generator=g).to(dev)
    shift = torch.randn(sum(cins), generator=g).to(dev)
    return xs, inv, shift, w, b, g


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act", CONV_CASES)
def test_cuda_conv_bnact_matches_plain(dtype, cins, kd, act, want_stats):
    """K1 as the Predictor runs it (no statistics) and as training runs
    it (``want_stats``: a separate instantiation of the kernel)."""
    dev = _cuda()
    xs, inv, shift, w, b, _ = _conv_case(dev, dtype, cins, kd)
    fused.reset_launches()
    got, s, q = fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, act,
                                            want_stats)
    assert fused.LAUNCHES["conv_bnact"] == 1
    ref, rs, rq = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act,
                                             want_stats)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    if not want_stats:
        assert s is None and q is None
        return
    # The statistics are those of the STORED output: held against the
    # plain sums of the kernel's own output, they differ only in order.
    ks, kq = fused.channel_stats(got)
    _assert_sum(s, ks)
    _assert_sum(q, kq)
    if dtype == torch.float32:
        _assert_sum(s, rs)
        _assert_sum(q, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act", CONV_CASES)
def test_cuda_conv_bnact_backward_matches_plain(dtype, cins, kd, act):
    """K4 (dx, dinv, dshift; not for the network input's C_in of 1 or
    3) and K5 (dW, db) against the plain backward, with nonzero
    statistics cotangents."""
    dev = _cuda()
    xs, inv, shift, w, b, g = _conv_case(dev, dtype, cins, kd, seed=1)
    y, _, _ = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act)
    cout = y.shape[-1]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds = torch.randn(cout, generator=g).to(dev)
    dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    args = (xs, inv, shift, w, y, dy, ds, dq, act)
    fused.reset_launches()
    if cins[0] % 32 == 0:
        dxs, dinv, dshift = fused.conv_bnact_dgrad_kernel(*args)
        rdxs, rdinv, rdshift = fused.conv_bnact_dgrad_plain(*args)
        torch.cuda.synchronize()
        for a, r in zip(dxs, rdxs):
            _assert_kernel(a, r)
        _assert_sum(dinv, rdinv)
        _assert_sum(dshift, rdshift)
    dw, db = fused.conv_bnact_wgrad_kernel(*args)
    assert fused.LAUNCHES["conv_bnact_dgrad"] == int(cins[0] % 32 == 0)
    assert fused.LAUNCHES["conv_bnact_wgrad"] == 1
    rdw, rdb = fused.conv_bnact_wgrad_plain(*args)
    torch.cuda.synchronize()
    _assert_sum(dw, rdw)
    _assert_sum(db, rdb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c", [((1, 2, 2), 32), ((2, 2, 2), 64)])
def test_cuda_pool_bnact_matches_plain(dtype, window, c):
    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 6, 10, c, generator=g).to(dev, dtype)
    inv = torch.randn(c, generator=g).to(dev)
    shift = torch.randn(c, generator=g).to(dev)
    got = fused.pool_bnact(x, inv, shift, "relu", window)
    ref = fused.pool_bnact(x, inv, shift, "relu", window, reference=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c,tie", [((1, 2, 2), 32, False),
                                          ((2, 2, 2), 64, False),
                                          ((1, 2, 2), 32, True)])
def test_cuda_pool_bnact_backward_matches_plain(dtype, window, c, tie):
    """K6: dx is exact (the same products); dinv and dshift are sums.
    ``tie`` quantizes x so windows hold exact ties, whose gradient goes
    to every tied element."""
    dev = _cuda()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 6, 10, c, generator=g)
    if tie:
        x = torch.round(2 * x) / 2
    x = x.to(dev, dtype)
    inv = torch.randn(c, generator=g).to(dev)
    shift = torch.randn(c, generator=g).to(dev)
    if tie:
        inv, shift = inv.abs() + 0.5, torch.full_like(shift, 2.0)
    pooled = (x.shape[0], x.shape[1] // window[0], 3, 5, c)
    dp = torch.randn(pooled, generator=g).to(dev, dtype)
    fused.reset_launches()
    dx, dinv, dshift = fused.pool_bnact_bwd_kernel(x, inv, shift, "relu",
                                                   window, dp)
    assert fused.LAUNCHES["pool_bnact_bwd"] == 1
    rdx, rdinv, rdshift = fused.pool_bnact_bwd_plain(x, inv, shift, "relu",
                                                     window, dp)
    torch.cuda.synchronize()
    assert torch.equal(dx, rdx)
    _assert_sum(dinv, rdinv)
    _assert_sum(dshift, rdshift)


UPCONV_CASES = [(128, 64, 2, False), (64, 32, 1, True)]


def _upconv_case(dev, dtype, cin, cout, kd, pro, seed=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, 5, 7, cin, generator=g).to(dev, dtype)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(cin, generator=g).to(dev) if pro else None
    shift = torch.randn(cin, generator=g).to(dev) if pro else None
    return x, inv, shift, w, b, ("relu" if pro else "linear"), g


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd,pro", UPCONV_CASES)
def test_cuda_upconv_bnact_matches_plain(dtype, cin, cout, kd, pro,
                                         want_stats):
    """K3 without statistics (the Predictor) and with them (training)."""
    dev = _cuda()
    x, inv, shift, w, b, act, _ = _upconv_case(dev, dtype, cin, cout, kd,
                                               pro)
    fused.reset_launches()
    got, s, q = fused.upconv_bnact_fwd_kernel(x, inv, shift, w, b, act,
                                              want_stats)
    assert fused.LAUNCHES["upconv_bnact"] == 1
    ref, rs, rq = fused.upconv_bnact_fwd_plain(x, inv, shift, w, b, act,
                                               want_stats)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    if not want_stats:
        assert s is None and q is None
        return
    ks, kq = fused.channel_stats(got)
    _assert_sum(s, ks)
    _assert_sum(q, kq)
    if dtype == torch.float32:
        _assert_sum(s, rs)
        _assert_sum(q, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd,pro", UPCONV_CASES)
def test_cuda_upconv_bnact_backward_matches_plain(dtype, cin, cout, kd,
                                                  pro):
    dev = _cuda()
    x, inv, shift, w, b, act, g = _upconv_case(dev, dtype, cin, cout, kd,
                                               pro, seed=5)
    y, _, _ = fused.upconv_bnact_fwd_plain(x, inv, shift, w, b, act)
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds = torch.randn(cout, generator=g).to(dev)
    dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    fused.reset_launches()
    args = (x, inv, shift, w, y, dy, ds, dq, act)
    dx, dinv, dshift, dw, db = fused.upconv_bnact_bwd_kernel(*args, True)
    assert fused.LAUNCHES["upconv_bnact_bwd"] == 1
    ref = fused.upconv_bnact_bwd_plain(*args, True)
    torch.cuda.synchronize()
    _assert_kernel(dx, ref[0])
    if pro:
        _assert_sum(dinv, ref[1])
        _assert_sum(dshift, ref[2])
    _assert_sum(dw, ref[3])
    _assert_sum(db, ref[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_matches_reference_forward(dtype):
    """The headline structure at a small input: every kernel launches,
    and the forward tracks forward(reference=True)."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             device=dev, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    fused.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"conv_bnact": 8, "pool_bnact": 2,
                              "upconv_bnact": 2, "conv_bnact_dgrad": 0,
                              "conv_bnact_wgrad": 0, "pool_bnact_bwd": 0,
                              "upconv_bnact_bwd": 0}
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


@pytest.mark.cuda
def test_cuda_kernels_index_past_2_31_elements():
    """Tensors of more than 2**31 elements (the L0 tensor of a batch of
    8 Predictor tiles has 2.1e9): each kernel's last outputs match the
    plain version on the last slab, so no offset wraps."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 520, 256, 256, 64, generator=g, device=dev,
                    dtype=torch.bfloat16)                 # 2.18e9 elements
    assert x.numel() > 2 ** 31
    inv = torch.randn(64, generator=g, device=dev)
    shift = torch.randn(64, generator=g, device=dev)
    w = 0.1 * torch.randn(32, 64, 1, 3, 3, generator=g, device=dev)
    b = torch.randn(32, generator=g, device=dev)
    y = fused.conv_bnact([x], inv, shift, w, b, "relu")
    ref = fused.conv_bnact([x[:, -1:]], inv, shift, w, b, "relu",
                           reference=True)
    _assert_kernel(y[:, -1:], ref)
    del y
    y = fused.pool_bnact(x, inv, shift, "relu", (2, 2, 2))
    ref = fused.pool_bnact(x[:, -2:], inv, shift, "relu", (2, 2, 2),
                           reference=True)
    assert torch.equal(y[:, -1:], ref)
    del y
    wu = 0.1 * torch.randn(64, 32, 2, 2, 2, generator=g, device=dev)
    xs = x[:, :130]                       # output: 2.18e9 elements
    y = fused.upconv_bnact(xs, inv, shift, wu, b, "relu")
    assert y.numel() > 2 ** 31
    ref = fused.upconv_bnact(xs[:, -1:], inv, shift, wu, b, "relu",
                             reference=True)
    _assert_kernel(y[:, -2:], ref)
