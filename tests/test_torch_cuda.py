"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card (marked ``cuda``; skips without a CUDA device):
K1-K7 (``ops/fused.py``; K1's and K3's bf16 tensor-core bodies also at
their own ragged cases), the 'batchp' batch norm's K8-K11
(``ops/pallas_bn.py``), the flat executor's ``flat_conv3`` and
``conv_direct`` (``ops/flat_conv.py``, ``ops/pallas_conv.py``: K1, K4
and K5 without a prologue), and the vup path's five entries
(``ops/vup.py``: rows 1's vup mode, 9, 22 and 23).
Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small and ragged (odd H and W, partial tiles); the 2D
model's shapes run on the D=1 view (N * D = N). Tolerances:
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

from elektronn3_tpu_torch.ops import fused, pallas_bn


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The 'batchp' kernels K8-K11 launch on no 'batch' model's path.
# The vup path's kernels launch only where a model has vup=True.
_NO_VUP = {"conv_vup": 0, "conv_vup_dgrad": 0, "conv_vup_wgrad": 0,
           "upconv_stats": 0, "upconv_stats_bwd": 0}
_NO_BN = {"bn_stats": 0, "bn_normalize": 0, "bn_bwd_reduce": 0,
          "bn_bwd_dx": 0}


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


# K8's and K10's float32 sums: within this share of max|ref| (summing
# order alone; a dropped ragged block of rows moves them by far more).
BN_SUM_TOL = 1e-5


def _assert_sum(got, ref, tol=1e-3):
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1e-6)
    err = float((got - ref).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol * scale, \
        (err, scale)


# (input channels, kd, activation, C_out, (N, D)): the 3D levels'
# convs, then the 2D model's L1 convs (32->64, 64->64, the 64+64 merge)
# at kd=1 on a batch of 8 D=1 planes, then a C=128 level's (64->128,
# 128->128 and the 128+128 merge at kd=3; the planar 128+128 merge).
CONV_CASES = [
    ((1,), 1, "linear", 32, (2, 5)), ((3,), 1, "linear", 32, (2, 5)),
    ((32,), 1, "relu", 32, (2, 5)), ((32, 32), 1, "relu", 32, (2, 5)),
    ((32,), 3, "linear", 64, (2, 5)), ((64,), 3, "leaky", 64, (2, 5)),
    ((64, 64), 3, "relu", 64, (2, 5)),
    ((32,), 1, "relu", 64, (8, 1)), ((64,), 1, "leaky", 64, (8, 1)),
    ((64, 64), 1, "relu", 64, (8, 1)),
    ((64,), 3, "linear", 128, (2, 4)), ((128,), 3, "leaky", 128, (2, 4)),
    ((128, 128), 3, "relu", 128, (2, 3)), ((128, 128), 1, "relu", 128,
                                           (2, 3))]


def _conv_case(dev, dtype, cins, kd, cout, nd, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(*nd, 13, 37, c, generator=g).to(dev, dtype)
          for c in cins]
    w = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(sum(cins), generator=g).to(dev)
    shift = torch.randn(sum(cins), generator=g).to(dev)
    return xs, inv, shift, w, b, g


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act,cout,nd", CONV_CASES)
def test_cuda_conv_bnact_matches_plain(dtype, cins, kd, act, cout, nd,
                                       want_stats):
    """K1 as the Predictor runs it (no statistics) and as training runs
    it (``want_stats``: a separate instantiation of the kernel)."""
    dev = _cuda()
    xs, inv, shift, w, b, _ = _conv_case(dev, dtype, cins, kd, cout, nd)
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
@pytest.mark.parametrize("cins,kd,act,cout,nd", CONV_CASES)
def test_cuda_conv_bnact_backward_matches_plain(dtype, cins, kd, act, cout,
                                                nd):
    """K4 (dx, dinv, dshift; not for the network input's C_in of 1 or
    3) and K5 (dW, db) against the plain backward, with nonzero
    statistics cotangents."""
    dev = _cuda()
    xs, inv, shift, w, b, g = _conv_case(dev, dtype, cins, kd, cout, nd,
                                         seed=1)
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
@pytest.mark.parametrize("window,c,nd", [
    ((1, 2, 2), 32, (2, 4)), ((2, 2, 2), 64, (2, 4)),
    ((1, 2, 2), 64, (8, 1)), ((1, 2, 2), 128, (8, 1)),
    ((2, 2, 2), 128, (2, 4))])
def test_cuda_pool_bnact_matches_plain(dtype, window, c, nd):
    """K2; (1, 2, 2) at C=64 and 128 on D=1 planes is row 16 (the 2D
    model's L1 pool) and its C=128 form."""
    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*nd, 6, 10, c, generator=g).to(dev, dtype)
    inv = torch.randn(c, generator=g).to(dev)
    shift = torch.randn(c, generator=g).to(dev)
    got = fused.pool_bnact(x, inv, shift, "relu", window)
    ref = fused.pool_bnact(x, inv, shift, "relu", window, reference=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c,tie,nd", [
    ((1, 2, 2), 32, False, (2, 4)), ((2, 2, 2), 64, False, (2, 4)),
    ((1, 2, 2), 32, True, (2, 4)), ((1, 2, 2), 64, False, (8, 1)),
    ((1, 2, 2), 128, False, (8, 1)), ((1, 2, 2), 128, True, (8, 1)),
    ((2, 2, 2), 128, False, (2, 4)), ((2, 2, 2), 128, True, (2, 4))])
def test_cuda_pool_bnact_backward_matches_plain(dtype, window, c, tie, nd):
    """K6: dx is exact (the same products); dinv and dshift are sums.
    ``tie`` quantizes x so windows hold exact ties, whose gradient goes
    to every tied element. At C=128 a block sums 16 channel groups."""
    dev = _cuda()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(*nd, 6, 10, c, generator=g)
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


# (C_in, C_out, kd, prologue, (N, D)): the 3D levels' upconvs, then
# the (1, 2, 2) upconv from a dense input on D=1 planes: 128->64 is row
# 19 (the 2D model's up_1), 256->128 its C=128 form; then the carried
# C=128 and C=256 activations with their prologue, both depths (row 24:
# 128->64; 256->128 the sf=64 up_1 from dense, here with a prologue).
UPCONV_CASES = [(128, 64, 2, False, (2, 3)), (64, 32, 1, True, (2, 3)),
                (128, 64, 1, False, (8, 1)), (256, 128, 1, False, (8, 1)),
                (128, 64, 1, True, (2, 3)), (128, 64, 2, True, (2, 3)),
                (256, 128, 1, True, (2, 3)), (256, 128, 2, True, (2, 3)),
                (256, 128, 2, False, (2, 3))]


def _upconv_case(dev, dtype, cin, cout, kd, pro, nd, seed=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*nd, 5, 7, cin, generator=g).to(dev, dtype)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(cin, generator=g).to(dev) if pro else None
    shift = torch.randn(cin, generator=g).to(dev) if pro else None
    return x, inv, shift, w, b, ("relu" if pro else "linear"), g


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd,pro,nd", UPCONV_CASES)
def test_cuda_upconv_bnact_matches_plain(dtype, cin, cout, kd, pro, nd,
                                         want_stats):
    """K3 without statistics (the Predictor) and with them (training)."""
    dev = _cuda()
    x, inv, shift, w, b, act, _ = _upconv_case(dev, dtype, cin, cout, kd,
                                               pro, nd)
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
@pytest.mark.parametrize("cin,cout,kd,pro,nd", UPCONV_CASES)
def test_cuda_upconv_bnact_backward_matches_plain(dtype, cin, cout, kd,
                                                  pro, nd):
    dev = _cuda()
    x, inv, shift, w, b, act, g = _upconv_case(dev, dtype, cin, cout, kd,
                                               pro, nd, seed=5)
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
                              "upconv_bnact_bwd": 0, **_NO_BN,
                              **_NO_VUP}
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_2d_matches_reference_forward(dtype):
    """The 2D model of train_simple2d.py at a small, ragged input: L0
    and L1 run the kernels on the D=1 view (L1's pool is row 16, the
    up_1 upconv from L2's dense output row 19), and the forward tracks
    forward(reference=True)."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, dim=2, dtype=dtype, device=dev,
             generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(3, 44, 76, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    fused.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {
        "conv_bnact": 8, "pool_bnact": 2, "upconv_bnact": 2,
        "conv_bnact_dgrad": 0, "conv_bnact_wgrad": 0, "pool_bnact_bwd": 0,
        "upconv_bnact_bwd": 0, **_NO_BN, **_NO_VUP}
    ref = m(x, reference=True)
    assert y.shape == (3, 44, 76, 2)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


@pytest.mark.cuda
def test_cuda_unet_defaults_to_the_card():
    """``UNet()`` with no device builds on the card, and the Predictor,
    which follows the model, predicts there through the kernels."""
    import numpy as np
    from elektronn3_tpu_torch.inference import Predictor
    from elektronn3_tpu_torch.models import UNet
    _cuda()
    m = UNet(dim=2)
    assert all(p.device.type == "cuda" for p in m.parameters())
    pred = Predictor(m)
    assert pred.device.type == "cuda"
    fused.reset_launches()
    out = pred.predict(np.zeros((1, 1, 32, 48), np.float32))
    assert out.shape == (1, 2, 32, 48)
    assert fused.LAUNCHES["conv_bnact"] > 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_sf64_matches_reference_forward(dtype):
    """The start_filts=64 model with ``pallas_flat=True`` at a small,
    ragged input: L0 (C=64, planar) and L1 (C=128) run the kernels, up_2
    takes the carried C=128 activation (row 24, kd=1), and the forward
    tracks forward(reference=True)."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=64, planar_blocks=(0,), dtype=dtype,
             device=dev, pallas_flat=True,
             generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    assert m.plan(x.shape) == [True, True, False, False]
    fused.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["conv_bnact"] == 8
    assert fused.LAUNCHES["upconv_bnact"] == 2
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


# (C, R): every channel count of the headline models' levels, at R
# under one reduction block, ragged across blocks, and past 1024 blocks'
# worth of minimum rows (so each block reads more than its minimum).
BN_CASES = [(c, r) for c in (32, 64, 128, 256, 512)
            for r in (5, 1059, 300_001)]


def _bn_case(dev, dtype, c, r, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = (3.0 + 2.0 * torch.randn(r, c, generator=g)).to(dev, dtype)
    gy = torch.randn(r, c, generator=g).to(dev, dtype)
    gamma = torch.randn(c, generator=g).to(dev)
    beta = torch.randn(c, generator=g).to(dev)
    return x, gy, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,r", BN_CASES)
def test_cuda_batch_norm_kernels_match_plain(dtype, c, r):
    """K8 (sums) and K10 (sums) against their plain versions on the same
    operands within BN_SUM_TOL, K9 and K11 (one rounding of the same
    float32 values, from the op's own glue) as _assert_kernel, each
    launched once."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, c, r)
    fused.reset_launches()
    sums = pallas_bn.bn_stats_kernel(x)
    for got, ref in zip(sums, pallas_bn.bn_stats_plain(x)):
        _assert_sum(got, ref, BN_SUM_TOL)
    mean, _, inv, scale, shift = pallas_bn.fold_forward(sums, r, gamma, beta,
                                                        1e-5)
    _assert_kernel(pallas_bn.bn_normalize_kernel(x, scale, shift),
                   pallas_bn.bn_normalize_plain(x, scale, shift))
    red = pallas_bn.bn_bwd_reduce_kernel(gy, x, mean, inv)
    for got, ref in zip(red, pallas_bn.bn_bwd_reduce_plain(gy, x, mean, inv)):
        _assert_sum(got, ref, BN_SUM_TOL)
    abc = pallas_bn.fold_backward(red, r, gamma, mean, inv)
    _assert_kernel(pallas_bn.bn_bwd_dx_kernel(gy, x, *abc),
                   pallas_bn.bn_bwd_dx_plain(gy, x, *abc))
    torch.cuda.synchronize()
    assert {k: fused.LAUNCHES[k] for k in _NO_BN} == dict.fromkeys(_NO_BN, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batch_norm_sums_are_the_same_bits_on_a_rerun(dtype):
    """K8 and K10 reduce in a fixed order without atomics."""
    dev = _cuda()
    x, gy, gamma, _ = _bn_case(dev, dtype, 64, 681_472 + 37)
    mean, inv = x.float().mean(0), torch.rsqrt(x.float().var(0) + 1e-5)
    for fn, args in ((pallas_bn.bn_stats_kernel, (x,)),
                     (pallas_bn.bn_bwd_reduce_kernel, (gy, x, mean, inv))):
        first = fn(*args)
        for _ in range(3):
            assert torch.equal(fn(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batch_norm_ops_match_reference(dtype):
    """The autograd op (K8, K9 forward; K10, K11 backward) and the eval
    op (K9) on a 5-D channels-last tensor against reference=True: the
    mean and dgamma, dbeta (K8's and K10's sums, scaled) within
    BN_SUM_TOL, the variance (E[x^2] - mean^2 cancels) within 1e-4."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, 128, 2 * 11 * 13 * 7)
    x, gy = x.view(2, 11, 13, 7, 128), gy.view(2, 11, 13, 7, 128)
    outs = []
    for reference in (False, True):
        xr, gr, br = (t.clone().requires_grad_(True) for t in (x, gamma,
                                                              beta))
        y, mean, var = pallas_bn.batch_norm_train(xr, gr, br,
                                                  reference=reference)
        y.backward(gy)
        ye = pallas_bn.batch_norm_inference(x, gamma, beta, mean, var,
                                            reference=reference)
        outs.append((y, mean, var, xr.grad, gr.grad, br.grad, ye))
    for i, (got, ref) in enumerate(zip(*outs)):
        if i in (1, 4, 5):
            _assert_sum(got, ref, BN_SUM_TOL)
        elif i == 2:
            _assert_sum(got, ref, 1e-4)
        else:
            _assert_kernel(got, ref)


def _step_grads(m, x, t, reference):
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    m.zero_grad(set_to_none=True)
    loss = CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                                  for n, p in m.named_parameters()}


def _check_step_against_reference(m, x, t, dtype):
    """One training step's loss and every gradient leaf against the same
    step through reference=True, as chip_smoke.py's check_train_step
    holds them, in the L2 norm: |g - r| <= rel |r| + 3 |r' - r|, r' the
    reference step on an input moved by about one ulp (the step's own
    rounding noise; a fixed relative bound alone does not hold even for
    the 'batch' model's K1-K7, whose weight gradients are small
    differences of large float32 sums); the bias of a conv that feeds a
    batch norm, whose exact gradient is 0, within ``zero`` of its weight
    gradient's norm. Returns the kernels' step's launch counts."""
    bf16 = dtype == torch.bfloat16
    tol = 5e-2 if bf16 else 1e-4
    rel, ulp, zero = (1e-2, 2.0 ** -8, 1e-2) if bf16 else \
        (1e-3, 2.0 ** -23, 1e-4)
    fused.reset_launches()
    lk, grads = _step_grads(m, x, t, False)
    launches = dict(fused.LAUNCHES)
    lr, ref = _step_grads(m, x, t, True)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    _, moved = _step_grads(m, x * (1 + ulp * noise.to(x.device)), t, True)
    assert abs(lk - lr) <= tol * abs(lr)
    bad = []
    for name, g in grads.items():
        r = ref[name]
        if not bool(torch.isfinite(g).all()):
            bad.append((name, "not finite"))
        elif name.endswith(".bias") and "norm" not in name \
                and name != "conv_final.bias":
            wnorm = float(ref[name[:-len("bias")] + "weight"].norm())
            q = max(float(g.norm()), float(r.norm())) / wnorm
            if q > zero:
                bad.append((name, "bias", q))
        else:
            err = float((g - r).norm())
            bnd = rel * float(r.norm()) + 3 * float((moved[name] - r).norm())
            if err > bnd:
                bad.append((name, err, bnd))
    assert not bad, bad
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_batchp_matches_reference(dtype):
    """The headline structure with 'batchp' at a small, ragged input: its
    library levels (L2, L3, up_0) run K8-K11 in training and K9 in eval,
    and the training loss, every gradient leaf and the eval forward
    track reference=True (``_check_step_against_reference``)."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             normalization="batchp", device=dev,
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    t = (x[..., 0] > 0).long()
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    launches = _check_step_against_reference(m, x, t, dtype)
    assert all(launches[k] == 7 for k in _NO_BN)
    m.eval()
    fused.reset_launches()
    y = m(x)
    assert fused.LAUNCHES["bn_normalize"] == 7
    ref = m(x, reference=True)
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


# ---------------------------------------------------------------------------
# The flat executor (rows 26/27 on K1/K4/K5), row 28 and N * D > 65535
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,cout", [
    ((32,), 1, 32), ((32, 32), 1, 32), ((64,), 1, 64), ((64, 64), 1, 64),
    ((32,), 3, 64)])
def test_cuda_flat_conv3_matches_plain(dtype, cins, kd, cout):
    """``flat_conv3`` with statistics and its backward (K1 with the
    identity prologue, K4, K5) against ``reference=True``, from float32
    parameters that both round to the dtype; nonzero statistics
    cotangents."""
    from elektronn3_tpu_torch.ops import flat_conv
    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    xs0 = [torch.randn(2, 3, 13, 38, c, generator=g).to(dev, dtype)
           for c in cins]
    w0 = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    b0 = torch.randn(cout, generator=g).to(dev)
    dy = (0.1 * torch.randn(2, 3, 13, 38, cout, generator=g)).to(dev, dtype)
    ds = torch.randn(cout, generator=g).to(dev)
    dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    outs = []
    for reference in (False, True):
        xs = [x.clone().requires_grad_(True) for x in xs0]
        w = w0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        fused.reset_launches()
        y, s, q = flat_conv.flat_conv3(xs, w, b, want_stats=True,
                                       reference=reference)
        torch.autograd.backward((y, s, q), (dy, ds, dq))
        torch.cuda.synchronize()
        n = 0 if reference else 1
        assert (fused.LAUNCHES["conv_bnact"], fused.LAUNCHES[
            "conv_bnact_dgrad"], fused.LAUNCHES["conv_bnact_wgrad"]) == \
            (n, n, n)
        outs.append((y, s, q, [x.grad for x in xs], w.grad, b.grad))
    (y, s, q, dxs, dw, db), (ry, rs, rq, rdxs, rdw, rdb) = outs
    _assert_kernel(y, ry)
    _assert_sum(s, rs, 1e-3 if dtype == torch.float32 else 1e-2)
    _assert_sum(q, rq, 1e-3 if dtype == torch.float32 else 1e-2)
    for a, r in zip(dxs, rdxs):
        _assert_kernel(a, r)
    if dtype == torch.bfloat16:         # dW and db come back bf16-rounded
        _assert_kernel(dw.to(dtype), rdw.to(dtype))
        _assert_kernel(db.to(dtype), rdb.to(dtype))
    else:
        _assert_sum(dw, rdw)
        _assert_sum(db, rdb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planar,cin,cout", [(True, 32, 32), (True, 64, 32),
                                             (False, 64, 64),
                                             (False, 128, 64)])
def test_cuda_conv_direct_matches_plain(dtype, planar, cin, cout):
    """Row 28: K1 with a zero bias, kd 1 (planar) and 3."""
    from elektronn3_tpu_torch.ops import pallas_conv
    dev = _cuda()
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 5, 13, 37, cin, generator=g).to(dev, dtype)
    kd = 1 if planar else 3
    w = (0.1 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    fused.reset_launches()
    y = pallas_conv.conv_direct(x, w, planar)
    assert fused.LAUNCHES["conv_bnact"] == 1
    ref = pallas_conv.conv_direct(x, w, planar, reference=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    _assert_kernel(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_past_65535_depth_slabs(dtype):
    """K1 and K4 at N * D = 65,536 (grid.x walks the slabs): the forward
    and the input gradient against their plain versions."""
    dev = _cuda()
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(2, 32768, 4, 8, 32, generator=g).to(dev, dtype)]
    w = (0.1 * torch.randn(32, 32, 1, 3, 3, generator=g)).to(dev)
    b = torch.randn(32, generator=g).to(dev)
    inv = torch.randn(32, generator=g).to(dev)
    shift = torch.randn(32, generator=g).to(dev)
    y, _, _ = fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, "relu",
                                          False)
    ref, _, _ = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, "relu")
    torch.cuda.synchronize()
    _assert_kernel(y, ref)
    dy = (0.1 * torch.randn(ref.shape, generator=g)).to(dev, dtype)
    args = (xs, inv, shift, w, ref, dy, None, None, "relu")
    dxs, dinv, dshift = fused.conv_bnact_dgrad_kernel(*args)
    rdxs, rdinv, rdshift = fused.conv_bnact_dgrad_plain(*args)
    torch.cuda.synchronize()
    _assert_kernel(dxs[0], rdxs[0])
    _assert_sum(dinv, rdinv)
    _assert_sum(dshift, rdshift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_silu_flat_matches_reference(dtype):
    """The headline structure with ``activation='silu'`` and
    ``pallas_flat=True``: L0 and its decoder level are flat, so a step
    launches K1, K4 and K5 three times each and nothing else of K1-K7,
    and tracks reference=True (``_check_step_against_reference``); the
    eval forward launches K1 three times and tracks it too."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             activation="silu", pallas_flat=True, device=dev,
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    assert m.level_kinds(x.shape) == ["flat", "library", "library",
                                      "library"]
    t = (x[..., 0] > 0).long()
    launches = _check_step_against_reference(m, x, t, dtype)
    assert launches == {**dict.fromkeys(launches, 0), "conv_bnact": 3,
                        "conv_bnact_dgrad": 3, "conv_bnact_wgrad": 3}
    m.eval()
    fused.reset_launches()
    y = m(x)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact": 3}
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


# ---------------------------------------------------------------------------
# The vup path (ops/vup.py): rows 1's vup mode, 9, 22 and 23
# ---------------------------------------------------------------------------

# (N, D, H, W) of the merge level: H / 2 and W / 2 odd, a partial tile
# of both conv bodies (16 x 32 on the CUDA cores, 8 x 64 on WMMA).
VUP_SHAPES = [(2, 3, 10, 14), (1, 2, 18, 70)]


def _vup_case(dev, dtype, shape, seed=0):
    """(carry, invc, shiftc, wu, bu, skip, inv, shift, w, b) of a C=64
    carry under a 32-channel merge level, torch layouts."""
    n, d, h, w = shape
    g = torch.Generator().manual_seed(seed)
    carry = torch.randn(n, d, h // 2, w // 2, 64, generator=g).to(dev, dtype)
    invc, shiftc = torch.randn(64, generator=g), torch.randn(64, generator=g)
    wu = 0.2 * torch.randn(64, 32, 1, 2, 2, generator=g)
    bu = 0.1 * torch.randn(32, generator=g)
    skip = torch.randn(n, d, h, w, 32, generator=g).to(dev, dtype)
    inv, shift = torch.randn(64, generator=g), torch.randn(64, generator=g)
    wt = 0.1 * torch.randn(32, 64, 1, 3, 3, generator=g)
    b = torch.randn(32, generator=g)
    return [carry, invc.to(dev), shiftc.to(dev), wu.to(dev), bu.to(dev),
            skip, inv.to(dev), shift.to(dev), wt.to(dev), b.to(dev)], g


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VUP_SHAPES, ids=str)
def test_cuda_vup_forward_matches_plain(shape, dtype, want_stats):
    """``conv_vup`` (K1's body recomputing input 0) with and without
    statistics, and ``upconv_stats`` (row 22), against their plain
    versions; the statistics of the stored output against the plain sums
    of the kernel's own output."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    args, _ = _vup_case(dev, dtype, shape)
    fused.reset_launches()
    got, s, q = vup.conv_vup_fwd_kernel(*args, "relu", "relu", want_stats)
    su, qu = vup.upconv_stats_kernel(*args[:5], "relu")
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_vup": 1, "upconv_stats": 1}
    ref, rs, rq = vup.conv_vup_fwd_plain(*args, "relu", "relu", want_stats)
    rsu, rqu = vup.upconv_stats_plain(*args[:5], "relu")
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    _assert_sum(su, rsu)
    _assert_sum(qu, rqu)
    if want_stats:
        ks, kq = fused.channel_stats(got)
        _assert_sum(s, ks)
        _assert_sum(q, kq)
    else:
        assert s is None and q is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VUP_SHAPES, ids=str)
def test_cuda_vup_backward_matches_plain(shape, dtype):
    """``conv_vup_dgrad`` (K4's body, then the chain into the carry),
    ``conv_vup_wgrad`` (K5's body) and ``upconv_stats_bwd`` (row 23)
    against their plain versions, with nonzero statistics cotangents."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    args, g = _vup_case(dev, dtype, shape, seed=1)
    y = vup.conv_vup_fwd_plain(*args, "relu", "relu")[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds = torch.randn(32, generator=g).to(dev)
    dq = (0.1 * torch.randn(32, generator=g)).to(dev)
    bargs = (*args[:9], y, dy, ds, dq, "relu", "relu")
    fused.reset_launches()
    got = vup.conv_vup_dgrad_kernel(*bargs)
    gw = vup.conv_vup_wgrad_kernel(*bargs)
    gs = vup.upconv_stats_bwd_kernel(*args[:5], ds, dq, "relu")
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_vup_dgrad": 1, "conv_vup_wgrad": 1,
                              "upconv_stats_bwd": 1}
    ref = vup.conv_vup_dgrad_plain(*bargs)
    rw = vup.conv_vup_wgrad_plain(*bargs)
    rs = vup.upconv_stats_bwd_plain(*args[:5], ds, dq, "relu")
    torch.cuda.synchronize()
    # (dcarry, dinvc, dshiftc, dwu, dbu, dskip, dinv, dshift)
    for i, (a, r) in enumerate(zip(got, ref)):
        (_assert_kernel if i in (0, 5) else _assert_sum)(a, r)
    for a, r in zip(gw, rw):
        _assert_sum(a, r)
    for i, (a, r) in enumerate(zip(gs, rs)):
        (_assert_kernel if i == 0 else _assert_sum)(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_vup_matches_reference(dtype):
    """The headline structure with ``vup=True``: a step launches the
    five vup entries once each and no upconv into L0 (K3 and K7 once,
    for up_1), tracks reference=True (``_check_step_against_reference``),
    and the eval forward launches ``conv_vup`` and tracks it too."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             vup=True, device=dev, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    t = (x[..., 0] > 0).long()
    launches = _check_step_against_reference(m, x, t, dtype)
    assert launches == {**dict.fromkeys(launches, 0), "conv_bnact": 7,
                        "pool_bnact": 2, "upconv_bnact": 1,
                        "conv_bnact_dgrad": 6, "conv_bnact_wgrad": 7,
                        "pool_bnact_bwd": 2, "upconv_bnact_bwd": 1,
                        "conv_vup": 1, "conv_vup_dgrad": 1,
                        "conv_vup_wgrad": 1, "upconv_stats": 1,
                        "upconv_stats_bwd": 1}
    m.eval()
    fused.reset_launches()
    y = m(x)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact": 7, "pool_bnact": 2,
                              "upconv_bnact": 1, "conv_vup": 1}
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


# K1's tensor-core body (bf16, every C_in % 16 == 0) at ragged planes:
# (input channels, kd, C_out, (N, D, H, W), prologue). "bn": a relu
# prologue with random vectors; "none": the identity prologue (no
# vectors, linear: the body skips its pass); "relu": no vectors but a
# relu. W = 37 and 44 take 16-column tiles, 22 and 13 32-column ones;
# C_out 96 and 256 split over blocks of 32 and 128 channels; the last
# case has N * D > 65535 at kd = 3.
TC_CONV_CASES = [
    ((16,), 3, 32, (2, 5, 13, 37), "bn"),
    ((32,), 3, 64, (2, 5, 13, 37), "none"),
    ((32,), 3, 64, (1, 4, 9, 44), "relu"),
    ((48, 16), 3, 96, (2, 3, 11, 22), "bn"),
    ((64, 64), 3, 64, (2, 5, 13, 37), "bn"),
    ((128,), 3, 128, (2, 4, 11, 22), "none"),
    ((128, 128), 3, 128, (1, 3, 13, 13), "bn"),
    ((256,), 1, 256, (2, 3, 9, 37), "bn"),
    ((32, 32), 1, 32, (8, 1, 21, 44), "bn"),
    ((16,), 3, 32, (2, 32769, 3, 5), "bn"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("cins,kd,cout,shape,pro", TC_CONV_CASES)
def test_cuda_conv_tc_body_matches_plain(cins, kd, cout, shape, pro,
                                         want_stats):
    """K1's bf16 tensor-core body against the plain version: output and
    the statistics of the stored output; one launch counted."""
    dev = _cuda()
    assert fused.conv_body(torch.bfloat16, cins) == "tc"
    g = torch.Generator().manual_seed(11)
    xs = [torch.randn(*shape, c, generator=g).to(dev, torch.bfloat16)
          for c in cins]
    cin = sum(cins)
    w = (0.1 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    if pro == "bn":
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
    act = "linear" if pro == "none" else "relu"
    fused.reset_launches()
    got, s, q = fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, act,
                                            want_stats)
    assert fused.LAUNCHES["conv_bnact"] == 1
    ref = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act)[0]
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    if want_stats:
        ks, kq = fused.channel_stats(got)
        _assert_sum(s, ks)
        _assert_sum(q, kq)


# K3's tensor-core body (bf16): (C_in, C_out, kd, (N, D, H, W), prologue)
# as above. W odd (W / 2 of the output odd); the voxel counts are not
# multiples of the block's 64; C_in 16 and 48 leave a partial weight
# stage, C_out 96 a GEMM width of three 128-column slices.
TC_UPCONV_CASES = [
    (16, 32, 1, (2, 3, 5, 7), "bn"),
    (32, 64, 2, (2, 3, 5, 7), "none"),
    (48, 96, 2, (1, 3, 9, 11), "bn"),
    (64, 32, 1, (2, 3, 5, 7), "relu"),
    (128, 64, 2, (2, 3, 5, 7), "bn"),
    (128, 64, 1, (8, 1, 9, 11), "none"),
    (256, 128, 2, (2, 3, 5, 7), "none"),
    (256, 128, 1, (8, 1, 7, 9), "bn"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("cin,cout,kd,shape,pro", TC_UPCONV_CASES)
def test_cuda_upconv_tc_body_matches_plain(cin, cout, kd, shape, pro,
                                           want_stats):
    """K3's bf16 tensor-core body against the plain version: output and
    the statistics of the stored output; one launch counted."""
    dev = _cuda()
    assert fused.upconv_body(torch.bfloat16) == "tc"
    g = torch.Generator().manual_seed(12)
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    if pro == "bn":
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
    act = "linear" if pro == "none" else "relu"
    fused.reset_launches()
    got, s, q = fused.upconv_bnact_fwd_kernel(x, inv, shift, w, b, act,
                                              want_stats)
    assert fused.LAUNCHES["upconv_bnact"] == 1
    ref = fused.upconv_bnact_fwd_plain(x, inv, shift, w, b, act)[0]
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    if want_stats:
        ks, kq = fused.channel_stats(got)
        _assert_sum(s, ks)
        _assert_sum(q, kq)
