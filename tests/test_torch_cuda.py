"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card (marked ``cuda``; skips without a CUDA device):
K1-K7 (``ops/fused.py``; K1's, K3's, K5's and K7's bf16 tensor-core
bodies also at their own ragged cases), the 'batchp' batch norm's K8-K11
(``ops/pallas_bn.py``), the flat executor's ``flat_conv3`` and
``conv_direct`` (``ops/flat_conv.py``, ``ops/pallas_conv.py``: K1, K4
and K5 without a prologue), and the vup path's five entries
(``ops/vup.py``: rows 1's vup mode, 9, 22 and 23; the five entries'
bf16 tensor-core bodies also at their own cases, against their plain
versions and their CUDA-core bodies, u bitwise K3's stored output and
``conv_vup``'s y bitwise K1's over it; the chain of the CUDA-core
``conv_vup_dgrad`` keeps K7's CUDA-core bodies), and K4 on inputs of
C_in % 32 != 0 (padded to 32-channel blocks).
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
    """K4 (dx, dinv, dshift) and K5 (dW, db) against the plain backward,
    with nonzero statistics cotangents; the network input's C_in of 1 or
    3 takes row 13's kernel (with dx) in their place."""
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
    conv1 = cins[0] <= fused.CONV1_MAX_CIN
    if conv1:
        dxs, dinv, dshift, dw, db = fused.conv1_bwd_kernel(*args, True)
    else:
        dxs, dinv, dshift = fused.conv_bnact_dgrad_kernel(*args)
    rdxs, rdinv, rdshift = fused.conv_bnact_dgrad_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(dxs, rdxs):
        _assert_kernel(a, r)
    _assert_sum(dinv, rdinv)
    _assert_sum(dshift, rdshift)
    if not conv1:
        dw, db = fused.conv_bnact_wgrad_kernel(*args)
    assert fused.LAUNCHES["conv_bnact_dgrad"] == int(not conv1)
    assert fused.LAUNCHES["conv_bnact_wgrad"] == int(not conv1)
    assert fused.LAUNCHES["conv1_bwd"] == int(conv1)
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
    got = fused.pool_bnact(x, inv, shift, "relu", window)[0]
    ref = fused.pool_bnact(x, inv, shift, "relu", window, reference=True)[0]
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
                              "conv_bnact_wgrad": 0, "conv1_bwd": 0,
                              "pool_bnact_bwd": 0, "upconv_bnact_bwd": 0,
                              **_NO_BN, **_NO_VUP}
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
        "conv_bnact_dgrad": 0, "conv_bnact_wgrad": 0, "conv1_bwd": 0,
        "pool_bnact_bwd": 0, "upconv_bnact_bwd": 0, **_NO_BN, **_NO_VUP}
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
    y = fused.pool_bnact(x, inv, shift, "relu", (2, 2, 2))[0]
    ref = fused.pool_bnact(x[:, -2:], inv, shift, "relu", (2, 2, 2),
                           reference=True)[0]
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
# under one block's row group, ragged across blocks, and past the grid
# plan's largest grid (so each block reads many row groups); then the
# 'batchp' pallas_flat=False step's four levels at batch 2 (b2).
BN_CASES = [(c, r) for c in (32, 64, 128, 256, 512)
            for r in (5, 1059, 300_001)] + [
    (32, 681_472), (64, 170_368), (128, 21_296), (256, 2_662)]


def _bn_case(dev, dtype, c, r, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = (3.0 + 2.0 * torch.randn(r, c, generator=g)).to(dev, dtype)
    gy = torch.randn(r, c, generator=g).to(dev, dtype)
    gamma = torch.randn(c, generator=g).to(dev)
    beta = torch.randn(c, generator=g).to(dev)
    return x, gy, gamma, beta


@pytest.fixture(params=["one cluster", "grid"])
def bn_plan(request, monkeypatch):
    """K8's and K10's plan forced to one cluster (no ticket, no partials)
    up to 4M elements (8 times the plan's own bound; beyond, one cluster
    sums thousands of rows a thread in series and float32 keeps fewer
    digits, so the plan never takes it there) or to the grid of clusters
    wherever R fills more than one cluster."""
    monkeypatch.setattr(pallas_bn, "SINGLE_CLUSTER_MAX",
                        1 << 22 if request.param == "one cluster" else 0)
    return request.param


def _assert_bn_stats(got, ref, gamma, beta):
    """K8's (5, C) [mean, var, inv, scale, shift]: the mean (a sum over
    rows, scaled) within BN_SUM_TOL of its scale, the variance (E[x^2] -
    mean^2 cancels) within 1e-4; the glue (inv, scale, shift) within
    BN_SUM_TOL of its scale from the kernel's own mean and var (at
    R = 5 the variance cancels 100-fold, and inv inherits that)."""
    _assert_sum(got[0], ref[0], BN_SUM_TOL)
    _assert_sum(got[1], ref[1], 1e-4)
    inv = torch.rsqrt(got[1] + 1e-5)
    for g, r in zip(got[2:], (inv, *pallas_bn._scale_shift(
            gamma, beta, got[0], inv))):
        _assert_sum(g, r, BN_SUM_TOL)


def _running(c, dev, seed=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g).to(dev),
            torch.rand(c, generator=g).to(dev) + 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,r", BN_CASES)
def test_cuda_batch_norm_kernels_match_plain(dtype, c, r, bn_plan):
    """K8 (with the running update) and K10 (a, b, c, dgamma, dbeta)
    against their plain versions on the same operands within BN_SUM_TOL
    (K8's variance 1e-4; the running buffers as K8's outputs), K9 and
    K11 on rows of K8's and K10's outputs (one rounding of the same
    float32 values) as _assert_kernel, each launched once, on both
    plans."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, c, r)
    ra, ra_ref = _running(c, dev), _running(c, dev)
    fused.reset_launches()
    st = pallas_bn.bn_stats_kernel(x, gamma, beta, 1e-5, (*ra, 0.1))
    ref = pallas_bn.bn_stats_plain(x, gamma, beta, 1e-5, (*ra_ref, 0.1))
    _assert_bn_stats(st, ref, gamma, beta)
    _assert_sum(ra[0], ra_ref[0], BN_SUM_TOL)
    _assert_sum(ra[1], ra_ref[1], 1e-4)
    _assert_kernel(pallas_bn.bn_normalize_kernel(x, st[3], st[4]),
                   pallas_bn.bn_normalize_plain(x, st[3], st[4]))
    red = pallas_bn.bn_bwd_reduce_kernel(gy, x, st[0], st[1], gamma, 1e-5)
    rref = pallas_bn.bn_bwd_reduce_plain(gy, x, st[0], st[1], gamma, 1e-5)
    for got, want in zip(red, rref):
        _assert_sum(got, want, BN_SUM_TOL)
    _assert_kernel(pallas_bn.bn_bwd_dx_kernel(gy, x, red[0], red[1], red[2]),
                   pallas_bn.bn_bwd_dx_plain(gy, x, red[0], red[1], red[2]))
    torch.cuda.synchronize()
    assert {k: fused.LAUNCHES[k] for k in _NO_BN} == dict.fromkeys(_NO_BN, 1)


def _bn_reductions(gy, x, gamma, beta):
    st = pallas_bn.bn_stats_kernel(x, gamma, beta, 1e-5)
    return st, pallas_bn.bn_bwd_reduce_kernel(gy, x, st[0], st[1], gamma,
                                              1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batch_norm_sums_are_the_same_bits_on_a_rerun(dtype, bn_plan):
    """K8's and K10's whole outputs (the sums and the glue) are the same
    bits on reruns, on either plan: the order of every sum is the
    plan's."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, 64, 681_472 + 37)
    first = _bn_reductions(gy, x, gamma, beta)
    for _ in range(3):
        for got, want in zip(_bn_reductions(gy, x, gamma, beta), first):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batch_norm_workspace_and_streams(dtype):
    """A grid plan's ticket is back at 0 after every call, the workspace
    is allocated once per stream, and a call on another stream (its own
    workspace) gives the same bits; after the first call K8 and K10
    allocate only their (5, C) outputs."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, 128, 85_221)
    r, c = x.shape
    assert pallas_bn.reduce_plan(r, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)[1] > 1
    first = _bn_reductions(gy, x, gamma, beta)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = pallas_bn._WORKSPACE[(dev.index or 0, stream)]
    assert int(ws[0].view(torch.int32)) == 0
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    again = _bn_reductions(gy, x, gamma, beta)
    after = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    assert after - before == 2
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        other = _bn_reductions(gy, x, gamma, beta)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    assert (dev.index or 0, side.cuda_stream) in pallas_bn._WORKSPACE
    assert int(pallas_bn._WORKSPACE[(dev.index or 0, side.cuda_stream)][0]
               .view(torch.int32)) == 0
    for a, b, d in zip(first, again, other):
        assert torch.equal(a, b) and torch.equal(a, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batch_norm_ops_match_reference(dtype):
    """The autograd op (K8, K9 forward; K10, K11 backward) and the eval
    op (K9) on a 5-D channels-last tensor against reference=True: the
    mean, dgamma, dbeta and the running mean (K8's and K10's sums,
    scaled) within BN_SUM_TOL, the variance and the running variance
    (E[x^2] - mean^2 cancels) within 1e-4."""
    dev = _cuda()
    x, gy, gamma, beta = _bn_case(dev, dtype, 128, 2 * 11 * 13 * 7)
    x, gy = x.view(2, 11, 13, 7, 128), gy.view(2, 11, 13, 7, 128)
    outs = []
    for reference in (False, True):
        xr, gr, br = (t.clone().requires_grad_(True) for t in (x, gamma,
                                                              beta))
        ra = _running(128, dev)
        y, mean, var = pallas_bn.batch_norm_train(
            xr, gr, br, reference=reference, running=(*ra, 0.1))
        y.backward(gy)
        ye = pallas_bn.batch_norm_inference(x, gamma, beta, mean, var,
                                            reference=reference)
        outs.append((y, mean, var, xr.grad, gr.grad, br.grad, ye, *ra))
    for i, (got, ref) in enumerate(zip(*outs)):
        if i in (1, 4, 5, 7):
            _assert_sum(got, ref, BN_SUM_TOL)
        elif i in (2, 8):
            _assert_sum(got, ref, 1e-4)
        else:
            _assert_kernel(got, ref)


@pytest.mark.cuda
def test_cuda_batch_norm_is_one_kernel_a_reduction():
    """One PallasBatchNorm3d training forward runs two device kernels
    (K8, K9) and its backward two (K10, K11), and nothing else: no
    second pass, no memset or fill (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from elektronn3_tpu_torch.modules.pallas_norm import PallasBatchNorm3d
    dev = _cuda()
    norm = PallasBatchNorm3d(64, device=dev).train()
    x = torch.randn(2, 22, 44, 44, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    gy = torch.randn_like(x)
    for _ in range(2):   # the workspace and the build before the count
        norm(x).backward(gy)
    x.grad = None
    norm.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = norm(x)
        torch.cuda.synchronize()
        y.backward(gy)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    kinds = [k for n in names for k in ("bn_reduce_kernel",
                                        "bn_affine_kernel") if k in n]
    assert len(names) == 4 and sorted(kinds) == sorted(
        ["bn_reduce_kernel", "bn_affine_kernel"] * 2), [
            n.split("(")[0] for n in names]


def _step_grads(m, x, t, reference):
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    m.zero_grad(set_to_none=True)
    loss = CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                                  for n, p in m.named_parameters()}


def _check_step_against_reference(m, x, t, dtype, zero_bias=True):
    """One training step's loss and every gradient leaf against the same
    step through reference=True, as chip_smoke.py's check_train_step
    holds them, in the L2 norm: |g - r| <= rel |r| + 3 |r' - r|, r' the
    reference step on an input moved by about one ulp (the step's own
    rounding noise; a fixed relative bound alone does not hold even for
    the 'batch' model's K1-K7, whose weight gradients are small
    differences of large float32 sums); the bias of a conv that feeds a
    batch norm, whose exact gradient is 0, within ``zero`` of its weight
    gradient's norm (``zero_bias`` False: held like the other leaves, as
    under a group norm of several channels a group, where that gradient
    is no exact 0). Returns the kernels' step's launch counts."""
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
        elif zero_bias and name.endswith(".bias") and "norm" not in name \
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
# of every conv body (16 x 32 on the CUDA cores, 16 x 16 or 8 x 32 on
# the tensor cores).
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
    versions, on the bodies ``vup.vup_body`` picks; the statistics of the
    stored output against the plain sums of the kernel's own output."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    args, _ = _vup_case(dev, dtype, shape)
    fused.reset_launches()
    got, s, q = vup.conv_vup_fwd_kernel(*args, "relu", "relu", want_stats)
    su, qu = vup.upconv_stats_kernel(*args[:5], "relu")
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_vup": 1, "upconv_stats": 1}
    body = vup.vup_body(dtype, 64, 32)
    assert fused.BODY_LAUNCHES == {("conv_vup", body): 1,
                                   ("upconv_stats", body): 1}
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
    """``conv_vup_dgrad`` (bf16: one tensor-core kernel, E on the chip;
    float32: K4's body, then the chain into the carry), ``conv_vup_wgrad``
    (K5's body) and ``upconv_stats_bwd`` (row 23) against their plain
    versions, with nonzero statistics cotangents, on the bodies
    ``vup.vup_body`` picks."""
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
    body = vup.vup_body(dtype, 64, 32)
    assert fused.BODY_LAUNCHES == {("conv_vup_dgrad", body): 1,
                                   ("conv_vup_wgrad", body): 1,
                                   ("upconv_stats_bwd", body): 1}
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
                        "conv_bnact_dgrad": 6, "conv_bnact_wgrad": 6,
                        "conv1_bwd": 1, "pool_bnact_bwd": 2,
                        "upconv_bnact_bwd": 1, "conv_vup": 1,
                        "conv_vup_dgrad": 1,
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


# K5's tensor-core body (bf16, every C_in % 16 == 0): (input channels,
# kd, C_out, (N, D, H, W), prologue, statistics cotangents). W = 37, 22,
# 13 and 5 leave a partial 16-column tile; 48 + 16 leaves a half slice
# of 16 channels in each input; C_out 96 takes 32-channel output blocks,
# 256 four of 64; the last case has N * D > 65535 at kd = 3.
TC_WGRAD_CASES = [
    ((16,), 3, 32, (2, 5, 13, 37), "bn", True),
    ((32,), 1, 32, (2, 3, 9, 37), "none", False),
    ((48, 16), 3, 96, (2, 3, 11, 22), "bn", True),
    ((64, 64), 3, 64, (2, 5, 13, 37), "bn", True),
    ((128,), 3, 128, (1, 4, 11, 22), "relu", False),
    ((128, 128), 3, 256, (1, 3, 9, 13), "bn", True),
    ((256,), 1, 64, (2, 3, 9, 37), "none", True),
    ((32, 32), 1, 32, (8, 1, 21, 44), "bn", True),
    ((16,), 3, 32, (2, 32769, 3, 5), "bn", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cins,kd,cout,shape,pro,stats", TC_WGRAD_CASES)
def test_cuda_wgrad_tc_body_matches_plain(cins, kd, cout, shape, pro,
                                          stats):
    """K5's bf16 tensor-core body against the plain version: dW and db;
    one launch counted."""
    dev = _cuda()
    assert fused.wgrad_body(torch.bfloat16, cins) == "tc"
    g = torch.Generator().manual_seed(13)
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
    y = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act)[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, torch.bfloat16)
    ds = dq = None
    if stats:
        ds = torch.randn(cout, generator=g).to(dev)
        dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    args = (xs, inv, shift, w, y, dy, ds, dq, act)
    fused.reset_launches()
    dw, db = fused.conv_bnact_wgrad_kernel(*args)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact_wgrad": 1}
    rdw, rdb = fused.conv_bnact_wgrad_plain(*args)
    torch.cuda.synchronize()
    _assert_sum(dw, rdw)
    _assert_sum(db, rdb)


# K7's tensor-core bodies (bf16): (C_in, C_out, kd, (N, D, H, W),
# prologue, input gradient, statistics cotangents). W odd; the voxel
# counts are not multiples of the dgrad's 128 or the wgrad's 32; C_in 16
# and 48 leave a partial 32-channel block, C_out 96 a partial
# 64-channel one; C_in 256 splits the dgrad over two blocks of 128.
TC_UPCONV_BWD_CASES = [
    (16, 32, 1, (2, 3, 5, 7), "bn", True, True),
    (32, 64, 2, (2, 3, 5, 7), "none", True, False),
    (48, 96, 2, (1, 3, 9, 11), "bn", False, True),
    (64, 32, 1, (2, 3, 5, 7), "relu", True, True),
    (128, 64, 2, (2, 3, 5, 7), "bn", True, True),
    (128, 64, 1, (8, 1, 9, 11), "none", False, False),
    (256, 128, 2, (2, 3, 5, 7), "none", True, True),
    (256, 128, 1, (8, 1, 7, 9), "bn", True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kd,shape,pro,input_grad,stats",
                         TC_UPCONV_BWD_CASES)
def test_cuda_upconv_bwd_tc_body_matches_plain(cin, cout, kd, shape, pro,
                                               input_grad, stats):
    """K7's bf16 tensor-core bodies against the plain version: dx (when
    asked for), dinv, dshift, dW and db; one launch counted."""
    dev = _cuda()
    assert fused.upconv_bwd_body(torch.bfloat16) == "tc"
    g = torch.Generator().manual_seed(14)
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    if pro == "bn":
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
    act = "linear" if pro == "none" else "relu"
    y = fused.upconv_bnact_fwd_plain(x, inv, shift, w, b, act)[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, torch.bfloat16)
    ds = dq = None
    if stats:
        ds = torch.randn(cout, generator=g).to(dev)
        dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    args = (x, inv, shift, w, y, dy, ds, dq, act, input_grad)
    fused.reset_launches()
    dx, dinv, dshift, dw, db = fused.upconv_bnact_bwd_kernel(*args)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "upconv_bnact_bwd": 1}
    ref = fused.upconv_bnact_bwd_plain(*args)
    torch.cuda.synchronize()
    if input_grad:
        _assert_kernel(dx, ref[0])
    else:
        assert dx is None and dinv is None and dshift is None
    if pro == "bn" and input_grad:
        _assert_sum(dinv, ref[1])
        _assert_sum(dshift, ref[2])
    _assert_sum(dw, ref[3])
    _assert_sum(db, ref[4])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VUP_SHAPES, ids=str)
def test_cuda_vup_chain_keeps_the_cuda_core_bodies(shape):
    """The vup chain (K7's bodies on E, inside the CUDA-core
    ``conv_vup_dgrad`` only: the tensor-core bodies of rows 9 and 23 keep
    E on the chip and run row 23's chain GEMMs instead) runs K7's
    CUDA-core bodies in bf16, where ``upconv_bnact`` takes the
    tensor-core ones: its dcarry, one thread's sum with no atomics,
    equals the CUDA-core body's bit for bit on the same E, and both
    agree with the tensor-core bodies."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    bf = torch.bfloat16
    assert vup.CHAIN_BODY == "cuda-core"
    assert fused.upconv_bwd_body(bf) == "tc"
    args, g = _vup_case(dev, bf, shape, seed=3)
    carry, invc, shiftc, wu = args[:4]
    n, d, h, w, _ = carry.shape
    e = (0.1 * torch.randn(n, d, 2 * h, 2 * w, 32, generator=g)).to(dev, bf)
    got = vup.vup_chain_kernel(carry, invc, shiftc, wu, e, "relu")
    bwd = (carry, invc, shiftc, wu, e, e, None, None, "relu", True)
    core = fused.upconv_bnact_bwd_kernel(*bwd, body="cuda-core")
    tc = fused.upconv_bnact_bwd_kernel(*bwd, body="tc")
    torch.cuda.synchronize()
    assert torch.equal(got[0], core[0])
    _assert_kernel(got[0], tc[0])
    for a, c, t in zip(got[1:], core[1:4], tc[1:4]):
        _assert_sum(a, c)
        _assert_sum(a, t)

# The bf16 tensor-core bodies of row 23 (``upconv_stats_bwd``) and row 9's
# weight gradient (``conv_vup_wgrad``): ((N, D, H, W) of the merge level,
# C_carry, C_up). VUP_SHAPES (H / 2 and W / 2 odd, partial tiles of the
# 64-voxel walk and of K5's 8 x 16 tiles), one with N * D > 65535 (the
# flat walk and K5's tile walk have no grid-dimension limit) and one at
# the largest template case, C_carry 128 and C_up 64 (two slices of u,
# so K5's dy_tot pre-pass with statistics cotangents).
VUP_TC_CASES = [(s, 64, 32) for s in VUP_SHAPES] + [
    ((1, 65540, 2, 2), 64, 32), ((1, 2, 10, 14), 128, 64)]


def _vup_tc_case(dev, shape, cc, cu, invc_given, stats, seed=5):
    """((carry, invc, shiftc, wu, bu), (skip, inv, shift, w, y, dy, ds,
    dq), (ds_u, dq_u)) in bf16: a C_cc carry under a C_cu + 32 -> 32
    merge; without ``invc_given`` the carry's prologue is relu alone,
    without ``stats`` there are no statistics cotangents (row 23's
    outputs are then zero)."""
    from elektronn3_tpu_torch.ops import vup
    bf = torch.bfloat16
    n, d, h, w = shape
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(dev)

    carry = rnd(n, d, h // 2, w // 2, cc).to(bf)
    invc = shiftc = None
    if invc_given:
        invc, shiftc = rnd(cc), rnd(cc)
    up = (carry, invc, shiftc, rnd(cc, cu, 1, 2, 2, scale=0.2),
          rnd(cu, scale=0.1))
    skip = rnd(n, d, h, w, 32).to(bf)
    inv, shift = rnd(cu + 32), rnd(cu + 32)
    wt, b = rnd(32, cu + 32, 1, 3, 3, scale=0.1), rnd(32)
    y = vup.conv_vup_fwd_plain(*up, skip, inv, shift, wt, b, "relu",
                               "relu")[0]
    dy = rnd(*y.shape, scale=0.1).to(bf)
    ds = dq = ds_u = dq_u = None
    if stats:
        ds, dq = rnd(32), rnd(32, scale=0.1)
        ds_u, dq_u = rnd(cu), rnd(cu, scale=0.1)
    return up, (skip, inv, shift, wt, y, dy, ds, dq), (ds_u, dq_u)


def _assert_vup_bwd(got_s, ref_s, got_w, ref_w):
    """Row 23's (dcarry, dinvc, dshiftc, dwu, dbu) and row 9's (dW, db):
    dcarry elementwise, the rest as sums (None where the reference has
    none)."""
    _assert_kernel(got_s[0], ref_s[0])
    for a, r in zip(got_s[1:], ref_s[1:]):
        if r is None:
            assert a is None
        else:
            _assert_sum(a, r)
    for a, r in zip(got_w, ref_w):
        _assert_sum(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("invc_given", [False, True])
@pytest.mark.parametrize("shape,cc,cu", VUP_TC_CASES, ids=str)
def test_cuda_vup_tc_bodies_match_plain(shape, cc, cu, invc_given, stats):
    """Row 23's bf16 body (one tensor-core kernel, E in shared memory)
    and row 9's weight gradient's (K5's tensor-core body recomputing u
    per tile) against their plain versions; the selector picks them and
    each launch is counted once."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    assert vup.vup_body(torch.bfloat16, cc, cu) == "tc"
    up, merge, cts = _vup_tc_case(dev, shape, cc, cu, invc_given, stats)
    fused.reset_launches()
    got_s = vup.upconv_stats_bwd_kernel(*up, *cts, "relu")
    got_w = vup.conv_vup_wgrad_kernel(*up, *merge, "relu", "relu")
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "upconv_stats_bwd": 1, "conv_vup_wgrad": 1}
    ref_s = vup.upconv_stats_bwd_plain(*up, *cts, "relu")
    ref_w = vup.conv_vup_wgrad_plain(*up, *merge, "relu", "relu")
    torch.cuda.synchronize()
    _assert_vup_bwd(got_s, ref_s, got_w, ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("invc_given", [False, True])
@pytest.mark.parametrize("shape,cc,cu", VUP_TC_CASES, ids=str)
def test_cuda_vup_tc_bodies_match_cuda_core(shape, cc, cu, invc_given,
                                            stats):
    """The same inputs through ``body='cuda-core'`` (the pass and K7's
    CUDA-core bodies; K5's CUDA-core body with ``VUP``) and
    ``body='tc'``: they agree within the kernel tolerances (their
    recomputes sum in different orders)."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    up, merge, cts = _vup_tc_case(dev, shape, cc, cu, invc_given, stats,
                                  seed=6)
    fused.reset_launches()
    core_s = vup.upconv_stats_bwd_kernel(*up, *cts, "relu",
                                         body="cuda-core")
    core_w = vup.conv_vup_wgrad_kernel(*up, *merge, "relu", "relu",
                                       body="cuda-core")
    tc_s = vup.upconv_stats_bwd_kernel(*up, *cts, "relu", body="tc")
    tc_w = vup.conv_vup_wgrad_kernel(*up, *merge, "relu", "relu", body="tc")
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "upconv_stats_bwd": 2, "conv_vup_wgrad": 2}
    torch.cuda.synchronize()
    _assert_vup_bwd(tc_s, core_s, tc_w, core_w)


# ---------------------------------------------------------------------------
# K4's tensor-core body (csrc/dgrad_tc.cu) and row 13's kernel
# (csrc/conv1_bwd.cu)
# ---------------------------------------------------------------------------

# K4's bf16 tensor-core body: (input channels, C_out: dy's channels, kd,
# (N, D, H, W), prologue, activation). W = 37 takes 16-column tiles and
# leaves a partial one, 22 and 44 32-column ones, H = 13 and 11 a partial
# row of tiles; dx of 32 to 128 + 128 channels takes blocks of 32, 64 and
# 128 (the 128 + 128 merge two of them); the last case has N * D >
# 65535. "bn": a prologue with random vectors; "none": the identity
# prologue with a linear activation (row 26's dgrad).
TC_DGRAD_CASES = [
    ((32,), 32, 1, (2, 3, 13, 37), "bn", "relu"),
    ((32, 32), 32, 1, (8, 1, 11, 44), "bn", "relu"),
    ((32,), 64, 3, (2, 5, 13, 37), "bn", "leaky"),
    ((64,), 64, 3, (2, 5, 13, 37), "bn", "linear"),
    ((64, 64), 64, 3, (2, 5, 11, 22), "bn", "relu"),
    ((64, 64), 64, 1, (8, 1, 13, 37), "bn", "leaky"),
    ((64,), 128, 3, (2, 4, 11, 22), "bn", "relu"),
    ((128,), 128, 3, (2, 4, 13, 37), "bn", "leaky"),
    ((128, 128), 128, 3, (1, 3, 13, 13), "bn", "relu"),
    ((128, 128), 128, 1, (2, 3, 11, 22), "bn", "relu"),
    ((32,), 32, 1, (2, 3, 13, 37), "none", "linear"),
    ((32, 32), 32, 1, (2, 3, 11, 22), "none", "linear"),
    ((32,), 32, 1, (2, 32769, 3, 5), "bn", "relu"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("cins,cout,kd,shape,pro,act", TC_DGRAD_CASES)
def test_cuda_dgrad_tc_body_matches_plain(cins, cout, kd, shape, pro, act,
                                          stats):
    """K4's bf16 tensor-core body against the plain version: dx of each
    input, dinv and dshift (with a prologue); with statistics cotangents
    at kd = 1 it folds dy_tot on load, at kd = 3 it runs the pre-pass.
    One launch counted, on the tc body."""
    dev = _cuda()
    assert fused.dgrad_body(torch.bfloat16) == "tc"
    g = torch.Generator().manual_seed(15)
    xs = [torch.randn(*shape, c, generator=g).to(dev, torch.bfloat16)
          for c in cins]
    cin = sum(cins)
    w = (0.1 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    if pro == "bn":
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
    y = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act)[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, torch.bfloat16)
    ds = dq = None
    if stats:
        ds = torch.randn(cout, generator=g).to(dev)
        dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    args = (xs, inv, shift, w, y, dy, ds, dq, act)
    fused.reset_launches()
    dxs, dinv, dshift = fused.conv_bnact_dgrad_kernel(*args)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact_dgrad": 1}
    assert fused.BODY_LAUNCHES == {("conv_bnact_dgrad", "tc"): 1}
    rdxs, rdinv, rdshift = fused.conv_bnact_dgrad_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(dxs, rdxs):
        _assert_kernel(a, r)
    if pro == "bn":
        _assert_sum(dinv, rdinv)
        _assert_sum(dshift, rdshift)
    else:
        assert dinv is None and dshift is None


# Row 13's kernel: (C_in, C_out, kd, prologue, statistics cotangents) at
# a ragged (2, 5, 13, 37) input; "none" is the network input's identity
# prologue, "bn" a relu prologue with random vectors.
CONV1_CASES = [
    (1, 32, 1, "none", True), (1, 64, 1, "none", True),
    (1, 32, 3, "none", True), (1, 64, 3, "bn", True),
    (3, 32, 1, "bn", True), (3, 64, 1, "none", True),
    (3, 32, 3, "none", True), (3, 64, 3, "bn", True),
    (2, 32, 1, "bn", False), (4, 64, 1, "none", True),
    (4, 32, 3, "bn", False), (1, 32, 1, "none", False),
    # C_out / CPT no power of two: the last lanes of a voxel are idle
    # (CPT 8, 4 and 1), and the widest C_out.
    (1, 96, 1, "none", True), (2, 160, 1, "bn", True),
    (3, 96, 3, "bn", True), (1, 128, 3, "none", True),
    (4, 256, 1, "bn", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("input_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd,pro,stats", CONV1_CASES)
def test_cuda_conv1_bwd_matches_plain(cin, cout, kd, pro, stats, dtype,
                                      input_grad):
    """Row 13's kernel against its plain version (the plain K5 and K4
    composed): dW and db, and with ``input_grad`` dx (and dinv, dshift
    with a prologue). One launch counted."""
    dev = _cuda()
    body = fused.conv1_body((cin,), input_grad)
    assert body == ("conv1+dx" if input_grad else "conv1")
    g = torch.Generator().manual_seed(16)
    xs = [torch.randn(2, 5, 13, 37, cin, generator=g).to(dev, dtype)]
    w = (0.3 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    act = "linear"
    if pro == "bn":
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
        act = "relu"
    y = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act)[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds = dq = None
    if stats:
        ds = torch.randn(cout, generator=g).to(dev)
        dq = (0.1 * torch.randn(cout, generator=g)).to(dev)
    args = (xs, inv, shift, w, y, dy, ds, dq, act, input_grad)
    fused.reset_launches()
    got = fused.conv1_bwd_kernel(*args)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv1_bwd": 1}
    assert fused.BODY_LAUNCHES == {("conv1_bwd", body): 1}
    ref = fused.conv1_bwd_plain(*args)
    torch.cuda.synchronize()
    _assert_sum(got[3], ref[3])
    _assert_sum(got[4], ref[4])
    if not input_grad:
        assert got[:3] == (None, None, None)
        return
    _assert_kernel(got[0][0], ref[0][0])
    if pro == "bn":
        _assert_sum(got[1], ref[1])
        _assert_sum(got[2], ref[2])
    else:
        assert got[1] is None and got[2] is None


def _input_grad_step(m, x, t, reference):
    """The loss, every parameter gradient and the input's gradient of
    one training step, and the kernels' launch counts."""
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    x = x.detach().clone().requires_grad_(True)
    m.zero_grad(set_to_none=True)
    fused.reset_launches()
    loss = CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t)
    loss.backward()
    return (float(loss.detach()), {n: p.grad.float().clone()
                                   for n, p in m.named_parameters()},
            x.grad, dict(fused.LAUNCHES))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_input_grad_matches_reference(dtype):
    """The headline structure with ``input_grad=True`` and an input that
    requires a gradient: one training step launches row 13's kernel
    once (with dx, in place of L0 conv1's K5) and tracks reference=True
    in the loss, the parameter gradients
    (``_check_step_against_reference``) and the input's gradient, in the
    L2 norm within 1e-2 (bf16; 1e-3 float32) of its norm plus 3 times the
    reference step's own difference under a one-ulp input change. With
    the default ``input_grad=False`` the same input's gradient is zeros
    in bf16, where JAX's 'auto' runs its fused conv1 (W = 40 <= 128), and
    the real one in float32, where it does not. After 10 Adam steps the
    input's gradient is compared again, its float32 noise from a 64-ulp
    input change (one that reaches the relu and pool decisions the
    kernels' rounding flips), and a zero dx must fail that limit."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    t = (x[..., 0] > 0).long()
    bf16 = dtype == torch.bfloat16
    rel, ulp = (1e-2, 2.0 ** -8) if bf16 else (1e-3, 2.0 ** -23)
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             input_grad=True, device=dev,
             generator=torch.Generator().manual_seed(0))
    launches = _check_step_against_reference(m, x, t, dtype)
    assert launches["conv1_bwd"] == 1
    assert launches["conv_bnact_wgrad"] == 7
    _, _, gx, launches = _input_grad_step(m, x, t, False)
    assert launches["conv1_bwd"] == 1
    _, _, rx, _ = _input_grad_step(m, x, t, True)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    _, _, mx, _ = _input_grad_step(m, x * (1 + ulp * noise.to(dev)), t, True)
    torch.cuda.synchronize()
    err = float((gx - rx).norm())
    limit = rel * float(rx.norm()) + 3 * float((mx - rx).norm())
    assert bool(torch.isfinite(gx).all()) and float(rx.norm()) > 0
    assert err <= limit, err
    m0 = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
              device=dev, generator=torch.Generator().manual_seed(0))
    _, _, gx0, launches = _input_grad_step(m0, x, t, False)
    assert launches["conv1_bwd"] == 1
    if bf16:
        assert bool((gx0 == 0).all())
    else:
        assert float((gx0 - rx).norm()) <= limit
    # At initialisation the one-ulp change moves the bf16 reference's dx
    # by about half its norm, so the limit above would pass a zero dx;
    # after 10 Adam steps by about a sixth. There the same comparison
    # holds and must fail a zero dx (error |ref|): the control.
    # In float32 the kernels' dx differs from the reference's only where
    # a relu or max-pool decision on a pre-activation within float32
    # rounding of 0 goes the other way (each flip moves dx by 1e-3 to
    # 3e-3 of its norm; 0-5 flips a run on an H100). A one-ulp input change
    # flips no decision in about 2 runs of 5, and then the noise term
    # holds none of the kernels' flips: the noise takes 64 ulps (2^-17),
    # which flips 4-19 of them on an H100, and the limit stays some 45
    # times under |ref|.
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    for _ in range(10):
        opt.zero_grad(set_to_none=True)
        CEDiceLoss(1.0, 1.0)(m.train()(x), t).backward()
        opt.step()
    flip = ulp if bf16 else 2.0 ** -17
    _, _, gx, _ = _input_grad_step(m, x, t, False)
    _, _, rx, _ = _input_grad_step(m, x, t, True)
    _, _, mx, _ = _input_grad_step(m, x * (1 + flip * noise.to(dev)), t,
                                   True)
    torch.cuda.synchronize()
    rn = float(rx.norm())
    limit = rel * rn + 3 * float((mx - rx).norm())
    assert float((gx - rx).norm()) <= limit, (float((gx - rx).norm()), limit)
    assert rn > limit, (rn, limit)


# The bf16 tensor-core bodies of the three entries this body set adds to
# rows 23 and 9's weight gradient: ``conv_vup`` (K1's body with u's slab
# staged from the recompute), ``conv_vup_dgrad`` (csrc/conv_vup_tc.cu)
# and ``upconv_stats`` (row 22): ((N, D, H, W) of the merge level,
# C_carry, C_up). VUP_SHAPES, W = 88 (32-column tiles that do not divide
# W), W / 2 = 3 odd with C_carry 32 (the CPU tests' W = 6), C_carry 128
# with C_up 64 (two chunks of the forward's recompute, and a second work
# item of the dgrad: 32 skip columns and 32 of zero padding), and C_up 64
# over C_carry 32.
VUP_ENTRY_CASES = [(s, 64, 32) for s in VUP_SHAPES] + [
    ((1, 2, 10, 88), 64, 32), ((2, 2, 6, 6), 32, 32),
    ((1, 2, 10, 14), 128, 64), ((1, 3, 8, 22), 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cc,cu", VUP_ENTRY_CASES, ids=str)
def test_cuda_vup_u_is_k3s_output(shape, cc, cu):
    """One u: the recompute on the tensor cores (``vup_mma``) is K3's
    stored bf16 output bit for bit. ``conv_vup`` with a merge weight that
    copies u's channels (a one at the centre tap), a zero bias and the
    identity prologue outputs its staged u exactly, which equals K3's
    tensor-core output on the same carry; and ``conv_vup``'s y with any
    weights equals K1's tensor-core output over [K3's u, skip]."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    bf = torch.bfloat16
    assert fused.upconv_body(bf) == "tc" and vup.vup_body(bf, cc, cu) == "tc"
    up, merge, _ = _vup_tc_case(dev, shape, cc, cu, True, False, seed=7)
    skip, inv, shift, wt = merge[:4]
    b = torch.randn(32, generator=torch.Generator().manual_seed(8)).to(dev)
    u = fused.upconv_bnact_fwd_kernel(*up, "relu", False)[0]
    ct = cu + skip.shape[-1]
    eye = torch.zeros(cu, ct, 1, 3, 3, device=dev)
    eye[torch.arange(cu), torch.arange(cu), 0, 1, 1] = 1.0
    fused.reset_launches()
    copy = vup.conv_vup_fwd_kernel(*up, skip, torch.ones(ct, device=dev),
                                   torch.zeros(ct, device=dev), eye,
                                   torch.zeros(cu, device=dev), "linear",
                                   "relu")[0]
    y = vup.conv_vup_fwd_kernel(*up, skip, inv, shift, wt, b, "relu",
                                "relu")[0]
    assert fused.BODY_LAUNCHES == {("conv_vup", "tc"): 2}
    y1 = fused.conv_bnact_fwd_kernel([u, skip], inv, shift, wt, b, "relu",
                                     False)[0]
    torch.cuda.synchronize()
    assert torch.equal(copy, u)
    assert torch.equal(y, y1)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape,cc,cu", VUP_ENTRY_CASES, ids=str)
def test_cuda_vup_tc_entries_match_plain(shape, cc, cu, stats):
    """``conv_vup`` (with and without statistics), ``upconv_stats`` and
    ``conv_vup_dgrad`` on their bf16 tensor-core bodies against their
    plain versions and their CUDA-core bodies on the same inputs:
    elementwise outputs (y, dcarry, dskip) at the kernel tolerance, sums
    as sums."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    up, merge, _ = _vup_tc_case(dev, shape, cc, cu, True, stats, seed=9)
    skip, inv, shift, wt, y, dy, ds, dq = merge
    b = torch.randn(32, generator=torch.Generator().manual_seed(10)).to(dev)
    fwd = (*up, skip, inv, shift, wt, b, "relu", "relu", stats)
    bwd = (*up, *merge, "relu", "relu")
    got, core = {}, {}
    fused.reset_launches()
    for body, out in (("tc", got), ("cuda-core", core)):
        out["fwd"] = vup.conv_vup_fwd_kernel(*fwd, body=body)
        out["stats"] = vup.upconv_stats_kernel(*up, "relu", body=body)
        out["dgrad"] = vup.conv_vup_dgrad_kernel(*bwd, body=body)
    assert fused.BODY_LAUNCHES == {
        (k, b): 1 for k in ("conv_vup", "upconv_stats", "conv_vup_dgrad")
        for b in ("tc", "cuda-core")}
    ref = {"fwd": vup.conv_vup_fwd_plain(*fwd),
           "stats": vup.upconv_stats_plain(*up, "relu"),
           "dgrad": vup.conv_vup_dgrad_plain(*bwd)}
    torch.cuda.synchronize()
    for other in (ref, core):
        _assert_kernel(got["fwd"][0], other["fwd"][0])
        for a, r in zip(got["stats"], other["stats"]):
            _assert_sum(a, r)
        # (dcarry, dinvc, dshiftc, dwu, dbu, dskip, dinv, dshift)
        for i, (a, r) in enumerate(zip(got["dgrad"], other["dgrad"])):
            (_assert_kernel if i in (0, 5) else _assert_sum)(a, r)
    if stats:
        ks, kq = fused.channel_stats(got["fwd"][0])
        _assert_sum(got["fwd"][1], ks)
        _assert_sum(got["fwd"][2], kq)


# ---------------------------------------------------------------------------
# K4 on inputs of C_in % 32 != 0 (a copy padded to 32-channel blocks)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd", [((8,), 3), ((40,), 3), ((40,), 1),
                                     ((32, 16), 1)], ids=str)
def test_cuda_conv_bnact_ragged_input_grad_matches_plain(cins, kd, dtype):
    """K4's wrapper pads each input of C_in % 32 != 0 (and the weight's
    columns, inv and shift) to 32-channel blocks, runs its body once and
    slices dx, dinv and dshift back: against the plain K4, which needs no
    padding, with statistics cotangents."""
    dev = _cuda()
    xs, inv, shift, w, b, g = _conv_case(dev, dtype, cins, kd, 32, (2, 3))
    y = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, "relu")[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds = torch.randn(32, generator=g).to(dev)
    dq = (0.1 * torch.randn(32, generator=g)).to(dev)
    args = (xs, inv, shift, w, y, dy, ds, dq, "relu")
    fused.reset_launches()
    dxs, dinv, dshift = fused.conv_bnact_dgrad_kernel(*args)
    assert fused.BODY_LAUNCHES == {
        ("conv_bnact_dgrad", fused.dgrad_body(dtype)): 1}
    rxs, rinv, rshift = fused.conv_bnact_dgrad_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(dxs, rxs):
        assert a.shape == r.shape
        _assert_kernel(a, r)
    _assert_sum(dinv, rinv)
    _assert_sum(dshift, rshift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unet_eight_channel_input_grad_matches_reference(dtype):
    """``UNet(in_channels=8)`` with an input that needs a gradient (two
    levels, planar L0): the input's gradient of a training step through
    the kernels (K4 on the padded copy at L0's conv1) against
    reference=True, in the L2 norm with the step's own rounding noise as
    ``_check_step_against_reference`` holds the parameters'."""
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    dev = _cuda()
    m = UNet(in_channels=8, n_blocks=2, start_filts=32, planar_blocks=(0,),
             dtype=dtype, device=dev,
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 16, 24, 8,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    t = (x[..., 0] > 0).long()
    bf16 = dtype == torch.bfloat16
    rel, ulp = (1e-2, 2.0 ** -8) if bf16 else (1e-3, 2.0 ** -23)

    def input_grad(x, reference):
        x = x.clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t).backward()
        return x.grad.float()

    fused.reset_launches()
    got = input_grad(x, False)
    assert fused.BODY_LAUNCHES.get(("conv_bnact_dgrad",
                                    fused.dgrad_body(dtype)), 0) >= 1
    ref = input_grad(x, True)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    moved = input_grad(x * (1 + ulp * noise.to(dev)), True)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).norm())
    assert err <= rel * float(ref.norm()) + 3 * float((moved - ref).norm())


# Row 3's kernel, K1's 'conv1' body (csrc/conv1_fwd.cu): (C_in, C_out,
# kd) at a ragged (2, 3, 45, 37) input: every C_in of 1, 3 and 4 at
# C_out 32, 64 and 256, kd 1 and 3, and C_out / CPT no power of two (96).
CONV1_FWD_CASES = [(1, 32, 1), (1, 64, 1), (1, 256, 1), (1, 32, 3),
                   (3, 32, 1), (3, 64, 3), (3, 256, 3), (4, 32, 3),
                   (4, 64, 1), (4, 256, 1), (1, 96, 1), (3, 96, 1)]


def _conv1_fwd_check(dev, dtype, shape, cin, cout, kd, pro, stats, seed):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(*shape, cin, generator=g).to(dev, dtype)]
    w = (0.3 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    act = "linear"
    if pro:
        inv = torch.randn(cin, generator=g).to(dev)
        shift = torch.randn(cin, generator=g).to(dev)
        act = "relu"
    assert fused.conv_body(dtype, [cin]) == "conv1"
    fused.reset_launches()
    got, s, q = fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, act,
                                            stats)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact": 1}
    assert fused.BODY_LAUNCHES == {("conv_bnact", "conv1"): 1}
    ref, rs, rq = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act,
                                             stats)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    if not stats:
        assert s is None and q is None
        return
    ks, kq = fused.channel_stats(got)
    _assert_sum(s, ks)
    _assert_sum(q, kq)
    if dtype == torch.float32:
        _assert_sum(s, rs)
        _assert_sum(q, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("pro", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd", CONV1_FWD_CASES)
def test_cuda_conv1_fwd_matches_plain(cin, cout, kd, dtype, pro, stats):
    """Row 3's kernel against K1's plain version: the output, and the
    statistics against the plain sums of its own stored output (and, in
    float32, the plain statistics). ``pro``: a relu prologue with random
    vectors, else the network input's identity prologue. One launch, on
    the 'conv1' body."""
    _conv1_fwd_check(_cuda(), dtype, (2, 3, 45, 37), cin, cout, kd, pro,
                     stats, seed=cin + cout + kd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,kd", [
    ((1, 3, 1, 1), 1, 3), ((2, 2, 1, 1), 4, 1), ((3, 1, 5, 1), 3, 1),
    ((2, 33000, 2, 8), 1, 1), ((1, 66000, 3, 5), 3, 3)])
def test_cuda_conv1_fwd_odd_planes(shape, cin, kd, dtype):
    """Row 3's kernel at planes of one voxel, a one-voxel-wide plane and
    N * D > 65535 (its persistent grid walks the tiles of every (n,
    depth) plane), with statistics and a prologue."""
    _conv1_fwd_check(_cuda(), dtype, shape, cin, 32, kd, True, True,
                     seed=sum(shape))


# K6 with the skip's cotangent: (window, C, activation, ties, prologue).
POOL_SKIP_CASES = [
    ((1, 2, 2), 32, "relu", False, True), ((1, 2, 2), 32, "relu", True,
                                           True),
    ((2, 2, 2), 64, "leaky", False, True), ((2, 2, 2), 64, "relu", True,
                                            True),
    ((1, 2, 2), 64, "relu", True, True), ((1, 2, 2), 128, "leaky", False,
                                          True),
    ((2, 2, 2), 128, "relu", True, True), ((1, 2, 2), 256, "relu", False,
                                           True),
    ((2, 2, 2), 512, "relu", True, True), ((1, 2, 2), 512, "leaky", False,
                                           True),
    ((2, 2, 2), 32, "relu", False, False), ((1, 2, 2), 64, "linear", True,
                                            True)]


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c,act,tie,pro", POOL_SKIP_CASES)
def test_cuda_pool_bnact_backward_skip_matches_plain(window, c, act, tie,
                                                     pro, dtype, skip):
    """K6 with and without the skip's cotangent (``dskip``) against its
    plain version: dx bitwise (the same two float32 roundings, then the
    one to the dtype), dinv and dshift within 1e-3. ``tie`` quantizes x
    under a positive scale and a negative shift, so windows hold repeated
    maxima and relu zeros; ``pro`` False is the identity prologue."""
    dev = _cuda()
    g = torch.Generator().manual_seed(c + len(act) + 2 * tie)
    x = torch.randn(2, 4, 6, 10, c, generator=g)
    if tie:
        x = torch.round(2 * x) / 2
    x = x.to(dev, dtype)
    inv = shift = None
    if pro:
        inv = torch.randn(c, generator=g).to(dev)
        shift = torch.randn(c, generator=g).to(dev)
        if tie:
            inv, shift = inv.abs() + 0.5, torch.full_like(shift, -1.0)
    pooled = (2, 4 // window[0], 3, 5, c)
    dp = torch.randn(pooled, generator=g).to(dev, dtype)
    dsk = torch.randn(x.shape, generator=g).to(dev, dtype) if skip else None
    fused.reset_launches()
    dx, dinv, dshift = fused.pool_bnact_bwd_kernel(x, inv, shift, act,
                                                   window, dp, dsk)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "pool_bnact_bwd": 1}
    rdx, rdinv, rdshift = fused.pool_bnact_bwd_plain(x, inv, shift, act,
                                                     window, dp, dsk)
    torch.cuda.synchronize()
    assert torch.equal(dx, rdx)
    if not pro:
        assert dinv is None and dshift is None
        return
    _assert_sum(dinv, rdinv)
    _assert_sum(dshift, rdshift)


def _level_adds(fn, shape):
    """The ``aten::add``/``aten::add_`` calls of ``fn`` (host profile,
    input shapes recorded) with two inputs of ``shape``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
        torch.cuda.synchronize()
    return [e for e in p.events() if e.name in ("aten::add", "aten::add_")
            and [list(s) for s in e.input_shapes[:2]] == [list(shape)] * 2]


@pytest.mark.cuda
def test_cuda_unet_level_input_gets_one_k6_dx():
    """The input of a kernel level (conv2's raw output, also the level's
    skip) takes its gradient from K6 alone: one K6 launch a kernel level
    and step, and no add of two gradients of the level's shape. A control
    graph with the skip as a separate use of x shows that add."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,),
             dtype=torch.bfloat16, device=dev,
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    assert list(m.level_kinds(x.shape)[:2]) == ["kernels", "kernels"]

    def step():
        m.zero_grad()
        m(x).float().square().mean().backward()
    step()
    fused.reset_launches()
    adds = _level_adds(step, (2, 8, 24, 40, 32)) \
        + _level_adds(step, (2, 8, 12, 20, 64))
    assert fused.LAUNCHES["pool_bnact_bwd"] == 4
    assert adds == []

    y = torch.randn(2, 8, 24, 40, 32, device=dev).to(torch.bfloat16)
    y.requires_grad_(True)

    def control():
        p = fused.pool_bnact(y, None, None, "relu", (1, 2, 2))[0]
        (p.float().sum() + (y * 1.0).float().sum()).backward()
    assert len(_level_adds(control, y.shape)) == 1


# ---------------------------------------------------------------------------
# The per-sample mode of K1 (both bodies and row 3's), K2 and K3 (group and
# instance norm): (N, C) prologue vectors and (N, C) statistics, held
# against the plain versions, whose statistics are channel_stats(y, True).
# Each sample's input has its own scale, so that the rows differ.
# ---------------------------------------------------------------------------

def _per_sample_x(shape, c, dtype, dev, g):
    n = shape[0]
    scale = torch.arange(1, n + 1, dtype=torch.float32).view(
        n, *(1,) * len(shape))
    return (scale * torch.randn(*shape, c, generator=g)).to(dev, dtype)


def _per_sample_pro(n, c, dev, g):
    return (torch.randn(n, c, generator=g).to(dev),
            torch.randn(n, c, generator=g).to(dev))


def _assert_per_sample_stats(got, s, q, ref_s, ref_q, dtype):
    """Statistics rows of (N, C): against the plain sums of the kernel's
    own stored output, and in float32 against the plain statistics."""
    ks, kq = fused.channel_stats(got, per_sample=True)
    assert s.shape == q.shape == ks.shape
    for i in range(s.shape[0]):
        _assert_sum(s[i], ks[i])
        _assert_sum(q[i], kq[i])
        if dtype == torch.float32:
            _assert_sum(s[i], ref_s[i])
            _assert_sum(q[i], ref_q[i])


def _assert_per_sample_repeats(run, out, i):
    """The per-sample mode's outputs are the same bits on a rerun, and
    sample ``i``'s are the same bits when it is run alone: ``run(None)``
    reruns the call, ``run(i)`` runs it on sample i's slice of every
    batched argument (its statistics summed in the same fixed order)."""
    again = run(None)
    alone = run(i)
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert a is None or torch.equal(a, b)
    for a, b in zip(out, alone):
        assert a is None or torch.equal(a[i], b[0])


def _slice(v, i):
    return None if v is None else v[i:i + 1].clone()


# (input channels, kd, activation, C_out, (N, D), (H, W)): the headline
# levels' convs (L0 32->32 and the 32+32 merge, L1 kd 3, the C=128 level)
# and a D * H * W past one block of every body.
PS_CONV_CASES = [
    ((32,), 1, "relu", 32, (3, 5), (13, 37)),
    ((32, 32), 1, "relu", 32, (2, 5), (13, 37)),
    ((32,), 3, "relu", 64, (2, 5), (13, 37)),
    ((64, 64), 3, "leaky", 64, (3, 4), (12, 20)),
    ((128, 128), 3, "relu", 128, (2, 3), (9, 11))]


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, "per_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act,cout,nd,hw", PS_CONV_CASES)
def test_cuda_conv_bnact_per_sample_matches_plain(dtype, cins, kd, act, cout,
                                                  nd, hw, want_stats):
    """K1 with (N, C) prologue vectors (row n of them applied to sample n)
    and, with statistics, (N, C_out) sums: one launch, on the
    tensor-core body in bf16 and the CUDA-core body in float32."""
    dev = _cuda()
    g = torch.Generator().manual_seed(sum(cins) + cout + kd)
    xs = [_per_sample_x(nd + hw, c, dtype, dev, g) for c in cins]
    w = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv, shift = _per_sample_pro(nd[0], sum(cins), dev, g)

    def run(i):
        if i is None:
            return fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, act,
                                               want_stats)
        return fused.conv_bnact_fwd_kernel(
            [_slice(x, i) for x in xs], _slice(inv, i), _slice(shift, i), w,
            b, act, want_stats)
    fused.reset_launches()
    got, s, q = run(None)
    body = "tc" if dtype == torch.bfloat16 else "cuda-core"
    assert fused.BODY_LAUNCHES == {("conv_bnact", body): 1}
    ref, rs, rq = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act,
                                             want_stats)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    _assert_per_sample_repeats(run, (got, s, q), 1)
    if not want_stats:
        assert s is None and q is None
        return
    _assert_per_sample_stats(got, s, q, rs, rq, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pro", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout,kd", [
    ((6, 8, 64, 64), 1, 32, 1), ((5, 4, 64, 96), 1, 64, 3),
    ((6, 8, 64, 64), 3, 32, 1), ((3, 3, 45, 37), 1, 32, 1)])
def test_cuda_conv1_fwd_per_sample_straddles_samples(shape, cin, cout, kd,
                                                     dtype, pro):
    """Row 3's kernel with per-sample statistics (and a per-sample
    prologue). Its persistent blocks walk tiles a grid apart: at 6 x 8
    planes of 16 tiles (768 tiles, more than the blocks that fit the
    card's SMs) the batch form's blocks take tiles of two or more
    samples; the per-sample mode walks each sample's tiles with blocks of
    its own, whose partial rows are summed in a fixed order: the same
    bits on a rerun and for a sample run alone."""
    dev = _cuda()
    g = torch.Generator().manual_seed(sum(shape) + cin)
    xs = [_per_sample_x(shape, cin, dtype, dev, g)]
    w = (0.3 * torch.randn(cout, cin, kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    act = "linear"
    if pro:
        inv, shift = _per_sample_pro(shape[0], cin, dev, g)
        act = "relu"

    def run(i):
        if i is None:
            return fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, act,
                                               "per_sample")
        return fused.conv_bnact_fwd_kernel(
            [_slice(xs[0], i)], _slice(inv, i), _slice(shift, i), w, b, act,
            "per_sample")
    fused.reset_launches()
    got, s, q = run(None)
    assert fused.BODY_LAUNCHES == {("conv_bnact", "conv1"): 1}
    ref, rs, rq = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, act,
                                             "per_sample")
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    _assert_per_sample_stats(got, s, q, rs, rq, dtype)
    _assert_per_sample_repeats(run, (got, s, q), shape[0] - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c,nd", [
    ((1, 2, 2), 32, (3, 4)), ((2, 2, 2), 64, (2, 4)),
    ((2, 2, 2), 128, (3, 2))])
def test_cuda_pool_bnact_per_sample_matches_plain(dtype, window, c, nd):
    """K2 with (N, C) prologue vectors: exact, as the batch form."""
    dev = _cuda()
    g = torch.Generator().manual_seed(c)
    x = _per_sample_x(nd + (6, 10), c, dtype, dev, g)
    inv, shift = _per_sample_pro(nd[0], c, dev, g)
    got = fused.pool_bnact(x, inv, shift, "relu", window)[0]
    ref = fused.pool_bnact(x, inv, shift, "relu", window, reference=True)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# (C_in, C_out, kd, prologue, (N, D), (H, W)): D * H * W of 105, 60 and
# 10,648 voxels (the bench L2 carry (22, 22, 22)), none a multiple of the
# tensor-core body's 64-voxel blocks, so the batch grid's blocks would
# straddle two samples; then the planar up_2 from the C=64 carry.
PS_UPCONV_CASES = [(128, 64, 2, True, (3, 3), (5, 7)),
                   (64, 32, 1, True, (3, 3), (4, 5)),
                   (128, 64, 2, False, (2, 3), (5, 7)),
                   (128, 64, 2, True, (2, 22), (22, 22)),
                   (256, 128, 2, True, (2, 2), (3, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("want_stats", [False, "per_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd,pro,nd,hw", PS_UPCONV_CASES)
def test_cuda_upconv_bnact_per_sample_matches_plain(dtype, cin, cout, kd,
                                                    pro, nd, hw, want_stats):
    """K3 with (N, C_in) prologue vectors and (N, C_out) statistics, at
    sample sizes that are no multiple of a block: its grid is (blocks of
    a sample, sample) in this mode; the same bits on a rerun and for a
    sample run alone."""
    dev = _cuda()
    g = torch.Generator().manual_seed(cin + kd + hw[0])
    x = _per_sample_x(nd + hw, cin, dtype, dev, g)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = shift = None
    act = "linear"
    if pro:
        inv, shift = _per_sample_pro(nd[0], cin, dev, g)
        act = "relu"
    if not pro and not want_stats:
        want_stats = "per_sample"   # a dense input: the statistics alone

    def run(i):
        if i is None:
            return fused.upconv_bnact_fwd_kernel(x, inv, shift, w, b, act,
                                                 want_stats)
        return fused.upconv_bnact_fwd_kernel(
            _slice(x, i), _slice(inv, i), _slice(shift, i), w, b, act,
            want_stats)
    fused.reset_launches()
    got, s, q = run(None)
    assert fused.LAUNCHES["upconv_bnact"] == 1
    ref, rs, rq = fused.upconv_bnact_fwd_plain(x, inv, shift, w, b, act,
                                               want_stats)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    _assert_per_sample_repeats(run, (got, s, q), 1)
    if not want_stats:
        assert s is None and q is None
        return
    _assert_per_sample_stats(got, s, q, rs, rq, dtype)


# ---------------------------------------------------------------------------
# The per-sample backward of row 13, K4, K5, K6 and K7 (training group and
# instance norm): (N, C) statistics cotangents and (N, C) prologue vectors
# in, (N, C) dinv and dshift out, each row against the plain version's;
# dinv and dshift (and dx) the same bits on a rerun and for a sample run
# alone (each block's partial row, summed in a fixed order); dW and db
# global as in the batch form.
# ---------------------------------------------------------------------------

def _ps_cts(n, c, dev, g):
    """(N, C) statistics cotangents, rows of different scales."""
    scale = torch.arange(1, n + 1, dtype=torch.float32).view(n, 1)
    return ((1e-3 * scale * torch.randn(n, c, generator=g)).to(dev),
            (1e-4 * scale * torch.randn(n, c, generator=g)).to(dev))


def _assert_rows(got, ref):
    assert got.shape == ref.shape and got.dim() == 2
    for i in range(got.shape[0]):
        _assert_sum(got[i], ref[i])


def _assert_bwd(got, ref, what):
    """A backward result (dxs or dx, dinv, dshift, dW, db), item by item:
    dx within the kernel tolerance, (N, C) rows and global sums within
    the sums' tolerance."""
    for k, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None, (what, k)
        elif isinstance(b, (list, tuple)):
            for ai, bi in zip(a, b):
                _assert_kernel(ai, bi)
        elif b.dtype != torch.float32 or b.dim() > 2:
            _assert_kernel(a, b)
        elif b.dim() == 2:
            _assert_rows(a, b)
        else:
            _assert_sum(a, b)


def _assert_bwd_repeats(run, out, i, keep):
    """The items ``keep`` of a per-sample backward result are the same
    bits on a rerun, and sample ``i``'s rows the same bits when it runs
    alone (``run(i)``)."""
    again, alone = run(None), run(i)
    torch.cuda.synchronize()
    for k in keep:
        a, b, c = out[k], again[k], alone[k]
        if isinstance(a, (list, tuple)):
            a, b, c = a[0], b[0], c[0]
        assert torch.equal(a, b), k
        assert torch.equal(a[i], c[0]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act,cout,nd,hw", PS_CONV_CASES)
def test_cuda_conv_bnact_per_sample_backward_matches_plain(dtype, cins, kd,
                                                           act, cout, nd,
                                                           hw):
    """K4 and K5 with (N, C_in) prologue vectors and (N, C_out)
    statistics cotangents, on the tensor-core bodies in bf16 and the
    CUDA-core bodies in float32 (K4's kd = 3 bf16 cases through the
    pre-pass)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(sum(cins) + cout + kd + 7)
    xs = [_per_sample_x(nd + hw, c, dtype, dev, g) for c in cins]
    w = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    inv, shift = _per_sample_pro(nd[0], sum(cins), dev, g)
    y = _per_sample_x(nd + hw, cout, dtype, dev, g)
    dy = (0.1 * torch.randn(*y.shape, generator=g)).to(dev, dtype)
    ds, dq = _ps_cts(nd[0], cout, dev, g)
    for kfn, pfn in ((fused.conv_bnact_dgrad_kernel,
                      fused.conv_bnact_dgrad_plain),
                     (fused.conv_bnact_wgrad_kernel,
                      fused.conv_bnact_wgrad_plain)):
        def run(i):
            if i is None:
                return kfn(xs, inv, shift, w, y, dy, ds, dq, act)
            return kfn([_slice(x, i) for x in xs], _slice(inv, i),
                       _slice(shift, i), w, _slice(y, i), _slice(dy, i),
                       _slice(ds, i), _slice(dq, i), act)
        fused.reset_launches()
        got = run(None)
        name = "conv_bnact_dgrad" if kfn is fused.conv_bnact_dgrad_kernel \
            else "conv_bnact_wgrad"
        assert fused.LAUNCHES[name] == 1 and fused.PS_LAUNCHES == {name: 1}
        ref = pfn(xs, inv, shift, w, y, dy, ds, dq, act)
        torch.cuda.synchronize()
        _assert_bwd(got, ref, name)
        if name == "conv_bnact_dgrad":
            assert got[1].shape == (nd[0], sum(cins))
            _assert_bwd_repeats(run, got, 1, (0, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("input_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,pro", [
    ((6, 8, 64, 64), 1, False), ((3, 3, 45, 37), 1, True),
    ((5, 4, 40, 96), 3, True)])
def test_cuda_conv1_bwd_per_sample_matches_plain(shape, cin, pro, dtype,
                                                 input_grad):
    """Row 13's kernel with (N, C_out) statistics cotangents (its
    persistent blocks walk tiles of several samples and restage each
    sample's rows) and, with ``input_grad`` and an (N, C_in) prologue,
    (N, C_in) dinv and dshift from each tile's partial row. Its dx adds
    the ring voxels' shares by shared-memory atomics, as in the batch
    form, so dx (and dinv, dshift from it) may differ in the last bits
    between runs: no path of a model runs it with dx and a prologue."""
    dev = _cuda()
    g = torch.Generator().manual_seed(sum(shape) + cin + 13)
    xs = [_per_sample_x(shape, cin, dtype, dev, g)]
    w = (0.3 * torch.randn(32, cin, 1, 3, 3, generator=g)).to(dev)
    inv = shift = None
    act = "linear"
    if pro:
        inv, shift = _per_sample_pro(shape[0], cin, dev, g)
        act = "relu"
    y = _per_sample_x(shape, 32, dtype, dev, g)
    dy = (0.1 * torch.randn(*y.shape, generator=g)).to(dev, dtype)
    ds, dq = _ps_cts(shape[0], 32, dev, g)

    def run(i):
        if i is None:
            return fused.conv1_bwd_kernel(xs, inv, shift, w, y, dy, ds, dq,
                                          act, input_grad)
        return fused.conv1_bwd_kernel(
            [_slice(xs[0], i)], _slice(inv, i), _slice(shift, i), w,
            _slice(y, i), _slice(dy, i), _slice(ds, i), _slice(dq, i), act,
            input_grad)
    fused.reset_launches()
    got = run(None)
    assert fused.PS_LAUNCHES == {"conv1_bwd": 1}
    ref = fused.conv1_bwd_plain(xs, inv, shift, w, y, dy, ds, dq, act,
                                input_grad)
    torch.cuda.synchronize()
    _assert_bwd(got, ref, "conv1_bwd")
    if input_grad and pro:
        assert got[1].shape == (shape[0], cin)
        # A sample run alone: its rows as in the batch.
        i = shape[0] - 1
        alone = run(i)
        torch.cuda.synchronize()
        _assert_kernel(alone[0][0][0], ref[0][0][i])
        _assert_sum(alone[1][0], ref[1][i])
        _assert_sum(alone[2][0], ref[2][i])


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,c,nd,hw", [
    ((1, 2, 2), 32, (3, 4), (6, 10)), ((2, 2, 2), 64, (2, 4), (6, 10)),
    ((2, 2, 2), 128, (3, 2), (6, 10)), ((1, 2, 2), 32, (2, 44), (44, 44))])
def test_cuda_pool_bnact_per_sample_backward_matches_plain(dtype, window, c,
                                                           nd, hw, skip):
    """K6 with (N, C) prologue vectors: dx exact, as the batch form, and
    (N, C) dinv, dshift from its per-sample grid."""
    dev = _cuda()
    g = torch.Generator().manual_seed(c + nd[1])
    x = _per_sample_x(nd + hw, c, dtype, dev, g)
    inv, shift = _per_sample_pro(nd[0], c, dev, g)
    pooled = (nd[0], nd[1] // window[0], hw[0] // 2, hw[1] // 2, c)
    dp = (0.1 * torch.randn(*pooled, generator=g)).to(dev, dtype)
    dsk = (0.1 * torch.randn(*x.shape, generator=g)).to(dev, dtype) \
        if skip else None

    def run(i):
        if i is None:
            return fused.pool_bnact_bwd_kernel(x, inv, shift, "relu", window,
                                               dp, dsk)
        return fused.pool_bnact_bwd_kernel(
            _slice(x, i), _slice(inv, i), _slice(shift, i), "relu", window,
            _slice(dp, i), _slice(dsk, i))
    fused.reset_launches()
    got = run(None)
    assert fused.PS_LAUNCHES == {"pool_bnact_bwd": 1}
    ref = fused.pool_bnact_bwd_plain(x, inv, shift, "relu", window, dp, dsk)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    _assert_rows(got[1], ref[1])
    _assert_rows(got[2], ref[2])
    _assert_bwd_repeats(run, got, 1, (1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,body", [
    (torch.float32, "cuda-core"), (torch.bfloat16, "tc"),
    (torch.bfloat16, "cuda-core")])
@pytest.mark.parametrize("cin,cout,kd,pro,nd,hw", PS_UPCONV_CASES)
def test_cuda_upconv_bnact_per_sample_backward_matches_plain(dtype, body,
                                                             cin, cout, kd,
                                                             pro, nd, hw):
    """K7 with (N, C_out) statistics cotangents (the bf16 pre-pass reads
    each voxel's sample's row) and an (N, C_in) prologue: the dgrad's
    per-sample grid at sample sizes that are no multiple of a block, its
    (N, C_in) dinv, dshift; the tensor-core bodies in bf16, the
    CUDA-core bodies in float32 and, on request, in bf16."""
    dev = _cuda()
    g = torch.Generator().manual_seed(cin + kd + hw[0] + 5)
    x = _per_sample_x(nd + hw, cin, dtype, dev, g)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    inv = shift = None
    act = "linear"
    if pro:
        inv, shift = _per_sample_pro(nd[0], cin, dev, g)
        act = "relu"
    yshape = (nd[0], kd * nd[1], 2 * hw[0], 2 * hw[1], cout)
    y = _per_sample_x(yshape[:-1], cout, dtype, dev, g)
    dy = (0.1 * torch.randn(*yshape, generator=g)).to(dev, dtype)
    ds, dq = _ps_cts(nd[0], cout, dev, g)

    def run(i):
        if i is None:
            return fused.upconv_bnact_bwd_kernel(x, inv, shift, w, y, dy, ds,
                                                 dq, act, True, body)
        return fused.upconv_bnact_bwd_kernel(
            _slice(x, i), _slice(inv, i), _slice(shift, i), w, _slice(y, i),
            _slice(dy, i), _slice(ds, i), _slice(dq, i), act, True, body)
    fused.reset_launches()
    got = run(None)
    assert fused.BODY_LAUNCHES == {("upconv_bnact_bwd", body): 1}
    assert fused.PS_LAUNCHES == {"upconv_bnact_bwd": 1}
    ref = fused.upconv_bnact_bwd_plain(x, inv, shift, w, y, dy, ds, dq, act)
    torch.cuda.synchronize()
    _assert_bwd(got, ref, "upconv_bnact_bwd")
    if pro:
        assert got[1].shape == (nd[0], cin)
        _assert_bwd_repeats(run, got, 1, (0, 1, 2))


def _group_unet(norm, dtype, dev, seed=0):
    """The headline structure with ``norm`` and random affine
    parameters."""
    from elektronn3_tpu_torch.models import UNet
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             normalization=norm, device=dev,
             generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if ".norm" in name:
                p.copy_(torch.randn(p.shape, generator=g)
                        if name.endswith("weight")
                        else 0.1 * torch.randn(p.shape, generator=g))
    return m.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["group", "instance"])
def test_cuda_unet_group_norm_matches_reference_forward(dtype, norm):
    """The headline structure with a group norm serves on the kernels'
    per-sample mode: K1 (row 3 once), K2 and K3 as under 'batch', no
    CUDA-core K1 in bf16, the same bits on a second call, and the forward
    tracks forward(reference=True). A training step through its kernel
    levels runs every backward kernel in the per-sample mode
    (``test_cuda_unet_group_norm_training_matches_reference`` holds it
    against the reference)."""
    dev = _cuda()
    m = _group_unet(norm, dtype, dev)
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    x[1] *= 3.0
    fused.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"conv_bnact": 8, "pool_bnact": 2,
                              "upconv_bnact": 2, "conv_bnact_dgrad": 0,
                              "conv_bnact_wgrad": 0, "conv1_bwd": 0,
                              "pool_bnact_bwd": 0, "upconv_bnact_bwd": 0,
                              **_NO_BN, **_NO_VUP}
    if dtype == torch.bfloat16:
        assert fused.BODY_LAUNCHES[("conv_bnact", "conv1")] == 1
        assert ("conv_bnact", "cuda-core") not in fused.BODY_LAUNCHES
    assert torch.equal(m(x), y)   # the statistics' fixed order
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())
    m.train()
    fused.reset_launches()
    m(x).float().square().mean().backward()
    bwd = ("conv_bnact_dgrad", "conv_bnact_wgrad", "conv1_bwd",
           "pool_bnact_bwd", "upconv_bnact_bwd")
    assert all(fused.LAUNCHES[k] > 0 for k in bwd)
    assert {k: fused.PS_LAUNCHES.get(k, 0) for k in fused.LAUNCHES} == \
        fused.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["group", "instance"])
def test_cuda_unet_group_norm_training_matches_reference(dtype, norm):
    """One training step of the group and instance models through the
    kernels' per-sample mode against the same step through
    reference=True (``_check_step_against_reference``; under 'group' a
    conv's bias gradient is no exact 0, so it is held like the other
    leaves): every launch of K1-K7 and row 13's in the per-sample mode,
    and the step's (N, C) prologue gradients the same bits on a rerun."""
    dev = _cuda()
    m = _group_unet(norm, dtype, dev)
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    x[1] *= 3.0
    t = (x[..., 0] > 0).long()
    launches = _check_step_against_reference(m, x, t, dtype,
                                             zero_bias=norm != "group")
    assert launches["conv1_bwd"] == 1 and launches["pool_bnact_bwd"] == 2
    assert launches["upconv_bnact_bwd"] == 2
    assert {k: fused.PS_LAUNCHES.get(k, 0) for k in launches} == launches
    # The same bits of every gradient that reaches a prologue, the kernel
    # levels' norm parameters, with cuDNN's deterministic algorithms on
    # the library levels (some of its backward algorithms add with
    # atomics).
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, g1 = _step_grads(m, x, t, False)
        _, g2 = _step_grads(m, x, t, False)
    finally:
        torch.backends.cudnn.deterministic = det
    for name in g1:
        if (name.startswith("down_convs.0") or name.startswith(
                "down_convs.1")) and ".norm" in name:
            assert torch.equal(g1[name], g2[name]), name


@pytest.mark.cuda
def test_cuda_group_predictor_does_not_depend_on_batch_size():
    """Each tile of a Predictor batch is a sample with its own group
    statistics: batch 1 and batch 2 give the same probabilities (within
    the bf16 forward tolerance; the kernel levels' bits are the same,
    the library levels' convs may pick other algorithms by batch), and a
    request repeats its probabilities bit for bit."""
    from elektronn3_tpu_torch.inference import Predictor
    dev = _cuda()
    m = _group_unet("group", torch.bfloat16, dev)
    x = torch.randn(1, 1, 16, 96, 96,
                    generator=torch.Generator().manual_seed(3)).numpy()
    outs = [Predictor(m, batch_size=bs, tile_shape=(8, 48, 48),
                      overlap_shape=(4, 8, 8), float16=True).predict(x)
            for bs in (1, 2, 2)]
    assert outs[0].shape == (1, 2, 16, 96, 96)
    assert float(abs(outs[0] - outs[1]).max()) <= 5e-2
    assert (outs[1] == outs[2]).all()


# ---------------------------------------------------------------------------
# The vup path's per-sample mode (group and instance norm under vup=True):
# its five entries with (N, C) prologue rows for the carry and the merge,
# (N, C) statistics and statistics cotangents, on the tensor-core bodies in
# bf16 and the CUDA-core bodies in both dtypes, against their plain
# versions; the per-sample sums and gradients the same bits on a rerun and
# for a sample run alone.
# ---------------------------------------------------------------------------

# ((N, D, H, W) of the merge level, C_carry, C_up): the shapes of
# VUP_SHAPES; three samples of 70 carry voxels (no multiple of a 64-voxel
# tile, so row 22's and 23's tiles end inside each sample); the largest
# template case (C_up 64: two items a tile in row 9's dgrad).
PS_VUP_CASES = [((2, 3, 10, 14), 64, 32), ((3, 2, 10, 14), 64, 32),
                ((1, 2, 18, 70), 64, 32), ((2, 2, 10, 14), 128, 64)]
PS_VUP_BODIES = [(torch.bfloat16, "tc"), (torch.bfloat16, "cuda-core"),
                 (torch.float32, "cuda-core")]


def _ps_vup_case(dev, dtype, shape, cc, cu, seed):
    """(up, merge): the carry with (N, C_cc) prologue rows, the upconv,
    and the skip with the (N, C_cu + 32) merge prologue and 32-channel
    merge conv, each sample of its own scale."""
    n, d, h, w = shape
    g = torch.Generator().manual_seed(seed)
    carry = _per_sample_x((n, d, h // 2, w // 2), cc, dtype, dev, g)
    invc, shiftc = _per_sample_pro(n, cc, dev, g)
    up = (carry, invc, shiftc,
          (0.2 * torch.randn(cc, cu, 1, 2, 2, generator=g)).to(dev),
          (0.1 * torch.randn(cu, generator=g)).to(dev))
    skip = _per_sample_x((n, d, h, w), 32, dtype, dev, g)
    inv, shift = _per_sample_pro(n, cu + 32, dev, g)
    merge = (skip, inv, shift,
             (0.1 * torch.randn(32, cu + 32, 1, 3, 3, generator=g)).to(dev),
             torch.randn(32, generator=g).to(dev))
    return up, merge, g


def _ps_slice(args, i):
    """Sample i's slice of every batched argument: the activations and
    the (N, C) rows (each weight's first dimension is a channel count
    above N)."""
    n = args[0].shape[0]
    return tuple(_slice(a, i) if isinstance(a, torch.Tensor) and a.dim() > 1
                 and a.shape[0] == n else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,body", PS_VUP_BODIES, ids=str)
@pytest.mark.parametrize("shape,cc,cu", PS_VUP_CASES, ids=str)
def test_cuda_vup_per_sample_forward_matches_plain(shape, cc, cu, dtype,
                                                   body):
    """``conv_vup`` with per-sample statistics (row 1's vup mode) and
    ``upconv_stats`` per sample (row 22), one per-sample launch each on
    ``body``: the output within the kernel tolerance, each (N, C) row of
    the statistics against the plain sums of the kernel's own stored
    output (float32: and against the plain statistics), every output the
    same bits on a rerun and for a sample alone."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    up, merge, _ = _ps_vup_case(dev, dtype, shape, cc, cu, sum(shape) + cu)
    args = (*up, *merge)
    fused.reset_launches()

    def run_fwd(i):
        a = args if i is None else _ps_slice(args, i)
        return vup.conv_vup_fwd_kernel(*a, "relu", "relu", "per_sample",
                                       body=body)

    def run_stats(i):
        a = up if i is None else _ps_slice(up, i)
        return vup.upconv_stats_kernel(*a, "relu", "per_sample", body=body)
    got, s, q = run_fwd(None)
    su, qu = run_stats(None)
    assert fused.BODY_LAUNCHES == {("conv_vup", body): 1,
                                   ("upconv_stats", body): 1}
    assert fused.PS_LAUNCHES == {"conv_vup": 1, "upconv_stats": 1}
    ref, rs, rq = vup.conv_vup_fwd_plain(*args, "relu", "relu", "per_sample")
    rsu, rqu = vup.upconv_stats_plain(*up, "relu", "per_sample")
    torch.cuda.synchronize()
    _assert_kernel(got, ref)
    _assert_per_sample_stats(got, s, q, rs, rq, dtype)
    assert su.shape == (shape[0], cu)
    _assert_rows(su, rsu)
    _assert_rows(qu, rqu)
    i = shape[0] - 1
    _assert_per_sample_repeats(run_fwd, (got, s, q), i)
    _assert_per_sample_repeats(run_stats, (su, qu), i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,body", PS_VUP_BODIES, ids=str)
@pytest.mark.parametrize("shape,cc,cu", PS_VUP_CASES, ids=str)
def test_cuda_vup_per_sample_backward_matches_plain(shape, cc, cu, dtype,
                                                    body):
    """``conv_vup_dgrad`` and ``conv_vup_wgrad`` (row 9) with (N, C)
    statistics cotangents, and ``upconv_stats_bwd`` (row 23) with (N, C_u)
    ones, on ``body``, each one per-sample launch: dcarry and dskip
    within the kernel tolerance, each (N, C) row of dinv, dshift, dinvc
    and dshiftc and the global dW, db, dwu and dbu within the sums'
    tolerance; dcarry, dskip and the (N, C) rows the same bits on a rerun
    and for a sample alone."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    up, merge, g = _ps_vup_case(dev, dtype, shape, cc, cu,
                                sum(shape) + cu + 1)
    skip, inv, shift, wt, _ = merge
    n = shape[0]
    y = vup.conv_vup_fwd_plain(*up, *merge, "relu", "relu")[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds, dq = _ps_cts(n, 32, dev, g)
    dsu, dqu = _ps_cts(n, cu, dev, g)
    bargs = (*up, skip, inv, shift, wt, y, dy, ds, dq)
    sargs = (*up, dsu, dqu)

    def runner(fn, a0):
        def run(i):
            a = a0 if i is None else _ps_slice(a0, i)
            tail = ("relu", "relu") if fn is not vup.upconv_stats_bwd_kernel \
                else ("relu",)
            return fn(*a, *tail, body=body)
        return run
    fused.reset_launches()
    runs = {name: runner(fn, a) for name, fn, a in (
        ("conv_vup_dgrad", vup.conv_vup_dgrad_kernel, bargs),
        ("conv_vup_wgrad", vup.conv_vup_wgrad_kernel, bargs),
        ("upconv_stats_bwd", vup.upconv_stats_bwd_kernel, sargs))}
    got = {k: r(None) for k, r in runs.items()}
    assert fused.PS_LAUNCHES == dict.fromkeys(runs, 1)
    assert fused.BODY_LAUNCHES == {(k, body): 1 for k in runs}
    ref = {"conv_vup_dgrad": vup.conv_vup_dgrad_plain(*bargs, "relu", "relu"),
           "conv_vup_wgrad": vup.conv_vup_wgrad_plain(*bargs, "relu", "relu"),
           "upconv_stats_bwd": vup.upconv_stats_bwd_plain(*sargs, "relu")}
    torch.cuda.synchronize()
    # dcarry and dskip elementwise, (N, C) rows row by row, the rest (the
    # weight and bias gradients, float32 sums over the batch) as sums, as
    # test_cuda_vup_backward_matches_plain holds them.
    elementwise = {"conv_vup_dgrad": (0, 5), "conv_vup_wgrad": (),
                   "upconv_stats_bwd": (0,)}
    for k in runs:
        for i, (a, r) in enumerate(zip(got[k], ref[k])):
            if i in elementwise[k]:
                _assert_kernel(a, r)
            elif r.dim() == 2:
                _assert_rows(a, r)
            else:
                _assert_sum(a, r)
    d = got["conv_vup_dgrad"]
    assert d[1].shape == (n, cc) and d[6].shape == (n, cu + 32)
    # (dcarry, dinvc, dshiftc, ., ., dskip, dinv, dshift); row 23's
    # (dcarry, dinvc, dshiftc)
    _assert_bwd_repeats(runs["conv_vup_dgrad"], d, n - 1, (0, 1, 2, 5, 6, 7))
    _assert_bwd_repeats(runs["upconv_stats_bwd"], got["upconv_stats_bwd"],
                        n - 1, (0, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["group", "instance"])
def test_cuda_unet_vup_group_matches_reference(dtype, norm):
    """The headline structure with ``vup=True`` and a group norm: a step
    launches the five vup entries once each, every launch in the
    per-sample mode, no upconv into L0, and tracks reference=True
    (``_check_step_against_reference``); the eval forward runs the
    statistics pass and the vup merge conv per sample, the same bits on a
    second call, and tracks reference=True."""
    dev = _cuda()
    m = _group_unet(norm, dtype, dev)
    m.vup = True
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    x[1] *= 3.0
    t = (x[..., 0] > 0).long()
    launches = _check_step_against_reference(m, x, t, dtype,
                                             zero_bias=norm != "group")
    assert launches == {**dict.fromkeys(launches, 0), "conv_bnact": 7,
                        "pool_bnact": 2, "upconv_bnact": 1,
                        "conv_bnact_dgrad": 6, "conv_bnact_wgrad": 6,
                        "conv1_bwd": 1, "pool_bnact_bwd": 2,
                        "upconv_bnact_bwd": 1, "conv_vup": 1,
                        "conv_vup_dgrad": 1, "conv_vup_wgrad": 1,
                        "upconv_stats": 1, "upconv_stats_bwd": 1}
    assert {k: fused.PS_LAUNCHES.get(k, 0) for k in launches} == launches
    m.eval()
    fused.reset_launches()
    y = m(x)
    assert fused.LAUNCHES == {**dict.fromkeys(fused.LAUNCHES, 0),
                              "conv_bnact": 7, "pool_bnact": 2,
                              "upconv_bnact": 1, "conv_vup": 1,
                              "upconv_stats": 1}
    assert fused.PS_LAUNCHES == {k: v for k, v in fused.LAUNCHES.items()
                                 if v}
    assert torch.equal(m(x), y)
    ref = m(x, reference=True)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vup", [False, True])
def test_cuda_unet_2d_group_matches_reference(dtype, vup):
    """The 2D model (``dim=2``, four levels) with a group norm: its L0-L2
    kernel levels (rows 16, 17, 19, 20 and the C=128 level's) run every
    launch of a training step in the per-sample mode, with ``vup`` too,
    and the step tracks reference=True; the eval forward the same bits on
    a second call."""
    from elektronn3_tpu_torch.models import UNet
    dev = _cuda()
    m = UNet(n_blocks=4, start_filts=32, dim=2, dtype=dtype,
             normalization="group", vup=vup, pallas_flat=True, device=dev,
             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 48, 64, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    x[1] *= 3.0
    t = (x[..., 0] > 0).long()
    assert m.level_kinds(x.shape) == ["kernels"] * 3 + ["library"]
    launches = _check_step_against_reference(m, x, t, dtype,
                                             zero_bias=False)
    assert launches["pool_bnact_bwd"] == 3 and launches["conv1_bwd"] == 1
    assert launches["conv_vup_dgrad"] == int(vup)
    assert {k: fused.PS_LAUNCHES.get(k, 0) for k in launches} == launches
    m.eval()
    y = m(x)
    assert torch.equal(m(x), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_vup_per_sample_mixed_vectors_match_plain(dtype):
    """A per-sample launch whose carry prologue is (C,) (repeated into the
    kernel's rows) and whose merge prologue and statistics cotangents are
    (N, C): dinvc and dshiftc come back (C,), the samples' rows summed,
    against the plain versions, which broadcast the (C,) vector."""
    from elektronn3_tpu_torch.ops import vup
    dev = _cuda()
    up, merge, g = _ps_vup_case(dev, dtype, (2, 3, 10, 14), 64, 32, 21)
    up = (up[0], up[1][0].contiguous(), up[2][0].contiguous(), *up[3:])
    y = vup.conv_vup_fwd_plain(*up, *merge, "relu", "relu")[0]
    dy = (0.1 * torch.randn(y.shape, generator=g)).to(dev, dtype)
    ds, dq = _ps_cts(2, 32, dev, g)
    bargs = (*up, *merge[:4], y, dy, ds, dq, "relu", "relu")
    fused.reset_launches()
    got = vup.conv_vup_dgrad_kernel(*bargs)
    assert fused.PS_LAUNCHES == {"conv_vup_dgrad": 1}
    ref = vup.conv_vup_dgrad_plain(*bargs)
    torch.cuda.synchronize()
    assert got[1].shape == (64,) and got[6].shape == (2, 64)
    for i, (a, r) in enumerate(zip(got, ref)):
        if i in (0, 5):
            _assert_kernel(a, r)
        elif r.dim() == 2:
            _assert_rows(a, r)
        else:
            _assert_sum(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_trainer_multi_accumulates_kernel_gradients(dtype, tmp_path):
    """``TrainerMulti`` on the kernels: the gradient its optimizer step
    sees is the mean of the two micro-batches' gradients as their
    backwards delivered them (K4, K5 and row 13's dW and db, recorded by
    a hook on each parameter before they are added into ``.grad``), to
    float32 rounding; rows 3 and 13 launch once a micro-batch. (Two
    backwards of the same batch on the kernels are not the same bits:
    their float32 sums run in another order each time.)"""
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.training import TrainerMulti
    dev = _cuda()
    m = UNet(n_blocks=3, start_filts=32, planar_blocks=(0,), dtype=dtype,
             device=dev, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(2, 8, 16, 16, 1, generator=g).to(dev, dtype)
          for _ in range(2)]
    ts = [(x[..., 0] > 0).long() for x in xs]
    parts = {n: [] for n, _ in m.named_parameters()}
    for n, p in m.named_parameters():
        p.register_hook(lambda gr, n=n: parts[n].append(gr.float().clone()))
    tr = TrainerMulti(m, CEDiceLoss(), optimizer=torch.optim.SGD(
        m.parameters(), lr=0.0), optimizer_iterations=2, loss_crop=(1, 2, 2),
        save_root=str(tmp_path), exp_name="multi", enable_tensorboard=False)
    seen = {}
    tr.optimizer.register_step_pre_hook(lambda opt, a, k: seen.update(
        {n: p.grad.float().clone() for n, p in m.named_parameters()}))
    fused.reset_launches()
    for x, t in zip(xs, ts):
        tr._train_batch({"inp": x, "target": t}, None)
    assert fused.BODY_LAUNCHES.get(("conv_bnact", "conv1"), 0) == 2
    assert fused.LAUNCHES["conv1_bwd"] == 2
    assert fused.LAUNCHES["conv_bnact_wgrad"] > 0
    for n, got in seen.items():
        assert len(parts[n]) == 2, n
        want = (parts[n][0] + parts[n][1]) / 2
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale, n
    assert all(p.grad is None for p in m.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_cuda_gnn_step_matches_cpu(conv):
    """A GNN step's loss and gradients on the card against the CPU's
    from the same weights (float32; ``index_add_`` sums with atomics on
    the card): within 1e-4 of each leaf's scale."""
    import copy
    from elektronn3_tpu_torch.modules.graph import GNN
    from elektronn3_tpu_torch.training.trainer_gnn import masked_nll
    dev = _cuda()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(500, 24, generator=g)
    ei = torch.randint(0, 500, (2, 3000), generator=g)
    y = torch.randint(0, 5, (500,), generator=g)
    torch.manual_seed(3)
    cpu = GNN(24, hidden=32, out_channels=5, conv=conv, dropout=0.0,
              device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    out = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        logits, _ = m(x.to(d), ei.to(d), train=True)
        loss = masked_nll(logits, y.to(d))
        loss.backward()
        out.append((float(loss), {n: p.grad.cpu()
                                  for n, p in m.named_parameters()}))
    (lc, gc), (lk, gk) = out
    assert abs(lk - lc) <= 1e-5 * abs(lc)
    for n, r in gc.items():
        assert float((gk[n] - r).abs().max()) <= \
            1e-4 * float(r.abs().max()), n
