"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card (marked ``cuda``; skips without a CUDA device).
Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small and ragged (odd H and W, partial tiles). Tolerances:
float32 1e-4 of the output's scale (TF32 off in the reference);
bfloat16 1e-2 of the scale plus one bfloat16 ulp of each stored value,
since the kernel and the reference sum in different orders before the
one rounding. The pool is exact.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cins,kd,act", [
    ((1,), 1, "linear"), ((32,), 1, "relu"), ((32, 32), 1, "relu"),
    ((32,), 3, "linear"), ((64,), 3, "leaky"), ((64, 64), 3, "relu")])
def test_cuda_conv_bnact_matches_plain(dtype, cins, kd, act):
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 5, 13, 37, c, generator=g).to(dev, dtype)
          for c in cins]
    cout = 64 if kd == 3 else 32
    w = (0.1 * torch.randn(cout, sum(cins), kd, 3, 3, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(sum(cins), generator=g).to(dev)
    shift = torch.randn(sum(cins), generator=g).to(dev)
    got = fused.conv_bnact(xs, inv, shift, w, b, act)
    ref = fused.conv_bnact(xs, inv, shift, w, b, act, reference=True)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)


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
@pytest.mark.parametrize("cin,cout,kd,pro", [
    (128, 64, 2, False), (64, 32, 1, True)])
def test_cuda_upconv_bnact_matches_plain(dtype, cin, cout, kd, pro):
    dev = _cuda()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 5, 7, cin, generator=g).to(dev, dtype)
    w = (0.1 * torch.randn(cin, cout, kd, 2, 2, generator=g)).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    inv = torch.randn(cin, generator=g).to(dev) if pro else None
    shift = torch.randn(cin, generator=g).to(dev) if pro else None
    act = "relu" if pro else "linear"
    got = fused.upconv_bnact(x, inv, shift, w, b, act)
    ref = fused.upconv_bnact(x, inv, shift, w, b, act, reference=True)
    torch.cuda.synchronize()
    _assert_kernel(got, ref)


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
                              "upconv_bnact": 2}
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
