"""The tensor-core bodies of K1 and K3 (``csrc/conv_tc.cu``,
``csrc/upconv_tc.cu``) on the CPU: the wrappers' weight packing, which
the kernels read as their B operand, and the body selectors, which decide
from the dtype and the channel counts which body a CUDA launch takes.
The kernels themselves run only on the card (``test_torch_cuda.py``).

The packing must be a pure relayout of the weight rounded to the
activation dtype: unpacked again it gives back the (kd, 3, 3, C_in,
C_out) and (kd, 2, 2, C_in, C_out) tap-major weights bit for bit.
"""

import pytest
import torch

from elektronn3_tpu_torch.ops import fused

CPU = torch.device("cpu")


def _weight(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout,cin,kd", [(32, 16, 1), (32, 32, 3),
                                         (64, 64, 3), (64, 128, 1),
                                         (128, 256, 3), (96, 48, 3)])
def test_conv_weight_packing_inverts(cout, cin, kd, src_dtype):
    """(C_out, C_in, kd, 3, 3) -> (kd, C_in / 16, 3, 3, C_out, 16) and
    back to (kd, 3, 3, C_in, C_out), exactly; each packed row of 16 is
    16 consecutive input channels of one (dz, ky, kx, co)."""
    w = _weight((cout, cin, kd, 3, 3), cin + cout + kd, src_dtype)
    p = fused.pack_conv_weight(w, torch.bfloat16, CPU)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (kd, cin // 16, 3, 3, cout, 16)
    back = p.permute(0, 2, 3, 1, 5, 4).reshape(kd, 3, 3, cin, cout)
    assert torch.equal(back, w.to(torch.bfloat16).permute(2, 3, 4, 1, 0))
    dz, kc, ky, kx, co = kd - 1, cin // 16 - 1, 2, 0, cout - 1
    assert torch.equal(p[dz, kc, ky, kx, co],
                       w[co, kc * 16:(kc + 1) * 16, dz, ky, kx]
                       .to(torch.bfloat16))


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,kd", [(64, 32, 1), (128, 64, 2),
                                         (256, 128, 2), (256, 128, 1),
                                         (48, 96, 2)])
def test_upconv_weight_packing_inverts(cin, cout, kd, src_dtype):
    """(C_in, C_out, kd, 2, 2) -> (C_in / 16, kd * 4 * C_out, 16), the
    columns in (a, b, c, co) order, and back to (kd, 2, 2, C_in, C_out),
    exactly."""
    w = _weight((cin, cout, kd, 2, 2), cin + cout + kd, src_dtype)
    p = fused.pack_upconv_weight(w, torch.bfloat16, CPU)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (cin // 16, kd * 4 * cout, 16)
    back = p.transpose(1, 2).reshape(cin, kd, 2, 2, cout) \
        .permute(1, 2, 3, 0, 4)
    assert torch.equal(back, w.to(torch.bfloat16).permute(2, 3, 4, 0, 1))
    a, b, c, co, kc = kd - 1, 1, 0, cout - 1, cin // 16 - 1
    col = ((a * 2 + b) * 2 + c) * cout + co
    assert torch.equal(p[kc, col], w[kc * 16:(kc + 1) * 16, co, a, b, c]
                       .to(torch.bfloat16))


@pytest.mark.parametrize("dtype,cins,body", [
    (torch.bfloat16, (32,), "tc"), (torch.bfloat16, (64, 64), "tc"),
    (torch.bfloat16, (16,), "tc"), (torch.bfloat16, (128, 128), "tc"),
    (torch.bfloat16, (1,), "cuda-core"), (torch.bfloat16, (3,), "cuda-core"),
    (torch.bfloat16, (32, 8), "cuda-core"),
    (torch.bfloat16, (24,), "cuda-core"),
    (torch.float32, (32,), "cuda-core"), (torch.float32, (64, 64),
                                          "cuda-core"),
    (torch.float32, (1,), "cuda-core")])
def test_conv_body_selector(dtype, cins, body):
    """K1 takes the tensor-core body for bf16 with every C_in % 16 == 0,
    the CUDA-core body for float32 and for C_in = 1 or 3."""
    assert fused.conv_body(dtype, cins) == body


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "tc"),
                                        (torch.float32, "cuda-core")])
def test_upconv_body_selector(dtype, body):
    assert fused.upconv_body(dtype) == body


def test_plain_path_launches_nothing():
    """On CPU tensors the wrappers' ops take the plain versions whatever
    the body would be on the card: no launch is counted."""
    fused.reset_launches()
    x = _weight((1, 2, 5, 7, 32), 1, torch.bfloat16)
    w = _weight((32, 32, 3, 3, 3), 2)
    y = fused.conv_bnact([x], None, None, w, torch.zeros(32), "linear")
    wu = _weight((32, 32, 2, 2, 2), 3)
    u = fused.upconv_bnact(x, None, None, wu, torch.zeros(32), "linear")
    assert y.shape == (1, 2, 5, 7, 32) and u.shape == (1, 4, 10, 14, 32)
    assert all(v == 0 for v in fused.LAUNCHES.values())
