"""The tensor-core bodies of K1, K3, K4, K5 and K7 (``csrc/conv_tc.cu``,
``csrc/upconv_tc.cu``, ``csrc/dgrad_tc.cu``, ``csrc/wgrad_tc.cu``,
``csrc/upconv_bwd_tc.cu``) and row 13's kernel (``csrc/conv1_bwd.cu``)
on the CPU: the wrappers' weight packing, which K1, K3 and K4 read as
their B operand and K7's dgrad reads K-major as its own, and the body
selectors, which decide from the dtype and the channel counts which body
a CUDA launch takes. The kernels themselves run only on the card
(``test_torch_cuda.py``).

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
    (torch.bfloat16, (1,), "conv1"), (torch.bfloat16, (3,), "conv1"),
    (torch.bfloat16, (4,), "conv1"), (torch.float32, (3,), "conv1"),
    (torch.bfloat16, (5,), "cuda-core"), (torch.bfloat16, (1, 1),
                                          "cuda-core"),
    (torch.float32, (4, 4), "cuda-core"),
    (torch.bfloat16, (32, 8), "cuda-core"),
    (torch.bfloat16, (24,), "cuda-core"),
    (torch.float32, (32,), "cuda-core"), (torch.float32, (64, 64),
                                          "cuda-core"),
    (torch.float32, (1,), "conv1")])
def test_conv_body_selector(dtype, cins, body):
    """K1 takes row 3's kernel (``csrc/conv1_fwd.cu``) for one input of
    at most 4 channels in either dtype (two inputs never), the
    tensor-core body for bf16 with every C_in % 16 == 0, the CUDA-core
    body for float32 and other counts."""
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


@pytest.mark.parametrize("dtype,cins,body", [
    (torch.bfloat16, (32,), "tc"), (torch.bfloat16, (64, 64), "tc"),
    (torch.bfloat16, (16,), "tc"), (torch.bfloat16, (48, 16), "tc"),
    (torch.bfloat16, (128, 128), "tc"), (torch.bfloat16, (256,), "tc"),
    (torch.bfloat16, (1,), "cuda-core"), (torch.bfloat16, (3,), "cuda-core"),
    (torch.bfloat16, (32, 8), "cuda-core"),
    (torch.bfloat16, (24,), "cuda-core"),
    (torch.float32, (32,), "cuda-core"), (torch.float32, (64, 64),
                                          "cuda-core"),
    (torch.float32, (1,), "cuda-core")])
def test_wgrad_body_selector(dtype, cins, body):
    """K5 takes the tensor-core body for bf16 with every C_in % 16 == 0,
    the CUDA-core body for float32 and other counts (the network input's
    C_in of 1 or 3 does not reach K5: row 13's kernel takes it)."""
    assert fused.wgrad_body(dtype, cins) == body


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "tc"),
                                        (torch.float32, "cuda-core")])
def test_upconv_bwd_body_selector(dtype, body):
    assert fused.upconv_bwd_body(dtype) == body


def test_upconv_bwd_body_refused_on_the_cpu_path():
    """A CPU tensor never reaches a body: the kernel wrapper refuses it,
    whichever body is asked for."""
    x = _weight((1, 2, 3, 5, 32), 4, torch.bfloat16)
    w = _weight((32, 32, 1, 2, 2), 5)
    y = fused.upconv_bnact_fwd_plain(x, None, None, w, torch.zeros(32),
                                     "linear")[0]
    for body in ("tc", "cuda-core"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused.upconv_bnact_bwd_kernel(x, None, None, w, y, y, None,
                                          None, "linear", True, body=body)


@pytest.mark.parametrize("cin,cout,kd", [(64, 32, 1), (128, 64, 2),
                                         (48, 96, 2)])
def test_upconv_packing_is_the_dgrad_operand(cin, cout, kd):
    """K7's dgrad reads K3's packed weight K-major: row (a, b, c, co) of
    the (kd * 4 * C_out, C_in) matrix it sees is W[:, co, a, b, c]. As a
    GEMM with the output cotangent's rows of (sub-position, C_out) per
    input voxel it gives the plain backward's input gradient (identity
    prologue, linear)."""
    n, d, h, w = 2, 2, 3, 5
    wt = _weight((cin, cout, kd, 2, 2), cin + 7 * cout, torch.bfloat16)
    p = fused.pack_upconv_weight(wt, torch.bfloat16, CPU)
    b = p.permute(1, 0, 2).reshape(kd * 4 * cout, cin).float()
    assert torch.equal(b.view(kd, 2, 2, cout, cin),
                       wt.float().permute(2, 3, 4, 1, 0))
    x = _weight((n, d, h, w, cin), 8, torch.bfloat16)
    dy = _weight((n, kd * d, 2 * h, 2 * w, cout), 9, torch.bfloat16)
    rows = dy.float().view(n, d, kd, h, 2, w, 2, cout) \
        .permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, kd * 4 * cout)
    got = (rows @ b).view(n, d, h, w, cin)
    ref = fused.upconv_bnact_bwd_plain(x, None, None, wt, dy, dy, None,
                                       None, "linear")[0]
    assert torch.allclose(got.to(torch.bfloat16).float(), ref.float(),
                          rtol=1e-2, atol=1e-2)


def test_plain_backward_launches_nothing():
    """The backward ops on CPU tensors (K4, K5, K7's plain versions, bf16,
    where the card would take the tensor-core bodies) count no launch."""
    fused.reset_launches()
    x = _weight((1, 2, 5, 7, 32), 6, torch.bfloat16).requires_grad_()
    w = _weight((32, 32, 3, 3, 3), 7).requires_grad_()
    wu = _weight((32, 32, 2, 2, 2), 8).requires_grad_()
    y = fused.conv_bnact([x], None, None, w, torch.zeros(32), "relu")
    u = fused.upconv_bnact(y, None, None, wu, torch.zeros(32), "linear")
    u.float().square().sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert wu.grad.shape == wu.shape
    assert all(v == 0 for v in fused.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The vup path's tensor-core bodies (rows 23 and 9's weight gradient)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,cc,cu,body", [
    (torch.bfloat16, 64, 32, "tc"), (torch.bfloat16, 32, 32, "tc"),
    (torch.bfloat16, 96, 64, "tc"), (torch.bfloat16, 128, 64, "tc"),
    (torch.bfloat16, 160, 32, "cuda-core"),
    (torch.bfloat16, 256, 64, "cuda-core"),
    (torch.bfloat16, 64, 96, "cuda-core"),
    (torch.bfloat16, 128, 128, "cuda-core"),
    (torch.float32, 64, 32, "cuda-core"),
    (torch.float32, 128, 64, "cuda-core")])
def test_vup_bwd_body_selector(dtype, cc, cu, body):
    """The one vup selector: all five entries (rows 1's vup mode, 9 and
    its weight gradient, 22, 23) take the tensor-core bodies for bf16 at
    the template cases (C_carry 32 to 128, C_up 32 or 64), the CUDA-core
    bodies for float32 and any other shape, so a step never mixes the
    two recomputes; asking an entry for a 'tc' body the selector does
    not name raises."""
    from elektronn3_tpu_torch.ops import vup
    assert vup.vup_body(dtype, cc, cu) == body
    for entry in ("conv_vup", "conv_vup_dgrad", "conv_vup_wgrad",
                  "upconv_stats", "upconv_stats_bwd"):
        assert vup._body(None, dtype, cc, cu, entry) == body
        assert vup._body("cuda-core", dtype, cc, cu, entry) == "cuda-core"
        if body != "tc":
            with pytest.raises(ValueError, match="no 'tc' body"):
                vup._body("tc", dtype, cc, cu, entry)


def _vup_inputs(seed=11):
    """A bf16 C=64 carry under a 32 + 32 -> 32 merge on the CPU, with the
    merge output and its cotangent from the plain forward."""
    from elektronn3_tpu_torch.ops import vup
    bf = torch.bfloat16
    up = (_weight((1, 2, 3, 5, 64), seed, bf), _weight((64,), seed + 1),
          _weight((64,), seed + 2), 0.1 * _weight((64, 32, 1, 2, 2), seed + 3),
          _weight((32,), seed + 4))
    merge = (_weight((1, 2, 6, 10, 32), seed + 5, bf),
             _weight((64,), seed + 6), _weight((64,), seed + 7),
             0.1 * _weight((32, 64, 1, 3, 3), seed + 8))
    y = vup.conv_vup_fwd_plain(*up, *merge, _weight((32,), seed + 9),
                               "relu", "relu")[0]
    return up, merge, y


@pytest.mark.parametrize("body", ["tc", "cuda-core"])
def test_vup_bwd_wrappers_refuse_cpu_tensors(body):
    """A CPU tensor never reaches a body: both wrappers refuse it,
    whichever body is asked for."""
    from elektronn3_tpu_torch.ops import vup
    up, merge, y = _vup_inputs()
    ds, dq = torch.zeros(32), torch.zeros(32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vup.upconv_stats_bwd_kernel(*up, ds, dq, "relu", body=body)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vup.conv_vup_wgrad_kernel(*up, *merge, y, y, ds, dq, "relu", "relu",
                                  body=body)


def test_vup_plain_backward_launches_nothing():
    """The vup ops' backward on CPU tensors (bf16, where the card would
    take the tensor-core bodies of rows 23 and 9's weight gradient)
    counts no launch."""
    from elektronn3_tpu_torch.ops import vup
    up, merge, _ = _vup_inputs(21)
    up = [t.requires_grad_() if t.dtype == torch.float32 else t for t in up]
    w = merge[3].requires_grad_()
    fused.reset_launches()
    y = vup.conv_vup(*up, merge[0], *merge[1:3], w, torch.zeros(32), "relu",
                     "relu")
    s, q = vup.upconv_stats(*up, "relu")
    (y.float().square().sum() + s.sum() + q.sum()).backward()
    assert w.grad.shape == w.shape and up[3].grad.shape == up[3].shape
    assert all(v == 0 for v in fused.LAUNCHES.values())


@pytest.mark.parametrize("cc,cu", [(64, 32), (32, 32), (128, 64)])
def test_upconv_packing_is_the_recompute_operand(cc, cu):
    """The tensor-core recompute (``vup_mma``, csrc/upconv_vup.cuh) reads
    K3's packed weight K-major as its B operand: column (b, c, co) of the
    (C_carry, 4 C_up) matrix it sees is W[:, co, 0, b, c]. As a GEMM with
    the prologued, rounded carry rows, plus the bias, rounded once, it
    gives ``vup._upconv_plain``'s upconv output within one bf16 rounding
    (the two sum in different orders)."""
    from elektronn3_tpu_torch.ops import vup
    bf = torch.bfloat16
    n, d, h, w = 2, 2, 3, 5
    wu = _weight((cc, cu, 1, 2, 2), cc + cu, bf)
    p = fused.pack_upconv_weight(wu, bf, CPU)
    b = p.permute(1, 0, 2).reshape(4 * cu, cc).float()
    assert torch.equal(b.view(2, 2, cu, cc),
                       wu.float()[:, :, 0].permute(2, 3, 1, 0))
    carry = _weight((n, d, h, w, cc), 12, bf)
    invc, shiftc, bu = (_weight((cc,), 13), _weight((cc,), 14),
                        _weight((cu,), 15))
    a = fused.prologue(carry, invc, shiftc, "relu").to(bf).float()
    rows = a.reshape(-1, cc) @ b.t() + bu.repeat(4)
    got = rows.to(bf).view(n, d, h, w, 2, 2, cu).permute(0, 1, 2, 4, 3, 5, 6) \
        .reshape(n, d, 2 * h, 2 * w, cu)
    ref = vup._upconv_plain(carry, invc, shiftc, wu, bu, "relu")
    assert torch.allclose(got.float(), ref.float(), rtol=2.0 ** -7,
                          atol=1e-6)


# ---------------------------------------------------------------------------
# K4's tensor-core body and row 13's kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout,cin,kd", [(32, 32, 1), (32, 64, 1),
                                         (64, 32, 3), (64, 128, 3),
                                         (128, 256, 3), (128, 64, 1)])
def test_dgrad_weight_packing_is_the_flipped_weight(cout, cin, kd,
                                                    src_dtype):
    """K4's operand (``pack_dgrad_weight``) against the unpacked flipped
    weight: (kd, C_out / 16, 3, 3, C_in, 16) holds at (dz, kc, ky, kx,
    ci, j) the weight W[kc * 16 + j, ci, kd - 1 - dz, 2 - ky, 2 - kx]
    rounded to bf16, exactly, and it is K1's packing of the (C_in, C_out)
    transposed, tap-flipped weight."""
    w = _weight((cout, cin, kd, 3, 3), 3 * cin + cout + kd, src_dtype)
    p = fused.pack_dgrad_weight(w, torch.bfloat16, CPU)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (kd, cout // 16, 3, 3, cin, 16)
    back = p.permute(1, 5, 4, 0, 2, 3).reshape(cout, cin, kd, 3, 3)
    assert torch.equal(back, w.to(torch.bfloat16).flip(2, 3, 4))
    dz, kc, ky, kx, ci, j = kd - 1, cout // 16 - 1, 2, 0, cin - 1, 5
    assert p[dz, kc, ky, kx, ci, j] == w[kc * 16 + j, ci, kd - 1 - dz,
                                         2 - ky, 2 - kx].to(torch.bfloat16)
    assert torch.equal(p, fused.pack_conv_weight(
        w.flip(2, 3, 4).transpose(0, 1), torch.bfloat16, CPU))


@pytest.mark.parametrize("cin,cout,kd", [(32, 32, 1), (32, 64, 3),
                                         (64, 32, 3)])
def test_dgrad_packing_is_the_dgrad_operand(cin, cout, kd):
    """K4's tensor-core body computes K1's 'same' conv of dy_tot with the
    packed weight as K1's packing of a (C_in, C_out, kd, 3, 3) weight:
    that conv, in float32 on the unpacked operand, is the plain K4's
    input gradient (identity prologue, linear) within one bf16
    rounding."""
    g = torch.Generator().manual_seed(cin + cout + kd)
    x = torch.randn(2, 4, 5, 7, cin, generator=g).to(torch.bfloat16)
    w = (0.1 * torch.randn(cout, cin, kd, 3, 3, generator=g)) \
        .to(torch.bfloat16)
    dy = torch.randn(2, 4, 5, 7, cout, generator=g).to(torch.bfloat16)
    p = fused.pack_dgrad_weight(w, torch.bfloat16, CPU).float()
    wk1 = p.permute(4, 1, 5, 0, 2, 3).reshape(cin, cout, kd, 3, 3)
    got = torch.nn.functional.conv3d(
        dy.float().permute(0, 4, 1, 2, 3), wk1, padding=(kd // 2, 1, 1))
    got = got.permute(0, 2, 3, 4, 1).to(torch.bfloat16)
    ref = fused.conv_bnact_dgrad_plain([x], None, None, w.float(), dy, dy,
                                       None, None, "linear")[0][0]
    assert torch.allclose(got.float(), ref.float(), rtol=2.0 ** -7,
                          atol=1e-5)


@pytest.mark.parametrize("dtype,cins,body", [
    (torch.bfloat16, (32,), "tc"), (torch.bfloat16, (64, 64), "tc"),
    (torch.bfloat16, (128, 128), "tc"), (torch.bfloat16, (32, 32), "tc"),
    (torch.float32, (32,), "cuda-core"),
    (torch.float32, (64, 64), "cuda-core")])
def test_dgrad_body_selector(dtype, cins, body):
    """K4 (each C_in % 32 == 0) runs its tensor-core body for bf16 and
    its CUDA-core body for float32."""
    assert fused.dgrad_body(dtype) == body


@pytest.mark.parametrize("cins,input_grad,body", [
    ((1,), True, "conv1+dx"), ((1,), False, "conv1"),
    ((3,), True, "conv1+dx"), ((3,), False, "conv1"),
    ((4,), True, "conv1+dx"), ((2,), False, "conv1"),
    ((5,), True, None), ((32,), True, None), ((32,), False, None),
    ((1, 1), True, None)])
def test_conv1_body_selector(cins, input_grad, body):
    """The network input's backward (one input of at most 4 channels)
    is row 13's kernel, with its dx when the input or prologue gradient
    is wanted; any other inputs take K4 and K5 (None)."""
    assert fused.conv1_body(cins, input_grad) == body


@pytest.mark.parametrize("body", ["dgrad", "wgrad"])
def test_backward_wrappers_refuse_network_input(body):
    """K4's and K5's wrappers refuse one input of 1 channel, on any
    device: :func:`conv_bnact`'s backward sends it to row 13's kernel,
    the one route to it."""
    x = _weight((1, 2, 3, 5, 1), 26, torch.bfloat16)
    w = _weight((32, 1, 1, 3, 3), 27)
    y = fused.conv_bnact_fwd_plain([x], None, None, w, torch.zeros(32),
                                   "linear")[0]
    fn = {"dgrad": fused.conv_bnact_dgrad_kernel,
          "wgrad": fused.conv_bnact_wgrad_kernel}[body]
    with pytest.raises(ValueError, match="conv1_bwd_kernel"):
        fn([x], None, None, w, y, y, None, None, "linear")


@pytest.mark.parametrize("cins,grad,ok", [
    ((1,), True, True), ((3,), True, True), ((4,), True, True),
    ((32,), True, True), ((32, 32), True, True), ((5,), False, True),
    ((5,), True, True), ((16,), True, True), ((8,), True, True),
    ((32, 16), True, True), ((1, 1), True, True)])
def test_input_gradient_contract(cins, grad, ok):
    """``conv_bnact`` takes an input that needs a gradient at any channel
    count, on any device: row 13's kernel gives one input of at most 4
    channels its dx, K4 every other (on a copy padded to 32-channel
    blocks where C_in % 32 != 0, ``fused._dgrad_padded``)."""
    xs = [_weight((1, 2, 3, 5, c), 20 + c).requires_grad_(grad)
          for c in cins]
    w = _weight((32, sum(cins), 1, 3, 3), 21)
    assert ok
    y = fused.conv_bnact(xs, None, None, w, torch.zeros(32), "linear")
    assert y.shape == (1, 2, 3, 5, 32)
    if grad:
        y.square().sum().backward()
        assert all(x.grad.shape == x.shape for x in xs)


def test_conv1_backward_launches_nothing_and_zero_without_input_grad():
    """On CPU tensors row 13's backward takes its plain version (no
    launch); ``input_grad=False`` gives the input a zero gradient and the
    weight the same gradient as with it."""
    fused.reset_launches()
    w0 = _weight((32, 1, 1, 3, 3), 22)
    grads = []
    for ig in (True, False):
        x = _weight((1, 2, 5, 7, 1), 23, torch.bfloat16).requires_grad_()
        w = w0.clone().requires_grad_()
        y = fused.conv_bnact([x], None, None, w, torch.zeros(32), "linear",
                             input_grad=ig)
        y.float().square().sum().backward()
        grads.append((x.grad, w.grad))
    assert bool(grads[0][0].abs().sum() > 0)
    assert grads[1][0].shape == grads[0][0].shape
    assert bool((grads[1][0] == 0).all())
    assert torch.equal(grads[0][1], grads[1][1])
    assert all(v == 0 for v in fused.LAUNCHES.values())
    assert fused.BODY_LAUNCHES == {}


@pytest.mark.parametrize("body", ["dgrad", "wgrad", "conv1"])
def test_backward_wrappers_refuse_cpu_tensors(body):
    """K4's, K5's and row 13's wrappers refuse a CPU tensor: a CUDA
    tensor launches its kernel or raises, and only the op picks the
    plain version."""
    x = _weight((1, 2, 3, 5, 1 if body == "conv1" else 32), 24,
                torch.bfloat16)
    w = _weight((32, x.shape[-1], 1, 3, 3), 25)
    y = fused.conv_bnact_fwd_plain([x], None, None, w, torch.zeros(32),
                                   "linear")[0]
    fn = {"dgrad": fused.conv_bnact_dgrad_kernel,
          "wgrad": fused.conv_bnact_wgrad_kernel,
          "conv1": fused.conv1_bwd_kernel}[body]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn([x], None, None, w, y, y, None, None, "linear")


# ---------------------------------------------------------------------------
# The tiles and the padded weight of the vup merge conv's tensor-core
# bodies (conv_vup: csrc/conv_tc.cu's vup instantiation; conv_vup_dgrad:
# csrc/conv_vup_tc.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("voxels", [256, 128])
@pytest.mark.parametrize("w", [2, 6, 14, 16, 22, 32, 44, 70, 88, 176, 256])
def test_vup_tile_has_an_even_origin(w, voxels):
    """``vup.vup_tile``: K1's and K4's tile width (16 or 32, the fewest
    wasted columns, 32 on a tie), TH x TW = the tile's voxels, both even,
    so a tile at (multiples of TH, TW) covers whole carry voxels. The
    forward's staging (each slab voxel written once, from the carry voxel
    under it) and the dgrad's epilogue map (each of the tile's voxels one
    (carry voxel, sub-position) of the TH / 2 x TW / 2 carry tile, 64 at
    256 voxels) are written out as the kernels compute them."""
    from elektronn3_tpu_torch.ops import vup
    th, tw = vup.vup_tile(w, voxels)
    assert tw == (16 if -(-w // 16) * 16 < -(-w // 32) * 32 else 32)
    assert th * tw == voxels and th % 2 == 0 and tw % 2 == 0
    # conv_tc.cu's vup_stage_u at an interior tile and at the origin.
    vr, vw = th // 2 + 2, tw // 2 + 2
    for h0, w0 in ((0, 0), (th, 3 * tw)):
        seen = {}
        for r in range(vr * vw):
            for sub in range(4):
                hh = 2 * (h0 // 2 - 1 + r // vw) + (sub >> 1)
                ww = 2 * (w0 // 2 - 1 + r % vw) + (sub & 1)
                sy, sx = hh - h0 + 1, ww - w0 + 1
                if 0 <= sy < th + 2 and 0 <= sx < tw + 2:
                    seen[(sy, sx)] = seen.get((sy, sx), 0) + 1
        assert len(seen) == (th + 2) * (tw + 2)
        assert set(seen.values()) == {1}
    # conv_vup_tc.cu's epilogue: voxel (r, c) of the tile -> E's row and
    # sub-position.
    cells = {((r // 2) * (tw // 2) + c // 2, (r % 2) * 2 + c % 2)
             for r in range(th) for c in range(tw)}
    assert len(cells) == voxels
    assert {cv for cv, _ in cells} == set(range(voxels // 4))
    if voxels == vup.VUP_DGRAD_VOXELS:
        assert voxels // 4 == 64   # row 23's tile (VBM)


@pytest.mark.parametrize("cout,cout_k1", [(32, 256), (64, 256), (96, 256),
                                          (128, 128), (256, 128)])
def test_conv_vup_tile_voxels_are_k1s(cout, cout_k1):
    """``conv_vup``'s tile holds K1's voxels: 128 where a block takes 128
    output channels (C_out % 128 == 0), else 256."""
    from elektronn3_tpu_torch.ops import vup
    assert vup.conv_vup_voxels(cout) == cout_k1


@pytest.mark.parametrize("cout,cin", [(32, 64), (32, 96), (64, 128),
                                      (32, 160)])
def test_vup_dgrad_weight_packing_pads_to_whole_items(cout, cin):
    """``vup.pack_vup_dgrad_weight``: ``fused.pack_dgrad_weight``'s
    operand with its C_in columns padded with zeros to a multiple of 64,
    a work item's columns."""
    from elektronn3_tpu_torch.ops import vup
    w = _weight((cout, cin, 1, 3, 3), cout + cin)
    p = vup.pack_vup_dgrad_weight(w, torch.bfloat16, CPU)
    ctp = -(-cin // 64) * 64
    assert p.shape == (1, cout // 16, 3, 3, ctp, 16) and p.is_contiguous()
    assert torch.equal(p[:, :, :, :, :cin],
                       fused.pack_dgrad_weight(w, torch.bfloat16, CPU))
    assert not p[:, :, :, :, cin:].any()


@pytest.mark.parametrize("entry", ["conv_vup_fwd", "conv_vup_dgrad",
                                   "upconv_stats"])
@pytest.mark.parametrize("body", ["tc", "cuda-core"])
def test_vup_wrappers_refuse_cpu_tensors(entry, body):
    """The three entries whose tensor-core bodies are new refuse a CPU
    tensor whichever body is asked for, as rows 23 and 9's weight
    gradient do."""
    from elektronn3_tpu_torch.ops import vup
    up, merge, y = _vup_inputs()
    ds, dq = torch.zeros(32), torch.zeros(32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if entry == "upconv_stats":
            vup.upconv_stats_kernel(*up, "relu", body=body)
        elif entry == "conv_vup_fwd":
            vup.conv_vup_fwd_kernel(*up, *merge, torch.zeros(32), "relu",
                                    "relu", body=body)
        else:
            vup.conv_vup_dgrad_kernel(*up, *merge, y, y, ds, dq, "relu",
                                      "relu", body=body)


def _c_declarations():
    """Every ``extern "C"`` entry of the kernel sources with the ctypes
    type of each parameter, read from its declaration."""
    import ctypes
    import re
    from elektronn3_tpu_torch.ops import _build
    src = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    decls = {}
    for m in re.finditer(r'extern "C" (?:int|int64_t) (e3_\w+)\(([^)]*)\)',
                         src):
        types = []
        for arg in (a.strip() for a in m.group(2).split(",")):
            if "*" in arg:
                types.append(ctypes.c_void_p)
            elif arg.startswith("int64_t"):
                types.append(ctypes.c_int64)
            elif arg.startswith("int"):
                types.append(ctypes.c_int)
            else:
                assert arg.startswith("float"), arg
                types.append(ctypes.c_float)
        decls[m.group(1)] = tuple(types)
    return decls


def _entries():
    from elektronn3_tpu_torch.ops import _build
    return sorted({**_build._SIGNATURES, **_build._PS_PARTS})


@pytest.mark.parametrize("name", _entries())
def test_ctypes_argtypes_match_the_c_declaration(name):
    """Each entry's ctypes argtypes (``_build._SIGNATURES``,
    ``_build._PS_PARTS``) are its C declaration's parameters, type by
    type: a pointer passed as a 32-bit int would be cut, and an argument
    out of place would reach the kernel as another."""
    from elektronn3_tpu_torch.ops import _build
    table = {**_build._SIGNATURES, **_build._PS_PARTS}
    assert _c_declarations()[name] == tuple(table[name])


def test_every_c_entry_has_argtypes():
    from elektronn3_tpu_torch.ops import _build
    assert set(_c_declarations()) == set(_build._SIGNATURES) | set(
        _build._PS_PARTS)
