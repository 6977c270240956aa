"""Times the port's fused kernels K1, K3, K4, K5, K6 and K7, rows 3's and
13's and the five vup entries (bf16, CUDA events, 20 launches after one
warm-up) in the checkout that is the working directory, and prints one
line.

    cd <checkout> && python3 <path>/kernel_times.py

Run it from two checkouts in turns (A, B, B, A) on one card, one run
right after the other, to compare their kernels: times taken on
different machines or cards are not comparable. Shapes:
- K1 at the 3D Predictor tile (1, 128, 256, 256) as served (the L0
  conv2 32->32 and the up_2 merge 32+32->32, kd=1, relu prologue), at
  its level 1 (1, 128, 128, 128) (conv1 32->64 without a prologue,
  conv2 64->64 and the up_1 merge 64+64->64 with one, kd=3), at
  bench.py's level 1 (8, 44, 44, 44) (the merge 64+64->64 with
  statistics) and as ``conv_direct`` (row 28, no prologue, zero bias)
  at benchmark/conv_microbench.py's L1up 128->64 (8, 22, 44, 44) and
  L2 128->128 (8, 11, 22, 22), kd=3;
- K3 served from a dense input: the tile's up_0 (2, 2, 2) 256->128 from
  (1, 32, 32, 32) and the 2D model's up_0 (1, 2, 2) 256->128 from
  (8, 1, 80, 80); with statistics and the prologue, the (1, 2, 2) up_2
  64->32 at bench.py's batch 8 of (44, 88, 88);
- K4 and K5 of that up_2 merge, K7 of that upconv, the vup entries of
  that up_2 (row 23, ``upconv_stats_bwd``, row 9's weight and input
  gradients, ``conv_vup_wgrad`` and ``conv_vup_dgrad``, with statistics
  cotangents, and row 22, ``upconv_stats``), K4 and K5 at
  bench.py's up_1 merge 64+64->64 kd=3 and L0 conv2 32->32 kd=1 and K4 at
  the start_filts=64 model's L1 merge 128+128->128 kd=3 (8, 44, 44, 44)
  (with statistics cotangents), row 13 (the weight gradient of the
  one-channel conv1: the network input takes no gradient; through
  ``conv1_bwd_kernel`` where the checkout has it, else K5's wrapper) at
  bench.py's L0 1->32 and the 2D model's (8, 1, 640, 640) 1->32, K7 at
  its up_1 (2, 2, 2) 128->64 from (8, 22, 22, 22) and at the 2D model's
  up_1 (1, 2, 2) 128->64 from (8, 1, 160, 160) (dense
  inputs); these first, on inputs from the plain forwards, so that
  nothing the forward kernels allocate moves their inputs between two
  checkouts;
- ``conv_vup`` (row 1's vup mode) as served at bench.py's up_2 and at
  the Predictor tile's (carry (1, 128, 128, 128, 64), skip (1, 128, 256,
  256, 32)), without statistics;
- K1 over the network input (row 3's kernel where the checkout has it)
  at bench.py's L0 1->32 and the 2D model's (8, 1, 640, 640) 1->32 with
  statistics, the 3D Predictor tile's 1->32 as served, and the
  start_filts=64 model's 1->64 at the bench with statistics and at the
  tile as served;
- K6 at bench.py's L0 (1, 2, 2) C=32 and L1 (2, 2, 2) C=64, the 2D
  model's L0-L2 and the start_filts=64 model's L1 (2, 2, 2) C=128,
  without the skip's cotangent and with it as a kernel level's backward
  runs it ("K6+skip": K6 with ``dskip`` where the checkout has it, else
  K6 and the add of the level's two gradients);
- the 'batchp' norm's two reductions, K8 and K10, at the (R, C) of
  chip_smoke.py's BN_VARIANTS in training (the headline step's library
  levels, a ragged R, the pallas_flat=False step's levels at batch 8
  and batch 2), each as the op runs it with its glue: in a checkout
  with the one-launch K8 and K10 that is one call each (K8 with the
  running update), in an older one the kernel, then ``fold_forward`` and
  the running update (K8), or ``rsqrt``, the kernel and
  ``fold_backward`` (K10). Two numbers each: the time a call of
  back-to-back calls (the host's issue rate where a call is
  host-bound), and the device time of a call from torch.profiler (every
  device kernel it runs).
Last, the headline UNet's training step at bench.py's shapes with
``vup`` on and off (step ms and peak allocated MB), and with
``normalization='batchp'`` at batch 8 and with ``pallas_flat=False`` at
batch 2, the start_filts=64 UNet's there and the 2D UNet's at batch 8 of
(640, 640) (step ms).
"""
import os
import sys

import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from elektronn3_tpu_torch.ops import _build, fused, pallas_conv, vup
    _build.library()
    torch.backends.cudnn.allow_tf32 = False

    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g, device="cuda")

    out = []
    bf = torch.bfloat16
    # The backward kernels first, on inputs from the plain forwards: what
    # the forward kernels under comparison allocate cannot move them.
    xs = [r(8, 44, 88, 88, 32).to(bf), r(8, 44, 88, 88, 32).to(bf)]
    w, b, inv, sh = r(32, 64, 1, 3, 3, scale=0.1), r(32), r(64), r(64)
    y = fused.conv_bnact_fwd_plain(xs, inv, sh, w, b, "relu")[0]
    dy = r(*y.shape, scale=0.1).to(bf)
    ds, dq = r(32, scale=1e-3), r(32, scale=1e-4)
    args = (xs, inv, sh, w, y, dy, ds, dq, "relu")
    out.append(("K4 bench merge",
                ms(lambda: fused.conv_bnact_dgrad_kernel(*args))))
    out.append(("K5 bench merge",
                ms(lambda: fused.conv_bnact_wgrad_kernel(*args))))
    del xs, y, dy, args
    xu = r(8, 44, 44, 44, 64).to(bf)
    wu, bu, invc, shc = r(64, 32, 1, 2, 2, scale=0.1), r(32), r(64), r(64)
    yu = fused.upconv_bnact_fwd_plain(xu, invc, shc, wu, bu, "relu")[0]
    dyu = r(*yu.shape, scale=0.1).to(bf)
    out.append(("K7 bench up_2", ms(lambda: fused.upconv_bnact_bwd_kernel(
        xu, invc, shc, wu, yu, dyu, ds, dq, "relu"))))
    del yu, dyu
    # The vup entries of that up_2 (carry xu, skip (8, 44, 88, 88, 32),
    # the merge 32+32->32 with statistics cotangents): row 23
    # (upconv_stats_bwd) and row 9's weight gradient (conv_vup_wgrad),
    # through the parent's positional signatures.
    skip = r(8, 44, 88, 88, 32).to(bf)
    wm, bm, invm, shm = r(32, 64, 1, 3, 3, scale=0.1), r(32), r(64), r(64)
    margs = (xu, invc, shc, wu, bu, skip, invm, shm, wm)
    yv = vup.conv_vup_fwd_plain(*margs, bm, "relu", "relu")[0]
    dyv = r(*yv.shape, scale=0.1).to(bf)
    out.append(("row 23 bench up_2", ms(lambda: vup.upconv_stats_bwd_kernel(
        xu, invc, shc, wu, bu, ds, dq, "relu"))))
    out.append(("conv_vup_wgrad bench up_2", ms(
        lambda: vup.conv_vup_wgrad_kernel(*margs, yv, dyv, ds, dq, "relu",
                                          "relu"))))
    out.append(("conv_vup_dgrad bench up_2", ms(
        lambda: vup.conv_vup_dgrad_kernel(*margs, yv, dyv, ds, dq, "relu",
                                          "relu"))))
    out.append(("upconv_stats bench up_2", ms(
        lambda: vup.upconv_stats_kernel(xu, invc, shc, wu, bu, "relu"))))
    del yv, dyv
    # K5 at bench.py's up_1 merge 64+64->64 kd3 (with ds/dq) and L0 conv2
    # 32->32 kd1; K4 at the same two and at the sf=64 model's L1 merge
    # 128+128->128 kd3; K7 at its up_1 (2,2,2) 128->64 from (8,22,22,22)
    # and at the 2D model's up_1 (1,2,2) 128->64 from (8,1,160,160), both
    # from a dense input.
    for label, shape, cins, cout, kd, kernels in (
            ("bench up_1 merge 64+64 kd3", (8, 44, 44, 44), (64, 64), 64, 3,
             "K5 K4"),
            ("bench L0 conv2 32->32", (8, 44, 88, 88), (32,), 32, 1,
             "K5 K4"),
            ("sf64 L1 merge 128+128 kd3", (8, 44, 44, 44), (128, 128), 128,
             3, "K4")):
        xs = [r(*shape, c).to(bf) for c in cins]
        cin = sum(cins)
        w, b, inv, sh = (r(cout, cin, kd, 3, 3, scale=0.05), r(cout), r(cin),
                         r(cin))
        y = fused.conv_bnact_fwd_plain(xs, inv, sh, w, b, "relu")[0]
        dy = r(*y.shape, scale=0.1).to(bf)
        dsc, dqc = r(cout, scale=1e-3), r(cout, scale=1e-4)
        bargs = (xs, inv, sh, w, y, dy, dsc, dqc, "relu")
        if "K5" in kernels:
            out.append((f"K5 {label}", ms(
                lambda: fused.conv_bnact_wgrad_kernel(*bargs))))
        out.append((f"K4 {label}", ms(
            lambda: fused.conv_bnact_dgrad_kernel(*bargs))))
        del xs, y, dy, bargs
        torch.cuda.empty_cache()
    # Row 13: conv1 1->32 of bench.py's step and of the 2D model's, with
    # statistics cotangents: its weight gradient (a checkout without
    # conv1_bwd_kernel runs it on K5's wrapper).
    conv1 = getattr(fused, "conv1_bwd_kernel", None)
    for label, shape in (("bench L0 conv1 1->32", (8, 44, 88, 88)),
                         ("2D L0 conv1 1->32", (8, 1, 640, 640))):
        x = [r(*shape, 1).to(bf)]
        w, b = r(32, 1, 1, 3, 3, scale=0.3), r(32)
        y = fused.conv_bnact_fwd_plain(x, None, None, w, b, "linear")[0]
        dy = r(*y.shape, scale=0.1).to(bf)
        dsc, dqc = r(32, scale=1e-3), r(32, scale=1e-4)
        args = (x, None, None, w, y, dy, dsc, dqc, "linear")
        out.append((f"row 13 {label}", ms(
            (lambda: conv1(*args, False)) if conv1 is not None
            else lambda: fused.conv_bnact_wgrad_kernel(*args))))
        del x, y, dy
        torch.cuda.empty_cache()
    for label, shape, cin, cout, kd in (
            ("bench up_1 (2,2,2) 128->64", (8, 22, 22, 22), 128, 64, 2),
            ("2D up_1 (1,2,2) 128->64", (8, 1, 160, 160), 128, 64, 1)):
        x = r(*shape, cin).to(bf)
        w, b = r(cin, cout, kd, 2, 2, scale=0.05), r(cout)
        yd = fused.upconv_bnact_fwd_plain(x, None, None, w, b, "linear")[0]
        dyd = r(*yd.shape, scale=0.1).to(bf)
        dsu, dqu = r(cout, scale=1e-3), r(cout, scale=1e-4)
        out.append((f"K7 {label}", ms(lambda: fused.upconv_bnact_bwd_kernel(
            x, None, None, w, yd, dyd, dsu, dqu, "linear"))))
        del x, yd, dyd
    for label, cins in (("tile L0 conv2", (32,)), ("tile up_2 merge",
                                                   (32, 32))):
        xs = [r(1, 128, 256, 256, c).to(bf) for c in cins]
        cin = sum(cins)
        w, b, inv, sh = r(32, cin, 1, 3, 3, scale=0.1), r(32), r(cin), r(cin)
        out.append((f"K1 {label}", ms(lambda: fused.conv_bnact_fwd_kernel(
            xs, inv, sh, w, b, "relu", False))))
        del xs
    for label, shape, cins, cout, st, pro in (
            ("tile L1 conv1 32->64 kd3", (1, 128, 128, 128), (32,), 64,
             False, False),
            ("tile L1 conv2 64->64 kd3", (1, 128, 128, 128), (64,), 64,
             False, True),
            ("tile L1 merge 64+64 kd3", (1, 128, 128, 128), (64, 64), 64,
             False, True),
            ("bench TL1 merge 64+64 kd3 +stats", (8, 44, 44, 44), (64, 64),
             64, True, True)):
        xs = [r(*shape, c).to(bf) for c in cins]
        cin = sum(cins)
        w, b = r(cout, cin, 3, 3, 3, scale=0.05), r(cout)
        inv, sh = (r(cin), r(cin)) if pro else (None, None)
        act = "relu" if pro else "linear"
        out.append((f"K1 {label}", ms(lambda: fused.conv_bnact_fwd_kernel(
            xs, inv, sh, w, b, act, st))))
        del xs
    for label, shape, cin, cout in (("L1up 128->64", (8, 22, 44, 44), 128,
                                     64),
                                    ("L2 128->128", (8, 11, 22, 22), 128,
                                     128)):
        x = r(*shape, cin).to(bf)
        w = r(cout, cin, 3, 3, 3, scale=0.05)
        out.append((f"K1 row 28 {label} kd3", ms(
            lambda: pallas_conv.conv_direct_kernel(x, w))))
    for label, shape, cin, cout, kd in (
            ("tile up_0 256->128 dense", (1, 32, 32, 32), 256, 128, 2),
            ("2D up_0 256->128 dense", (8, 1, 80, 80), 256, 128, 1)):
        x = r(*shape, cin).to(bf)
        w, b = r(cin, cout, kd, 2, 2, scale=0.05), r(cout)
        out.append((f"K3 {label}", ms(lambda: fused.upconv_bnact_fwd_kernel(
            x, None, None, w, b, "linear", False))))
    out.append(("K3 bench up_2 +stats", ms(
        lambda: fused.upconv_bnact_fwd_kernel(xu, invc, shc, wu, bu, "relu",
                                              True))))
    # conv_vup as served (no statistics) at that up_2 and at the tile's.
    out.append(("conv_vup bench up_2", ms(lambda: vup.conv_vup_fwd_kernel(
        *margs, bm, "relu", "relu", False))))
    del xu, skip, margs
    torch.cuda.empty_cache()
    xt, st = r(1, 128, 128, 128, 64).to(bf), r(1, 128, 256, 256, 32).to(bf)
    out.append(("conv_vup tile up_2", ms(lambda: vup.conv_vup_fwd_kernel(
        xt, invc, shc, wu, bu, st, invm, shm, wm, bm, "relu", "relu",
        False))))
    del xt, st
    torch.cuda.empty_cache()
    out += conv1_forward(r)
    out += pool_backward(r)
    out += bn_reductions()
    out += steps()
    print(os.path.basename(os.getcwd()) + ": " + "; ".join(
        f"{k} {v:.3f}" for k, v in out), flush=True)


def conv1_forward(r):
    """K1 over the network input (bf16, kd=1; row 3's kernel where the
    checkout has it, else K1's CUDA-core body, whichever K1's wrapper
    takes): bench.py's L0 1->32 with statistics, the 2D model's, the 3D
    Predictor tile's as served, and the start_filts=64 model's 1->64 at
    the bench with statistics and at the tile as served."""
    from elektronn3_tpu_torch.ops import fused
    out = []
    for label, shape, cout, st in (
            ("bench L0 1->32 +stats", (8, 44, 88, 88), 32, True),
            ("2D L0 1->32 +stats", (8, 1, 640, 640), 32, True),
            ("tile L0 1->32", (1, 128, 256, 256), 32, False),
            ("sf64 L0 1->64 +stats", (8, 44, 88, 88), 64, True),
            ("sf64 tile L0 1->64", (1, 128, 256, 256), 64, False)):
        x = [r(*shape, 1).to(torch.bfloat16)]
        w, b = r(cout, 1, 1, 3, 3, scale=0.3), r(cout)
        out.append((f"conv1 fwd {label}", ms(
            lambda: fused.conv_bnact_fwd_kernel(x, None, None, w, b,
                                                "linear", st))))
        del x
        torch.cuda.empty_cache()
    return out


def pool_backward(r):
    """K6 (bf16, relu prologue) at bench.py's L0 (1,2,2) C=32 and L1
    (2,2,2) C=64, the 2D model's L0-L2 (1,2,2) C=32/64/128 and the
    start_filts=64 model's L1 (2,2,2) C=128: without the skip's
    cotangent, then with it as the level's backward runs it (one K6 with
    ``dskip`` where the checkout has it, else K6 and the add of the two
    gradients that autograd then runs)."""
    import inspect
    from elektronn3_tpu_torch.ops import fused
    skip_in = "dskip" in inspect.signature(
        fused.pool_bnact_bwd_kernel).parameters
    out = []
    for label, shape, win in (
            ("bench L0 (1,2,2) C=32", (8, 44, 88, 88, 32), (1, 2, 2)),
            ("bench L1 (2,2,2) C=64", (8, 44, 44, 44, 64), (2, 2, 2)),
            ("2D L0 C=32", (8, 1, 640, 640, 32), (1, 2, 2)),
            ("2D L1 C=64", (8, 1, 320, 320, 64), (1, 2, 2)),
            ("2D L2 C=128", (8, 1, 160, 160, 128), (1, 2, 2)),
            ("sf64 L1 (2,2,2) C=128", (8, 44, 44, 44, 128), (2, 2, 2))):
        c = shape[-1]
        x = r(*shape).to(torch.bfloat16)
        inv, sh = r(c), r(c)
        pooled = (shape[0], shape[1] // win[0], shape[2] // 2,
                  shape[3] // 2, c)
        dp = r(*pooled).to(torch.bfloat16)
        dsk = r(*shape).to(torch.bfloat16)
        args = (x, inv, sh, "relu", win, dp)
        out.append((f"K6 {label}", ms(
            lambda: fused.pool_bnact_bwd_kernel(*args))))
        if skip_in:
            def k6_skip():
                return fused.pool_bnact_bwd_kernel(*args, dsk)
        else:
            def k6_skip():
                dx, dinv, dshift = fused.pool_bnact_bwd_kernel(*args)
                return dx + dsk, dinv, dshift
        out.append((f"K6+skip {label}", ms(k6_skip)))
        del x, dp, dsk, args
        torch.cuda.empty_cache()
    return out


# (label, R, C) of K8 and K10: chip_smoke.py's BN_VARIANTS in training.
BN_SHAPES = [("bench L2", 85_184, 128), ("bench L3", 10_648, 256),
             ("ragged", 85_221, 128), ("b8 L0", 2_725_888, 32),
             ("b8 L1", 681_472, 64), ("b2 L0", 681_472, 32),
             ("b2 L1", 170_368, 64), ("b2 L2", 21_296, 128),
             ("b2 L3", 2_662, 256)]


def device_ms(fn, n=20):
    """Device time of one call of ``fn``: every device kernel of ``n``
    calls after a warm-up (torch.profiler), per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type.name == "CUDA") / 1e3 / n


def bn_reductions():
    """K8 and K10 with their glue at BN_SHAPES (bf16): per call and
    device ms, in whichever form the checkout has them."""
    import inspect
    from elektronn3_tpu_torch.ops import pallas_bn as bn
    one_launch = len(inspect.signature(bn.bn_stats_kernel).parameters) > 1
    g = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for label, r, c in BN_SHAPES:
        x = (3.0 + 2.0 * torch.randn(r, c, generator=g, device="cuda")).to(
            torch.bfloat16)
        gy = torch.randn(r, c, generator=g, device="cuda").to(torch.bfloat16)
        gamma = torch.randn(c, generator=g, device="cuda")
        beta = torch.randn(c, generator=g, device="cuda")
        ra_mean = torch.zeros(c, device="cuda")
        ra_var = torch.ones(c, device="cuda")
        mean = x.float().mean(0)
        var = x.float().var(0, unbiased=False)
        if one_launch:
            def k8():
                return bn.bn_stats_kernel(x, gamma, beta, 1e-5,
                                          (ra_mean, ra_var, 0.1))

            def k10():
                return bn.bn_bwd_reduce_kernel(gy, x, mean, var, gamma, 1e-5)
        else:
            def k8():
                f = bn.fold_forward(bn.bn_stats_kernel(x), r, gamma, beta,
                                    1e-5)
                with torch.no_grad():
                    for buf, val in ((ra_mean, f[0]), (ra_var, f[1])):
                        buf.copy_(0.9 * buf.float() + 0.1 * val.float())
                return f

            def k10():
                inv = torch.rsqrt(var + 1e-5)
                sums = bn.bn_bwd_reduce_kernel(gy, x, mean, inv)
                return (bn.fold_backward(sums, r, gamma, mean, inv),
                        sums[1].to(gamma.dtype), sums[0].to(gamma.dtype))
        out += [(f"K8 {label}", ms(k8, 50)), (f"K8 device {label}",
                                               device_ms(k8)),
                (f"K10 {label}", ms(k10, 50)), (f"K10 device {label}",
                                                 device_ms(k10))]
        del x, gy
        torch.cuda.empty_cache()
    return out


def ms(fn, reps=20):
    """Mean time of ``fn`` over ``reps`` back-to-back calls after one
    warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def steps():
    """The headline UNet's training step (bf16, CEDiceLoss, Adam, 5
    device-resident batches; 3 warm-up and 20 timed steps ended by a
    host read of the loss) at bench.py's shapes with ``vup`` on, then
    off (step ms and the timed steps' peak allocated MB), then with
    ``normalization='batchp'`` (batch 8) and with it and
    ``pallas_flat=False`` at batch 2 (step ms), then the start_filts=64
    model at bench.py's shapes and the 2D model at batch 8 of (640, 640)
    (step ms)."""
    import time
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.training import train_step
    crit = CEDiceLoss(1.0, 1.0)
    out = []
    for label, kw, batch in (
            ("vup=True", dict(vup=True), 8), ("vup=False", {}, 8),
            ("batchp", dict(normalization="batchp"), 8),
            ("batchp b2", dict(normalization="batchp", pallas_flat=False),
             2), ("sf64", dict(start_filts=64), 8),
            ("2D", dict(dim=2, planar_blocks=()), 8)):
        g = torch.Generator(device="cuda").manual_seed(7)
        shape = (batch, 640, 640, 1) if kw.get("dim") == 2 \
            else (batch, 44, 88, 88, 1)
        batches = [(torch.randn(shape, generator=g, device="cuda"),
                    torch.randint(0, 2, shape[:-1], generator=g,
                                  device="cuda"))
                   for _ in range(5)]
        model = UNet(**{**dict(in_channels=1, out_channels=2, n_blocks=4,
                               start_filts=32, planar_blocks=(0,),
                               dtype=torch.bfloat16, device="cuda",
                               generator=torch.Generator().manual_seed(4)),
                        **kw})
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        for _ in range(3):
            loss = train_step(model, crit, opt, *batches[0])
        float(loss)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(20):
            loss = train_step(model, crit, opt, *batches[i % 5])
        float(loss)
        out.append((f"step {label}", (time.perf_counter() - t0) / 20 * 1e3))
        if "vup" in label:
            out.append((f"peak MB {label}",
                        torch.cuda.max_memory_allocated() / 1e6))
        del model, opt, batches
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
