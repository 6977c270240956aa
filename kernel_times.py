"""Times the port's fused kernels K1, K3, K4, K5 and K7, row 13's and two
vup entries (bf16, CUDA events, 20 launches after one warm-up) in the
checkout that is the working directory, and prints one line.

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
  that up_2 (row 23, ``upconv_stats_bwd``, and row 9's weight gradient,
  ``conv_vup_wgrad``, with statistics cotangents), K4 and K5 at
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
  checkouts.
Last, the headline UNet's training step at bench.py's shapes with
``vup`` on and off (step ms and peak allocated MB).
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

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

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
    del skip, yv, dyv, margs
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
    del xu
    out += vup_steps()
    print(os.path.basename(os.getcwd()) + ": " + "; ".join(
        f"{k} {v:.3f}" for k, v in out), flush=True)


def vup_steps():
    """The headline UNet's training step at bench.py's shapes (bf16,
    CEDiceLoss, Adam, 5 device-resident batches; 3 warm-up and 20 timed
    steps ended by a host read of the loss) with ``vup`` on, then off:
    step ms and the timed steps' peak allocated MB."""
    import time
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.training import train_step
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (8, 44, 88, 88, 1)
    batches = [(torch.randn(shape, generator=g, device="cuda"),
                torch.randint(0, 2, shape[:-1], generator=g, device="cuda"))
               for _ in range(5)]
    crit = CEDiceLoss(1.0, 1.0)
    out = []
    for on in (True, False):
        model = UNet(in_channels=1, out_channels=2, n_blocks=4,
                     start_filts=32, planar_blocks=(0,), dtype=torch.bfloat16,
                     device="cuda", vup=on,
                     generator=torch.Generator().manual_seed(4))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        for _ in range(3):
            loss = train_step(model, crit, opt, *batches[0])
        float(loss)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(20):
            loss = train_step(model, crit, opt, *batches[i % 5])
        float(loss)
        out += [(f"step vup={on}", (time.perf_counter() - t0) / 20 * 1e3),
                (f"peak MB vup={on}", torch.cuda.max_memory_allocated() / 1e6)]
        del model, opt
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
