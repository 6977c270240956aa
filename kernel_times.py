"""Times the port's fused kernels K1, K3, K4, K5 and K7 (bf16, CUDA
events, 20 launches after one warm-up) in the checkout that is the
working directory, and prints one line.

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
- K4 and K5 of that up_2 merge, K7 of that upconv; these three first,
  on inputs from the plain forwards, so that nothing the forward kernels
  allocate moves their inputs between two checkouts.
"""
import os
import sys

import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from elektronn3_tpu_torch.ops import _build, fused, pallas_conv
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
    print(os.path.basename(os.getcwd()) + ": " + "; ".join(
        f"{k} {v:.3f}" for k, v in out), flush=True)


if __name__ == "__main__":
    main()
