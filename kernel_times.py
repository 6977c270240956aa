"""Times the port's fused kernels K1, K3, K4, K5 and K7 at the headline
UNet's shapes (bf16, CUDA events, 20 launches after one warm-up) in the
checkout that is the working directory, and prints one line.

    cd <checkout> && python3 <path>/kernel_times.py

Run it from two checkouts in turns (A, B, B, A) on one card, one run
right after the other, to compare their kernels: times taken on
different machines or cards are not comparable. Shapes: K1 at the 3D Predictor tile (1, 128, 256,
256) as served (the L0 conv2 32->32 and the up_2 merge 32+32->32, relu
prologue); K4 and K5 of that merge, K3 with statistics and K7 of the
up_2 (1, 2, 2) upconv 64->32 at bench.py's batch 8 of (44, 88, 88).
"""
import os
import sys

import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from elektronn3_tpu_torch.ops import _build, fused
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
    for label, cins in (("tile L0 conv2", (32,)), ("tile up_2 merge",
                                                   (32, 32))):
        xs = [r(1, 128, 256, 256, c).to(bf) for c in cins]
        cin = sum(cins)
        w, b, inv, sh = r(32, cin, 1, 3, 3, scale=0.1), r(32), r(cin), r(cin)
        out.append((f"K1 {label}", ms(lambda: fused.conv_bnact_fwd_kernel(
            xs, inv, sh, w, b, "relu", False))))
        del xs
    xs = [r(8, 44, 88, 88, 32).to(bf), r(8, 44, 88, 88, 32).to(bf)]
    w, b, inv, sh = r(32, 64, 1, 3, 3, scale=0.1), r(32), r(64), r(64)
    y = fused.conv_bnact_fwd_kernel(xs, inv, sh, w, b, "relu", False)[0]
    dy = r(*y.shape, scale=0.1).to(bf)
    ds, dq = r(32, scale=1e-3), r(32, scale=1e-4)
    args = (xs, inv, sh, w, y, dy, ds, dq, "relu")
    out.append(("K4 bench merge",
                ms(lambda: fused.conv_bnact_dgrad_kernel(*args))))
    out.append(("K5 bench merge",
                ms(lambda: fused.conv_bnact_wgrad_kernel(*args))))
    x = r(8, 44, 44, 44, 64).to(bf)
    wu, bu, invc, shc = r(64, 32, 1, 2, 2, scale=0.1), r(32), r(64), r(64)
    yu = fused.upconv_bnact_fwd_kernel(x, invc, shc, wu, bu, "relu", True)[0]
    dyu = r(*yu.shape, scale=0.1).to(bf)
    out.append(("K3 bench up_2 +stats", ms(
        lambda: fused.upconv_bnact_fwd_kernel(x, invc, shc, wu, bu, "relu",
                                              True))))
    out.append(("K7 bench up_2", ms(lambda: fused.upconv_bnact_bwd_kernel(
        x, invc, shc, wu, yu, dyu, ds, dq, "relu"))))
    print(os.path.basename(os.getcwd()) + ": " + "; ".join(
        f"{k} {v:.3f}" for k, v in out), flush=True)


if __name__ == "__main__":
    main()
