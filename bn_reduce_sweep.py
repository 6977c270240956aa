"""Tunes the plan of the 'batchp' norm's reductions K8 (``bn_stats``)
and K10 (``bn_bwd_reduce``, csrc/batch_norm.cu) on the card: bf16 device
time (torch.profiler) of each at the 'batchp' steps' shapes under every
grid configuration (blocks of a cluster, blocks an SM, rows a thread at
least), one cluster against the grid from 2^17 to 2^21 elements, and
the time a call of back-to-back calls of each beside its library call
(``torch.batch_norm_stats``, ``native_batch_norm_backward``).

    python3 bn_reduce_sweep.py

The module constants of ops/pallas_bn.py are set for each arm and put
back at the end; prints one line an arm.
"""
import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from elektronn3_tpu_torch.ops import pallas_bn as bn

# (label, R, C): the b2 step's four levels, the bench step's library
# levels, the pallas_flat=False step's L0 and L1 at batch 8.
SHAPES = [("b2 L0", 681_472, 32), ("b2 L1", 170_368, 64),
          ("b2 L2", 21_296, 128), ("b2 L3", 2_662, 256),
          ("bench L2", 85_184, 128), ("bench L3", 10_648, 256),
          ("b8 L0", 2_725_888, 32), ("b8 L1", 681_472, 64)]
KNOBS = ("CLUSTER", "BLOCKS_PER_SM", "MIN_ROWS_PER_THREAD",
         "SINGLE_CLUSTER_MAX")


def call_ms(fn, n=200):
    """Time a call of ``n`` back-to-back calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n=20):
    """Device time of the reduction kernel a call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type.name == "CUDA"
               and "bn_reduce_kernel" in e.name) / 1e3 / n


def operands(r, c):
    x = torch.randn(r, c, device="cuda").to(torch.bfloat16)
    gy = torch.randn(r, c, device="cuda").to(torch.bfloat16)
    gamma = torch.ones(c, device="cuda")
    return x, gy, gamma, bn.bn_stats_kernel(x, gamma, gamma, 1e-5)


def both(x, gy, gamma, st):
    """K8's and K10's device ms."""
    return (device_ms(lambda: bn.bn_stats_kernel(x, gamma, gamma, 1e-5)),
            device_ms(lambda: bn.bn_bwd_reduce_kernel(gy, x, st[0], st[1],
                                                      gamma, 1e-5)))


def configure(**kw):
    for k, v in kw.items():
        setattr(bn, k, v)
    bn._WORKSPACE.clear()


def main():
    if not torch.cuda.is_available():
        sys.exit("bn_reduce_sweep: no CUDA device")
    saved = {k: getattr(bn, k) for k in KNOBS}
    try:
        for cl in (4, 8):
            for bps in (1, 2):
                for mr in (8, 16):
                    configure(CLUSTER=cl, BLOCKS_PER_SM=bps,
                              MIN_ROWS_PER_THREAD=mr,
                              SINGLE_CLUSTER_MAX=saved["SINGLE_CLUSTER_MAX"])
                    line = []
                    for label, r, c in SHAPES:
                        a, b = both(*operands(r, c))
                        line.append(f"{label} {a * 1e3:.1f}/{b * 1e3:.1f}")
                    print(f"grid cluster {cl}, {bps} a SM, {mr} rows: K8/K10 "
                          "us " + "; ".join(line), flush=True)
        for cl, c in ((8, 32), (8, 128), (8, 256), (4, 128)):
            configure(**{**saved, "CLUSTER": cl})
            for elems in (1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21):
                ops = operands(elems // c, c)
                t = {}
                for arm, limit in (("one cluster", 1 << 40), ("grid", 0)):
                    bn.SINGLE_CLUSTER_MAX = limit
                    t[arm] = both(*ops)
                print(f"cluster {cl} C={c} R={elems // c}: K8/K10 ms",
                      json.dumps(t), flush=True)
        configure(**saved)
        for label, r, c in SHAPES:
            x, gy, gamma, st = operands(r, c)
            ra = (torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"),
                  0.1)
            k8 = call_ms(lambda: bn.bn_stats_kernel(x, gamma, gamma, 1e-5, ra))
            k10 = call_ms(lambda: bn.bn_bwd_reduce_kernel(
                gy, x, st[0], st[1], gamma, 1e-5))
            lib8 = call_ms(lambda: torch.batch_norm_stats(x, 1e-5))
            lib10 = call_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                gy, x, gamma, None, None, st[0], st[2], True, 1e-5,
                [False, True, True]))
            print(f"a call {label}: K8 {k8 * 1e3:.1f} us (library "
                  f"{lib8 * 1e3:.1f}), K10 {k10 * 1e3:.1f} us (library "
                  f"{lib10 * 1e3:.1f})", flush=True)
    finally:
        configure(**saved)


if __name__ == "__main__":
    main()
