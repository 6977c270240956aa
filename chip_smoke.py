"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Drives the port's two paths (``elektronn3_tpu_torch``; no JAX) at the
headline model's full width and checks them:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the hand-written kernels of ``elektronn3_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time
   and each kernel's registers;
3. holds the forward kernels K1-K3 against their plain PyTorch versions
   at the shapes of one Predictor tile (128, 256, 256), in bfloat16 and
   float32, and times both;
4. holds the statistics outputs of K1 and K3 and the backward kernels
   K4-K7 against their plain versions at the shapes of ``bench.py``'s
   training step (batch 8 of (44, 88, 88): levels (44, 88, 88) x 32,
   (44, 44, 44) x 64, (22, 22, 22) x 128), in bfloat16 and float32, and
   times both;
5. builds the headline UNet (n_blocks=4, start_filts=32, planar L0,
   batch norm, bfloat16) with seeded weights and random running
   statistics and holds ``forward`` against ``forward(reference=True)``
   on one tile;
6. runs Predictor requests on a seeded (1, 1, 64, 256, 256) volume
   (tile (64, 128, 128), overlap (32, 64, 64), batch 2): bfloat16
   probabilities twice (the second timed, with the kernels' launch
   counts reset just before it) and a uint8 argmax; checks the outputs
   and that K1-K3 launched (the serving path);
7. trains the headline UNet (bf16, ``CEDiceLoss(1, 1)``, Adam 1e-3) at
   ``bench.py``'s shapes: 3 warm-up and 20 timed steps over 5
   device-resident batches on the kernel path (launch counts reset just
   before the timed steps: every kernel must launch), the plain path,
   and the kernel path again; a falling loss on a fixed, learnable
   batch; then one
   step's loss, parameter gradients and new running statistics against
   the same step through ``reference=True``, in float32 and bfloat16;
8. runs ``Trainer.run(max_steps=4)`` on a small in-memory dataset into a
   temporary directory and resumes a second Trainer from what it wrote.

``--profile`` also profiles three kernel-path training steps with
``torch.profiler`` and prints the device time by kernel.

Any failed check raises, and the script exits non-zero. The last lines
are a JSON object with each kernel's numbers, the card's name and power
limit, then ``{"ok": true, "device": {...}}``.
"""

import copy
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TILE = (128, 256, 256)             # one Predictor input tile (D, H, W)
L1 = (128, 128, 128)               # its level 1
L2 = (64, 64, 64)                  # its level 2 (the up_1 upconv input)
BATCH = 8                          # bench.py's training step
PATCH = (44, 88, 88)               # its L0
TL1 = (44, 44, 44)
TL2 = (22, 22, 22)
WARMUP, STEPS, N_BATCHES = 3, 20, 5
# check_train_step: a gradient leaf may differ from the reference step's
# by this many times the reference step's own difference under a one-ulp
# input change (the noise), plus a relative term. On an H100 the leaves
# whose bound the noise sets differ by at most 2.3 times the noise in
# float32 and 0.8 times in bfloat16 (PERF.md gives the readings).
NOISE_FACTOR = 3
_F = "elektronn3_tpu/ops/flat_fused.py"
_F64 = "elektronn3_tpu/ops/flat_fused64.py"
SOURCES = {
    "conv_bnact": ("elektronn3_tpu_torch/csrc/conv_bnact.cu",
                   f"{_F}:689 conv_bnact_flat; {_F}:2020 conv1_bnstats_flat;"
                   f" {_F64}:1087 conv3_bnact_flat64"),
    "pool_bnact": ("elektronn3_tpu_torch/csrc/pool_bnact.cu",
                   f"{_F}:1454 pool_bnact_flat_skip; {_F64}:1597 "
                   "pool222_bnact_flat64_skip"),
    "upconv_bnact": ("elektronn3_tpu_torch/csrc/upconv_bnact.cu",
                     f"{_F64}:1977 upconv222_bn_flat64; {_F64}:2657 "
                     "upconv122_from_flat64"),
    "conv_bnact_dgrad": ("elektronn3_tpu_torch/csrc/conv_bnact_bwd.cu",
                         f"{_F}:742 _conv_bnact_bwd (dgrad); {_F64}:1139 "
                         "_conv64_bwd (dgrad)"),
    "conv_bnact_wgrad": ("elektronn3_tpu_torch/csrc/conv_bnact_bwd.cu",
                         f"{_F}:742 _conv_bnact_bwd (wgrad); {_F64}:1139 "
                         f"_conv64_bwd (wgrad); {_F}:2091 _conv1_bwd"),
    "pool_bnact_bwd": ("elektronn3_tpu_torch/csrc/pool_bnact.cu",
                       f"{_F}:1367 _pool_bwd_impl; {_F64}:1519 "
                       "_pool64_bwd_impl"),
    "upconv_bnact_bwd": ("elektronn3_tpu_torch/csrc/upconv_bnact.cu",
                         f"{_F64}:2044 _upconv64_bwd; {_F64}:2732 "
                         "_upconv122_f64_bwd"),
}
# Forward variants at the Predictor tile's shapes:
# (kernel, label, level shape, input channels, C_out, kd / window, prologue)
VARIANTS = [
    ("conv_bnact", "L0 conv1 1->32 kd1", TILE, (1,), 32, 1, False),
    ("conv_bnact", "L0 conv2 32->32 kd1", TILE, (32,), 32, 1, True),
    ("conv_bnact", "up_2 merge 32+32->32 kd1", TILE, (32, 32), 32, 1, True),
    ("conv_bnact", "L1 conv1 32->64 kd3", L1, (32,), 64, 3, False),
    ("conv_bnact", "L1 conv2 64->64 kd3", L1, (64,), 64, 3, True),
    ("conv_bnact", "up_1 merge 64+64->64 kd3", L1, (64, 64), 64, 3, True),
    ("pool_bnact", "L0 pool (1,2,2) C=32", TILE, (32,), 32, (1, 2, 2), True),
    ("pool_bnact", "L1 pool (2,2,2) C=64", L1, (64,), 64, (2, 2, 2), True),
    ("upconv_bnact", "up_1 (2,2,2) 128->64", L2, (128,), 64, 2, False),
    ("upconv_bnact", "up_2 (1,2,2) 64->32", L1, (64,), 32, 1, True),
]
# Training variants at bench.py's shapes (batch 8), same fields. A conv
# variant checks the statistics outputs of K1, then K4 (unless its input
# is the network input) and K5; an upconv one the statistics of K3, then
# K7; a pool one K6.
TRAIN_VARIANTS = [
    ("conv", "L0 conv1 1->32 kd1", PATCH, (1,), 32, 1, False),
    ("conv", "L0 conv2 32->32 kd1", PATCH, (32,), 32, 1, True),
    ("conv", "up_2 merge 32+32->32 kd1", PATCH, (32, 32), 32, 1, True),
    ("conv", "L1 conv1 32->64 kd3", TL1, (32,), 64, 3, True),
    ("conv", "L1 conv2 64->64 kd3", TL1, (64,), 64, 3, True),
    ("conv", "up_1 merge 64+64->64 kd3", TL1, (64, 64), 64, 3, True),
    ("pool", "L0 pool (1,2,2) C=32", PATCH, (32,), 32, (1, 2, 2), True),
    ("pool", "L1 pool (2,2,2) C=64", TL1, (64,), 64, (2, 2, 2), True),
    ("upconv", "up_1 (2,2,2) 128->64", TL2, (128,), 64, 2, False),
    ("upconv", "up_2 (1,2,2) 64->32", TL1, (64,), 32, 1, True),
]


def cuda_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bf16_ulp(r):
    _, e = torch.frexp(r)
    return torch.ldexp(torch.ones_like(r), e - 8)


def check_close(got, ref, dtype, what):
    """Elementwise: bf16 |got - ref| <= 1e-2 max|ref| + one bf16 ulp of
    ref (the one rounding after sums taken in another order); float32
    <= 1e-4 max|ref|. Returns the max abs error."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    if dtype == torch.bfloat16:
        bound = 1e-2 * scale + bf16_ulp(ref)
    else:
        bound = torch.full_like(ref, 1e-4 * scale)
    if not bool(torch.isfinite(got).all()) or not bool((err <= bound).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())} "
                             f"over bound (max|ref| {scale})")
    return float(err.max())


def check_sum(got, ref, what, tol=1e-3):
    """A float32 sum over voxels (statistics, dinv, dshift, dW, db), the
    same terms summed in another order: |got - ref| <= 1e-3 max|ref|.
    Returns the max abs error."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise AssertionError(f"{what}: max abs err {err} over {tol} x "
                             f"max|ref| {scale}")
    return err


def rand_on_card(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g, device="cuda")
    return rnd


def make_case(fused, kernel, shape, cins, cout, kdw, pro, dtype, seed):
    """Inputs for one forward variant (as served: no statistics);
    returns (kernel call, plain call), each giving the output tensor."""
    rnd = rand_on_card(seed)
    xs = [rnd(1, *shape, c).to(dtype) for c in cins]
    cin = sum(cins)
    inv = rnd(cin) if pro else None          # negative scales included
    shift = rnd(cin, scale=0.5) if pro else None
    act = "relu" if pro else "linear"
    if kernel == "conv_bnact":
        std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
        w, b = rnd(cout, cin, kdw, 3, 3, scale=std), rnd(cout, scale=0.1)
        args = (xs, inv, shift, w, b, act, False)
        run, plain = fused.conv_bnact_fwd_kernel, fused.conv_bnact_fwd_plain
    elif kernel == "pool_bnact":
        args = (xs[0], inv, shift, act, kdw)
        run, plain = fused.pool_bnact_fwd_kernel, fused.pool_bnact_fwd_plain
        return (lambda: run(*args)), (lambda: plain(*args))
    else:
        std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
        w, b = rnd(cin, cout, kdw, 2, 2, scale=std), rnd(cout, scale=0.1)
        args = (xs[0], inv, shift, w, b, act, False)
        run, plain = (fused.upconv_bnact_fwd_kernel,
                      fused.upconv_bnact_fwd_plain)
    return (lambda: run(*args)[0]), (lambda: plain(*args)[0])


class Stats:
    """Per kernel: the largest error and the bf16 times at the path's
    shapes."""

    def __init__(self):
        self.k = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
                  for name in SOURCES}

    def add(self, kernel, label, dtype, err, ms, plain_ms, time_it=True):
        s = self.k[kernel]
        s["err"] = max(s["err"], err)
        if dtype == torch.bfloat16 and time_it:
            s["ms"] += ms
            s["plain_ms"] += plain_ms
        print(f"kernel {kernel:16s} {label:34s} {str(dtype)[6:]:8s} "
              f"max_abs_err {err:.3e}  {ms:9.3f} ms  plain "
              f"{plain_ms:9.3f} ms", flush=True)


def kernel_phase(fused, stats):
    """K1-K3 at the Predictor tile's shapes."""
    for seed, (kernel, label, shape, cins, cout, kdw, pro) in \
            enumerate(VARIANTS):
        for dtype in (torch.bfloat16, torch.float32):
            run, plain = make_case(fused, kernel, shape, cins, cout, kdw,
                                   pro, dtype, seed)
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            err = check_close(got, ref, dtype, f"{label} {dtype}")
            del got, ref
            stats.add(kernel, label, dtype, err, cuda_ms(run),
                      cuda_ms(plain))
            torch.cuda.empty_cache()


def train_kernel_phase(fused, stats):
    """The statistics outputs of K1 and K3 and K4-K7 at bench.py's
    shapes. Forward statistics are held against the plain sums of the
    kernel's own stored output (the same values: only the order of the
    sum differs). The statistics variants are printed but not added to
    K1's and K3's times (those stay the Predictor tile's)."""
    for seed, (kind, label, shape, cins, cout, kdw, pro) in \
            enumerate(TRAIN_VARIANTS):
        for dtype in (torch.bfloat16, torch.float32):
            rnd = rand_on_card(100 + seed)
            xs = [rnd(BATCH, *shape, c).to(dtype) for c in cins]
            cin = sum(cins)
            inv = rnd(cin) if pro else None
            shift = rnd(cin, scale=0.5) if pro else None
            act = "relu" if pro else "linear"
            if kind == "pool":
                dp_shape = (BATCH, shape[0] // kdw[0], shape[1] // 2,
                            shape[2] // 2, cin)
                dp = rnd(*dp_shape).to(dtype)
                args = (xs[0], inv, shift, act, kdw, dp)
                run = lambda: fused.pool_bnact_bwd_kernel(*args)   # noqa
                plain = lambda: fused.pool_bnact_bwd_plain(*args)  # noqa
                got, ref = run(), plain()
                torch.cuda.synchronize()
                if not torch.equal(got[0], ref[0]):
                    raise AssertionError(f"K6 {label}: dx not exact")
                err = max(check_sum(got[1], ref[1], f"K6 {label} dinv"),
                          check_sum(got[2], ref[2], f"K6 {label} dshift"))
                del got, ref
                stats.add("pool_bnact_bwd", label, dtype, err,
                          cuda_ms(run), cuda_ms(plain))
                continue
            if kind == "conv":
                std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
                w = rnd(cout, cin, kdw, 3, 3, scale=std)
                fwd_name = "conv_bnact"
                fwd, fwd_plain = (fused.conv_bnact_fwd_kernel,
                                  fused.conv_bnact_fwd_plain)
                bwds = [("conv_bnact_wgrad", fused.conv_bnact_wgrad_kernel,
                         fused.conv_bnact_wgrad_plain)]
                if cins[0] % 32 == 0:
                    bwds.insert(0, ("conv_bnact_dgrad",
                                    fused.conv_bnact_dgrad_kernel,
                                    fused.conv_bnact_dgrad_plain))
                fargs = (xs, inv, shift)
            else:
                std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
                w = rnd(cin, cout, kdw, 2, 2, scale=std)
                fwd_name = "upconv_bnact"
                fwd, fwd_plain = (fused.upconv_bnact_fwd_kernel,
                                  fused.upconv_bnact_fwd_plain)
                bwds = [("upconv_bnact_bwd", fused.upconv_bnact_bwd_kernel,
                         fused.upconv_bnact_bwd_plain)]
                fargs = (xs[0], inv, shift)
            b = rnd(cout, scale=0.1)
            y, s, q = fwd(*fargs, w, b, act, True)
            torch.cuda.synchronize()
            ks, kq = fused.channel_stats(y)
            err = max(check_sum(s, ks, f"{label} sum"),
                      check_sum(q, kq, f"{label} sumsq"))
            _, rs, rq = fwd_plain(*fargs, w, b, act, True)
            if dtype == torch.float32:
                err = max(err, check_sum(s, rs, f"{label} sum vs plain"),
                          check_sum(q, rq, f"{label} sumsq vs plain"))
            del s, q, ks, kq, rs, rq
            stats.add(fwd_name, label + " +stats", dtype, err,
                      cuda_ms(lambda: fwd(*fargs, w, b, act, True)),
                      cuda_ms(lambda: fwd_plain(*fargs, w, b, act, True)),
                      time_it=False)
            dy = rnd(*y.shape, scale=0.1).to(dtype)
            ds, dq = rnd(cout, scale=1e-3), rnd(cout, scale=1e-4)
            bargs = (*fargs, w, y, dy, ds, dq, act)
            for name, kfn, pfn in bwds:
                run = lambda: kfn(*bargs)                          # noqa
                plain = lambda: pfn(*bargs)                        # noqa
                got, ref = run(), plain()
                torch.cuda.synchronize()
                err = 0.0
                for what, g, r in zip(("dx", "dinv", "dshift", "dW", "db"),
                                      _bwd_named(name, got),
                                      _bwd_named(name, ref)):
                    if g is None:
                        continue
                    if what == "dx":
                        for gi, ri in zip(g, r):
                            err = max(err, check_close(
                                gi, ri, dtype, f"{name} {label} dx"))
                    else:
                        err = max(err, check_sum(g, r, f"{name} {label} "
                                                 f"{what}"))
                del got, ref
                stats.add(name, label, dtype, err, cuda_ms(run),
                          cuda_ms(plain))
            del y, dy, xs
            torch.cuda.empty_cache()


def _bwd_named(name, out):
    """A backward result as (dx list, dinv, dshift, dW, db)."""
    if name == "conv_bnact_dgrad":
        return out[0], out[1], out[2], None, None
    if name == "conv_bnact_wgrad":
        return None, None, None, out[0], out[1]
    return [out[0]], out[1], out[2], out[3], out[4]


def randomize_norms(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.weight.copy_(torch.randn(c, generator=g))
                m.bias.copy_(0.2 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def headline_unet(UNet, seed, dtype=torch.bfloat16):
    return UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
                planar_blocks=(0,), normalization="batch", dtype=dtype,
                device="cuda", generator=torch.Generator().manual_seed(seed))


def predictor_phase(UNet, Predictor, fused):
    # -- model: kernels against the reference forward on one tile --------
    model = headline_unet(UNet, 0).eval()
    randomize_norms(model, 1)
    x = torch.randn((1, *TILE, 1), generator=torch.Generator().manual_seed(2))
    x = x.cuda()
    with torch.inference_mode():
        y = model(x)
        y_ref = model(x, reference=True)
    torch.cuda.synchronize()
    if y.shape != (1, *TILE, 2) or y.dtype != torch.bfloat16:
        raise AssertionError(f"model output {tuple(y.shape)} {y.dtype}")
    err = (y.float() - y_ref.float()).abs().max().item()
    scale = y_ref.float().abs().max().item()
    if not (bool(torch.isfinite(y).all()) and err <= 5e-2 * scale):
        raise AssertionError(f"UNet forward vs reference: err {err}, "
                             f"max|ref| {scale}")
    print(f"model: UNet bf16 forward vs reference on {(1, *TILE, 1)}: max "
          f"abs err {err:.4e} (max|ref| {scale:.4e}, bound 5e-2 x)",
          flush=True)
    del y, y_ref, x
    torch.cuda.empty_cache()

    # -- Predictor requests (the serving path) ---------------------------
    vol = torch.randn((1, 1, 64, 256, 256),
                      generator=torch.Generator().manual_seed(3)).numpy()
    kw = dict(tile_shape=(64, 128, 128), overlap_shape=(32, 64, 64),
              float16=True, batch_size=2)
    pred = Predictor(model, **kw)
    pred.predict(vol)                                  # warm-up request
    torch.cuda.synchronize()
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    dt = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    print(f"predictor: bf16 probabilities {probs.shape} in {dt:.3f} s = "
          f"{vol.size / dt / 1e6:.2f} MVox/s; launches {launches}",
          flush=True)
    t0 = time.perf_counter()
    ids = Predictor(model, argmax_with_threshold=True, **kw).predict(vol)
    dt_ids = time.perf_counter() - t0
    print(f"predictor: uint8 argmax {ids.shape} in {dt_ids:.3f} s = "
          f"{vol.size / dt_ids / 1e6:.2f} MVox/s", flush=True)
    if probs.shape != (1, 2, 64, 256, 256) or not np.isfinite(probs).all():
        raise AssertionError("probabilities: bad shape or non-finite")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-2:
        raise AssertionError(
            f"probabilities sum to 1 within {np.abs(probs.sum(1) - 1).max()}")
    if ids.dtype != np.uint8 or ids.shape != (1, 1, 64, 256, 256):
        raise AssertionError(f"argmax output {ids.dtype} {ids.shape}")
    margin = np.abs(probs[:, 1] - probs[:, 0])
    agree = (ids[:, 0] == probs.argmax(1)) | (margin <= 2.0 ** -7)
    if not agree.all():
        raise AssertionError(f"argmax disagrees with the probabilities at "
                             f"{int((~agree).sum())} voxels")
    missing = [k for k in ("conv_bnact", "pool_bnact", "upconv_bnact")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{missing}")
    return launches


def _step_grads(model, crit, x, y, reference):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = crit(model(x, reference=reference), y)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                                  for n, p in model.named_parameters()}


def check_train_step(UNet, crit, x, y):
    """One step's loss, parameter gradients and new running statistics
    on the kernel path against the same step through reference=True,
    from equal parameters and running statistics, in float32 and in
    bfloat16. Per gradient leaf, in the L2 norm:
    |g - r| <= rel |r| + NOISE_FACTOR |r' - r|, with rel 1e-3 (float32)
    or 1e-2 (bf16) and r' the reference step on an input moved by about one ulp
    of the dtype (2^-23 or 2^-8 relative, seeded): the step's own
    rounding noise. A batch norm over 2.7 M voxels makes a weight
    gradient the small difference of large float32 sums (and in bf16
    each term is rounded before the weight-gradient product, as in JAX),
    so that noise can be a large share of a leaf; the kernels sum in
    another order than the plain versions. The bias of a conv that
    feeds a batch norm has an exact gradient of 0: both of its computed
    gradients must be at most 1e-4 (float32) or 1e-2 (bf16) of the
    weight gradient's norm. The loss within 1e-4 (float32) or 1e-2
    (bf16) relative; each running statistic within 1e-3 (float32) or
    5e-2 (bf16) of its max."""
    failures = []
    for dtype, rel, ulp, zero in ((torch.float32, 1e-3, 2.0 ** -23, 1e-4),
                                  (torch.bfloat16, 1e-2, 2.0 ** -8, 1e-2)):
        bf16 = dtype == torch.bfloat16
        model = headline_unet(UNet, 4, dtype)
        ref_model = copy.deepcopy(model)
        lk, grads = _step_grads(model, crit, x, y, False)
        lr, ref = _step_grads(ref_model, crit, x, y, True)
        noise = torch.randn(x.shape, generator=torch.Generator(
            device=x.device).manual_seed(11), device=x.device)
        _, moved = _step_grads(copy.deepcopy(model), crit,
                               x * (1 + ulp * noise), y, True)
        torch.cuda.synchronize()
        if not (np.isfinite(lk) and abs(lk - lr) <= (1e-2 if bf16 else 1e-4)
                * abs(lr)):
            failures.append(f"{dtype} loss {lk} vs reference {lr}")
        rows = []
        worst_zero = 0.0
        for name, g in grads.items():
            r = ref[name]
            if name.endswith(".bias") and name != "conv_final.bias" \
                    and "norm" not in name:
                wnorm = float(ref[name[:-len("bias")] + "weight"].norm())
                q = max(float(g.norm()), float(r.norm())) / wnorm
                worst_zero = max(worst_zero, q)
                if not bool(torch.isfinite(g).all()) or q > zero:
                    failures.append(f"{dtype} grad {name} (exactly 0): "
                                    f"{q} of the weight gradient")
                continue
            err = float((g - r).norm())
            rn = float(r.norm())
            nz = float((moved[name] - r).norm())
            bound = rel * rn + NOISE_FACTOR * nz
            rows.append((err / max(bound, 1e-30), name, err, nz, rn))
            if not bool(torch.isfinite(g).all()) or err > bound:
                failures.append(f"{dtype} grad {name}: |g - r| {err} > "
                                f"bound {bound} (noise {nz}, |r| {rn})")
        rows.sort(reverse=True)
        for q, n, e, nz, rn in rows:
            print(f"  leaf {str(dtype)[6:]:8s} {n:28s} |g-r| {e:.3e}  "
                  f"noise |r'-r| {nz:.3e}  |r| {rn:.3e}  err/noise "
                  f"{e / max(nz, 1e-30):6.3f}  err/|r| "
                  f"{e / max(rn, 1e-30):.2e}  err/bound {q:.3f}")
        by_noise = max(rows, key=lambda t: t[2] / max(t[3], 1e-30))
        worst_noise = by_noise[2] / max(by_noise[3], 1e-30)
        buffers = dict(ref_model.named_buffers())
        worst_buf = 0.0
        for name, b in model.named_buffers():
            if b.dtype != torch.float32:
                continue
            rb = buffers[name]
            brel = float((b - rb).abs().max()) / float(rb.abs().max())
            worst_buf = max(worst_buf, brel)
            if brel > (5e-2 if bf16 else 1e-3):
                failures.append(f"{dtype} running statistic {name}: "
                                f"relative err {brel}")
        print(f"train: one {str(dtype)[6:]} step vs reference=True: loss "
              f"{lk:.6f} vs {lr:.6f}; {len(rows)} gradients, worst "
              f"err/bound: " + ", ".join(
                  f"{n} {q:.3f} (|g-r| {e:.3e}, noise {nz:.3e}, "
                  f"|r| {rn:.3e})" for q, n, e, nz, rn in rows[:4])
              + f"; worst err/noise {worst_noise:.3f} ({by_noise[1]}); "
              f"worst err/|r| {max(t[2] / max(t[4], 1e-30) for t in rows):.2e}"
              f"; biases "
              f"before a batch norm at most {worst_zero:.2e} of their "
              f"weight gradient; running statistics max rel err "
              f"{worst_buf:.3e}", flush=True)
        del model, ref_model
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def timed_steps(train_step, model, crit, opt, batches, reference,
                before=None):
    """bench.py's loop: WARMUP steps, then STEPS timed steps cycling the
    device-resident batches, ended by a host read of the loss; ``before``
    runs just before the timed steps."""
    for _ in range(WARMUP):
        loss = train_step(model, crit, opt, *batches[0], reference=reference)
    float(loss)
    if before is not None:
        before()
    t0 = time.perf_counter()
    for i in range(STEPS):
        loss = train_step(model, crit, opt, *batches[i % len(batches)],
                          reference=reference)
    final = float(loss)
    dt = (time.perf_counter() - t0) / STEPS
    if not np.isfinite(final):
        raise AssertionError(f"non-finite loss {final}")
    return dt


def train_phase(UNet, CEDiceLoss, train_step, fused):
    crit = CEDiceLoss(1.0, 1.0)
    shape = (BATCH, *PATCH, 1)
    g = torch.Generator(device="cuda").manual_seed(7)
    batches = [(torch.randn(shape, generator=g, device="cuda"),
                torch.randint(0, 2, shape[:-1], generator=g, device="cuda"))
               for _ in range(N_BATCHES)]
    model = headline_unet(UNet, 4)

    vox = int(np.prod(shape))
    plain_model = copy.deepcopy(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    plain_opt = torch.optim.Adam(plain_model.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    dt_k = timed_steps(train_step, model, crit, opt, batches, False,
                       fused.reset_launches)
    launches = dict(fused.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    dt_p = timed_steps(train_step, plain_model, crit, plain_opt, batches,
                       True)
    peak_p = torch.cuda.max_memory_allocated() / 1e9
    dt_k2 = timed_steps(train_step, model, crit, opt, batches, False)
    for what, dt in (("kernels", dt_k), ("plain", dt_p),
                     ("kernels again", dt_k2)):
        print(f"train: {what:13s} step {dt * 1e3:9.2f} ms = "
              f"{vox / dt / 1e6:7.2f} MVox/s (batch {BATCH} of {PATCH}, "
              f"bf16, CEDiceLoss, Adam)", flush=True)
    print(f"train: peak device memory {peak:.2f} GB (kernels), "
          f"{peak_p:.2f} GB (plain); launches over {STEPS} steps "
          f"{launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{missing}")

    # A fixed batch whose target is learnable from the input (the sign
    # of x; the timed batches' targets are noise).
    fixed = (batches[0][0], (batches[0][0][..., 0] > 0).long())
    losses = [float(train_step(model, crit, opt, *fixed))
              for _ in range(10)]
    if not (np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"loss on a fixed batch does not fall: "
                             f"{losses}")
    print(f"train: loss on a fixed batch (target: sign of the input) over "
          f"10 steps {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    check_train_step(UNet, crit, *batches[0])
    return launches, model, crit, opt, batches


def profile_phase(train_step, model, crit, opt, batches):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            train_step(model, crit, opt, *batches[i])
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=30), flush=True)


class Patches(torch.utils.data.Dataset):
    """Seeded (1, D, H, W) inputs and (D, H, W) class targets."""

    def __init__(self, n, shape=(1, *PATCH), seed=0):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + shape).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + shape[1:])

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


def trainer_phase(UNet, CEDiceLoss, Trainer):
    with tempfile.TemporaryDirectory() as root:
        model = headline_unet(UNet, 5)
        tr = Trainer(model, CEDiceLoss(1.0, 1.0), train_dataset=Patches(8),
                     batch_size=2, save_root=root, exp_name="smoke",
                     nan_check_interval=2)
        tr.run(max_steps=4)
        if tr.step != 4 or not np.isfinite(tr.last_stats["tr_loss"]).all():
            raise AssertionError(f"Trainer.run: step {tr.step}, losses "
                                 f"{tr.last_stats['tr_loss']}")
        tr2 = Trainer(headline_unet(UNet, 6), CEDiceLoss(1.0, 1.0),
                      train_dataset=Patches(8), batch_size=2,
                      save_root=root, exp_name="resumed")
        tr2.load_state(f"{tr.save_path}/state_dict_final.pth")
        a, b = model.state_dict(), tr2.model.state_dict()
        if tr2.step != 4 or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("load_state did not restore the run")
        print(f"trainer: run(max_steps=4) batch 2 of {PATCH}: losses "
              f"{[round(v, 4) for v in tr.last_stats['tr_loss']]}, last "
              f"epoch {tr.last_misc['tr_speed_vx']:.2f} MVx/s; load_state "
              f"restored step {tr2.step} and every tensor", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from elektronn3_tpu_torch.inference import Predictor
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.ops import _build, fused
    from elektronn3_tpu_torch.training import Trainer, train_step

    print(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ("(nvcc ran)" if _build.build_seconds is not None
             else "(library already built)"), flush=True)
    kernel = "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '_Z.*?\d((?:[a-z]+_)+kernel)"
                      r"(I\w*?E)?E*v", line)
        if m:
            kernel = m.group(1) + (m.group(2) or "")
        elif "registers" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")

    stats = Stats()
    kernel_phase(fused, stats)
    train_kernel_phase(fused, stats)
    pred_launches = predictor_phase(UNet, Predictor, fused)
    train_launches, model, crit, opt, batches = train_phase(
        UNet, CEDiceLoss, train_step, fused)
    if "--profile" in sys.argv[1:]:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(UNet, CEDiceLoss, Trainer)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": train_launches[k],
         "launches_by_path": {"predictor": pred_launches[k],
                              "train": train_launches[k]},
         "max_abs_err": stats.k[k]["err"], "ms": stats.k[k]["ms"],
         "plain_ms": stats.k[k]["plain_ms"]} for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
