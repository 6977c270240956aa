"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's serving path (``elektronn3_tpu_torch``; no JAX) at the
headline model's full width and checks it:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the hand-written kernels of ``elektronn3_tpu_torch/csrc`` with
   nvcc and prints the build time and each kernel's registers;
3. holds every kernel variant the path uses against its plain PyTorch
   version at the shapes of one Predictor tile (128, 256, 256), in
   bfloat16 and float32, and times both;
4. builds the headline UNet (n_blocks=4, start_filts=32, planar L0,
   batch norm, bfloat16) with seeded weights and random running
   statistics and holds ``forward`` against ``forward(reference=True)``
   on one tile;
5. runs Predictor requests on a seeded (1, 1, 64, 256, 256) volume
   (tile (64, 128, 128), overlap (32, 64, 64), batch 2): bfloat16
   probabilities twice (the second timed, with the kernels' launch
   counts reset just before it) and a uint8 argmax; checks the outputs
   and that every kernel launched.

Any failed check raises, and the script exits non-zero. The last two
lines are a JSON object with each kernel's numbers, then
``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

TILE = (128, 256, 256)             # one Predictor input tile (D, H, W)
L1 = (128, 128, 128)               # its level 1
L2 = (64, 64, 64)                  # its level 2 (the up_1 upconv input)
SOURCES = {
    "conv_bnact": ("elektronn3_tpu_torch/csrc/conv_bnact.cu",
                   "elektronn3_tpu/ops/flat_fused.py:689 conv_bnact_flat; "
                   "elektronn3_tpu/ops/flat_fused.py:2020 conv1_bnstats_flat; "
                   "elektronn3_tpu/ops/flat_fused64.py:1087 "
                   "conv3_bnact_flat64"),
    "pool_bnact": ("elektronn3_tpu_torch/csrc/pool_bnact.cu",
                   "elektronn3_tpu/ops/flat_fused.py:1454 "
                   "pool_bnact_flat_skip; elektronn3_tpu/ops/flat_fused64.py"
                   ":1597 pool222_bnact_flat64_skip"),
    "upconv_bnact": ("elektronn3_tpu_torch/csrc/upconv_bnact.cu",
                     "elektronn3_tpu/ops/flat_fused64.py:1977 "
                     "upconv222_bn_flat64; elektronn3_tpu/ops/flat_fused64.py"
                     ":2657 upconv122_from_flat64"),
}
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
    """bf16: |got - ref| <= 1e-2 max|ref| + one bf16 ulp of ref;
    float32: <= 1e-4 max|ref|. Returns the max abs error."""
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


def make_case(fused, kernel, shape, cins, cout, kdw, pro, dtype, seed):
    """Inputs for one variant; returns (kernel call, plain call)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g, device=dev)

    xs = [rnd(1, *shape, c).to(dtype) for c in cins]
    cin = sum(cins)
    inv = rnd(cin) if pro else None          # negative scales included
    shift = rnd(cin, scale=0.5) if pro else None
    act = "relu" if pro else "linear"
    if kernel == "conv_bnact":
        std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
        w, b = rnd(cout, cin, kdw, 3, 3, scale=std), rnd(cout, scale=0.1)
        args = (xs, inv, shift, w, b, act)
        call = fused.conv_bnact
    elif kernel == "pool_bnact":
        args = (xs[0], inv, shift, act, kdw)
        call = fused.pool_bnact
    else:
        std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
        w, b = rnd(cin, cout, kdw, 2, 2, scale=std), rnd(cout, scale=0.1)
        args = (xs[0], inv, shift, w, b, act)
        call = fused.upconv_bnact
    return (lambda: call(*args)), (lambda: call(*args, reference=True))


def kernel_phase(fused):
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in SOURCES}
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
            ms, plain_ms = cuda_ms(run), cuda_ms(plain)
            print(f"kernel {kernel:12s} {label:26s} {str(dtype)[6:]:8s} "
                  f"max_abs_err {err:.3e}  {ms:9.3f} ms  plain "
                  f"{plain_ms:9.3f} ms", flush=True)
            s = stats[kernel]
            s["err"] = max(s["err"], err)
            if dtype == torch.bfloat16:      # the path's dtype
                s["ms"] += ms
                s["plain_ms"] += plain_ms
            torch.cuda.empty_cache()
    return stats


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
    from elektronn3_tpu_torch.ops import _build, fused

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
        m = re.search(r"Compiling entry function '.*?\d((?:up)?conv_bnact"
                      r"(?:_mma)?_kernel|pool_bnact_kernel)"
                      r"(?:I(f|13__nv_bfloat16))?", line)
        if m:
            kernel = m.group(1) + {"f": "<float>", None: "",
                                   "13__nv_bfloat16": "<bf16>"}[m.group(2)]
        elif "registers" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")

    stats = kernel_phase(fused)

    # -- model: kernels against the reference forward on one tile --------
    model = UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
                 planar_blocks=(0,), normalization="batch",
                 dtype=torch.bfloat16, device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval()
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

    # -- Predictor requests (the main path) ------------------------------
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches[k],
         "max_abs_err": stats[k]["err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"]} for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
