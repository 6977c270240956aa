"""Why the float32 input-gradient comparison of
tests/test_torch_cuda.py::test_cuda_unet_input_grad_matches_reference
can fail: repeats its comparison after 10 Adam steps (``--init``: at
initialisation, the test's first comparison) and counts, at those
parameters, the relu and max-pool decisions on which the kernel forward
and ``reference=True`` disagree.

    python3 input_grad_flips.py [N_FLOAT32 [N_BFLOAT16]] [--cpu] [--init]

For each run (a fresh model trained through the kernels, whose float32
atomics sum in another order each run) one JSON line: |dx - ref|, the
test's limit (1e-3 of |ref| (1e-2 in bf16) plus 3 times the reference's
dx change under a one-ulp input change), |ref|, the flips of the kernel
forward and of the one-ulp change, and for input changes of 1, 4, 16 and
64 ulps the noise term, its flips, its limit and whether a zero dx
fails that limit. Decisions are read from the
prologue inputs of every kernel op (x * inv + shift), the library
levels' normalized outputs and the pool windows (ceil mode). ``--cpu``
runs both sides on their plain versions (a rehearsal: no flips).
"""
import json
import sys

import torch
import torch.nn.functional as F

from elektronn3_tpu_torch.models import UNet, unet as unet_mod
from elektronn3_tpu_torch.modules.loss import CEDiceLoss
from elektronn3_tpu_torch.ops import fused

AMPLITUDES = (1, 4, 16, 64)   # input changes, in ulps of the dtype
_RECORD = None                # the decisions' inputs while capturing


def _pre(x, inv, shift):
    return x.float() * inv + shift


def _spy_fused(name, pool):
    real = getattr(fused, name)

    def spy(x, inv, shift, *rest):
        if _RECORD is not None and inv is not None:
            xx = torch.cat(list(x), -1) if isinstance(x, (list, tuple)) \
                else x
            act = rest[1] if pool else rest[-2]
            if act in ("relu", "leaky"):
                _RECORD.append(("pool" if pool else "pro",
                                _pre(xx, inv, shift),
                                rest[2] if pool else None))
        return real(x, inv, shift, *rest)
    setattr(fused, name, spy)


def _install_spies():
    for name in ("conv_bnact_fwd_kernel", "conv_bnact_fwd_plain",
                 "upconv_bnact_fwd_kernel", "upconv_bnact_fwd_plain"):
        _spy_fused(name, False)
    for name in ("pool_bnact_fwd_kernel", "pool_bnact_fwd_plain"):
        _spy_fused(name, True)
    materialize, head = fused.materialize, fused.head_bnact
    apply_norm, ceil_maxpool = unet_mod.apply_norm, unet_mod.ceil_maxpool

    def spy_materialize(acts, act):
        if _RECORD is not None and acts.inv is not None:
            _RECORD.append(("pro", _pre(acts.raw, acts.inv, acts.shift),
                            None))
        return materialize(acts, act)

    def spy_head(acts, *a, **k):
        if _RECORD is not None and acts.inv is not None:
            _RECORD.append(("pro", _pre(acts.raw, acts.inv, acts.shift),
                            None))
        return head(acts, *a, **k)

    def spy_norm(norm, x, reference=False):
        y = apply_norm(norm, x, reference)
        if _RECORD is not None:
            _RECORD.append(("pro", y.float(), None))
        return y

    def spy_pool(x, window):
        if _RECORD is not None:
            _RECORD.append(("libpool", x.float(), tuple(window)))
        return ceil_maxpool(x, window)
    fused.materialize, fused.head_bnact = spy_materialize, spy_head
    unet_mod.apply_norm, unet_mod.ceil_maxpool = spy_norm, spy_pool


def capture(m, x, reference):
    """The training forward's decision inputs (running statistics left
    as they were)."""
    global _RECORD
    state = {k: v.clone() for k, v in m.state_dict().items()}
    _RECORD = []
    with torch.no_grad():
        m.train()(x, reference=reference)
    rec, _RECORD = _RECORD, None
    m.load_state_dict(state)
    return rec


def _pool_argmax(p, window, relu):
    a = (torch.relu(p) if relu else p).movedim(-1, 1)
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(a, window, window, ceil_mode=True, return_indices=True)


def flips(ra, rb):
    """Per decision point, the decisions that differ between captures
    ``ra`` and ``rb``: (kind, shape, count, largest |pre| of ``rb`` among
    the flipped relus, largest |pre| difference)."""
    out = []
    for (ka, pa, wa), (kb, pb, wb) in zip(ra, rb):
        if ka != kb or pa.shape != pb.shape:
            raise AssertionError("the two forwards took other paths")
        if ka == "pro":
            fl = (pa > 0) != (pb > 0)
            n = int(fl.sum())
            out.append(("relu", tuple(pa.shape), n,
                        float(pb.abs()[fl].max()) if n else 0.0,
                        float((pa - pb).abs().max())))
        else:
            va, ia = _pool_argmax(pa, wa, ka == "pool")
            vb, ib = _pool_argmax(pb, wb, ka == "pool")
            out.append(("pool", tuple(pa.shape),
                        int(((ia != ib) & (vb > 0)).sum()), 0.0,
                        float((pa - pb).abs().max())))
    return out


def input_grad(m, x, t, reference):
    x = x.detach().clone().requires_grad_(True)
    m.zero_grad(set_to_none=True)
    CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t).backward()
    return x.grad.detach().clone()


def param_grads(m, x, t, reference):
    m.zero_grad(set_to_none=True)
    CEDiceLoss(1.0, 1.0)(m.train()(x, reference=reference), t).backward()
    return {n: p.grad.float().clone() for n, p in m.named_parameters()}


def leaf_check(m, x, t, rel, ulp, noise):
    """The card test's comparison of every parameter gradient leaf
    (``_check_step_against_reference``): |g - r| <= rel |r| + 3 |r' - r|
    in the L2 norm, r' the reference on the input moved by ``ulp``
    (relative, seeded ``noise``); the exactly-0 biases left out. The
    worst err / bound, its leaf and the leaves over their bound."""
    g = param_grads(m, x, t, False)
    r = param_grads(m, x, t, True)
    mv = param_grads(m, x * (1 + ulp * noise), t, True)
    worst, over = (0.0, ""), []
    for n, gv in g.items():
        if n.endswith(".bias") and "norm" not in n \
                and n != "conv_final.bias":
            continue
        err = float((gv - r[n]).norm())
        bnd = rel * float(r[n].norm()) + 3 * float((mv[n] - r[n]).norm())
        worst = max(worst, (err / bnd, n))
        if err > bnd:
            over.append((n, err, bnd))
    return worst, over


def run(dtype, i, dev, steps=10):
    """One run: the test's model and input, ``steps`` Adam steps through
    the kernels, then the comparison and the decisions."""
    x = torch.randn(2, 8, 24, 40, 1,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    t = (x[..., 0] > 0).long()
    bf16 = dtype == torch.bfloat16
    rel, ulp = (1e-2, 2.0 ** -8) if bf16 else (1e-3, 2.0 ** -23)
    m = UNet(n_blocks=4, start_filts=32, planar_blocks=(0,), dtype=dtype,
             input_grad=True, device=dev,
             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        CEDiceLoss(1.0, 1.0)(m.train()(x), t).backward()
        opt.step()
    noise = torch.randn(x.shape,
                        generator=torch.Generator().manual_seed(11)).to(dev)
    gx = input_grad(m, x, t, False)
    rx = input_grad(m, x, t, True)
    rn = float(rx.norm())
    err = float((gx - rx).norm())
    rk, rr = capture(m, x, False), capture(m, x, True)
    fk = flips(rk, rr)
    noises = {}
    for k in AMPLITUDES:
        xa = x * (1 + k * ulp * noise)
        n = float((input_grad(m, xa, t, True) - rx).norm())
        noises[k] = (n, sum(f[2] for f in flips(capture(m, xa, True), rr)),
                     rel * rn + 3 * n)
    limit = noises[1][2]
    leaves = {}
    if steps == 0:
        # The test's first comparison, of the parameter gradients, with
        # the noise of a one-ulp and of a 64-ulp input change.
        for k in (1, 64):
            (q, n), over = leaf_check(m, x, t, rel, k * ulp, noise)
            leaves[k] = dict(worst_ratio=q, worst_leaf=n, over=over)
    return dict(leaves_by_ulps=leaves, dtype=str(dtype)[6:], run=i,
                adam_steps=steps, err=err, limit=limit,
                ref_norm=rn, passed=err <= limit, zero_dx_fails=rn > limit,
                flips_kernel=sum(f[2] for f in fk),
                flips_kernel_by_point=[f for f in fk if f[2]],
                max_pre_diff_kernel=max(f[4] for f in fk),
                noise_by_ulps={k: dict(noise=v[0], flips=v[1], limit=v[2],
                                       passed=err <= v[2],
                                       zero_dx_fails=rn > v[2])
                               for k, v in noises.items()})


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    cpu = "--cpu" in sys.argv[1:]
    if not cpu and not torch.cuda.is_available():
        sys.exit("input_grad_flips: no CUDA device (--cpu rehearses)")
    if not cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu" if cpu else "cuda")
    n32 = int(args[0]) if args else 20
    n16 = int(args[1]) if len(args) > 1 else 0
    _install_spies()
    runs = [(torch.float32, i) for i in range(n32)] + \
        [(torch.bfloat16, i) for i in range(n16)]
    steps = 0 if "--init" in sys.argv[1:] else 10
    for dtype, i in runs:
        print(json.dumps(run(dtype, i, dev, steps)), flush=True)


if __name__ == "__main__":
    main()
