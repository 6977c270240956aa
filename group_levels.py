"""Where the bf16 forward of the headline UNet departs from
``reference=True``, level by level, under 'batch', 'group' and
'instance' norm.

    python3 group_levels.py [--cpu]

For each norm one seeded model (random affine parameters of both signs)
runs one eval forward on the kernels on a (2, 64, 128, 128) input of two
samples of different scales; each level's inputs and output are
recorded, and the level then runs again on the same inputs through the
plain versions (``reference=True``). Per level, one JSON line: the
largest |kernel - plain| of its output over the largest |plain| (the
raw conv output and, for a kernel level, the prologued output its
consumer sees), i.e. what that level adds on its own; then the whole
forward's output against the whole ``reference=True`` forward, in the
same measure. ``--cpu`` runs both sides on their plain versions (a
rehearsal: zeros).
"""
import json
import sys

import torch

from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.ops import fused
from elektronn3_tpu_torch.ops.fused import FusedActs

NORMS = ("batch", "group", "instance")
SHAPE = (2, 64, 128, 128, 1)


def _model(norm, dev):
    m = UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
             planar_blocks=(0,), normalization=norm, dtype=torch.bfloat16,
             device=dev, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if ".norm" in name:
                p.copy_((torch.randn(p.shape, generator=g)
                         if name.endswith("weight")
                         else 0.1 * torch.randn(p.shape, generator=g)))
        for name, b in m.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
            elif name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=g))
    return m.eval()


def _views(out, act):
    """The tensors of a level's output to compare, by name."""
    if isinstance(out, tuple) and not isinstance(out, FusedActs):
        res = {}
        for i, o in enumerate(out):
            res.update({f"{i}.{k}": v for k, v in _views(o, act).items()})
        return res
    if isinstance(out, FusedActs):
        return {"raw": out.raw,
                "prologued": fused.materialize(out, act)}
    return {"out": out}


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def run(norm, dev):
    m = _model(norm, dev)
    act = "relu"
    levels = [("down", i, d) for i, d in enumerate(m.down_convs)] + \
        [("up", i, u) for i, u in enumerate(m.up_convs)]
    calls = []
    for kind, i, mod in levels:
        real = mod.forward
        # the position of the ``reference`` argument
        pos = 2 if kind == "down" else 3

        def spy(*a, _real=real, _kind=kind, _i=i, _pos=pos):
            out = _real(*a)
            calls.append((_kind, _i, _real, a, _pos, out))
            return out
        mod.forward = spy
    g = torch.Generator().manual_seed(2)
    x = torch.randn(SHAPE, generator=g)
    x[1] *= 3.0
    x = x.to(dev)
    with torch.no_grad():
        y = m(x)
        kinds = m.level_kinds(x.shape)
        for kind, i, real, a, pos, out in calls:
            a = list(a)
            a[pos] = True
            ref = real(*a)
            line = dict(norm=norm, level=f"{kind}_{i}",
                        kind=kinds[i if kind == "down"
                                   else m.n_blocks - 2 - i])
            for k, v in _views(out, act).items():
                line[k] = _rel(v, _views(ref, act)[k])
            print(json.dumps(line), flush=True)
        for _, _, mod in levels:
            del mod.forward
        ref = m(x, reference=True)
    print(json.dumps(dict(norm=norm, level="model", out=_rel(y, ref))),
          flush=True)


def main():
    cpu = "--cpu" in sys.argv[1:]
    if not cpu and not torch.cuda.is_available():
        sys.exit("group_levels: no CUDA device (--cpu rehearses)")
    if not cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu" if cpu else "cuda")
    global SHAPE
    if cpu:
        SHAPE = (2, 4, 12, 16, 1)
    for norm in NORMS:
        run(norm, dev)


if __name__ == "__main__":
    main()
