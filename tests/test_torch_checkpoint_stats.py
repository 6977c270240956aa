"""A checkpointed block's recompute normalises with the statistics its
forward computed.

On the card the batch-mode statistics of K1, K3 and the vup entries are
float32 atomic sums, whose order changes from run to run; a recompute
that summed them again would normalise with other numbers than the
forward, and the backward would differentiate another forward. Here, on
the kernels' plain versions, each call's statistics are scaled by a
factor that grows with the call count (a stand-in for the other
summation order), so a recompute that computed its own would see other
statistics than the forward did. With ``checkpointing`` True and
'policy' the step must still give the non-checkpointed step's loss,
gradients and running statistics bit for bit (the forward's statistics
replayed from ``fused.StatsTape``), and without the tape it must not
(the check can fail).
"""

import pytest
import torch

from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules.loss import CEDiceLoss
from elektronn3_tpu_torch.ops import fused, vup

KW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
          planar_blocks=(0,), pallas_flat=True, device="cpu")
SHAPE = (2, 4, 8, 8, 1)
# (module, plain forward returning (..., s, q) last) of every op with
# statistics side outputs.
STAT_OPS = ((fused, "conv_bnact_fwd_plain"), (fused, "upconv_bnact_fwd_plain"),
            (vup, "conv_vup_fwd_plain"), (vup, "upconv_stats_plain"))


def _drifting(monkeypatch):
    """Scale each op call's statistics by 1 + 1e-3 * (call number)."""
    calls = [0]
    for mod, name in STAT_OPS:
        real = getattr(mod, name)

        def f(*a, _real=real, **k):
            out = list(_real(*a, **k))
            calls[0] += 1
            if out[-1] is not None:
                g = 1 + 1e-3 * calls[0]
                out[-2], out[-1] = out[-2] * g, out[-1] * g
            return tuple(out)
        monkeypatch.setattr(mod, name, f)
    return calls


def _step(checkpointing, use_vup, calls):
    calls[0] = 0
    m = UNet(checkpointing=checkpointing, vup=use_vup, **KW).train()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(SHAPE, generator=g)
    loss = CEDiceLoss(1.0, 1.0)(m(x), (x[..., 0] > 0).long())
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in m.named_parameters()},
            {n: b.clone() for n, b in m.named_buffers()}, calls[0])


def _same(a, b):
    return torch.equal(a[0], b[0]) and all(
        torch.equal(a[1][n], b[1][n]) for n in a[1]) and all(
        torch.equal(a[2][n], b[2][n]) for n in a[2])


@pytest.mark.parametrize("use_vup", [False, True])
@pytest.mark.parametrize("checkpointing", [True, "policy"])
def test_recompute_sees_the_forward_statistics(monkeypatch, checkpointing,
                                               use_vup):
    calls = _drifting(monkeypatch)
    plain = _step(False, use_vup, calls)
    ck = _step(checkpointing, use_vup, calls)
    assert ck[3] > plain[3]          # the blocks ran again
    assert _same(ck, plain)


def test_without_the_tape_the_recompute_drifts(monkeypatch):
    calls = _drifting(monkeypatch)
    plain = _step(False, False, calls)
    monkeypatch.setattr(fused, "tape_stats", lambda s, q: None)
    assert not _same(_step(True, False, calls), plain)


def test_the_tape_is_idle_outside_checkpointing(monkeypatch):
    """A step without checkpointing records nothing."""
    kept = []
    monkeypatch.setattr(fused.StatsTape, "__call__",
                        lambda self, s, q: kept.append(s))
    calls = [0]
    _step(False, True, calls)
    assert not kept and not fused._TAPES
