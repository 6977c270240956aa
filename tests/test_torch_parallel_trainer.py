"""``Trainer(mesh=..., shard_strategy=...)`` of the port on 2 gloo CPU
ranks against the same Trainer in one process on the global batch, and
the port's multi-rank dry run.

``tests/_torch_parallel_ranks.py``'s ``run_trainer``: a batch-norm UNet
trained 3 SGD steps (batch 4 of 8 samples: two epochs), validated after
each on 5 samples (the last batch of 1, padded to the ranks), with the
streaming ``DSC`` and the non-streaming ``AUROC``, TensorBoard with
gradient histograms every epoch and a preview every epoch, then
``bn_update`` over the mesh. On 2 ranks (``parallel.launch``, a
``file://`` store in ``tmp_path``, a hard timeout), with rank 0's
histogram writer raising at every call, it finishes; every
file comes from rank 0 (rank 1 writes nothing) and rank 0 writes the
files of the one-process run; both ranks end with the same parameters
and running statistics, bit for bit, which are the one-process run's
(1e-4 of each tensor's max plus 1e-6: three steps of sums in another
order), and with its losses and validation metrics (1e-5 relative).
"""

import os

import pytest
import torch

from elektronn3_tpu_torch.models import UNet
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.parallel import dryrun_multichip, launch, make_mesh
from elektronn3_tpu_torch.training import Trainer
from _torch_parallel_ranks import run_trainer

HERE = os.path.dirname(os.path.abspath(__file__))
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=8,
          planar_blocks=(0,), normalization="batch")
TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    state = UNet(device="cpu", **KW).state_dict()
    d = tmp_path_factory.mktemp("trainer")
    torch.save(dict(kw=KW, state=state, strategy="shard_map"),
               d / "spec.pt")
    launch("_torch_parallel_ranks:trainer", 2, [str(d / "spec.pt")],
           timeout=240, workdir=str(d), pythonpath=[HERE],
           device="cpu")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    root = str(tmp_path_factory.mktemp("one"))
    one = run_trainer(KW, state, root)
    files = sorted(os.path.relpath(os.path.join(p, f), root)
                   for p, _, fs in os.walk(root) for f in fs)
    return dict(ranks=ranks, one=one, files=files)


def test_files_come_from_rank_0(runs):
    r0, r1 = runs["ranks"]
    assert r1["files"] == []
    assert [f for f in r0["files"] if "events" not in f] == \
        [f for f in runs["files"] if "events" not in f]
    assert any("events" in f for f in r0["files"])
    assert "run/model_final.pt" in r0["files"]


def test_rank0_histogram_failure_keeps_the_ranks_in_step(runs):
    """Rank 0's writer raised at each epoch's histograms (rank 0 logs it
    and goes on); the gradient pass behind them ran on both ranks before
    that, so the collectives stayed paired: the run finished on both,
    at the one-process run's parameters (the test below)."""
    r0, r1 = runs["ranks"]
    assert r0["hist_failed"] and r1["hist_failed"] == []
    assert all(t.startswith("param/") for t in r0["hist_failed"])
    assert r0["step"] == r1["step"] == 3


def test_ranks_end_equal_to_each_other_and_to_one_process(runs):
    r0, r1 = runs["ranks"]
    one = runs["one"]
    assert r0["step"] == r1["step"] == one.step == 3
    for k, ref in (("params", dict(one.model.named_parameters())),
                   ("buffers", dict(one.model.named_buffers()))):
        for name, t in ref.items():
            assert torch.equal(r0[k][name], r1[k][name]), (k, name)
            t = t.detach()
            if not t.is_floating_point():
                assert torch.equal(r0[k][name], t), name
                continue
            err = float((r0[k][name] - t).abs().max())
            assert err <= TOL * float(t.abs().max()) + 1e-6, (k, name, err)


@pytest.mark.parametrize("stat", ["tr_loss_mean", "val_loss", "val_DSC",
                                  "val_AUROC"])
def test_stats_equal_one_process(runs, stat):
    want = runs["one"].last_stats[stat]
    for r in runs["ranks"]:
        assert abs(r["stats"][stat] - want) <= 1e-5 * abs(want), \
            (r["stats"][stat], want)


def test_shard_strategy(tmp_path):
    """'auto', 'gspmd' and 'shard_map' are taken (one implementation);
    anything else raises JAX's ValueError, and a batch the ranks do not
    divide raises too (a mesh of one rank here)."""
    for i, strategy in enumerate(("auto", "gspmd", "shard_map")):
        Trainer(UNet(device="cpu", **KW), ploss.CEDiceLoss(),
                save_root=str(tmp_path), exp_name=f"s{i}", mesh=make_mesh(),
                shard_strategy=strategy, enable_tensorboard=False)
    with pytest.raises(ValueError, match="shard_strategy must be"):
        Trainer(UNet(device="cpu", **KW), ploss.CEDiceLoss(),
                save_root=str(tmp_path), exp_name="bad", mesh=make_mesh(),
                shard_strategy="fsdp", enable_tensorboard=False)


def test_dryrun_multichip_2():
    dryrun_multichip(2, timeout=240)
