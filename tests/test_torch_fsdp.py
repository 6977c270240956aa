"""The dry run's fsdp leg (``parallel/dryrun.py``) against JAX's
``_fsdp_spec``, on the CPU without ranks.

- The shard axis: every parameter of the dry run's UNet and of the
  headline UNet goes through the converter into JAX's tree; the port
  splits it (``fsdp_dims``) exactly where JAX's ``_fsdp_spec`` splits
  the converted leaf, over 2 and 4 ranks, and block ``k`` of the port's
  split holds the values of block ``k`` of JAX's (each parameter filled
  with distinct integers, so a block is known by its values whatever
  axis order the converter uses).
- ``fsdp_shard`` hands each rank its block, the blocks of all ranks
  together the whole parameter.
- One process (an axis without a process group): ``fsdp_step`` is
  ``train_step``, bit for bit.

The leg across ranks (the gathered parameters after one Adam step equal
to the dp step's, each leaf and its moments a 1/n share) runs in
tests/test_torch_parallel_trainer.py's ``test_dryrun_multichip_2``.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.parallel.dryrun import _fsdp_spec
from elektronn3_tpu_torch.models import UNet, flax_from_state_dict
from elektronn3_tpu_torch.modules.loss import CEDiceLoss
from elektronn3_tpu_torch.parallel import Axis
from elektronn3_tpu_torch.parallel.dryrun import (
    fsdp_dims, fsdp_shard, fsdp_step)
from elektronn3_tpu_torch.training import train_step

MODELS = {
    "dryrun": (dict(n_blocks=2, start_filts=4, planar_blocks=(0,)),
               (2, 4, 16, 16, 1)),
    "headline": (dict(n_blocks=4, start_filts=32, planar_blocks=(0,)),
                 (1, 8, 32, 32, 1)),
}


def _numbered(kw):
    """The port's model with every parameter filled with distinct
    integers, one range a parameter."""
    m = UNet(device="cpu", normalization="batch", **kw)
    start = 0
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.arange(start, start + p.numel(),
                                 dtype=torch.float32).view(p.shape))
            start += p.numel()
    assert start < 2 ** 24   # exact in float32
    return m


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_shard_axis_is_jax_fsdp_spec(name, n):
    kw, shape = MODELS[name]
    m = _numbered(kw)
    tree = jax.eval_shape(lambda: junet.init_unet(
        junet.UNet(normalization="batch", **kw), shape))
    leaves = jax.tree_util.tree_leaves(
        flax_from_state_dict(m.state_dict(), tree)["params"])
    by_first = {int(np.min(v)): np.asarray(v) for v in leaves}
    dims = fsdp_dims(m, n)
    params = dict(m.named_parameters())
    assert len(by_first) == len(params) == len(dims)
    split = 0
    for pname, p in params.items():
        leaf = by_first[int(p.min())]
        spec = tuple(_fsdp_spec(leaf, n))
        jax_split = bool(spec) and spec[-1] == "data"
        assert jax_split == (dims[pname] is not None), pname
        if not jax_split:
            continue
        split += 1
        jax_blocks = np.split(leaf, n, axis=-1)
        port_blocks = p.detach().chunk(n, dims[pname])
        for jb, pb in zip(jax_blocks, port_blocks):
            assert np.array_equal(np.sort(jb, axis=None),
                                  np.sort(pb.numpy(), axis=None)), pname
    assert split > 0


@pytest.mark.parametrize("n", [2, 4])
def test_shards_cover_each_parameter(n):
    m = _numbered(MODELS["headline"][0])
    dims = fsdp_dims(m, n)
    ranks = [fsdp_shard(m, dims, Axis("data", n, i, None)) for i in range(n)]
    for name, p in m.named_parameters():
        if dims[name] is None:
            assert all(torch.equal(r[name], p) for r in ranks)
            continue
        blocks = [r[name] for r in ranks]
        assert all(b.numel() == p.numel() // n for b in blocks)
        assert torch.equal(torch.cat(blocks, dims[name]), p)
        if dims[name] == 1:   # a transposed conv's output channels
            assert "upconv" in name


def test_fsdp_step_in_one_process_is_train_step():
    kw, shape = MODELS["dryrun"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, size=shape[:-1]))
    torch.manual_seed(0)
    a = UNet(device="cpu", normalization="batch", **kw)
    b = copy.deepcopy(a)
    axis = Axis("data", 1, 0, None)
    dims = fsdp_dims(b, 1)
    params = fsdp_shard(b, dims, axis)
    la = train_step(a, CEDiceLoss(), torch.optim.Adam(a.parameters(), 1e-3),
                    x, y)
    lb = fsdp_step(b, params, dims, CEDiceLoss(),
                   torch.optim.Adam(params.values(), 1e-3), x, y, axis)
    assert torch.equal(la, lb)
    for name, p in a.named_parameters():
        assert torch.equal(p, params[name]), name
    for (name, r), s in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(r, s), name
