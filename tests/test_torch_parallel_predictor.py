"""``Predictor(mesh=..., shard_mode=..., shard_axis=..., halo=...)`` of
the port on 4 gloo CPU ranks against the JAX Predictor sharded over 4
virtual devices, and against the port's unsharded Predictor: the
counterparts of ``test_predictor_mesh_sharded`` and
``test_predictor_tile_grid_sharded`` of ``tests/test_parallel.py``, on
the same 2D UNet (two levels, four filters, no norm) converted from
JAX's variables.

- 'spatial': the (64, 16) image split along H into four shards with a
  halo of 16. Every rank returns JAX's sharded output (1e-5); it equals
  the port's unsharded tiling with the same zero-extended 48-row
  windows (tiles (16, 16), overlap (16, 0): 1e-4, JAX's bound) and the
  whole-image prediction away from the image's edge by the receptive
  field (1e-3, JAX's bound).
- 'tiles': nine (32, 32) tiles with (8, 8) overlap, a count the 4 ranks
  do not divide (padded with the last tile, dropped after); every rank
  returns JAX's sharded output and the unsharded one (1e-5).
- The three ``ValueError``s of JAX's Predictor: 'spatial' without a
  halo, 'spatial' with flip TTA, and an unknown mode.
"""

import os

import numpy as np
import pytest
import torch

from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models.unet import UNet as JaxUNet, init_unet
from elektronn3_tpu.parallel import make_mesh as jax_mesh
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.parallel import launch, make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=4, dim=2,
          normalization="none")
TILES_KW = dict(tile_shape=(32, 32), overlap_shape=(8, 8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    jmodel = JaxUNet(**KW)
    variables = init_unet(jmodel, (1, 64, 16, 1))
    spatial_inp = rng.normal(size=(1, 1, 64, 16)).astype(np.float32)
    tiles_inp = rng.normal(size=(1, 1, 96, 96)).astype(np.float32)
    state = state_dict_from_flax(variables, UNet(device="cpu", **KW))
    d = tmp_path_factory.mktemp("predictor")
    torch.save(dict(kw=KW, state=state, halo=16, spatial_inp=spatial_inp,
                    tiles_inp=tiles_inp, tiles_kw=TILES_KW), d / "spec.pt")
    launch("_torch_parallel_ranks:predictor", N, [str(d / "spec.pt")],
           timeout=180, workdir=str(d), pythonpath=[HERE],
           device="cpu")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    model = UNet(device="cpu", **KW)
    model.load_state_dict(state)
    return dict(
        ranks=ranks, model=model, spatial_inp=spatial_inp,
        tiles_inp=tiles_inp,
        jax_spatial=JaxPredictor(
            model=jmodel, state=variables, mesh=jax_mesh({"space": N}),
            shard_axis=2, halo=16).predict(spatial_inp),
        jax_tiles=JaxPredictor(
            model=jmodel, state=variables, mesh=jax_mesh({"data": N}),
            shard_mode="tiles", **TILES_KW).predict(tiles_inp))


def test_spatial_sharding_matches_jax_and_the_unsharded_tiling(runs):
    single = Predictor(runs["model"]).predict(runs["spatial_inp"])
    tiled = Predictor(runs["model"], tile_shape=(16, 16),
                      overlap_shape=(16, 0)).predict(runs["spatial_inp"])
    for got in runs["ranks"]:
        sharded = got["spatial"]
        assert sharded.shape == single.shape == runs["jax_spatial"].shape
        np.testing.assert_allclose(sharded, runs["jax_spatial"], atol=1e-5)
        assert np.allclose(tiled, sharded, atol=1e-4), \
            np.abs(tiled - sharded).max()
        assert np.allclose(single[:, :, 16:-16], sharded[:, :, 16:-16],
                           atol=1e-3)


def test_tile_sharding_matches_jax_and_the_unsharded_request(runs):
    """Nine tiles on four ranks: padded to twelve, three a rank."""
    single = Predictor(runs["model"], **TILES_KW).predict(runs["tiles_inp"])
    for got in runs["ranks"]:
        assert got["tiles"].shape == single.shape
        np.testing.assert_allclose(got["tiles"], runs["jax_tiles"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["tiles"], single, atol=1e-5)


def test_predictor_mesh_value_errors():
    model = UNet(device="cpu", **KW)
    mesh = make_mesh()
    with pytest.raises(ValueError, match="halo is required"):
        Predictor(model, mesh=mesh, shard_mode="spatial")
    with pytest.raises(ValueError, match="flip-TTA"):
        Predictor(model, mesh=mesh, halo=4, augmentations=2)
    with pytest.raises(ValueError, match="shard_mode must be"):
        Predictor(model, mesh=mesh, shard_mode="rows")
    # the same three from JAX's Predictor
    jmodel = JaxUNet(**KW)
    variables = init_unet(jmodel, (1, 32, 32, 1))
    jmesh = jax_mesh({"space": 1})
    for kw, msg in ((dict(shard_mode="spatial"), "halo is required"),
                    (dict(halo=4, augmentations=2), "flip-TTA"),
                    (dict(shard_mode="rows"), "shard_mode must be")):
        with pytest.raises(ValueError, match=msg):
            JaxPredictor(model=jmodel, state=variables, mesh=jmesh, **kw)
