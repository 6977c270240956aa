"""The port's Predictor/tiled_apply (elektronn3_tpu_torch.inference)
against the JAX package's, on the same seeded volume and the same
parameters (converted with state_dict_from_flax). The JAX side runs the
XLA executor (pallas_flat=False); the port runs its kernel levels' plain
versions on the CPU. float32 probabilities agree to 1e-4."""

import jax
import numpy as np
import pytest
import torch

from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models.unet import UNet as JaxUNet, init_unet
from elektronn3_tpu_torch.inference import Predictor, tiled_apply
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax

KW = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
          planar_blocks=(0,), normalization="batch")
VOLUME = (1, 1, 8, 32, 32)
TILED = dict(tile_shape=(4, 16, 16), overlap_shape=(2, 8, 8), batch_size=3)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    jm = JaxUNet(pallas_flat=False, **KW)
    v = jax.device_get(init_unet(jm, (1, 8, 32, 32, 1)))
    v = jax.tree_util.tree_map(np.asarray, v)
    for lvl in v["batch_stats"].values():
        for bn in lvl.values():
            bn["mean"] = (0.2 * rng.normal(size=bn["mean"].shape)) \
                .astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, size=bn["var"].shape) \
                .astype(np.float32)
    pm = UNet(device="cpu", **KW)
    pm.load_state_dict(state_dict_from_flax(v, pm))
    vol = rng.normal(size=VOLUME).astype(np.float32)
    return jm, v, pm, vol


@pytest.mark.parametrize("mode", ["whole", "tiled"])
def test_predictor_probabilities_match_jax(models, mode):
    jm, v, pm, vol = models
    kw = TILED if mode == "tiled" else {}
    ref = JaxPredictor(jm, v, **kw).predict(vol)
    out = Predictor(pm, **kw).predict(vol)
    assert out.shape == ref.shape == (1, 2) + VOLUME[2:]
    assert out.dtype == np.float32
    assert np.max(np.abs(out - np.asarray(ref, np.float32))) <= 1e-4


@pytest.mark.parametrize("thr", [True, 0.4])
def test_predictor_argmax_matches_jax(models, thr):
    jm, v, pm, vol = models
    ref = JaxPredictor(jm, v, argmax_with_threshold=thr,
                       **TILED).predict(vol)
    out = Predictor(pm, argmax_with_threshold=thr, **TILED).predict(vol)
    assert out.dtype == np.uint8 and out.shape == ref.shape == \
        (1, 1) + VOLUME[2:]
    # A class flips only where the decision margin is at rounding level.
    probs = Predictor(pm, **TILED).predict(vol)
    cut = 0.5 if thr is True else thr
    ambiguous = np.abs(probs[:, 1:2] - cut) < 1e-5
    assert np.all((out == ref) | ambiguous)


def test_predictor_bf16_probabilities(models):
    _, _, pm, vol = models
    m16 = UNet(dtype=torch.bfloat16, device="cpu", **KW)
    m16.load_state_dict(pm.state_dict())
    out = Predictor(m16, float16=True, **TILED).predict(vol)
    assert out.dtype == np.float32 and out.shape == (1, 2) + VOLUME[2:]
    assert np.all(np.isfinite(out))
    assert np.max(np.abs(out.sum(1) - 1.0)) <= 1e-2


def test_predictor_pads_indivisible_volume(models):
    _, _, pm, vol = models
    part = vol[..., :6, :28, :30]
    out = Predictor(pm, **TILED).predict(part)
    assert out.shape == (1, 2, 6, 28, 30)
    with pytest.raises(ValueError):
        Predictor(pm, strict_shapes=True, **TILED).predict(part)


def _identity(x):
    return x


@pytest.mark.parametrize("shape,tile,overlap", [
    ((1, 1, 16, 16), (8, 8), (2, 2)),
    ((1, 2, 8, 16, 16), (4, 8, 8), (2, 4, 4))])
def test_tiled_apply_identity(shape, tile, overlap):
    inp = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    out = tiled_apply(_identity, inp, tile_shape=tile, overlap_shape=overlap,
                      offset=None, out_shape=shape)
    assert np.array_equal(out, inp)


def test_tiled_apply_offset():
    """A valid-conv model that shrinks by 2 per side."""
    inp = np.random.default_rng(1).normal(size=(1, 1, 20, 20)) \
        .astype(np.float32)
    out = tiled_apply(lambda x: x[:, :, 2:-2, 2:-2], inp, tile_shape=(8, 8),
                      overlap_shape=(2, 2), offset=(2, 2),
                      out_shape=(1, 1, 16, 16))
    assert np.array_equal(out, inp[:, :, 2:-2, 2:-2])


def test_tiled_apply_bad_tile_shape():
    inp = np.zeros((1, 1, 16, 16), np.float32)
    with pytest.raises(ValueError):
        tiled_apply(_identity, inp, tile_shape=(7, 7), overlap_shape=(2, 2),
                    offset=None, out_shape=(1, 1, 16, 16))
