"""The port's warp on the card (elektronn3_tpu_torch.data.warp) and its
``DeviceWarpPatchLoader`` against the JAX package's ``ops/warp.py`` and
``data/device_pipeline.py``, run here on the CPU.

- ``warp_interpolate_batch`` and ``warp_interpolate``: the same windows,
  matrices (affine and perspective) and origins through both; within
  1e-5 of max|ref|, labels equal.
- The elastic and photometric applies given JAX's own draws (the
  ``jax.random`` draws that JAX's functions make, made here from the
  same keys): within 1e-5 of max|ref| (1e-4 for the elastic field,
  smoothed by a convolution in each framework).
- ``DeviceWarpPatchLoader`` against JAX's under the same seed with
  ``perspective=False``: the same host draws (matrices, window origins,
  windows, ``n_failed``), the inputs within 1e-5 of max|ref|, the labels
  equal, uint8 labels and several channels too.
- JAX's loader takes its window from the patch corners before the
  homogeneous divide; the port's, after it: on perspective samples the
  divided corners lie inside the window that was read, and no sampled
  voxel lies outside it (the warp would clamp it to the edge).
- ``prefetch_to_device`` on the CPU: dtypes, order, pass-through.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.data import device_pipeline as jdp
from elektronn3_tpu.data import sources as jsources
from elektronn3_tpu.ops import warp as jwarp
from elektronn3_tpu_torch.data import coord_transforms as pct
from elektronn3_tpu_torch.data import device_pipeline as pdp
from elektronn3_tpu_torch.data import pipeline as ppipeline
from elektronn3_tpu_torch.data import sources as psources
from elektronn3_tpu_torch.data import warp as pwarp

TOL = 1e-5
PATCH = (6, 20, 24)
WINDOW = (14, 34, 40)
SRC = (36, 96, 100)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _matrices(n, perspective, seed=0):
    """(M_invs, los) of in-window warps of PATCH from WINDOW-sized
    windows."""
    rng = np.random.default_rng(seed)
    ms, los = [], []
    while len(ms) < n:
        M = pct.get_warped_coord_transform(
            SRC, PATCH, warp_amount=1.0, perspective=perspective, rng=rng)
        M_inv = np.linalg.inv(M.astype(np.float64)).astype(np.float32)
        c = (M_inv @ pct.make_dest_corners(PATCH).T).T
        c = c[:, :3] / c[:, 3:4]
        lo = np.floor(c.min(0)) - 1
        if np.all(np.ceil(c.max(0)) + 2 - lo <= WINDOW):
            ms.append(M_inv)
            los.append(lo.astype(np.float32))
    return np.stack(ms), np.stack(los)


@pytest.mark.parametrize("perspective", [False, True])
def test_warp_interpolate_batch_matches_jax(perspective):
    rng = np.random.default_rng(1)
    windows = rng.normal(size=(3,) + WINDOW).astype(np.float32) * 5 + 2
    labels = rng.integers(0, 4, size=(3,) + WINDOW).astype(np.uint8)
    M_invs, los = _matrices(3, perspective)
    for discrete, w in ((False, windows), (True, labels)):
        ref = np.asarray(jwarp.warp_interpolate_batch(
            jnp.asarray(w.astype(np.float32)), jnp.asarray(M_invs),
            jnp.asarray(los), PATCH, discrete=discrete))
        got = pwarp.warp_interpolate_batch(
            torch.from_numpy(w), torch.from_numpy(M_invs),
            torch.from_numpy(los), PATCH, discrete=discrete)
        assert got.shape == (3,) + PATCH and got.dtype == torch.float32
        if discrete:
            assert np.array_equal(got.numpy(), ref)
        else:
            assert _rel_err(got, ref) <= TOL
    one = pwarp.warp_interpolate(torch.from_numpy(windows[1]),
                                 torch.from_numpy(M_invs[1]),
                                 torch.from_numpy(los[1]), PATCH)
    ref = np.asarray(jwarp.warp_interpolate(
        jnp.asarray(windows[1]), jnp.asarray(M_invs[1]), jnp.asarray(los[1]),
        PATCH))
    assert _rel_err(one, ref) <= TOL


def test_out_of_window_counts_clamped_voxels():
    M_invs, los = _matrices(2, True)
    assert pwarp.out_of_window(torch.from_numpy(M_invs),
                               torch.from_numpy(los), PATCH, WINDOW) == 0
    shifted = torch.from_numpy(los) + torch.tensor([0.0, 5.0, 0.0])
    assert pwarp.out_of_window(torch.from_numpy(M_invs), shifted, PATCH,
                               WINDOW) > 0


def _jax_uniform_noise(key, shape):
    keys = jax.random.split(key, 3)
    return np.stack([np.asarray(jax.random.uniform(
        keys[i], shape, jnp.float32, -1.0, 1.0)) for i in range(3)])


def test_elastic_matches_jax_given_its_draws():
    key = jax.random.PRNGKey(3)
    for sigma, alpha, aniso in ((2.0, 10.0, 2.0), (1.0, 4.0, 1.0)):
        ref = np.asarray(jwarp.elastic_displacement(key, PATCH, sigma, alpha,
                                                    aniso))
        noise = torch.from_numpy(_jax_uniform_noise(key, PATCH))
        got = pwarp.elastic_displacement_apply(noise, sigma, alpha, aniso)
        assert got.shape == PATCH + (3,)
        assert _rel_err(got, ref) <= 1e-4
    rng = np.random.default_rng(4)
    window = rng.normal(size=WINDOW).astype(np.float32)
    M_invs, los = _matrices(1, False, seed=5)
    disp = np.array(ref)
    for discrete in (False, True):
        r = np.asarray(jwarp.warp_interpolate_elastic(
            jnp.asarray(window), jnp.asarray(M_invs[0]), jnp.asarray(los[0]),
            jnp.asarray(disp), PATCH, discrete=discrete))
        g = pwarp.warp_interpolate_elastic(
            torch.from_numpy(window), torch.from_numpy(M_invs[0]),
            torch.from_numpy(los[0]), torch.from_numpy(disp), PATCH,
            discrete=discrete)
        if discrete:
            assert np.array_equal(g.numpy(), r)
        else:
            assert _rel_err(g, r) <= TOL
    gen = torch.Generator().manual_seed(0)
    field = pwarp.elastic_displacement(gen, PATCH, 2.0, 10.0, 2.0)
    assert field.shape == PATCH + (3,) and torch.isfinite(field).all()


def _batch():
    return np.random.default_rng(6).normal(
        size=(4,) + PATCH + (2,)).astype(np.float32)


def test_brightness_contrast_matches_jax_given_its_draws():
    x, key = _batch(), jax.random.PRNGKey(7)
    for prob in (1.0, 0.5):
        ref = np.asarray(jwarp.random_brightness_contrast(
            jnp.asarray(x), key, 0.4, 0.3, prob))
        kb, kc, kp = jax.random.split(key, 3)
        shape = (4, 1, 1, 1, 1)
        a = 1 + np.asarray(jax.random.normal(kc, shape)) * 0.3
        b = np.asarray(jax.random.normal(kb, shape)) * 0.4
        apply = np.asarray(jax.random.bernoulli(kp, prob, shape))
        got = pwarp.brightness_contrast_apply(
            torch.from_numpy(x), torch.from_numpy(a.ravel()),
            torch.from_numpy(b.ravel()), torch.from_numpy(apply.ravel()))
        assert _rel_err(got, ref) <= TOL


def test_noise_and_gamma_match_jax_given_their_draws():
    x, key = _batch(), jax.random.PRNGKey(8)
    shape = (4, 1, 1, 1, 1)
    for prob in (1.0, 0.5):
        ref = np.asarray(jwarp.additive_gaussian_noise(jnp.asarray(x), key,
                                                       0.2, prob))
        kn, kp = jax.random.split(key)
        noise = np.asarray(jax.random.normal(kn, x.shape, jnp.float32)) * 0.2
        apply = np.asarray(jax.random.bernoulli(kp, prob, shape)).ravel()
        got = pwarp.gaussian_noise_apply(torch.from_numpy(x),
                                         torch.from_numpy(noise),
                                         torch.from_numpy(apply))
        assert _rel_err(got, ref) <= TOL

        ref = np.asarray(jwarp.random_gamma(jnp.asarray(x), key, 0.3, prob))
        kg, kp = jax.random.split(key)
        gamma = np.exp(np.asarray(jax.random.normal(kg, shape)) * 0.3)
        apply = np.asarray(jax.random.bernoulli(kp, prob, shape)).ravel()
        got = pwarp.gamma_apply(torch.from_numpy(x),
                                torch.from_numpy(gamma.ravel()),
                                torch.from_numpy(apply))
        assert _rel_err(got, ref) <= TOL
    ref = np.asarray(jwarp.normalize(jnp.asarray(x), [1.0, 2.0], [3.0, 4.0]))
    got = pwarp.normalize(torch.from_numpy(x), [1.0, 2.0], [3.0, 4.0])
    assert _rel_err(got, ref) <= TOL


def test_photometric_draws_are_seeded_and_prob_zero_is_identity():
    x = torch.from_numpy(_batch())
    for fn in (pwarp.random_brightness_contrast, pwarp.additive_gaussian_noise,
               pwarp.random_gamma):
        a = fn(x, torch.Generator().manual_seed(1))
        b = fn(x, torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, x)
        assert torch.equal(fn(x, torch.Generator().manual_seed(1),
                              prob=0.0), x)


def _sources(mod, raw, lab):
    return [mod.ArrayDataSource(r) for r in raw], \
        None if lab is None else [mod.ArrayDataSource(t) for t in lab]


def _cubes(channels=1, label_max=2):
    rng = np.random.default_rng(9)
    shape = SRC if channels == 1 else (channels,) + SRC
    raw = [(150 + 40 * rng.normal(size=shape)).astype(np.float32)
           for _ in range(2)]
    lab = [rng.integers(0, label_max, size=SRC).astype(np.int16)
           for _ in range(2)]
    return raw, lab


LOADER_KW = dict(patch_shape=PATCH, batch_size=3, epoch_size=2,
                 window_shape=WINDOW, warp_prob=0.7, aniso_factor=2,
                 warp_kwargs=dict(sample_aniso=True, warp_amount=1.0),
                 normalize=(155.291411, 41.812504), cube_prios=[2, 1], seed=4)


@pytest.mark.parametrize("channels,label_max", [(1, 2), (1, 300), (2, 3)])
def test_device_loader_matches_jax(channels, label_max):
    raw, lab = _cubes(channels, label_max)
    jl = jdp.DeviceWarpPatchLoader(*_sources(jsources, raw, lab), **LOADER_KW)
    pl = pdp.DeviceWarpPatchLoader(*_sources(psources, raw, lab),
                                   device="cpu", **LOADER_KW)
    assert pl._targets_u8 == jl._targets_u8 == (label_max <= 256)
    # the host draws, one sample at a time
    for _ in range(4):
        jw, jt, jm, jlo = jl._sample_one()
        pw, pt, pm, plo = pl._sample_one()
        assert np.array_equal(pm, jm) and np.array_equal(plo, jlo)
        assert pw.dtype == jw.dtype and np.array_equal(pw, jw)
        assert pt.dtype == jt.dtype and np.array_equal(pt, jt)
    assert (pl.n_failed, pl.n_ok) == (jl.n_failed, jl.n_ok)
    # whole batches
    for ref, got in zip(jl, pl):
        assert got["inp"].shape == (3,) + PATCH + (channels,)
        assert got["inp"].dtype == torch.float32
        assert got["target"].dtype == torch.int64
        assert got["target"].shape == (3,) + PATCH
        assert _rel_err(got["inp"], ref["inp"]) <= TOL
        assert np.array_equal(got["target"].numpy(), np.asarray(ref["target"]))
    assert (pl.n_failed, pl.n_ok) == (jl.n_failed, jl.n_ok)


def test_device_loader_without_targets_and_with_augment():
    raw, _ = _cubes()
    calls = []

    def augment(x, generator):
        calls.append(generator)
        return pwarp.additive_gaussian_noise(x, generator, 0.1)

    pl = pdp.DeviceWarpPatchLoader(*_sources(psources, raw, None),
                                   device="cpu", augment_fn=augment,
                                   **LOADER_KW)
    batches = list(pl)
    assert len(batches) == 2 and "target" not in batches[0]
    assert calls[0] is pl.generator


def test_perspective_window_holds_every_sampled_voxel():
    """JAX's fault 2 is not copied: with perspective warps, the divided
    corners of each sample lie inside the window that was read, and the
    warp samples no voxel outside it."""
    raw, lab = _cubes()
    kw = dict(LOADER_KW, warp_prob=1.0, window_shape=(16, 44, 48),
              warp_kwargs=dict(sample_aniso=True, warp_amount=1.0,
                               perspective=True))
    pl = pdp.DeviceWarpPatchLoader(*_sources(psources, raw, lab),
                                   device="cpu", **kw)
    corners = pct.make_dest_corners(PATCH)
    n_persp = 0
    for _ in range(12):
        _, _, M_inv, lo = pl._sample_one()
        n_persp += bool(np.any(M_inv[3, :3] != 0))
        c = (M_inv.astype(np.float64) @ corners.T).T
        c = c[:, :3] / c[:, 3:4]
        assert np.all(c >= lo) and np.all(c + 1 < lo + kw["window_shape"])
        assert pwarp.out_of_window(
            torch.from_numpy(M_inv[None]), torch.from_numpy(lo[None]),
            PATCH, kw["window_shape"]) == 0
    assert n_persp == 12


def test_prefetch_to_device_on_the_cpu():
    batches = [{"inp": np.full((2, 3, 1), i, np.float32),
                "target": np.full((2, 3), i, np.int64),
                "mask": np.ones(2, bool), "fname": [f"a{i}", f"b{i}"]}
               for i in range(5)]
    out = list(ppipeline.prefetch_to_device(iter(batches), size=2,
                                            device="cpu",
                                            inp_dtype=torch.bfloat16))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["inp"].dtype == torch.bfloat16 and float(b["inp"][0, 0]) == i
        assert b["target"].dtype == torch.int64 and int(b["target"][1, 2]) == i
        assert b["mask"].dtype == torch.bool
        assert b["fname"] == [f"a{i}", f"b{i}"]
