"""The port's host-side data pipeline (elektronn3_tpu_torch.data) against
the JAX package's (elektronn3_tpu.data), on the CPU.

The same numpy inputs go through both:

- the matrix builders and ``get_warped_coord_transform`` under the same
  ``default_rng(s)``: bit for bit;
- ``warp_slice`` on the native (C++) path and on the numpy path, affine
  and perspective, with a smaller, centred target: within 1e-6 of
  max|ref|, labels equal; the port's native gathers against their numpy
  plain versions;
- each transform after the same ``np.random.seed(s)``: bit for bit, and
  the global random state left in the same place;
- ``data/utils.py``; ``PatchCreator`` samples and ``get_preview_batch``;
  the ``DataLoader`` batches, order and per-sample seeds.

JAX's ``PatchCreator`` draws its warp matrix from a fresh, unseeded
generator (its ``warp_cut`` passes no ``rng`` to
``get_warped_coord_transform``), so it never repeats; the port seeds
that generator from numpy's global state. For the comparison, JAX's
module is given the port's generator with ``monkeypatch``. Then the
port's fixes: a seeded ``DataLoader`` over ``PatchCreator`` repeats at
``num_workers`` 0 and 2, and its workers do not repeat each other; the
``Trainer``'s loader does the same. The native build raises when it
cannot build.
"""

import signal

import numpy as np
import pytest
import torch

from elektronn3_tpu.data import cnndata as jcnndata
from elektronn3_tpu.data import coord_transforms as jct
from elektronn3_tpu.data import pipeline as jpipeline
from elektronn3_tpu.data import utils as jutils
from elektronn3_tpu.data.transforms import random as jrandom
from elektronn3_tpu.data.transforms import transforms as jT
from elektronn3_tpu_torch.data import cnndata as pcnndata
from elektronn3_tpu_torch.data import coord_transforms as pct
from elektronn3_tpu_torch.data import native as pnative
from elektronn3_tpu_torch.data import pipeline as ppipeline
from elektronn3_tpu_torch.data import sources as psources
from elektronn3_tpu_torch.data import utils as putils
from elektronn3_tpu_torch.data.transforms import random as prandom
from elektronn3_tpu_torch.data.transforms import transforms as pT
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import Trainer

SRC = (40, 72, 80)                  # a source cube
PATCH = (12, 24, 28)
TPATCH = (8, 16, 20)                # a centred target, offset (2, 4, 4)
WARP_TOL = 1e-6


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(0)
    raw = (150 + 40 * rng.normal(size=SRC)).astype(np.float32)
    lab = (rng.random(SRC) < 0.3).astype(np.int16) \
        + (rng.random(SRC) < 0.2).astype(np.int16)
    return raw, lab


@pytest.fixture(scope="module")
def h5files(cube, tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("h5")
    raw, lab = cube
    paths = []
    for i in range(2):
        r, t = root / f"raw_{i}.h5", root / f"barrier_int16_{i}.h5"
        with h5py.File(r, "w") as f:
            f.create_dataset("raw", data=np.roll(raw, 7 * i, axis=2))
        with h5py.File(t, "w") as f:
            f.create_dataset("lab", data=np.roll(lab, 7 * i, axis=2))
        paths.append(((str(r), "raw"), (str(t), "lab")))
    return paths


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

BUILDERS = [
    ("rotmat", lambda m, r: m.get_random_rotmat(False, 0.7, r)),
    ("rotmat_lock_z", lambda m, r: m.get_random_rotmat(True, 1.0, r)),
    ("flipmat", lambda m, r: m.get_random_flipmat(False, r)),
    ("flipmat_no_x", lambda m, r: m.get_random_flipmat(True, r)),
    ("swapmat", lambda m, r: m.get_random_swapmat(False, r)),
    ("swapmat_lock_z", lambda m, r: m.get_random_swapmat(True, r)),
    ("warpmat", lambda m, r: m.get_random_warpmat(False, False, 1.0, r)),
    ("warpmat_persp", lambda m, r: m.get_random_warpmat(True, True, 0.5, r)),
    ("transform", lambda m, r: m.get_warped_coord_transform(
        SRC, PATCH, rng=r)),
    ("transform_persp_target", lambda m, r: m.get_warped_coord_transform(
        (1,) + SRC, PATCH, aniso_factor=2, warp_amount=0.8, lock_z=False,
        perspective=True, target_src_shape=(SRC[0] - 4,) + SRC[1:],
        target_patch_shape=TPATCH, rng=r)),
    ("transform_no_warp", lambda m, r: m.get_warped_coord_transform(
        SRC, PATCH, warp_amount=0, no_x_flip=True, sample_aniso=False,
        rng=r)),
]


@pytest.mark.parametrize("name,build", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_matrix_builders_match_jax_bitwise(name, build):
    for s in range(5):
        ref = build(jct, np.random.default_rng(s))
        got = build(pct, np.random.default_rng(s))
        assert got.dtype == ref.dtype
        assert np.array_equal(got, ref), name


def test_matrix_helpers_match_jax():
    for a in (0.0, 0.3, -2.0):
        for f in ("rotate_x", "rotate_y", "rotate_z"):
            assert np.array_equal(getattr(pct, f)(a), getattr(jct, f)(a))
    assert np.array_equal(pct.scale_inv(2, 3, 4), jct.scale_inv(2, 3, 4))
    assert np.array_equal(pct.make_dest_coords(PATCH),
                          jct.make_dest_coords(PATCH))
    assert np.array_equal(pct.make_dest_corners(PATCH),
                          jct.make_dest_corners(PATCH))


def test_unseeded_builders_follow_numpys_global_state():
    np.random.seed(3)
    a = pct.get_warped_coord_transform(SRC, PATCH, perspective=True)
    np.random.seed(3)
    b = pct.get_warped_coord_transform(SRC, PATCH, perspective=True)
    c = pct.get_warped_coord_transform(SRC, PATCH, perspective=True)
    assert np.array_equal(a, b) and not np.array_equal(b, c)


# ---------------------------------------------------------------------------
# warp_slice and the native kernels
# ---------------------------------------------------------------------------

def _warp_case(cube, perspective, seed):
    raw, lab = cube
    tsrc_shape = (SRC[0] - 4,) + SRC[1:]
    for s in range(seed, seed + 50):
        M = jct.get_warped_coord_transform(
            SRC, PATCH, warp_amount=1.0, perspective=perspective,
            target_src_shape=tsrc_shape, target_patch_shape=TPATCH,
            rng=np.random.default_rng(s))
        try:
            jct.warp_slice(jct_sources(raw), PATCH, M,
                           jct_sources(lab[2:-2]), TPATCH)
        except jct.WarpingOOBError:
            continue
        return M, raw, lab[2:-2]
    raise AssertionError("no in-bounds warp found")


def jct_sources(a):
    from elektronn3_tpu.data.sources import ArrayDataSource
    return ArrayDataSource(a)


@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_warp_slice_matches_jax(cube, monkeypatch, perspective, path):
    for seed in (0, 100):
        M, raw, lab = _warp_case(cube, perspective, seed)
        if path == "numpy":
            monkeypatch.setattr(jct, "_native_available", lambda: False)
        else:
            assert jct._native_available()
        ref = jct.warp_slice(jct_sources(raw), PATCH, M, jct_sources(lab),
                             TPATCH, input_discrete_ix=[])
        got = pct.warp_slice(psources.ArrayDataSource(raw), PATCH, M,
                             psources.ArrayDataSource(lab), TPATCH,
                             input_discrete_ix=[], debug=path == "numpy")
        monkeypatch.undo()
        assert got[0].shape == (1,) + PATCH and got[1].shape == (1,) + TPATCH
        assert np.max(np.abs(got[0] - ref[0])) <= \
            WARP_TOL * np.max(np.abs(ref[0]))
        assert np.array_equal(got[1], ref[1])


def test_warp_slice_out_of_bounds_raises():
    raw = np.zeros(SRC, np.float32)
    M = pct.translate(-SRC[0], 0, 0)     # the patch starts past the cube
    with pytest.raises(pct.WarpingOOBError):
        pct.warp_slice(psources.ArrayDataSource(raw), PATCH, M)


def test_native_gathers_match_their_plain_versions():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(10, 12, 14)).astype(np.float32)
    lo = np.array([1.5, 2.0, -0.5], np.float32)
    coords = (rng.uniform(0, 1, size=(5, 7, 3)) * [8.9, 10.9, 12.9]
              + lo).astype(np.float32)
    lin = pnative.map_coordinates_linear(src, coords, lo)
    ref = pct.map_coordinates_linear(src, coords, lo)
    assert np.max(np.abs(lin - ref)) <= WARP_TOL * np.max(np.abs(ref))
    # nearest away from .5 ties (lround and rint part there)
    frac = np.abs((coords - lo) % 1 - 0.5)
    keep = np.all(frac > 1e-3, axis=-1)
    near = pnative.map_coordinates_nearest(src, coords, lo)
    assert np.array_equal(near[keep],
                          pct.map_coordinates_nearest(src, coords, lo)[keep])
    M = pct.translate(1.25, 2.5, 3.75)     # patch to source coordinates
    lo0 = np.zeros(3, np.float32)
    out = pnative.warp_interp(src, M, (5, 6, 7), lo0, False, False)
    grid = pct.make_dest_coords((5, 6, 7))
    rel = np.tensordot(grid, M, axes=[[-1], [1]])[..., :3]
    assert np.max(np.abs(out - pct.map_coordinates_linear(src, rel, lo0))) \
        <= WARP_TOL * np.max(np.abs(out))


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))    # no g++ on it
    with pytest.raises(OSError):
        pnative.build()
    monkeypatch.setattr(pnative, "SRC", tmp_path / "missing.cpp")
    with pytest.raises(FileNotFoundError):
        pnative.build()


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def _sampler(mod):
    return mod.HalfNormal(sigma=1.0, rng=np.random.default_rng(4))


def _blur_config():
    return dict(probability=1.0, threshold=0.3,
                lower_lim_region_size=(2, 3, 3),
                upper_lim_region_size=(4, 6, 6))


TRANSFORMS = [
    ("identity", lambda T, r: T.Identity()),
    ("normalize", lambda T, r: T.Normalize(mean=155.291411, std=41.812504)),
    ("brightness_contrast", lambda T, r: T.RandomBrightnessContrast(
        0.4, 0.3, prob=0.8)),
    ("gamma", lambda T, r: T.RandomGammaCorrection(gamma_std=0.25,
                                                   channels=[0], prob=0.9)),
    ("gray", lambda T, r: T.RandomGrayAugment(channels=[0], prob=0.9)),
    ("gaussian_blur", lambda T, r: T.RandomGaussianBlur(
        distsigma=_sampler(r), prob=0.9, aniso_factor=2)),
    ("noise", lambda T, r: T.AdditiveGaussianNoise(sigma=0.1, channels=[0],
                                                   prob=0.9)),
    ("crop", lambda T, r: T.RandomCrop((8, 12, 20))),
    ("elastic", lambda T, r: T.ElasticTransform(sigma=2, alpha=8, prob=1.0,
                                                aniso_factor=2)),
    ("flip", lambda T, r: T.RandomFlip(ndim_spatial=3)),
    ("slicewise", lambda T, r: T.RandomSlicewiseTransform(
        T.AdditiveGaussianNoise(sigma=0.5), prob=0.4)),
    ("remap", lambda T, r: T.RemapTargetIDs([1, 0, 2])),
    ("remap_dict", lambda T, r: T.RemapTargetIDs({0: 2, 2: 0},
                                                 reverse=True)),
    ("onehot", lambda T, r: T.SmoothOneHotTarget(3, smooth_eps=0.1)),
    ("distance", lambda T, r: T.Compose([
        T.Lambda(lambda i, t: (i, (t > 0).astype(np.int64))),
        T.DistanceTransformTarget(scale=10.0)])),
    ("squeeze", lambda T, r: T.Compose([
        T.Lambda(lambda i, t: (i, t[None])), T.SqueezeTarget(dim=0)])),
    ("blurring", lambda T, r: T.RandomBlurring(_blur_config(),
                                               patch_shape=PATCH)),
    ("neurodata", lambda T, r: T.Compose([
        T.Normalize(mean=155.291411, std=41.812504),
        T.RandomGrayAugment(channels=[0], prob=0.3),
        T.RandomGammaCorrection(gamma_std=0.25, channels=[0], prob=0.3),
        T.AdditiveGaussianNoise(sigma=0.1, channels=[0], prob=0.3)])),
]


@pytest.mark.parametrize("name,make", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_jax_bitwise(cube, name, make):
    raw, lab = cube
    inp = raw[None, :PATCH[0], :PATCH[1], :PATCH[2]].copy()
    tgt = lab[:PATCH[0], :PATCH[1], :PATCH[2]].astype(np.int64)
    jt, pt = make(jT, jrandom), make(pT, prandom)
    for s in range(6):
        np.random.seed(s)
        ri, rt = jt(inp.copy(), tgt.copy())
        after_ref = np.random.rand()
        np.random.seed(s)
        gi, gt = pt(inp.copy(), tgt.copy())
        assert np.random.rand() == after_ref, "a different number of draws"
        assert gi.dtype == ri.dtype and np.array_equal(gi, ri), name
        assert gt.dtype == rt.dtype and np.array_equal(gt, rt), name


def test_transform_2d_matches_jax_bitwise(cube):
    raw, lab = cube
    inp = raw[None, 0, :32, :32].copy()
    tgt = lab[0, :32, :32].astype(np.int64)
    for make in (lambda T: T.RandomRotate2d(prob=1.0),
                 lambda T: T.RandomFlip(ndim_spatial=2, prob=0.5),
                 lambda T: T.ElasticTransform(sigma=3, alpha=10, prob=1.0)):
        for s in range(3):
            np.random.seed(s)
            ri, rt = make(jT)(inp.copy(), tgt.copy())
            np.random.seed(s)
            gi, gt = make(pT)(inp.copy(), tgt.copy())
            assert np.array_equal(gi, ri) and np.array_equal(gt, rt)


def test_drop_if_too_much_bg_matches_jax():
    inp = np.zeros((1, 4, 4), np.float32)
    tgt = np.zeros((4, 4), np.int64)
    for s in range(20):
        outcome = []
        for T in (jT, pT):
            np.random.seed(s)
            try:
                T.DropIfTooMuchBG(threshold=0.5)(inp, tgt)
                outcome.append("kept")
            except T._DropSample:
                outcome.append("dropped")
        assert outcome[0] == outcome[1]


def test_optional_package_transforms_raise_as_jax():
    inp = np.random.default_rng(0).random((1, 16, 16)).astype(np.float32)
    try:
        ref = jT.Clahe2d()(inp, None)[0]
    except ImportError:
        with pytest.raises(ImportError, match="scikit-image"):
            pT.Clahe2d()(inp, None)
    else:
        assert np.array_equal(pT.Clahe2d()(inp, None)[0], ref)

    def albu(image, mask=None):    # an albumentations-style callable
        return {"image": image[::-1].copy(), "mask": mask}

    out, t = pT.AlbuSeg2d(albu)(inp, None)
    assert np.array_equal(out, jT.AlbuSeg2d(albu)(inp, None)[0])


def test_samplers_match_jax_and_follow_numpys_global_state():
    for name, args in (("Normal", (0.5, 2.0, (-1, 3))),
                       ("HalfNormal", (1.5, (0, 2))), ("RandInt", (2, 9)),
                       ("Uniform", (-1.0, 4.0))):
        ref = getattr(jrandom, name)(*args, rng=np.random.default_rng(7))
        got = getattr(prandom, name)(*args, rng=np.random.default_rng(7))
        assert np.array_equal(got((3, 4)), ref((3, 4))), name
        unseeded = getattr(prandom, name)(*args)
        np.random.seed(1)
        a = unseeded(5)
        np.random.seed(1)
        assert np.array_equal(unseeded(5), a), name


def test_random_blurring_scheduler_matches_jax():
    from elektronn3_tpu.data.transforms import random_blurring as jrb
    from elektronn3_tpu_torch.data.transforms import random_blurring as prb
    for kw in (dict(value=0.1, max_value=0.5, growth_type="lin",
                    interval=4),
               dict(value=0.1, max_value=0.5, growth_type="exp",
                    interval=4)):
        a, b = jrb.ScalarScheduler(**kw), prb.ScalarScheduler(**kw)
        assert [a.step() for _ in range(6)] == [b.step() for _ in range(6)]
    with pytest.raises(ValueError):
        prb.check_random_data_blurring_config(
            PATCH, 0.5, 0.2, (2, 3, 3), (4, 6, 30))


# ---------------------------------------------------------------------------
# utils.py
# ---------------------------------------------------------------------------

def test_data_utils_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    targets = [rng.integers(0, 3, size=(5, 6)), rng.integers(0, 3, (4,))]
    for mode in ("inverse", "inversesquared", "norpf"):
        assert np.array_equal(putils.calculate_class_weights(targets, mode),
                              jutils.calculate_class_weights(targets, mode))
    binary = [rng.integers(0, 2, size=(30,))]
    assert np.array_equal(
        pcnndata.calculate_class_weights(binary, "binmean"),
        jcnndata.calculate_class_weights(binary, "binmean"))
    with pytest.raises(ValueError):
        putils.calculate_class_weights(targets, "nope")
    inputs = [rng.normal(size=(2, 4, 5)), rng.normal(size=(2, 3, 3))]
    assert np.array_equal(putils.calculate_means(inputs),
                          jutils.calculate_means(inputs))
    assert np.array_equal(putils.calculate_stds(inputs),
                          jutils.calculate_stds(inputs))
    assert putils.calculate_nd_slice(np.zeros((2, 5, 6, 7)), (1, 2, 3),
                                     (4, 5, 6)) == jutils.calculate_nd_slice(
        np.zeros((2, 5, 6, 7)), (1, 2, 3), (4, 5, 6))
    assert np.array_equal(putils.squash01(inputs[0]),
                          jutils.squash01(inputs[0]))
    assert putils.calculate_offset(lambda x: x[:, 1:-1, 2:-2, :],
                                   (1, 8, 8, 1)) == (1, 2)
    path = str(tmp_path / "out.h5")
    putils.save_to_h5({"a": inputs[0]}, path)
    with pytest.raises(FileExistsError):
        putils.save_to_h5({"a": inputs[0]}, path)
    import h5py
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["a"][()], inputs[0])
    with putils.CleanExit():
        raise KeyboardInterrupt
    with putils.DelayedInterrupt(signals=(signal.SIGUSR1,)):
        old = signal.getsignal(signal.SIGUSR1)
    assert signal.getsignal(signal.SIGUSR1) is not old


# ---------------------------------------------------------------------------
# PatchCreator, get_preview_batch
# ---------------------------------------------------------------------------

def _seeded_jax_transform(monkeypatch):
    """JAX's PatchCreator with the port's warp generator (seeded from
    numpy's global state), so that the two can be compared."""
    orig = jct.get_warped_coord_transform

    def seeded(*args, **kwargs):
        if kwargs.get("rng") is None:
            kwargs["rng"] = np.random.default_rng(np.random.randint(2 ** 32))
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcnndata.coord_transforms,
                        "get_warped_coord_transform", seeded)


def _patch_creators(mod, T, h5files, **kw):
    common = [T.SqueezeTarget(dim=0), T.Normalize(mean=155.291411,
                                                  std=41.812504)]
    transform = T.Compose(common + [
        T.RandomGrayAugment(channels=[0], prob=0.3),
        T.RandomGammaCorrection(gamma_std=0.25, channels=[0], prob=0.3),
        T.AdditiveGaussianNoise(sigma=0.1, channels=[0], prob=0.3)])
    args = dict(input_sources=[p[0] for p in h5files],
                target_sources=[p[1] for p in h5files], patch_shape=PATCH,
                aniso_factor=2, epoch_size=6, warp_prob=0.5,
                warp_kwargs=dict(sample_aniso=True, perspective=True,
                                 warp_amount=1.0),
                transform=transform)
    args.update(kw)
    return mod.PatchCreator(**args)


@pytest.mark.parametrize("offset", [(0, 0, 0), (2, 4, 4)])
def test_patch_creator_matches_jax(h5files, monkeypatch, offset):
    _seeded_jax_transform(monkeypatch)
    jpc = _patch_creators(jcnndata, jT, h5files, offset=offset)
    ppc = _patch_creators(pcnndata, pT, h5files, offset=offset)
    assert np.array_equal(ppc.cube_prios, jpc.cube_prios)
    for s in range(8):
        np.random.seed(s)
        ref = jpc[0]
        np.random.seed(s)
        got = ppc[0]
        assert got.keys() == ref.keys()
        assert np.array_equal(got["inp"], ref["inp"])
        assert got["target"].dtype == ref["target"].dtype == np.int64
        assert np.array_equal(got["target"], ref["target"])
        assert got["fname"] == ref["fname"]
        assert got["target"].shape == tuple(np.subtract(PATCH,
                                                        2 * np.array(offset)))
    assert (ppc.n_successful_warp, ppc.n_failed_warp) == \
        (jpc.n_successful_warp, jpc.n_failed_warp)
    assert ppc.warp_stats == jpc.warp_stats


def test_get_preview_batch_matches_jax(h5files):
    for kw in (dict(preview_shape=(8, 16, 24)), dict(preview_shape=(16, 20),
                                                     dim=2)):
        ref = jcnndata.get_preview_batch(
            h5files[0][0], transform=jT.Normalize(150.0, 40.0), **kw)
        got = pcnndata.get_preview_batch(
            h5files[0][0], transform=pT.Normalize(150.0, 40.0), **kw)
        assert got.dtype == np.float32 and np.array_equal(got, ref)
    with pytest.raises(ValueError):
        pcnndata.get_preview_batch(h5files[0][0], preview_shape=(80, 8, 8))


def test_hdf5_source_matches_array_source(h5files, cube):
    src = psources.HDF5DataSource(*h5files[0][0])
    mem = psources.HDF5DataSource(*h5files[0][0], in_memory=True)
    arr = psources.ArrayDataSource(cube[0])
    for s in (src, mem, arr):
        assert s.shape == SRC and s.ndim == 3 and s.dtype == np.float32
        cut = psources.slice_3d(s, (1, 2, 3), (5, 9, 11),
                                prepend_empty_axis=True)
        assert np.array_equal(cut, cube[0][None, 1:5, 2:9, 3:11])
    with pytest.raises(RuntimeError):
        psources.slice_3d(arr, (0, 0, 0), (SRC[0] + 1, 4, 4))


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

class Draws:
    """Samples drawn from numpy's global random state."""

    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"inp": np.random.normal(size=(2, 3, 4)).astype(np.float32),
                "target": np.random.randint(0, 3, size=(3, 4)),
                "fname": f"s{i}"}


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False)])
def test_data_loader_matches_jax(drop_last, shuffle):
    kw = dict(batch_size=4, num_workers=0, seed=5, drop_last=drop_last,
              shuffle=shuffle)
    jl, pl = jpipeline.DataLoader(Draws(), **kw), \
        ppipeline.DataLoader(Draws(), **kw)
    assert len(pl) == len(jl)
    for _ in range(2):    # two epochs: the order and the seeds move on
        ref, got = list(jl), list(pl)
        assert len(got) == len(ref) == len(pl)
        for r, g in zip(ref, got):
            assert g["inp"].shape[-1] == 2    # channels-last
            assert np.array_equal(g["inp"], r["inp"])
            assert np.array_equal(g["target"], r["target"])
            assert np.array_equal(g["fname"], r["fname"])


def test_data_loader_generator_gives_torch_order():
    """With a ``torch.Generator`` the order is torch's shuffling
    ``DataLoader``'s under the same generator seed; the samples keep
    their per-sample seeds."""
    got = [list(b["fname"]) for b in ppipeline.DataLoader(
        Draws(), batch_size=4, num_workers=0, seed=5,
        generator=torch.Generator().manual_seed(3))]
    ref = [[f"s{i}" for i in b.tolist()] for b in torch.utils.data.DataLoader(
        range(10), batch_size=4, shuffle=True, drop_last=True,
        generator=torch.Generator().manual_seed(3))]
    assert got == ref
    whole = next(iter(ppipeline.DataLoader(
        Draws(), batch_size=10, num_workers=0, seed=5, shuffle=False)))
    by_name = dict(zip(whole["fname"], whole["inp"]))
    for b in ppipeline.DataLoader(Draws(), batch_size=4, num_workers=0,
                                  seed=5,
                                  generator=torch.Generator().manual_seed(3)):
        for name, x in zip(b["fname"], b["inp"]):
            assert np.array_equal(x, by_name[name])


def test_data_loader_pin_memory_gives_tensors():
    """``pin_memory`` hands torch's pinning thread CPU tensors (pinned
    where a card is): the same values; strings stay as they were."""
    kw = dict(batch_size=4, num_workers=0, seed=5)
    plain = list(ppipeline.DataLoader(Draws(), **kw))
    pinned = list(ppipeline.DataLoader(Draws(), pin_memory=True, **kw))
    assert len(pinned) == len(plain) == 2
    for a, b in zip(plain, pinned):
        for key in ("inp", "target"):
            assert isinstance(b[key], torch.Tensor)
            assert np.array_equal(b[key].numpy(), a[key])
        assert list(b["fname"]) == list(a["fname"])


def test_collate_and_channels_last_match_jax():
    samples = [Draws()[i] for i in range(3)]
    ref = jpipeline.to_channels_last(jpipeline.default_collate(samples))
    got = ppipeline.to_channels_last(ppipeline.default_collate(samples))
    assert np.array_equal(got["inp"], ref["inp"])
    assert np.array_equal(got["fname"], ref["fname"])
    with pytest.raises(ValueError):
        ppipeline.DataLoader(Draws(), worker_type="fiber")


def _batches(loader):
    return [(b["inp"].copy(), b["target"].copy()) for b in loader]


def test_seeded_patch_creator_loader_repeats(h5files):
    """JAX's fault 1 is not copied: two passes of a seeded loader over
    PatchCreator give the same batches, at num_workers 0 and 2, and the
    two workers give different patches."""
    runs = {}
    for workers in (0, 2, 2):
        ds = _patch_creators(pcnndata, pT, h5files, epoch_size=4)
        loader = ppipeline.DataLoader(ds, batch_size=2, num_workers=workers,
                                      seed=11, timeout=60)
        runs.setdefault(workers, []).append(_batches(loader))
    first = runs[0][0]
    for run in runs[0] + runs[2]:
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(run, first))
    # torch hands whole batches to workers in turn: batch 0 comes from
    # worker 0, batch 1 from worker 1
    patches = [p for inp, _ in first for p in inp]
    assert all(not np.array_equal(patches[i], patches[j])
               for i in range(4) for j in range(i))


def test_trainer_loader_repeats_and_workers_differ(h5files, tmp_path):
    """The Trainer's own loader: the same seed gives the same batches
    again, at num_workers 0 and 2, and no two samples are the same."""
    seen = {}
    for run, workers in enumerate((0, 0, 2)):
        ds = _patch_creators(pcnndata, pT, h5files, epoch_size=4,
                             warp_prob=1.0)
        tr = Trainer(torch.nn.Linear(1, 1), ploss.CEDiceLoss(1.0, 1.0),
                     train_dataset=ds, batch_size=2, num_workers=workers,
                     save_root=str(tmp_path), exp_name=f"r{run}",
                     enable_tensorboard=False, seed=3)
        for epoch in range(2):
            tr.epoch = epoch
            seen.setdefault(run, []).append(_batches(tr._loader()))
    for run in (1, 2):
        for e in range(2):
            for a, b in zip(seen[run][e], seen[0][e]):
                assert np.array_equal(a[0], b[0])
                assert np.array_equal(a[1], b[1])
    patches = [p for e in range(2) for inp, _ in seen[0][e] for p in inp]
    assert all(not np.array_equal(patches[i], patches[j])
               for i in range(len(patches)) for j in range(i))


def test_trainer_unlabeled_passes_differ(h5files, tmp_path):
    """The Trainer's unlabeled batches: each pass over an unlabeled
    PatchCreator, in one epoch or the next, draws new patches, and a
    second Trainer under the same seed draws the same ones again."""
    seen = []
    for run in range(2):
        ds = _patch_creators(pcnndata, pT, h5files, epoch_size=2,
                             warp_prob=1.0)
        tr = Trainer(torch.nn.Linear(1, 1), ploss.CEDiceLoss(1.0, 1.0),
                     train_dataset=ds, unlabeled_dataset=ds, batch_size=2,
                     save_root=str(tmp_path), exp_name=f"u{run}",
                     enable_tensorboard=False, seed=3)
        got = []
        for epoch in range(2):   # each epoch cycles the loader anew
            it = tr._unlabeled_batches()
            got += [next(it).numpy() for _ in range(2)]   # two passes
        seen.append(got)
    assert all(np.array_equal(a, b) for a, b in zip(*seen))
    patches = [p for inp in seen[0] for p in inp]
    assert all(not np.array_equal(patches[i], patches[j])
               for i in range(len(patches)) for j in range(i))
