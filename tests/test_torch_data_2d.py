"""The port's 2D datasets (``SimpleNeuroData2d``, ``Segmentation2d``,
``Reconstruction2d``, ``TripletData2d``) against the JAX package's, on
the CPU, on files the test writes: an HDF5 pair in the layout of
``benchmark/make_synthetic_neurodata.py`` (``raw`` float32 and ``lab``
int16, from its ``make_cube`` at a small shape), and png (gray, RGB,
uint8) and tif (uint16, float32) images with label images.

Every sample is drawn after the same ``np.random.seed`` on both sides
through the same transforms (the port's against JAX's: Normalize on the
HDF5 slices, RandomCrop, RandomFlip, AdditiveGaussianNoise, and a
DropIfTooMuchBG that drops some samples), and must be equal bit for
bit, its dtype included. ``TripletData2d`` draws its negative from its
own generator in the port; JAX's draws it from numpy's global state
first, so JAX is handed the port's draw for that one call. The import of
``h5py`` and ``imageio`` happens when a dataset is made. Last,
``examples/train_simple2d_torch.py`` runs 2 steps and its validation on
the CPU.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from elektronn3_tpu.data import cnndata as jcd
from elektronn3_tpu.data import transforms as jT
from elektronn3_tpu_torch.data import cnndata as pcd
from elektronn3_tpu_torch.data import transforms as pT

h5py = pytest.importorskip("h5py")
imageio = pytest.importorskip("imageio.v2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_cube():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_neurodata",
        os.path.join(ROOT, "benchmark", "make_synthetic_neurodata.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_cube


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data2d")
    raw, lab = _make_cube()(np.random.default_rng(0), shape=(96, 32, 48))
    with h5py.File(d / "raw_0.h5", "w") as f:
        f.create_dataset("raw", data=raw)
    with h5py.File(d / "barrier_int16_0.h5", "w") as f:
        f.create_dataset("lab", data=lab)
    rng = np.random.default_rng(1)
    imgs, labs = [], []
    for i, (ext, kind) in enumerate([("png", "gray"), ("png", "rgb"),
                                     ("tif", "u16"), ("tif", "f32")]):
        shape = (36, 40) if kind != "rgb" else (36, 40, 3)
        if kind in ("gray", "rgb"):
            img = rng.integers(0, 256, size=shape).astype(np.uint8)
        elif kind == "u16":
            img = rng.integers(0, 4096, size=shape).astype(np.uint16)
        else:
            img = rng.normal(100, 20, size=shape).astype(np.float32)
        lb = (rng.uniform(size=(36, 40)) < 0.4).astype(np.uint8)
        if i == 1:
            lb = np.stack([lb * 255] * 3, -1)   # an RGB label image
        ip, lp = d / f"img_{i}.{ext}", d / f"lab_{i}.png"
        imageio.imwrite(ip, img)
        imageio.imwrite(lp, lb)
        imgs.append(str(ip))
        labs.append(str(lp))
    layers = [str(d / f"layer_{c}.png") for c in range(2)]
    for p in layers:
        imageio.imwrite(p, rng.integers(0, 256, size=(36, 40)).astype(
            np.uint8))
    return dict(h5=(str(d / "raw_0.h5"), str(d / "barrier_int16_0.h5")),
                imgs=imgs, labs=labs, layers=layers)


def _transforms(T, crop, drop=False, normalize=False):
    """The 2D example's training transforms (``Normalize`` only on the
    one-channel HDF5 slices: the image sets mix channel counts)."""
    ts = [T.Normalize(mean=155.291411, std=41.812504)] if normalize else []
    ts += [T.RandomCrop(crop), T.RandomFlip(ndim_spatial=2),
           T.AdditiveGaussianNoise(sigma=0.1, prob=0.5)]
    if drop:
        ts.append(T.DropIfTooMuchBG(threshold=0.7))
    return T.Compose(ts)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, str):
            assert va == vb, k
            continue
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        assert np.array_equal(va, vb), k


def _pairs(port, ref, n, seed=10):
    assert len(port) == len(ref)
    for i in range(n):
        np.random.seed(seed + i)
        a = port[i % len(port)]
        np.random.seed(seed + i)
        b = ref[i % len(ref)]
        _same(a, b)


@pytest.mark.parametrize("train", [True, False])
def test_simple_neuro_data_2d(files, train):
    inp, tgt = files["h5"]
    port = pcd.SimpleNeuroData2d(
        inp, tgt, train=train, transform=_transforms(pT, (16, 24),
                                                     normalize=True))
    ref = jcd.SimpleNeuroData2d(
        inp, tgt, train=train, transform=_transforms(jT, (16, 24),
                                                     normalize=True))
    assert len(port) == (90 if train else 6)
    _pairs(port, ref, 6)


@pytest.mark.parametrize("invert, offset, mult", [
    (False, (0, 0), 1), (True, (2, 3), 2)])
def test_segmentation_2d(files, invert, offset, mult):
    kw = dict(offset=offset, invert_targets=invert, epoch_multiplier=mult)
    port = pcd.Segmentation2d(files["imgs"], files["labs"],
                              _transforms(pT, (24, 24)), **kw)
    ref = jcd.Segmentation2d(files["imgs"], files["labs"],
                             _transforms(jT, (24, 24)), **kw)
    _pairs(port, ref, 8)


def test_segmentation_2d_layer_stack_and_drops(files):
    """An input of stacked single-channel layers; a transform that drops
    samples until one has enough foreground."""
    inps = [files["layers"], files["imgs"][0]]
    port = pcd.Segmentation2d(inps, files["labs"][:2],
                              _transforms(pT, (24, 24), drop=True))
    ref = jcd.Segmentation2d(inps, files["labs"][:2],
                             _transforms(jT, (24, 24), drop=True))
    assert port.inps[0].shape == (2, 36, 40)
    _pairs(port, ref, 6)


def test_reconstruction_2d(files):
    port = pcd.Reconstruction2d(files["imgs"], _transforms(pT, (20, 20)),
                                epoch_multiplier=3)
    ref = jcd.Reconstruction2d(files["imgs"], _transforms(jT, (20, 20)),
                               epoch_multiplier=3)
    _pairs(port, ref, 12)


def test_triplet_data_2d(files, monkeypatch):
    port = pcd.TripletData2d(files["imgs"], files["labs"],
                             _transforms(pT, (20, 20)),
                             rng=np.random.default_rng(5))
    ref = jcd.TripletData2d(files["imgs"], files["labs"],
                            _transforms(jT, (20, 20)))
    draws = np.random.default_rng(5)
    real = np.random.randint
    for i in range(10):
        first = [int(draws.integers(0, len(port.inps) - 1))]

        def randint(*a, **k):
            # JAX's negative draw (the first randint of its call) is the
            # port's; the transforms' draws go on from the seed.
            return first.pop() if first else real(*a, **k)
        np.random.seed(20 + i)
        a = port[i]
        np.random.seed(20 + i)
        monkeypatch.setattr(np.random, "randint", randint)
        b = ref[i]
        monkeypatch.setattr(np.random, "randint", real)
        _same(a, b)
    # A negative never repeats the anchor's image, and the draws repeat
    # from the same seed.
    again, twin = (pcd.TripletData2d(files["imgs"], files["labs"],
                                     pT.Identity(),
                                     rng=np.random.default_rng(5))
                   for _ in range(2))
    for i in range(8):
        s = again[i]
        assert not np.array_equal(s["neg"], s["anchor"])
        assert np.array_equal(s["neg"], twin[i]["neg"])
    with pytest.raises(ValueError):
        pcd.TripletData2d(files["imgs"][:1], files["labs"][:1])


def test_no_h5py_or_imageio_at_import():
    code = ("import sys; import elektronn3_tpu_torch.data.cnndata; "
            "print(int('h5py' in sys.modules), "
            "int('imageio' in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split()
    assert out == ["0", "0"]


def test_simple2d_example_runs_on_the_cpu(tmp_path, monkeypatch):
    """``examples/train_simple2d_torch.py`` end to end for 2 steps and
    its validation on a synthetic HDF5 pair (96 slices of 160 x 160),
    the model made small through its import, on the CPU."""
    import runpy

    import elektronn3_tpu_torch.models as pmodels

    raw, lab = _make_cube()(np.random.default_rng(2), shape=(96, 160, 160))
    with h5py.File(tmp_path / "raw_0.h5", "w") as f:
        f.create_dataset("raw", data=raw)
    with h5py.File(tmp_path / "barrier_int16_0.h5", "w") as f:
        f.create_dataset("lab", data=lab)
    unet = pmodels.UNet
    monkeypatch.setattr(pmodels, "UNet", lambda **kw: unet(
        **{**kw, "n_blocks": 2, "start_filts": 8}))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(sys, "argv", [
        "train_simple2d_torch.py", "-d", str(tmp_path), "-m", "2", "-j",
        "0", "-n", "example", "--device", "cpu"])
    g = runpy.run_path(os.path.join(ROOT, "examples",
                                    "train_simple2d_torch.py"),
                       run_name="__main__")
    tr = g["trainer"]
    assert tr.step == 2 and np.isfinite(tr.last_stats["tr_loss"]).all()
    assert np.isfinite(tr.last_stats["val_loss"])
    assert (tmp_path / "e3tpu_training" / "example" /
            "state_dict_final.pth").is_file()
