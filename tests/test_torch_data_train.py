"""The data slice as a whole: a training step of the port fed by the
port's pipeline against the JAX package's step fed by JAX's, on the CPU
in float32.

A small UNet (n_blocks=2, start_filts=32, planar L0, batch norm; the
JAX variables converted into the port's model; JAX at
``pallas_flat=False``, the port's L0 on its kernel ops' plain versions)
takes one step on the first batch of each loader:

- ``DataLoader(seed=...)`` over ``PatchCreator`` with the neurodata
  example's transforms and perspective warps (JAX's module given the
  port's seeded warp generator, as in ``test_torch_data_host.py``): the
  two first batches are equal bit for bit;
- ``DeviceWarpPatchLoader`` under the same seed with
  ``perspective=False``: inputs within 1e-5 of max|ref|, labels equal.

The losses agree within 1e-5 (relative), every parameter gradient within
1e-3 of its own scale plus 1e-6 (the two frameworks sum in other
orders), and ``train_step`` returns the loss of that step.

Last, ``examples/train_unet_neurodata_torch.py`` runs 2 steps and its
validation on small HDF5 cubes, its patch, preview and model made small
and put on the CPU through its imports.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.data import cnndata as jcnndata
from elektronn3_tpu.data import coord_transforms as jct
from elektronn3_tpu.data import device_pipeline as jdp
from elektronn3_tpu.data import pipeline as jpipeline
from elektronn3_tpu.data import sources as jsources
from elektronn3_tpu.data.transforms import transforms as jT
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.data import cnndata as pcnndata
from elektronn3_tpu_torch.data import device_pipeline as pdp
from elektronn3_tpu_torch.data import pipeline as ppipeline
from elektronn3_tpu_torch.data import sources as psources
from elektronn3_tpu_torch.data.transforms import transforms as pT
from elektronn3_tpu_torch.models import (
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import train_step

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "train_unet_neurodata_torch.py"
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
PATCH = (4, 12, 16)
SRC = (24, 48, 56)
BATCH = 2
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-3
LEAF_ATOL = 1e-6


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    import h5py
    rng = np.random.default_rng(12)
    root = tmp_path_factory.mktemp("cubes")
    raw = (155 + 40 * rng.normal(size=SRC)).astype(np.float32)
    lab = (np.abs(rng.normal(size=SRC)) < 0.5).astype(np.int16)
    rp, lp = root / "raw.h5", root / "lab.h5"
    with h5py.File(rp, "w") as f:
        f.create_dataset("raw", data=raw)
    with h5py.File(lp, "w") as f:
        f.create_dataset("lab", data=lab)
    return dict(raw=raw, lab=lab, files=((str(rp), "raw"), (str(lp), "lab")))


@pytest.fixture(scope="module")
def variables():
    return junet.init_unet(junet.UNet(pallas_flat=False, **KW),
                           (BATCH,) + PATCH + (1,))


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


def _jax_step(v, x, y):
    model = junet.UNet(pallas_flat=False, **KW)
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32)

    loss, g = jax.value_and_grad(loss_fn)(v["params"])
    return float(loss), g


def _check_port_step(v, x, y, ref_loss, ref_grads):
    m = UNet(device="cpu", **KW)
    m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
    state = {k: t.clone() for k, t in m.state_dict().items()}
    m.train()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(x), y)
    loss.backward()
    loss = loss.detach()
    grads = _leaves(flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, v,
        ("params",))["params"])
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    ref = _leaves(ref_grads)
    assert grads.keys() == ref.keys()
    for k in ref:
        scale = float(np.max(np.abs(ref[k])))
        assert np.max(np.abs(grads[k] - ref[k])) <= \
            LEAF_TOL * scale + LEAF_ATOL, k
    m.load_state_dict(state)
    opt = torch.optim.SGD(m.parameters(), lr=1e-2)
    step_loss = train_step(m, ploss.CEDiceLoss(1.0, 1.0), opt, x, y)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)


def _creator(mod, T, files):
    transform = T.Compose([
        T.SqueezeTarget(dim=0),
        T.Normalize(mean=155.291411, std=41.812504),
        T.RandomGrayAugment(channels=[0], prob=0.3),
        T.RandomGammaCorrection(gamma_std=0.25, channels=[0], prob=0.3),
        T.AdditiveGaussianNoise(sigma=0.1, channels=[0], prob=0.3)])
    return mod.PatchCreator(
        input_sources=[files[0]], target_sources=[files[1]],
        patch_shape=PATCH, aniso_factor=2, epoch_size=4, warp_prob=0.5,
        warp_kwargs=dict(sample_aniso=True, perspective=True,
                         warp_amount=1.0), transform=transform)


def test_patch_creator_fed_step_matches_jax(cubes, variables, monkeypatch):
    orig = jct.get_warped_coord_transform

    def seeded(*args, **kwargs):
        kwargs["rng"] = np.random.default_rng(np.random.randint(2 ** 32))
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcnndata.coord_transforms,
                        "get_warped_coord_transform", seeded)
    kw = dict(batch_size=BATCH, num_workers=0, seed=2)
    ref = next(iter(jpipeline.DataLoader(
        _creator(jcnndata, jT, cubes["files"]), **kw)))
    got = next(iter(ppipeline.DataLoader(
        _creator(pcnndata, pT, cubes["files"]), **kw)))
    assert got["inp"].shape == (BATCH,) + PATCH + (1,)
    assert np.array_equal(got["inp"], ref["inp"])
    assert np.array_equal(got["target"], ref["target"])
    loss, grads = _jax_step(variables, ref["inp"], ref["target"])
    batch = next(ppipeline.prefetch_to_device([got], device="cpu"))
    _check_port_step(variables, batch["inp"], batch["target"], loss, grads)


def test_device_loader_fed_step_matches_jax(cubes, variables):
    kw = dict(patch_shape=PATCH, batch_size=BATCH, epoch_size=1,
              warp_prob=0.5, aniso_factor=2,
              warp_kwargs=dict(sample_aniso=True, warp_amount=1.0),
              normalize=(155.291411, 41.812504), seed=6)
    ref = next(iter(jdp.DeviceWarpPatchLoader(
        [jsources.ArrayDataSource(cubes["raw"])],
        [jsources.ArrayDataSource(cubes["lab"])], **kw)))
    got = next(iter(pdp.DeviceWarpPatchLoader(
        [psources.ArrayDataSource(cubes["raw"])],
        [psources.ArrayDataSource(cubes["lab"])], device="cpu", **kw)))
    ref_inp = np.asarray(ref["inp"])
    assert np.max(np.abs(got["inp"].numpy() - ref_inp)) <= \
        1e-5 * np.max(np.abs(ref_inp))
    assert np.array_equal(got["target"].numpy(), np.asarray(ref["target"]))
    loss, grads = _jax_step(variables, ref_inp, np.asarray(ref["target"]))
    _check_port_step(variables, got["inp"], got["target"], loss, grads)


def test_neurodata_example_runs_on_the_cpu(cubes, tmp_path, monkeypatch):
    """``examples/train_unet_neurodata_torch.py`` end to end for 2 steps
    and its validation, on small HDF5 cubes: the patch, the preview and
    the model made small and put on the CPU through its imports."""
    import runpy
    import sys

    import h5py

    import elektronn3_tpu_torch.data as pdata
    import elektronn3_tpu_torch.models as pmodels

    for i in range(3):
        with h5py.File(tmp_path / f"raw_{i}.h5", "w") as f:
            f.create_dataset("raw", data=cubes["raw"])
        with h5py.File(tmp_path / f"barrier_int16_{i}.h5", "w") as f:
            f.create_dataset("lab", data=cubes["lab"])
    creator, preview, unet = (pdata.PatchCreator, pdata.get_preview_batch,
                              pmodels.UNet)
    monkeypatch.setattr(pdata, "PatchCreator", lambda **kw: creator(
        **{**kw, "patch_shape": PATCH}))
    monkeypatch.setattr(pdata, "get_preview_batch", lambda **kw: preview(
        **{**kw, "preview_shape": PATCH}))
    monkeypatch.setattr(pmodels, "UNet", lambda **kw: unet(
        **{**kw, **KW, "device": "cpu"}))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(sys, "argv", [
        "train_unet_neurodata_torch.py", "-d", str(tmp_path), "-m", "2",
        "-j", "0", "-n", "example"])
    g = runpy.run_path(str(EXAMPLE), run_name="__main__")
    tr = g["trainer"]
    assert tr.step == 2 and np.isfinite(tr.last_stats["tr_loss"]).all()
    assert np.isfinite(tr.last_stats["val_loss"])
    assert (tmp_path / "e3tpu_training" / "example" /
            "state_dict_final.pth").is_file()
