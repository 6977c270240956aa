"""The rest of the port's Predictor (elektronn3_tpu_torch.inference)
against the JAX package's, on the CPU in float32.

The same seeded numpy inputs and the same parameters (converted with
``state_dict_from_flax``; batch norms with random statistics) go through
JAX's ``Predictor`` (its UNet at ``pallas_flat=False``, XLA) and the
port's (its kernel levels on the kernel ops' plain versions); float32
probabilities agree within 1e-4:

- flip test-time augmentation, an int and a list spec, 2D and 3D, tiled
  and whole, with the model called (1 + flips) times as often as
  without; non-spatial axes raise as in JAX;
- ``offset='auto'`` on a valid-conv 2D and 3D UNet (the probe cached by
  input rank, ``offset`` left as given, as ``tests/test_inference.py``
  checks JAX's), tiled and whole, and an explicit offset;
- ``out_shape`` giving an unbatched input its axes; ``transform`` (the
  port's ``Normalize`` against JAX's); ``verbose`` (the MVox/s and
  progress logs) and ``collect_phase_times`` (JAX's six phases);
  ``predict_proba``;
- reference checkpoints through ``Predictor(state=...)``: a
  ``state_dict.pth`` bundle (``module.`` prefixes,
  ``num_batches_tracked``), a bare state dict, a pickled module, a
  TorchScript ``.pts`` and a ``full_norm=False`` bundle (gaps in the
  norm numbers) against JAX's ``Predictor(state=<same path>)``; the
  strict import's errors;
- the model from a port ``model*.pt`` path and as a plain callable, the
  same bits as the module; JAX's model files raise;
- the ``Trainer``'s ``preview_offset`` through ``_run_preview_inference``;
- ``examples/inference_h5_torch.py`` on a small HDF5 file.
"""

import logging
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from elektronn3_tpu.data.transforms import Normalize as JaxNormalize
from elektronn3_tpu.inference import Predictor as JaxPredictor
from elektronn3_tpu.models.unet import UNet as JaxUNet, init_unet
from elektronn3_tpu_torch.data.transforms import Normalize
from elektronn3_tpu_torch.inference import (
    DEFAULT_AUGMENTATIONS_2D, DEFAULT_AUGMENTATIONS_3D, Predictor)
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.models.torch_import import load_torch_state_dict
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import Trainer, save_model

TOL = 1e-4
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,), normalization="batch")
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "inference_h5_torch.py")


def _variables(jm, shape, rng):
    v = jax.tree_util.tree_map(np.asarray,
                               jax.device_get(init_unet(jm, shape)))
    for lvl in v.get("batch_stats", {}).values():
        for bn in lvl.values():
            bn["mean"] = (0.2 * rng.normal(size=bn["mean"].shape)).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, size=bn["var"].shape).astype(
                np.float32)
    return v


def _pair(kw, shape, seed=5):
    """(JAX model, its variables, the port model with them)."""
    rng = np.random.default_rng(seed)
    jm = JaxUNet(pallas_flat=False, **kw)
    v = _variables(jm, shape, rng)
    pm = UNet(device="cpu", **kw)
    pm.load_state_dict(state_dict_from_flax(v, pm))
    return jm, v, pm


@pytest.fixture(scope="module")
def m3d():
    jm, v, pm = _pair(KW, (1, 4, 16, 16, 1))
    vol = np.random.default_rng(1).normal(size=(1, 1, 4, 16, 16)).astype(
        np.float32)
    return jm, v, pm, vol


@pytest.fixture(scope="module")
def m2d():
    jm, v, pm = _pair(dict(KW, dim=2, planar_blocks=()), (1, 16, 16, 1))
    imgs = np.random.default_rng(2).normal(size=(2, 1, 16, 16)).astype(
        np.float32)
    return jm, v, pm, imgs


@pytest.fixture
def port_log(caplog):
    """caplog on the port's logger (which does not propagate)."""
    log = logging.getLogger("elektronn3_tpu_torch")
    log.addHandler(caplog.handler)
    yield caplog
    log.removeHandler(caplog.handler)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert float(np.abs(out - ref).max()) <= TOL


def _model_calls(pm, pred, inp):
    calls = []
    hook = pm.register_forward_hook(lambda *a: calls.append(1))
    try:
        out = pred.predict(inp)
    finally:
        hook.remove()
    return out, len(calls)


TILED_3D = dict(tile_shape=(2, 8, 8), overlap_shape=(1, 4, 4), batch_size=2)
TILED_2D = dict(tile_shape=(8, 8), overlap_shape=(4, 4), batch_size=3)


@pytest.mark.parametrize("dim, spec, tiled", [
    (3, 8, True), (3, [(2,), (3, 4)], False), (2, 4, False),
    (2, [(), (3,)], True)])
def test_tta_matches_jax(m3d, m2d, dim, spec, tiled):
    jm, v, pm, inp = m3d if dim == 3 else m2d
    kw = (TILED_3D if dim == 3 else TILED_2D) if tiled else {}
    ref = JaxPredictor(jm, v, augmentations=spec, **kw).predict(inp)
    out, calls = _model_calls(pm, Predictor(pm, augmentations=spec, **kw),
                              inp)
    _close(out, ref)
    _, plain_calls = _model_calls(pm, Predictor(pm, **kw), inp)
    if isinstance(spec, int):
        spec = (DEFAULT_AUGMENTATIONS_3D if dim == 3
                else DEFAULT_AUGMENTATIONS_2D)[:spec]
    assert calls == (1 + sum(1 for a in spec if a)) * plain_calls


def test_tta_int_spec_takes_the_first_defaults_of_the_rank(m3d):
    _, _, pm, vol = m3d
    a = Predictor(pm, augmentations=3, **TILED_3D).predict(vol)
    b = Predictor(pm, augmentations=DEFAULT_AUGMENTATIONS_3D[:3],
                  **TILED_3D).predict(vol)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("spec", [[(1,)], [(2, 5)], [(0, 3)]])
def test_tta_non_spatial_axes_raise_as_in_jax(m3d, spec):
    jm, v, pm, vol = m3d
    with pytest.raises(ValueError, match="non-spatial"):
        JaxPredictor(jm, v, augmentations=spec).predict(vol)
    with pytest.raises(ValueError, match="non-spatial"):
        Predictor(pm, augmentations=spec).predict(vol)


VALID = {
    # The JAX test's model: one block, 2 convs of 3 px: offset 2.
    2: (dict(in_channels=1, out_channels=2, n_blocks=1, start_filts=2,
             dim=2, normalization="none", conv_mode="valid"),
        (1, 1, 20, 20), (8, 8), (2, 2)),
    # Planar L0 (1,3,3), L1 3x3x3: (12, 32, 32) -> (8, 16, 16).
    3: (dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=4,
             planar_blocks=(0,), conv_mode="valid"),
        (1, 1, 12, 32, 32), (4, 8, 8), (2, 8, 8)),
}


@pytest.mark.parametrize("dim", [2, 3])
def test_valid_offset_auto_matches_jax(dim):
    kw, shape, tile, offset = VALID[dim]
    jm, v, pm = _pair(kw, shape[:1] + shape[2:] + shape[1:2], 7)
    inp = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    out_spatial = tuple(s - 2 * o for s, o in zip(shape[2:], offset))
    for kwp in ({}, dict(tile_shape=tile)):
        ref = JaxPredictor(jm, v, offset="auto", **kwp).predict(inp)
        pr = Predictor(pm, offset="auto", **kwp)
        out = pr.predict(inp)
        assert pr._offset_by_rank[len(shape)] == offset
        assert pr.offset is None
        assert out.shape == (1, 2) + out_spatial
        _close(out, ref)
        # The second request reuses the cached offset.
        assert np.array_equal(pr.predict(inp), out)
        assert np.array_equal(
            Predictor(pm, offset=offset, **kwp).predict(inp), out)


def test_out_shape_gives_an_unbatched_input_its_axes(m3d, m2d):
    for jm, v, pm, inp, out_shape in (
            m3d + ((1, 2, 4, 16, 16),),
            m2d[:3] + (m2d[3][:1], (1, 2, 16, 16))):
        unbatched = inp[0, 0] if inp.ndim == 5 else inp[0]   # 3 axes
        ref = JaxPredictor(jm, v, out_shape=out_shape).predict(unbatched)
        out = Predictor(pm, out_shape=out_shape).predict(unbatched)
        assert out.shape == out_shape
        _close(out, ref)


def test_transform_matches_jax(m3d):
    jm, v, pm, vol = m3d
    ref = JaxPredictor(jm, v, transform=JaxNormalize(0.3, 1.7),
                       **TILED_3D).predict(vol)
    out = Predictor(pm, transform=Normalize(0.3, 1.7),
                    **TILED_3D).predict(vol)
    _close(out, ref)
    assert not np.allclose(out, Predictor(pm, **TILED_3D).predict(vol))


def test_phase_times_and_verbose_logs(m3d, port_log):
    jm, v, pm, vol = m3d
    jp = JaxPredictor(jm, v, collect_phase_times=True, **TILED_3D)
    jp.predict(vol)
    pr = Predictor(pm, collect_phase_times=True, verbose=True, **TILED_3D)
    with port_log.at_level(logging.INFO, logger="elektronn3_tpu_torch"):
        out = pr.predict(vol)
    assert set(pr.last_phase_times) == set(jp.last_phase_times) == {
        "h2d", "compute", "d2h", "host_assemble", "device_call",
        "host_scatter"}
    assert all(t >= 0 for t in pr.last_phase_times.values())
    assert "MVox/s" in port_log.text and "tiled_apply:" in port_log.text
    whole = Predictor(pm, collect_phase_times=True)
    whole.predict(vol)
    assert set(whole.last_phase_times) == {"h2d", "compute", "d2h"}
    assert Predictor(pm, **TILED_3D).last_phase_times is None
    assert np.array_equal(pr.predict_proba(vol), out)


def test_model_from_a_port_file_and_as_a_callable(m3d, tmp_path):
    _, _, pm, vol = m3d
    ref = Predictor(pm, **TILED_3D).predict(vol)
    path = str(tmp_path / "model_final.pt")
    save_model(pm, path)
    assert np.array_equal(
        Predictor(path, device="cpu", **TILED_3D).predict(vol), ref)
    assert np.array_equal(Predictor(lambda x: pm(x), device="cpu",
                                    out_channels=2, **TILED_3D).predict(vol),
                          ref)


@pytest.mark.parametrize("name", ["model.e3tpu", "model.stablehlo"])
def test_jax_model_files_raise(tmp_path, name):
    with pytest.raises(ValueError, match=r"model\*\.pt"):
        Predictor(str(tmp_path / name), device="cpu")


def _write_checkpoint(src, kind, path):
    """A reference-style checkpoint of ``src``'s weights; returns what
    the port's Predictor takes (the path, or the dict itself)."""
    sd = src.state_dict()
    if kind == "bundle":
        torch.save({"model_state_dict": {"module." + k: t
                                         for k, t in sd.items()},
                    "optimizer_state_dict": {}}, path)
        return path
    if kind == "bare":
        torch.save(sd, path)
        return dict(sd)
    if kind == "pickled":
        torch.save(src, path)
        return path
    # TorchScript: the library plan traces (the kernel ops are Python).
    lib = UNet(device="cpu", pallas_flat=False,
               **{k: getattr(src, k) for k in ("in_channels",
                                              "out_channels", "n_blocks",
                                              "start_filts", "planar_blocks",
                                              "full_norm")})
    lib.load_state_dict(sd)
    torch.jit.save(torch.jit.trace(lib.eval(), torch.zeros(1, 4, 16, 16, 1)),
                   path)
    return path


@pytest.mark.parametrize("kind, full_norm", [
    ("bundle", True), ("bare", True), ("pickled", True), ("pts", True),
    ("bundle", False)])
def test_reference_checkpoint_matches_jax(kind, full_norm, tmp_path):
    kw = dict(KW, full_norm=full_norm)
    jm, _, src = _pair(kw, (1, 4, 16, 16, 1), 11)
    vol = np.random.default_rng(4).normal(size=(1, 1, 4, 16, 16)).astype(
        np.float32)
    path = str(tmp_path / ("model.pts" if kind == "pts" else "state.pth"))
    state = _write_checkpoint(src, kind, path)
    ref = JaxPredictor(jm, state=path, **TILED_3D).predict(vol)
    dst = UNet(device="cpu", generator=torch.Generator().manual_seed(9),
               **kw)
    out = Predictor(dst, state=state, **TILED_3D).predict(vol)
    _close(out, ref)
    assert np.array_equal(out, Predictor(src, **TILED_3D).predict(vol))
    if not full_norm:
        assert "down_convs.0.norm1.weight" in dst.state_dict()
        assert "down_convs.0.norm0.weight" not in dst.state_dict()


def test_strict_import_raises_and_lenient_import_keeps(m3d, port_log):
    pm = m3d[2]
    sd = dict(pm.state_dict())
    bad = dict(sd, **{"conv_final.weight": torch.zeros(3, 32, 1, 1, 1)})
    with pytest.raises(ValueError, match="conv_final.weight: shape"):
        load_torch_state_dict(bad, pm)
    missing = {k: t for k, t in sd.items() if k != "conv_final.bias"}
    with pytest.raises(ValueError, match="conv_final.bias missing"):
        load_torch_state_dict(missing, pm)
    extra = dict(sd, **{"up_convs.0.attention.psi.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not in the model"):
        load_torch_state_dict(extra, pm)
    with port_log.at_level(logging.WARNING, logger="elektronn3_tpu_torch"):
        kept = load_torch_state_dict(missing, pm, strict=False)
    assert "conv_final.bias missing" in port_log.text
    assert torch.equal(kept["conv_final.bias"], sd["conv_final.bias"])


class _Patches(torch.utils.data.Dataset):
    def __init__(self, shape, out):
        self.shape, self.out = shape, out

    def __len__(self):
        return 2

    def __getitem__(self, i):
        g = np.random.default_rng(i)
        return {"inp": g.normal(size=self.shape).astype(np.float32),
                "target": g.integers(0, 2, size=self.out).astype(np.int64)}


def test_trainer_preview_offset_reaches_the_predictor(tmp_path):
    """The preview of a valid-conv model with ``preview_offset`` is the
    tiled Predictor's with that offset; an offset the model does not
    shrink by fails in the preview."""
    kw, shape, tile, offset = VALID[3]
    model = UNet(device="cpu", **kw)
    batch = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    ref = Predictor(model, tile_shape=tile, offset=offset).predict(batch)
    tr = Trainer(model, ploss.CEDiceLoss(), train_dataset=_Patches(
        shape[1:], (8, 16, 16)), save_root=str(tmp_path), exp_name="off",
        enable_tensorboard=False, preview_batch=batch,
        preview_tile_shape=tile, preview_offset=offset)
    out = tr._run_preview_inference()
    assert out.shape == (1, 2, 8, 16, 16)
    assert np.array_equal(out, ref)


def test_inference_example_runs_on_the_cpu(m3d, tmp_path, monkeypatch):
    """``examples/inference_h5_torch.py`` on a (4, 16, 16) HDF5 volume
    with a port model file: its uint8 map is the tiled Predictor's
    foreground probability (normalized input) times 255."""
    import h5py

    _, _, pm, vol = m3d
    raw = 155.3 + 41.8 * vol[0, 0]
    with h5py.File(tmp_path / "raw.h5", "w") as f:
        f.create_dataset("raw", data=raw)
    save_model(pm, str(tmp_path / "model.pt"))
    monkeypatch.setattr(sys, "argv", [
        "inference_h5_torch.py", str(tmp_path / "model.pt"),
        str(tmp_path / "raw.h5"), "--device", "cpu", "--tile", "2", "8",
        "8", "--overlap", "1", "4", "4", "--augmentations", "2"])
    runpy.run_path(EXAMPLE, run_name="__main__")
    with h5py.File(tmp_path / "raw_pred.h5", "r") as f:
        pred = f["pred"][()]
    ref = Predictor(pm, tile_shape=(2, 8, 8), overlap_shape=(1, 4, 4),
                    transform=Normalize(155.291411, 41.812504),
                    augmentations=2).predict(raw[None, None])
    assert pred.dtype == np.uint8 and pred.shape == raw.shape
    assert np.array_equal(pred, (ref[0, 1] * 255).astype(np.uint8))
