"""``examples/validate_torch.py`` (the port's offline validation) against
the JAX package's ``examples/validate.py`` path, on the CPU, and the
port's ``floatX``.

A small JAX UNet (n_blocks=2, start_filts=4, planar L0, batch norm with
random running statistics, float32, ``pallas_flat=False``: XLA only)
goes through the converter into the port's UNet, which ``save_model``
writes. Two (48, 96, 96) cubes of membrane-like raw data and barrier
labels are written as raw_{i}.h5 / barrier_int16_{i}.h5. The script's
``valid_dataset`` and the port's seeded ``DataLoader`` give 2 batches of
2 (44, 88, 88) patches, which both models see:

- the port's ``validate()`` equals JAX's ``training.metrics`` Accuracy,
  Precision, Recall, DSC and IoU on JAX's logits within 1e-4, and the
  port's argmax equals JAX's at every voxel whose JAX logit margin
  exceeds 1e-4;
- the script, run twice with ``--device cpu -n 2 -b 2`` in subprocesses,
  prints JAX's lines with those values, the same both times;
- without ``--device`` on a machine with no card the script raises the
  port's "no CUDA device" error, and does not run on the CPU;
- ``elektronn3_tpu_torch.floatX`` is numpy's float32, JAX's ``floatX``,
  and the transforms' ``floatX``.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elektronn3_tpu
import elektronn3_tpu_torch
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.training import metrics as jmetrics
from elektronn3_tpu_torch.data import DataLoader
from elektronn3_tpu_torch.data.transforms import transforms as ptransforms
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.training import load_model, save_model
from test_torch_unet import _randomize

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "examples" / "validate_torch.py"
KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=4,
          planar_blocks=(0,), normalization="batch")
CUBE = (48, 96, 96)
PATCH = (44, 88, 88)
N_BATCHES, BATCH = 2, 2
METRIC_TOL = 1e-4
MARGIN = 1e-4
JAX_METRICS = {"val_accuracy": jmetrics.Accuracy,
               "val_precision": jmetrics.Precision,
               "val_recall": jmetrics.Recall, "val_DSC": jmetrics.DSC,
               "val_IoU": jmetrics.IoU}


def _script():
    spec = importlib.util.spec_from_file_location("validate_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cube(rng):
    """Smoothed noise as raw data around 155 and int16 barrier labels
    where its ridges are (both classes in every patch)."""
    small = rng.normal(size=(CUBE[0] // 4, CUBE[1] // 8, CUBE[2] // 8))
    vol = np.repeat(np.repeat(np.repeat(small, 4, 0), 8, 1), 8, 2)
    for ax in range(3):
        vol = (vol + np.roll(vol, 1, ax) + np.roll(vol, -1, ax)) / 3.0
    lab = (np.abs(vol) < 0.25).astype(np.int16)
    raw = (155.0 + 41.0 * vol + 5.0 * rng.normal(size=CUBE)).astype(
        np.float32)
    return raw, lab


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("neuro_data")
    rng = np.random.default_rng(11)
    for i in range(2):
        raw, lab = _cube(rng)
        with h5py.File(root / f"raw_{i}.h5", "w") as f:
            f.create_dataset("raw", data=raw)
        with h5py.File(root / f"barrier_int16_{i}.h5", "w") as f:
            f.create_dataset("lab", data=lab)
    script = _script()
    ds = script.valid_dataset(str(root), [0, 1], N_BATCHES * BATCH)
    batches = list(DataLoader(ds, batch_size=BATCH, num_workers=0,
                              shuffle=False, seed=0))

    jm = junet.UNet(pallas_flat=False, **KW)
    v = _randomize(junet.init_unet(jm, (BATCH, *PATCH, 1)), rng)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    # The head's class-1 bias at the first batch's median margin, so
    # that the random model predicts both classes.
    y0 = np.asarray(fwd(v, jnp.asarray(batches[0]["inp"])))
    bias = np.asarray(v["params"]["conv_final"]["bias"]).copy()
    bias[1] -= np.median(y0[..., 1] - y0[..., 0])
    v["params"]["conv_final"]["bias"] = jnp.asarray(bias)
    y_jax = np.concatenate([np.asarray(fwd(v, jnp.asarray(b["inp"])))
                            for b in batches])
    port = UNet(device="cpu", **KW)
    port.load_state_dict(state_dict_from_flax(jax.device_get(v), port))
    model_path = root / "model.pt"
    save_model(port, str(model_path))
    target = np.concatenate([np.asarray(b["target"]) for b in batches])
    loaded, _ = load_model(str(model_path), device="cpu")
    outs = []   # the logits validate() counts
    loaded.register_forward_hook(lambda m, a, out: outs.append(out.numpy()))
    vals = script.validate(loaded, batches, torch.device("cpu"))
    y_port = np.concatenate(outs)
    return dict(root=root, model_path=model_path, script=script,
                y_jax=y_jax, y_port=y_port, target=target, vals=vals)


def test_validate_matches_jax_metrics(runs):
    y_jax, y_port, target = runs["y_jax"], runs["y_port"], runs["target"]
    assert y_jax.shape == y_port.shape == (N_BATCHES * BATCH, *PATCH, 2)
    assert set(np.unique(target)) == {0, 1}
    sure = np.abs(y_jax[..., 1] - y_jax[..., 0]) > MARGIN
    pred_jax, pred_port = y_jax.argmax(-1), y_port.argmax(-1)
    assert 0 < pred_jax.mean() < 1, "a one-class prediction"
    assert (pred_port == pred_jax)[sure].all(), int(
        ((pred_port != pred_jax) & sure).sum())
    vals = runs["vals"]
    assert list(vals) == list(JAX_METRICS)
    for name, ev in JAX_METRICS.items():
        want = float(ev()(target, y_jax))
        assert np.isfinite(want) and 0 < want < 100, (name, want)
        assert abs(vals[name] - want) <= METRIC_TOL, (name, vals[name],
                                                      want)


def test_script_prints_jax_lines_and_repeats(runs):
    cmd = [sys.executable, str(SCRIPT), str(runs["model_path"]), "-d",
           str(runs["root"]), "-i", "0", "1", "-n", str(N_BATCHES), "-b",
           str(BATCH), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.splitlines())
    want = [f"Validated on {N_BATCHES * BATCH} patches:"] + [
        f"  {name}: {v:.2f}" for name, v in runs["vals"].items()]
    assert outs[0] == want
    assert outs[1] == outs[0]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is the card there")
def test_script_without_device_needs_the_card(runs, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        str(SCRIPT), str(runs["model_path"]), "-d", str(runs["root"]),
        "-i", "0", "-n", "1", "-b", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runs["script"].main()


def test_floatx_is_one_object():
    assert elektronn3_tpu_torch.floatX is np.float32 is elektronn3_tpu.floatX
    assert ptransforms.floatX is elektronn3_tpu_torch.floatX
    assert "floatX" in elektronn3_tpu_torch.__all__
