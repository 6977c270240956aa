"""The deployment artifact: the port's ``export_program``/``load_program``
(``torch.export``, ``.pt2``) against the JAX package's
``export_stablehlo``/``load_stablehlo``, on the CPU in float32.

- JAX parity: the same weights, drawn with numpy into JAX's tree and
  converted flax->torch, go through both exports and both loads, for a
  3D UNet (n_blocks=2, start_filts=32, planar L0) built with
  ``pallas_flat=True`` on both sides under 'batch' and 'batchp' (JAX's
  Pallas batch norm in interpret mode), and a 2D UNet. Both exports
  drop their kernel plan: JAX applies its variables to a
  ``pallas_flat=False`` clone, the port exports a copy on the library
  plan. So JAX takes the variables in its XLA executor's tree: under
  'batchp' its fused tree names the kernel levels' norms
  ``BatchNorm_<n>``, which the clone's ``PallasBatchNorm_<n>`` do not
  find (flax's ScopeParamNotFoundError). Tolerance: the two programs
  within 5e-6 of the output's scale (two frameworks' float32
  convolutions and norms, summed in other orders; 4.6e-7 to 7.1e-7
  measured on the three cases; JAX's own round-trip test,
  tests/test_training.py, holds its program to its eager forward at
  1e-5); the port's program against the port's eager forward on the
  library plan bit for bit.
- The graph: a 'batchp' program holds one ``e3tpu.bn_normalize`` node
  (K9) per ``PallasBatchNorm``, a 'batch' program none; the copy that is
  exported plans every level on the library; the file keeps no example
  input.
- The op: ``torch.library.opcheck`` on ``e3tpu::bn_normalize``.
- Isolation: a new interpreter loads a 'batchp' program with ``torch``
  and ``ops.pallas_bn`` alone and gives the same outputs.
- The live model: its mode, ``pallas_flat``, parameters, running
  statistics and a following training step are what they were.
- The Trainer writes ``model_final.pt2`` and ``model_best.pt2`` from
  ``example_input``; ``Predictor(path)`` gives ``Predictor(model)``'s
  output on the library plan, pads a short last batch, names both
  shapes when the tile does not fit the program, and refuses a device
  other than the program's.
- ``select_mpl_backend`` where matplotlib is installed.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elektronn3_tpu_torch
from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.training.trainer import export_stablehlo, load_stablehlo
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.models import unet as unet_mod
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.modules.pallas_norm import PallasBatchNorm
from elektronn3_tpu_torch.ops import pallas_bn
from elektronn3_tpu_torch.training import (
    Trainer, export_program, load_program, train_step)

KW = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
          planar_blocks=(0,))
SHAPE = (1, 4, 16, 16, 1)
KW_2D = dict(in_channels=1, out_channels=2, n_blocks=2, start_filts=32,
             dim=2)
SHAPE_2D = (1, 16, 16, 1)
PARITY_TOL = 5e-6       # the two programs, of max |JAX's output|
CASES = {"3d-batch": (dict(KW, normalization="batch"), SHAPE),
         "3d-batchp": (dict(KW, normalization="batchp"), SHAPE),
         "2d-batch": (dict(KW_2D, normalization="batch"), SHAPE_2D)}


def _numpy_variables(jm, shape, seed):
    """JAX's XLA-executor tree of ``jm`` filled from a numpy seed: conv
    kernels at 1 / sqrt(fan-in), biases and norm shifts about 0.1, norm
    scales about 1, running means about 0.1, running variances in
    [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda: junet.init_unet(
        jm.clone(pallas_flat=False), shape))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        s = leaf.shape
        if "kernel" in name:
            v = rng.normal(size=s) / np.sqrt(np.prod(s[:-1]))
        elif "var" in name:
            v = 0.5 + rng.random(s)
        elif "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=s)
        else:
            v = 0.1 * rng.normal(size=s)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _kinds_spy(monkeypatch):
    """The plans that ``UNet.level_kinds`` returns."""
    seen = []
    real = unet_mod.UNet.level_kinds

    def spy(self, shape):
        kinds = real(self, shape)
        seen.append(list(kinds))
        return kinds
    monkeypatch.setattr(unet_mod.UNet, "level_kinds", spy)
    return seen


def _case(name, tmp, seed):
    kw, shape = CASES[name]
    jm = junet.UNet(pallas_flat=True, **kw)
    v = _numpy_variables(jm, shape, seed)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    export_stablehlo(jm, v, shape, str(tmp / f"{name}.stablehlo"))
    y_jax = np.asarray(load_stablehlo(str(tmp / f"{name}.stablehlo"))(
        jnp.asarray(x)))
    pm = UNet(device="cpu", pallas_flat=True, **kw)
    pm.load_state_dict(state_dict_from_flax(v, pm))
    path = str(tmp / f"{name}.pt2")
    loaded = []
    with pytest.MonkeyPatch.context() as mp:
        kinds = _kinds_spy(mp)
        export_program(pm, shape, path)
        load = torch.export.load
        mp.setattr(torch.export, "load",
                   lambda *a, **k: loaded.append(load(*a, **k)) or loaded[-1])
        program = load_program(path)
    with torch.inference_mode():
        y = program(torch.from_numpy(x)).numpy()
        library = copy.deepcopy(pm)
        library.pallas_flat = False
        y_eager = library.eval()(torch.from_numpy(x)).numpy()
    return dict(y_jax=y_jax, y=y, y_eager=y_eager, kinds=kinds,
                example_inputs=loaded[0].example_inputs, path=path, x=x,
                model=pm, program=program, plan=pm.level_kinds(shape))


_LOAD_ALONE = """
import sys, numpy as np, torch
import elektronn3_tpu_torch.ops.pallas_bn
m = torch.export.load(sys.argv[1]).module()
y = m(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], y.detach().numpy())
bad = [k for k in sys.modules if k.startswith(tuple(
    'elektronn3_tpu_torch.' + p for p in ('models', 'training', 'inference')))]
assert not bad, bad
"""


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The three cases, and a new interpreter that loads and runs the
    'batchp' program with ``torch`` and ``ops.pallas_bn`` alone, started
    here so that it runs beside the tests before its own (the last)."""
    tmp = tmp_path_factory.mktemp("export")
    out = {name: _case(name, tmp, 10 * i) for i, name in enumerate(CASES)}
    c = out["3d-batchp"]
    np.save(tmp / "x.npy", c["x"])
    root = os.path.dirname(os.path.dirname(elektronn3_tpu_torch.__file__))
    c["y_alone"] = str(tmp / "y.npy")
    c["alone"] = subprocess.Popen(
        [sys.executable, "-c", _LOAD_ALONE, c["path"], str(tmp / "x.npy"),
         c["y_alone"]], env=dict(os.environ, PYTHONPATH=root),
        stderr=subprocess.PIPE, text=True)
    yield out
    c["alone"].kill()
    c["alone"].wait()


@pytest.mark.parametrize("name", list(CASES))
def test_program_matches_jax_program(cases, name):
    c = cases[name]
    assert c["y"].shape == c["y_jax"].shape == CASES[name][1][:-1] + (2,)
    scale = np.abs(c["y_jax"]).max()
    assert np.abs(c["y"] - c["y_jax"]).max() <= PARITY_TOL * scale
    assert np.array_equal(c["y"], c["y_eager"])


@pytest.mark.parametrize("name", list(CASES))
def test_export_drops_the_kernel_plan(cases, name):
    """The model plans L0 on the kernels; the exported copy plans every
    level on the library. The file keeps no example input."""
    c = cases[name]
    assert c["plan"] == ["kernels", "library"]
    assert c["kinds"] and all(k == ["library", "library"]
                              for k in c["kinds"])
    assert c["example_inputs"] is None


@pytest.mark.parametrize("name,norms", [("3d-batch", 0), ("3d-batchp", 7),
                                        ("2d-batch", 0)])
def test_batchp_program_holds_k9_per_norm(cases, name, norms):
    c = cases[name]
    ops = [n for n in c["program"].graph.nodes if n.op == "call_function"
           and str(n.target).startswith("e3tpu.")]
    assert sum(isinstance(m, PallasBatchNorm)
               for m in c["model"].modules()) == norms
    assert len(ops) == norms
    assert all(str(n.target) == "e3tpu.bn_normalize.default" for n in ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_normalize_op_passes_opcheck(dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(37, 32)).astype(np.float32))
    scale, shift = (torch.from_numpy(rng.normal(size=32).astype(np.float32))
                    for _ in range(2))
    args = (x.to(dtype), scale, shift)
    result = torch.library.opcheck(torch.ops.e3tpu.bn_normalize.default,
                                   args)
    assert set(result.values()) == {"SUCCESS"}, result
    assert torch.equal(torch.ops.e3tpu.bn_normalize(*args),
                       pallas_bn.bn_normalize_plain(*args))


def _small(seed):
    """KW's UNet at start_filts=4: what the export copies and what the
    Predictor does with a program do not depend on the width."""
    torch.manual_seed(seed)
    return UNet(device="cpu", pallas_flat=True, normalization="batch",
                **dict(KW, start_filts=4))


def test_export_leaves_the_live_model_as_it_was(tmp_path):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 4, 16, 16, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 2, size=(2, 4, 16, 16)))
    crit = ploss.CEDiceLoss(1.0, 1.0)
    a, b = _small(1), _small(1)
    train_step(a, crit, torch.optim.Adam(a.parameters(), 1e-3), x, y)
    train_step(b, crit, torch.optim.Adam(b.parameters(), 1e-3), x, y)
    before = copy.deepcopy(a.state_dict())
    export_program(a, SHAPE, str(tmp_path / "m.pt2"))
    assert a.training and a.pallas_flat is True
    after = a.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    la = train_step(a, crit, torch.optim.SGD(a.parameters(), 1e-2), x, y)
    lb = train_step(b, crit, torch.optim.SGD(b.parameters(), 1e-2), x, y)
    assert torch.equal(la, lb)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


class _Patches(torch.utils.data.Dataset):
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n, 1) + SHAPE[1:-1]).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + SHAPE[1:-1])

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    model = _small(2)
    tr = Trainer(model, ploss.CEDiceLoss(1.0, 1.0),
                 train_dataset=_Patches(2, 0), valid_dataset=_Patches(2, 1),
                 batch_size=2, save_root=str(root), exp_name="run",
                 example_input=np.zeros(SHAPE, np.float32),
                 enable_tensorboard=False)
    tr.run(max_steps=1)
    return tr


@pytest.mark.parametrize("suffix", ["_final", "_best"])
def test_trainer_writes_programs_the_predictor_serves(trained, suffix):
    path = os.path.join(trained.save_path, f"model{suffix}.pt2")
    assert os.path.isfile(path)
    kw = dict(tile_shape=(2, 8, 8), overlap_shape=(1, 4, 4))
    vol = np.random.default_rng(4).normal(size=(1, 1, 4, 16, 24)).astype(
        np.float32)
    got = Predictor(path, **kw).predict(vol)
    if suffix == "_final":
        library = copy.deepcopy(trained.model)
        library.pallas_flat = False
        # one tile a call, as the batch-1 program takes them (a call's
        # batch size changes the CPU convolutions' rounding)
        ref = Predictor(library, batch_size=1, **kw).predict(vol)
        assert np.array_equal(got, ref)
    assert got.shape == (1, 2, 4, 16, 24) and np.isfinite(got).all()


def test_program_predictor_pads_a_short_batch_and_checks_shapes(tmp_path):
    """A batch-2 program under 5 tiles at batch 4: the Predictor's second
    call holds 1 tile, which the program sees padded to 2; a tile of
    another shape raises, naming both shapes, and so does another
    device."""
    model = _small(3).eval()
    path = str(tmp_path / "b2.pt2")
    export_program(model, (2, 4, 16, 16, 1), path)
    vol = np.random.default_rng(6).normal(size=(1, 1, 2, 8, 40)).astype(
        np.float32)
    kw = dict(tile_shape=(2, 8, 8), overlap_shape=(1, 4, 4))
    calls = []
    pred = Predictor(path, batch_size=4, **kw)
    pred.model.module.register_forward_pre_hook(
        lambda m, a: calls.append(tuple(a[0].shape)))
    got = pred.predict(vol)
    model.pallas_flat = False
    # the model's last call holds 1 tile, the program's 2: the CPU
    # convolutions round by the batch, a few float32 ulps
    ref = Predictor(model, batch_size=2, **kw).predict(vol)
    assert np.abs(got - ref).max() <= 1e-6
    assert calls == [(2, 4, 16, 16, 1)] * 3
    wrong = Predictor(path, tile_shape=(2, 8, 8), overlap_shape=(0, 4, 4))
    assert wrong.batch_size == 2
    with pytest.raises(ValueError, match=r"\(2, 4, 16, 16, 1\).*"
                       r"\(\d+, 2, 16, 16, 1\)"):
        wrong.predict(vol)
    with pytest.raises(ValueError, match="runs on cpu.*not on cuda"):
        Predictor(path, device="cuda", **kw)


def test_select_mpl_backend(monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    monkeypatch.delenv("DISPLAY", raising=False)
    elektronn3_tpu_torch.select_mpl_backend()
    assert matplotlib.get_backend().lower() == "agg"


def test_program_loads_without_the_model_code(cases):
    """A new interpreter with ``torch`` and ``ops.pallas_bn`` alone (the
    op's registration) runs the 'batchp' program (started by ``cases``;
    last in the file, so that it has run beside the other tests)."""
    c = cases["3d-batchp"]
    _, err = c["alone"].communicate(timeout=120)
    assert c["alone"].returncode == 0, err
    assert np.array_equal(np.load(c["y_alone"]), c["y"])
