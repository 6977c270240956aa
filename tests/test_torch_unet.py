"""The port's UNet (elektronn3_tpu_torch) against the JAX UNet.

The headline structure (n_blocks=4, start_filts=32, planar L0, batch norm
with random running statistics) at input (1, 4, 12, 16, 1) runs the JAX
eval forward with ``pallas_flat=True`` through exactly the Pallas
kernels the port replaces (rows 1 to 7 of the port's kernel table, in
interpret mode) plus the XLA head: L2 declines (H=3 is odd) and L3
(C=256) has no kernel. The port, given the same parameters through
``state_dict_from_flax``, runs its kernel ops' plain versions on the
CPU and must match both JAX executors at atol 2e-4 (the fused-vs-XLA
tolerance of tests/test_flat64.py). float32.
"""

import logging
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import unet as junet
from elektronn3_tpu.models.torch_import import load_torch_state_dict
from elektronn3_tpu_torch.models import UNet, state_dict_from_flax
from elektronn3_tpu_torch.ops import fused

SHAPE = (1, 4, 12, 16, 1)
KW = dict(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
          planar_blocks=(0,), normalization="batch")
JAX_ROWS = {"conv_bnact_flat", "pool_bnact_flat_skip", "conv1_bnstats_flat",
            "conv3_bnact_flat64", "pool222_bnact_flat64_skip",
            "upconv222_bn_flat64", "upconv122_from_flat64",
            "head_bnact_from_flat"}
# Helpers the JAX forward also calls: shape planning and the lane fold
# of conv1's statistics side output (no kernel).
JAX_PLANNING = {"conv64_vmem_bytes", "bwd_ki_split", "flat_geometry",
                "flat_geometry64", "dense_rows_ok", "fold_lane_stats",
                "fold_lane_stats64"}


def _randomize(variables, rng):
    """Non-trivial parameters: random conv biases, BN scales of both
    signs, shifted means, variances in [0.5, 1.5]."""
    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "keys"):
                out[k] = walk(v, kind)
                continue
            v = np.asarray(v)
            if kind == "params" and k == "bias":
                v = 0.1 * rng.normal(size=v.shape)
            elif k == "scale":
                v = rng.normal(size=v.shape)
            elif k == "mean":
                v = 0.2 * rng.normal(size=v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, size=v.shape)
            out[k] = jnp.asarray(v, jnp.float32)
        return out
    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def _jax_entry_points():
    """The executor functions models/unet.py references, by module
    alias."""
    src = Path(junet.__file__).read_text()
    mods = {"_ffu": junet._ffu, "_ff64": junet._ff64, "_fc": junet._fc}
    return {(alias, name) for alias, name in
            re.findall(r"\b(_ffu|_ff64|_fc)\.([a-z]\w*)", src)
            if callable(getattr(mods[alias], name, None))}, mods


@pytest.fixture(scope="module")
def jax_runs():
    """Variables, input, and the JAX eval outputs of both executors,
    with the executor ops the pallas_flat=True forward called."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=SHAPE).astype(np.float32)
    m_fused = junet.UNet(pallas_flat=True, **KW)
    m_xla = junet.UNet(pallas_flat=False, **KW)
    v = _randomize(junet.init_unet(m_xla, SHAPE), rng)
    entry, mods = _jax_entry_points()
    called = set()

    def spy(name, fn):
        def wrapped(*a, **k):
            called.add(name)
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for alias, name in entry:
            mp.setattr(mods[alias], name, spy(name, getattr(mods[alias],
                                                            name)))
        y_fused = np.asarray(m_fused.apply(v, jnp.asarray(x), train=False))
    y_xla = np.asarray(m_xla.apply(v, jnp.asarray(x), train=False))
    return v, x, y_fused, y_xla, called


@pytest.fixture(scope="module")
def port_model(jax_runs):
    v = jax_runs[0]
    m = UNet(device="cpu", **KW).eval()
    m.load_state_dict(state_dict_from_flax(jax.device_get(v), m))
    return m


def test_jax_fused_forward_runs_ported_rows(jax_runs):
    assert jax_runs[4] - JAX_PLANNING == JAX_ROWS


@pytest.mark.parametrize("executor", ["pallas_flat=True", "pallas_flat=False"])
def test_port_unet_matches_jax(jax_runs, port_model, executor):
    _, x, y_fused, y_xla, _ = jax_runs
    ref = y_fused if executor == "pallas_flat=True" else y_xla
    with torch.no_grad():
        y = port_model(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape and y.dtype == np.float32
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


def test_port_plan_goes_through_kernel_ops(jax_runs, port_model,
                                           monkeypatch):
    calls = {}
    for name in ("conv_bnact", "pool_bnact", "upconv_bnact", "head_bnact"):
        fn = getattr(fused, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(fused, name, counted)
    assert port_model.plan(SHAPE) == [True, True, False, False]
    with torch.no_grad():
        port_model(torch.from_numpy(jax_runs[1]))
    # L0, L1 and their decoder levels: 8 convs, 2 pools, 2 upconvs.
    assert calls == {"conv_bnact": 8, "pool_bnact": 2, "upconv_bnact": 2,
                     "head_bnact": 1}


@pytest.mark.parametrize("w,plan,reason", [
    (14, [True, False, False, False], "level 1 (C=64, 4x6x7): odd level "
     "shape H=6, W=7"),
    (15, [False, True, False, False], "level 0 (C=32, 4x12x15): odd level "
     "shape H=12, W=15")])
def test_port_declined_level_matches_jax(jax_runs, port_model, caplog, w,
                                         plan, reason):
    """A level with an odd shape runs plain torch with a logged reason.
    W=14: the L0 kernel decoder takes the dense output of the plain L1
    decoder. W=15: the plain L0 decoder materializes the carried
    activation of the L1 kernel decoder and crops (autocrop)."""
    v = jax_runs[0]
    x = np.random.default_rng(w).normal(size=(1, 4, 12, w, 1)) \
        .astype(np.float32)
    ref = np.asarray(junet.UNet(pallas_flat=False, **KW).apply(
        v, jnp.asarray(x), train=False))
    pkg_logger = logging.getLogger("elektronn3_tpu_torch")  # no propagation
    pkg_logger.addHandler(caplog.handler)
    try:
        assert port_model.plan(x.shape) == plan
    finally:
        pkg_logger.removeHandler(caplog.handler)
    assert any(reason in r.getMessage() for r in caplog.records)
    with torch.no_grad():
        y = port_model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(y - ref)) <= 2e-4, np.max(np.abs(y - ref))


def test_port_bf16_forward_tracks_f32(jax_runs, port_model):
    m16 = UNet(dtype=torch.bfloat16, device="cpu", **KW).eval()
    m16.load_state_dict(port_model.state_dict())
    x = torch.from_numpy(jax_runs[1])
    with torch.no_grad():
        y32 = port_model(x)
        y16 = m16(x)
    assert y16.dtype == torch.bfloat16
    scale = float(y32.abs().max())
    assert float((y16.float() - y32).abs().max()) <= 5e-2 * scale


def test_converter_round_trip_is_exact(jax_runs, port_model):
    v = jax.device_get(jax_runs[0])
    back = load_torch_state_dict(state_dict_from_flax(v, port_model),
                                 junet.UNet(pallas_flat=False, **KW),
                                 variables=v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        assert np.array_equal(np.asarray(a), np.asarray(flat_b[path])), path


def test_seeded_init_is_reproducible():
    def init(seed):
        return UNet(generator=torch.Generator().manual_seed(seed),
                    device="cpu", **KW).state_dict()
    a, b, c = init(5), init(5), init(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["down_convs.1.conv1.weight"],
                           c["down_convs.1.conv1.weight"])
    w = a["down_convs.1.conv2.weight"]       # (64, 64, 3, 3, 3)
    std = (2.0 / ((64 + 64) * 27)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert not any(float(a[k].abs().max()) for k in a
                   if k.endswith("conv1.bias"))


def test_port_package_never_imports_jax():
    pkg = Path(__file__).resolve().parent.parent / "elektronn3_tpu_torch"
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|"
                     r"elektronn3_tpu)(\.|\s|$)", re.M)
    for f in pkg.rglob("*.py"):
        assert not bad.search(f.read_text()), f
    code = ("import sys, elektronn3_tpu_torch.models, "
            "elektronn3_tpu_torch.inference, elektronn3_tpu_torch.ops.fused, "
            "elektronn3_tpu_torch.ops.flat_conv, "
            "elektronn3_tpu_torch.ops.pallas_conv, "
            "elektronn3_tpu_torch.ops.vup, "
            "elektronn3_tpu_torch.training, "
            "elektronn3_tpu_torch.training.metrics, "
            "elektronn3_tpu_torch.training.schedulers, "
            "elektronn3_tpu_torch.training.optim, "
            "elektronn3_tpu_torch.training.handlers, "
            "elektronn3_tpu_torch.training.plotting, "
            "elektronn3_tpu_torch.training.recalibration, "
            "elektronn3_tpu_torch.training.train_utils, "
            "elektronn3_tpu_torch.modules.loss, "
            "elektronn3_tpu_torch.data, "
            "elektronn3_tpu_torch.data.sources, "
            "elektronn3_tpu_torch.data.native, "
            "elektronn3_tpu_torch.data.coord_transforms, "
            "elektronn3_tpu_torch.data.transforms, "
            "elektronn3_tpu_torch.data.transforms.random, "
            "elektronn3_tpu_torch.data.transforms.transforms, "
            "elektronn3_tpu_torch.data.transforms.random_blurring, "
            "elektronn3_tpu_torch.data.utils, "
            "elektronn3_tpu_torch.data.cnndata, "
            "elektronn3_tpu_torch.data.pipeline, "
            "elektronn3_tpu_torch.data.warp, "
            "elektronn3_tpu_torch.data.device_pipeline;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'elektronn3_tpu')];"
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=pkg.parent, timeout=120)
    assert res.returncode == 0, res.stderr
