"""The model zoo of the port outside its parity matrix: saved and loaded,
served, inspected and trained through the port's entry points on the
CPU.

- ``save_model``/``load_model`` and ``Predictor(model=path)`` round-trip
  one model of each family (simple, UNet3dLite with its valid-conv
  offset, VNet, the 3D FCN, the 2D FCN, MSDNet, FC-DenseNet; the
  classifier through ``save_model`` alone: the Predictor is for dense
  outputs);
- ``model_utils``' ``num_params`` and ``find_first_conv`` against JAX's,
  its conv surgery, summary and receptive field;
- ``InferenceModel.predict_proba`` against the Predictor's softmax;
- ``PoolingError`` and the other ``ValueError`` s; every zoo model
  raising ``RuntimeError`` without a device on this CPU-only machine;
- ``train_step`` with a classifier's (N, n_classes) logits and with
  ``StackedConv2ScalarWithLatentAdd``'s two inputs;
- the zoo's files import neither JAX nor the JAX package.
"""

from __future__ import annotations

import ast
import os

import jax
import numpy as np
import pytest
import torch

import elektronn3_tpu_torch
from elektronn3_tpu import models as J
from elektronn3_tpu.models import model_utils as jmu
from elektronn3_tpu_torch import models as P
from elektronn3_tpu_torch.inference import Predictor
from elektronn3_tpu_torch.models import model_utils as pmu
from elektronn3_tpu_torch.models.base import InferenceModel, load_model
from elektronn3_tpu_torch.models.unet3d_lite import PoolingError
from elektronn3_tpu_torch.modules import CrossEntropyLoss, EvoNorm
from elektronn3_tpu_torch.training import save_model
from elektronn3_tpu_torch.training import load_model as load_saved
from elektronn3_tpu_torch.training.trainer import train_step

from _torch_zoo_common import _SMALL_TIRAMISU, randomize_

CPU = dict(device="cpu")

# family: (port model, channels-first request input)
FAMILIES = {
    "simple": (lambda: P.Simple3DNet(**CPU), (1, 1, 8, 8, 8)),
    "unet3d_lite": (lambda: P.UNet3dLite(**CPU), (1, 1, 26, 148, 148)),
    "vnet": (lambda: P.VNet(fac=4, **CPU), (1, 1, 16, 16, 16)),
    "fcn": (lambda: P.fcn8s(**CPU), (1, 1, 32, 32, 32)),
    "fcn_2d": (lambda: P.FCN8s(backbone="vgg11", **CPU), (1, 3, 32, 32)),
    "msdnet": (lambda: P.MSDNet(num_layers=4, volumetric=False, **CPU),
               (2, 1, 16, 16)),
    "tiramisu": (lambda: P.FCDenseNet(in_channels=1, n_classes=3,
                                      **_SMALL_TIRAMISU, **CPU),
                 (1, 1, 16, 16)),
}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)


def _predict_kw(name):
    if name == "unet3d_lite":
        # Tiles of the model's fixed input, overlapping by its offset.
        return dict(tile_shape=(22, 140, 140),
                    offset=P.UNet3dLite.offset, batch_size=2)
    return {}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_save_load_and_serve(name, tmp_path):
    factory, shape = FAMILIES[name]
    torch.manual_seed(0)
    m = factory()
    randomize_(m)
    path = str(tmp_path / "model.pt")
    save_model(m, path, info={"family": name})
    m2, info = load_saved(path, device="cpu")
    assert info == {"family": name} and type(m2) is type(m)
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k
    x = _x(shape)
    a = Predictor(m, **_predict_kw(name)).predict(x)
    b = Predictor(path, device="cpu", **_predict_kw(name)).predict(x)
    np.testing.assert_array_equal(a, b)
    if name == "unet3d_lite":
        assert a.shape == (1, 2, 14, 60, 60)
        # One tile by hand: the model's output of the crop it reads.
        with torch.no_grad():
            ref = torch.softmax(m.eval()(torch.as_tensor(
                x[:, :, :22, :140, :140]).movedim(1, -1)), -1)
        np.testing.assert_allclose(a[:, :, :10, :52, :52],
                                   ref.movedim(-1, 1).numpy(), atol=1e-5)
    else:
        assert a.shape == (shape[0], m.out_channels) + shape[2:]


@pytest.mark.parametrize("cls", ["StackedConv2Scalar",
                                 "StackedConv2ScalarWithLatentAdd"])
def test_classifier_save_load(cls, tmp_path):
    m = getattr(P, cls)(1, 5, **CPU)
    path = str(tmp_path / "model.pt")
    save_model(m, path)
    m2, _ = load_saved(path, device="cpu")
    assert (m2.in_channels, m2.n_classes) == (1, 5)
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k


def _jax_vars(jm, shape):
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda x: jm.init({"params": key}, x, train=False),
                          jax.ShapeDtypeStruct(shape, np.float32))


@pytest.mark.parametrize("jf,pf,shape", [
    (lambda: J.Simple3DNet(), lambda: P.Simple3DNet(**CPU), (1, 8, 8, 8, 1)),
    (lambda: J.fcn8s(), lambda: P.fcn8s(**CPU), (1, 32, 32, 32, 1)),
    (lambda: J.VNet(fac=4, relu=False), lambda: P.VNet(fac=4, relu=False,
                                                       **CPU),
     (1, 16, 16, 16, 1)),
    (lambda: J.MSDNet(num_layers=3, volumetric=False),
     lambda: P.MSDNet(num_layers=3, volumetric=False, **CPU), (1, 8, 8, 1)),
    (lambda: J.FCDenseNet(in_channels=1, n_classes=3, **_SMALL_TIRAMISU),
     lambda: P.FCDenseNet(in_channels=1, n_classes=3, **_SMALL_TIRAMISU,
                          **CPU), (1, 16, 16, 1)),
])
def test_model_utils_match_jax(jf, pf, shape):
    """``num_params`` and ``find_first_conv`` (the flax tree's order:
    keys sorted at each level) give JAX's count and leaf."""
    v = _jax_vars(jf(), shape)
    pm = pf()
    assert pmu.num_params(pm) == jmu.num_params(v)
    jpath = jmu.find_first_conv(None, v)
    ppath = pmu.find_first_conv(pm)
    assert ppath.rsplit(".", 1)[0].replace(".", "/") + "/kernel" == jpath


def test_model_utils_surgery_summary_receptive_field():
    m = P.Simple3DNet(**CPU)
    w0 = m.Conv_0.weight.detach().clone()
    pmu.change_conv1_input_channels(m, 1, 3)
    assert m.in_channels == 3 and m.Conv_0.weight.shape[1] == 3
    torch.testing.assert_close(m.Conv_0.weight[:, 2:3], w0)
    assert m(torch.zeros(1, 8, 8, 8, 3)).shape == (1, 8, 8, 8, 2)
    s = pmu.model_summary(m, (1, 8, 8, 8, 3))
    assert "Conv_0" in s and f"Total params: {pmu.num_params(m)}" in s
    rf = pmu.visualize_receptive_field(P.Simple3DNet(**CPU), (1, 9, 9, 9, 1))
    assert rf.shape == (9, 9, 9) and rf.max() > 0
    assert rf[0, 0, 0] == 0 and rf[4, 4, 4] > 0   # two 3^3 convs: radius 2


def test_inference_model_matches_predictor(tmp_path):
    torch.manual_seed(0)
    m = P.MSDNet(num_layers=3, volumetric=False, **CPU)
    randomize_(m)
    x = _x((3, 1, 16, 16))
    ref = Predictor(m).predict(x)
    im = InferenceModel((m, m.state_dict()), disable_cuda=True)
    np.testing.assert_allclose(im.predict_proba(x, bs=2), ref, atol=1e-6)
    path = str(tmp_path / "model.pt")
    save_model(m, path)
    np.testing.assert_allclose(
        load_model(path, disable_cuda=True).predict_proba(x), ref, atol=1e-6)
    with torch.no_grad():
        direct = torch.softmax(m.eval()(torch.as_tensor(x).movedim(1, -1)),
                               -1).movedim(-1, 1).numpy()
    np.testing.assert_allclose(ref, direct, atol=1e-6)


def test_errors():
    with pytest.raises(PoolingError):
        P.UNet3dLite(**CPU)(torch.zeros(1, 22, 142, 142, 1))
    with pytest.raises(ValueError, match="channels-last"):
        P.UNet3dLite(**CPU)(torch.zeros(1, 1, 22, 140, 140))
    with pytest.raises(ValueError, match="divisible by 16"):
        P.VNet(fac=4, **CPU)(torch.zeros(1, 16, 16, 24, 1))
    with pytest.raises(ValueError, match="channels-last"):
        P.FCN8s(**CPU)(torch.zeros(1, 32, 32, 1))
    with pytest.raises(ValueError, match="backbone"):
        P.FCN8s(backbone="vgg12", **CPU)
    with pytest.raises(ValueError, match="channels-last"):
        P.MSDNet(volumetric=True, num_layers=2, **CPU)(
            torch.zeros(1, 16, 16, 1))
    with pytest.raises(ValueError, match="version"):
        EvoNorm(4, version="B1", **CPU)
    m = P.StackedConv2ScalarWithLatentAdd(1, 5, n_scalar=2, **CPU)
    with pytest.raises(ValueError, match="scal shape"):
        m(torch.zeros(1, 1, 128, 128, 1), torch.zeros(1, 3))


@pytest.mark.parametrize("factory", [
    lambda: P.Simple3DNet(), lambda: P.Extended3DNet(), lambda: P.N3DNet(),
    lambda: P.StackedConv2Scalar(1, 5),
    lambda: P.StackedConv2ScalarWithLatentAdd(1, 5), lambda: P.UNet3dLite(),
    lambda: P.VNet(), lambda: P.fcn32s(), lambda: P.fcn16s(),
    lambda: P.fcn8s(), lambda: P.FCN32s(), lambda: P.FCN16s(),
    lambda: P.FCN8s(), lambda: P.FCNs(), lambda: P.MSDNet(),
    lambda: P.FCDenseNet(), lambda: P.FCDenseNet57(12),
    lambda: P.FCDenseNet67(12), lambda: P.FCDenseNet103(12)])
def test_zoo_models_raise_without_a_device(factory):
    """No fallback: a zoo model built without ``device`` runs on the
    card, and raises on a machine without one."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()


def test_train_step_classifier_logits():
    """``train_step`` with (N, n_classes) logits and (N,) class targets:
    the step is the hand-written one."""
    torch.manual_seed(0)
    m = P.StackedConv2Scalar(1, 5, dropout_rate=0.0, **CPU)
    ref = P.StackedConv2Scalar(1, 5, dropout_rate=0.0, **CPU)
    ref.load_state_dict(m.state_dict())
    x = torch.as_tensor(_x((4, 1, 128, 128, 1)))
    y = torch.tensor([0, 3, 1, 4])
    crit = CrossEntropyLoss()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    loss = train_step(m, crit, opt, x, y)
    ref.train()
    out = ref(x)
    assert out.shape == (4, 5)
    want = torch.nn.functional.cross_entropy(out, y)
    want.backward()
    torch.testing.assert_close(loss, want.detach())
    for (n, p), q in zip(m.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p.detach(), (q - 0.1 * q.grad).detach(),
                                   msg=n)


def test_train_step_two_inputs():
    """A tuple ``inp`` is the model's positional inputs:
    ``StackedConv2ScalarWithLatentAdd(x, scal)``."""
    torch.manual_seed(0)
    m = P.StackedConv2ScalarWithLatentAdd(1, 3, dropout_rate=0.0,
                                          n_scalar=2, **CPU)
    ref = P.StackedConv2ScalarWithLatentAdd(1, 3, dropout_rate=0.0,
                                            n_scalar=2, **CPU)
    ref.load_state_dict(m.state_dict())
    x = torch.as_tensor(_x((2, 1, 128, 128, 1)))
    scal = torch.as_tensor(_x((2, 2), 1))
    y = torch.tensor([2, 0])
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    loss = train_step(m, CrossEntropyLoss(), opt, (x, scal), y)
    ref.train()
    want = torch.nn.functional.cross_entropy(ref(x, scal), y)
    torch.testing.assert_close(loss, want.detach())


_ZOO_FILES = [
    "models/simple.py", "models/unet3d_lite.py", "models/vnet.py",
    "models/fcn.py", "models/fcn_2d.py", "models/msdnet.py",
    "models/tiramisu.py", "models/model_utils.py", "models/base.py",
    "models/convert.py", "modules/wsconv.py", "modules/evonorm.py",
    "modules/l1batchnorm.py", "modules/axial_attention.py",
    "modules/layers.py", "modules/__init__.py", "models/__init__.py"]


@pytest.mark.parametrize("rel", _ZOO_FILES)
def test_zoo_files_import_no_jax(rel):
    root = os.path.dirname(elektronn3_tpu_torch.__file__)
    tree = ast.parse(open(os.path.join(root, rel)).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "flax", "elektronn3_tpu"), (rel, n)
