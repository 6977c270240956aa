"""The port's model zoo against the JAX package's on the CPU: VNet,
UNet3dLite, the 3D and 2D FCNs, MSDNet, FC-DenseNet and the simple nets.

For each model, at the JAX zoo tests' sizes (tests/test_model_zoo.py):
the port's weights (norm parameters and statistics drawn from a seed)
go to the flax tree through ``convert.py`` (every leaf of both trees
used, and back again bit for bit), then one jitted JAX function gives
the eval forward and one training step (loss, every gradient, the new
batch statistics) beside the port's. Dropout cannot draw the same
numbers in both frameworks: JAX's ``nn.Dropout`` is patched to the
identity in this test only (recording its calls) and the port's rates
are set to 0; the port's dropout calls are held to JAX's sites and
rates, and its draws to one seed. FC-DenseNet runs a small
configuration (FC-DenseNet57 takes JAX about 30 s to trace and compile
on the CPU); the 57/67/103 builders are held to JAX's fields.

Tolerances are ``_torch_zoo_common``'s: forward 1e-4 x max |ref|,
gradients 1e-3 of each leaf's norm, running statistics 1e-5, bf16
forward 5e-2 x max |ref|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu import models as J
from elektronn3_tpu_torch import models as P

from _torch_zoo_common import (
    BF16_TOL, CASES, CPU, assert_close, check_model, flax_vars, inputs,
    randomize_, t)


@pytest.mark.parametrize("name", [
    "simple3d", "extended3d", "n3d", "fcn32s", "fcn8s", "FCN8s", "FCNs",
    "msdnet2d", "msdnet3d", "tiramisu"])
def test_model_matches_jax(name, monkeypatch):
    """Eval forward, one training step (loss, every gradient, the new
    running statistics), the converter both ways, and the dropout
    sites (``_torch_zoo_common.check_model``)."""
    check_model(name, monkeypatch)


@pytest.mark.parametrize("name", ["simple3d", "fcn8s", "FCN8s", "msdnet2d",
                                  "tiramisu"])
def test_bf16_forward_matches_jax(name):
    """A bfloat16 model's eval forward against JAX's
    ``dtype=jnp.bfloat16``, from the same float32 weights."""
    jf, pf, shape, _ = CASES[name]
    torch.manual_seed(0)
    port = pf(dtype=torch.bfloat16, **CPU)
    randomize_(port)
    x = inputs(shape)
    jm = jf(dtype=jnp.bfloat16)
    variables = flax_vars(jm, port, x, train=False)
    port.eval()
    with torch.no_grad():
        out = port(t(x))
    ref, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                           mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    assert out.dtype == torch.float32
    assert_close(out.numpy(), np.asarray(ref, np.float32), BF16_TOL, name)


@pytest.mark.parametrize("name", ["tiramisu", "fcn8s"])
def test_dropout_draws_repeat_under_a_seed(name):
    """The port's dropout draws from the input device's generator: the
    same seed gives the same training forward, another seed another."""
    _, pf, shape, _ = CASES[name]
    torch.manual_seed(0)
    port = pf(**CPU)
    x = t(inputs(shape))
    state = {k: v.clone() for k, v in port.state_dict().items()}

    def run(seed):
        port.load_state_dict(state)
        torch.manual_seed(seed)
        port.train()
        with torch.no_grad():
            return port(x)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("builder,kw", [
    ("FCDenseNet57", {}), ("FCDenseNet67", {}), ("FCDenseNet103", {})])
def test_tiramisu_builders_match_jax(builder, kw):
    """The FC-DenseNet builders give JAX's configuration."""
    jm = getattr(J, builder)(n_classes=12, in_channels=3)
    pm = getattr(P, builder)(12, 3, device="meta")
    for f in ("in_channels", "down_blocks", "up_blocks",
              "bottleneck_layers", "growth_rate", "out_chans_first_conv",
              "n_classes"):
        assert tuple(np.atleast_1d(getattr(pm, f))) \
            == tuple(np.atleast_1d(getattr(jm, f))), f
