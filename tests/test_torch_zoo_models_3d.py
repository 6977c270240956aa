"""The port's fixed-size and deep volumetric zoo models against the JAX
package's on the CPU: UNet3dLite at its (22, 140, 140) input, VNet (relu
and PReLU) and the image-to-scalar classifiers, split from
``test_torch_zoo_models.py`` (whose docstring says what each case
checks, with ``_torch_zoo_common``'s tolerances) to keep each file's
time near 40 s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from elektronn3_tpu import models as J
from elektronn3_tpu_torch import models as P

from _torch_zoo_common import (
    CASES, CPU, FWD_TOL, DropoutTape, assert_close, assert_grads,
    check_model, dropout_off_, flax_vars, inputs, port_grads, randomize_, t)


@pytest.mark.parametrize("name", ["stacked2scalar", "unet3d_lite", "vnet",
                                  "vnet_prelu"])
def test_model_matches_jax(name, monkeypatch):
    """Eval forward, one training step (loss, every gradient, the new
    running statistics), the converter both ways, and the dropout
    sites (``_torch_zoo_common.check_model``)."""
    check_model(name, monkeypatch)


def test_adaptive_pool_matches_jax():
    """The classifiers' pooling of fewer than 100 features (70, JAX's
    test size) into torch's uneven adaptive bins, against JAX's
    ``_adaptive_avg_pool_1d``."""
    from elektronn3_tpu.models.simple import _adaptive_avg_pool_1d
    x = inputs((2, 70))
    ref = _adaptive_avg_pool_1d(jnp.asarray(x), 100)
    out = torch.nn.functional.adaptive_avg_pool1d(t(x)[:, None], 100)[:, 0]
    assert_close(out.numpy(), ref, FWD_TOL, "adaptive pool")
    port = P.StackedConv2Scalar(1, 5, **CPU).eval()
    assert port(t(inputs((1, 1, 128, 128, 1)))).shape == (1, 5)


def test_latent_add_matches_jax(monkeypatch):
    """``StackedConv2ScalarWithLatentAdd``: its two inputs, forward and
    gradients against JAX's."""
    DropoutTape(monkeypatch)
    torch.manual_seed(0)
    port = P.StackedConv2ScalarWithLatentAdd(1, 5, n_scalar=2, **CPU)
    randomize_(port)
    dropout_off_(port)
    x = inputs((2, 10, 128, 128, 1))
    scal = inputs((2, 2), seed=5)
    jm = J.StackedConv2ScalarWithLatentAdd(in_channels=1, n_classes=5,
                                           n_scalar=2)
    variables = flax_vars(jm, port, x, scal, train=False)
    port.train()
    out = port(t(x), t(scal))
    out.sum().backward()

    def loss_fn(p):
        o, _ = jm.apply({"params": p,
                         "batch_stats": variables["batch_stats"]},
                        x, scal, train=True, mutable=["batch_stats"])
        return jnp.sum(o), o
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    assert_close(out.detach().numpy(), ref, FWD_TOL, "latent add")
    assert_grads(port_grads(port, variables), grads, "latent add")


@pytest.mark.parametrize("name", ["vnet", "stacked2scalar"])
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
