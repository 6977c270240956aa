"""The port's zoo modules against the JAX package's on the CPU: WSConv
and WSConvTranspose, EvoNorm B0/S0, the L1 batch and group norms,
Gather-Excite, self and axial attention, the axial positional embedding
and the (reversible) axial image transformer; and the flax conv helpers
they and the zoo's models stand on (``conv_transpose_cl``'s 'SAME'
padding at odd and even sizes, ``resize_nearest_to``).

The port's weights (with norm parameters, statistics, WS gains and
Rezero's ``g`` drawn from a seed) go to the flax tree through
``convert.py``; the same numpy inputs and a random output cotangent go
through ``apply`` and ``jax.vjp`` on one side and the port's forward and
``torch.autograd`` on the other. Tolerances are ``_torch_zoo_common``'s:
forward 1e-4 x max |ref|, gradients (of the inputs and every parameter)
1e-3 of each leaf's norm, running statistics 1e-5, bf16 forward 5e-2 x
max |ref|.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu import modules as JM
from elektronn3_tpu_torch import modules as PM
from elektronn3_tpu_torch.models.convert import flax_from_state_dict
from elektronn3_tpu_torch.modules.axial_attention import Rezero
from elektronn3_tpu_torch.modules.layers import (
    ConvTranspose, conv_transpose_cl, resize_nearest_to)

from _torch_zoo_common import (
    BF16_TOL, FWD_TOL, assert_close, assert_grads, assert_stats, flax_vars,
    port_grads, randomize_, t)

CPU = dict(device="cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def check_module(jmod, pmod, xs, train=None, stats=False, seed=11):
    """Forward, input and parameter gradients (and with ``stats`` the
    new batch statistics) of ``pmod`` against ``jmod`` on inputs
    ``xs``; ``train`` is passed to both as JAX's ``train`` keyword and
    the port's mode."""
    kw = {} if train is None else {"train": train}
    randomize_(pmod)
    variables = flax_vars(jmod, pmod, *xs, **kw)
    if train is not None:
        pmod.train(train)
    tx = [t(x).requires_grad_(True) for x in xs]
    out = pmod(*tx)
    g = _rand(out.shape, seed)
    (out * t(g)).sum().backward()

    others = {k: v for k, v in variables.items() if k != "params"}

    def f(params, *a):
        res = jmod.apply({"params": params, **others}, *a,
                         mutable=list(others) or False, **kw)
        return res[0] if others else res

    def fwd_bwd(params, g, *a):
        ref, vjp = jax.vjp(f, params, *a)
        return ref, vjp(g)

    params = variables.get("params", {})
    ref, grads = jax.jit(fwd_bwd)(params, jnp.asarray(g),
                                  *[jnp.asarray(x) for x in xs])
    assert_close(out.detach().numpy(), ref, FWD_TOL, type(pmod).__name__)
    for i, (a, r) in enumerate(zip(tx, grads[1:])):
        assert_grads({"x": a.grad.numpy()}, {"x": np.asarray(r)},
                     f"{type(pmod).__name__} input {i}")
    if params:
        assert_grads(port_grads(pmod, variables), grads[0],
                     type(pmod).__name__)
    if stats:
        new = jmod.apply(variables, *xs, mutable=["batch_stats"], **kw)[1]
        mine = flax_from_state_dict(pmod.state_dict(), variables,
                                    ("batch_stats",), model=pmod)
        assert_stats(mine["batch_stats"], new["batch_stats"],
                     type(pmod).__name__)
    return variables


# ---------------------------------------------------------------------------
# WSConv / WSConvTranspose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k,s,groups", [
    ((2, 9, 10, 4), (3, 3), (2, 2), 2),
    ((1, 5, 9, 8, 3), (3, 3, 3), (1, 2, 2), 1),
    ((1, 6, 6, 6, 4), (2, 2, 2), (2, 2, 2), 4),
])
def test_wsconv_matches_jax(shape, k, s, groups):
    cin = shape[-1]
    jmod = JM.WSConv(features=6 if groups != 4 else 8, kernel_size=k,
                     strides=s, feature_group_count=groups)
    pmod = PM.WSConv(cin, jmod.features, k, strides=s,
                     feature_group_count=groups, **CPU)
    check_module(jmod, pmod, [_rand(shape, 1)])


@pytest.mark.parametrize("shape,k,s", [
    ((2, 5, 6, 4), (3, 3), (2, 2)),
    ((1, 3, 4, 5, 3), (2, 2, 2), (2, 2, 2)),
    ((1, 4, 3, 3, 2), (1, 3, 3), (1, 2, 2)),
])
def test_wsconv_transpose_matches_jax(shape, k, s):
    jmod = JM.WSConvTranspose(features=5, kernel_size=k, strides=s)
    pmod = PM.WSConvTranspose(shape[-1], 5, k, strides=s, **CPU)
    check_module(jmod, pmod, [_rand(shape, 2)])


def test_wsconv_bf16_forward():
    jmod = JM.WSConv(features=6, kernel_size=(3, 3), dtype=jnp.bfloat16)
    pmod = PM.WSConv(4, 6, (3, 3), dtype=torch.bfloat16, **CPU)
    x = _rand((2, 8, 8, 4), 3)
    randomize_(pmod)
    v = flax_vars(jmod, pmod, x)
    ref = jmod.apply(v, x)
    out = pmod(t(x))
    assert out.dtype == torch.bfloat16
    assert_close(out.float().detach().numpy(), np.asarray(ref, np.float32),
                 BF16_TOL, "WSConv bf16")


# ---------------------------------------------------------------------------
# EvoNorm, L1 norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,train,shape", [
    ("B0", True, (2, 5, 6, 8)), ("B0", False, (2, 5, 6, 8)),
    ("B0", True, (2, 3, 4, 5, 8)), ("S0", True, (2, 5, 6, 8)),
    ("S0", True, (2, 3, 4, 5, 64)),
])
def test_evonorm_matches_jax(version, train, shape):
    c = shape[-1]
    jmod = JM.EvoNorm(version=version, groups=4)
    pmod = PM.EvoNorm(c, version=version, groups=4, **CPU)
    check_module(jmod, pmod, [_rand(shape, 4)], train=train,
                 stats=version == "B0")


def test_evonorm_bf16_forward():
    jmod = JM.EvoNorm(version="S0", groups=4)
    pmod = PM.EvoNorm(8, version="S0", groups=4, **CPU)
    x = _rand((2, 5, 6, 8), 5)
    v = flax_vars(jmod, pmod, x, train=True)
    ref = jmod.apply(v, jnp.asarray(x, jnp.bfloat16), train=True)
    out = pmod(t(x, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert_close(out.float().detach().numpy(), np.asarray(ref, np.float32),
                 BF16_TOL, "EvoNorm bf16")


@pytest.mark.parametrize("train,shape", [
    (True, (2, 5, 6, 4)), (False, (2, 5, 6, 4)), (True, (2, 3, 4, 5, 6))])
def test_l1_batch_norm_matches_jax(train, shape):
    jmod = JM.L1BatchNorm()
    pmod = PM.L1BatchNorm(shape[-1], **CPU)
    check_module(jmod, pmod, [_rand(shape, 6)], train=train, stats=True)


@pytest.mark.parametrize("groups,shape", [(2, (2, 5, 6, 4)),
                                          (4, (2, 3, 4, 5, 8))])
def test_l1_group_norm_matches_jax(groups, shape):
    jmod = JM.L1GroupNorm(groups=groups)
    pmod = PM.L1GroupNorm(shape[-1], groups=groups, **CPU)
    check_module(jmod, pmod, [_rand(shape, 7)])


# ---------------------------------------------------------------------------
# Gather-Excite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extent", [0, 2, 4])
@pytest.mark.parametrize("param_gather", [False, True])
@pytest.mark.parametrize("param_excite", [False, True])
def test_gather_excite_matches_jax(extent, param_gather, param_excite):
    shape = (2, 9, 8, 4)    # odd H: the 'SAME' convs' extra high voxel
    jmod = JM.GatherExcite(channels=4, extent=extent,
                           param_gather=param_gather,
                           param_excite=param_excite)
    pmod = PM.GatherExcite(4, extent, param_gather, param_excite,
                           spatial_shape=shape[1:-1], **CPU)
    check_module(jmod, pmod, [_rand(shape, 8)])


def test_gather_excite_3d_matches_jax():
    shape = (1, 4, 6, 5, 3)
    jmod = JM.GatherExcite(channels=3, extent=0, param_gather=True,
                           spatial_dim=3)
    pmod = PM.GatherExcite(3, 0, True, True, spatial_dim=3,
                           spatial_shape=shape[1:-1], **CPU)
    check_module(jmod, pmod, [_rand(shape, 9)])


def test_gather_excite_errors():
    with pytest.raises(ValueError, match="spatial_shape"):
        PM.GatherExcite(4, 0, param_gather=True, **CPU)
    m = PM.GatherExcite(4, 0, param_gather=True, spatial_shape=(8, 8),
                        **CPU)
    with pytest.raises(ValueError, match="gather convs"):
        m(torch.zeros(1, 32, 32, 4))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def test_self_attention_matches_jax():
    check_module(JM.SelfAttention(dim=16, heads=4),
                 PM.SelfAttention(16, heads=4, **CPU),
                 [_rand((2, 10, 16), 10)])


@pytest.mark.parametrize("shape,nd,sum_out", [
    ((2, 8, 12, 16), 2, True), ((1, 4, 6, 8, 8), 3, False),
    ((1, 4, 6, 8, 8), 3, True)])
def test_axial_attention_matches_jax(shape, nd, sum_out):
    c = shape[-1]
    heads = 4 if c == 16 else 2
    jmod = JM.AxialAttention(dim=c, num_dimensions=nd, heads=heads,
                             sum_axial_out=sum_out)
    pmod = PM.AxialAttention(c, nd, heads, sum_axial_out=sum_out, **CPU)
    check_module(jmod, pmod, [_rand(shape, 11)])


def test_axial_positional_embedding_matches_jax():
    jmod = JM.AxialPositionalEmbedding(dim=16, shape=(8, 12))
    pmod = PM.AxialPositionalEmbedding(16, (8, 12), **CPU)
    check_module(jmod, pmod, [_rand((2, 8, 12, 16), 12)])


@pytest.mark.parametrize("reversible", [False, True])
@pytest.mark.parametrize("nd,shape", [(2, (2, 6, 8, 8)),
                                      (3, (1, 3, 4, 5, 8))])
def test_axial_image_transformer_matches_jax(reversible, nd, shape):
    """Forward and gradients, with every Rezero ``g`` drawn from the
    seed (at 0, its initial value, a wrong block could not show); the
    reversible form against JAX's ``custom_vjp`` backward."""
    jmod = JM.AxialImageTransformer(dim=8, depth=2, heads=2,
                                    num_dimensions=nd, reversible=reversible)
    pmod = PM.AxialImageTransformer(8, 2, heads=2, num_dimensions=nd,
                                    reversible=reversible, **CPU)
    check_module(jmod, pmod, [_rand(shape, 13)])
    gs = [m.g.item() for m in pmod.modules() if isinstance(m, Rezero)]
    assert len(gs) == 4 and all(g != 0 for g in gs)


def test_reversible_saves_no_activation():
    """The reversible sequence keeps only its outputs for the backward:
    the autograd graph holds two saved tensors however deep it is, and
    its gradients are the plain residual stack's."""
    torch.manual_seed(0)
    m = PM.AxialImageTransformer(8, 3, heads=2, reversible=True, **CPU)
    randomize_(m)
    x = t(_rand((2, 6, 8, 8), 14)).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda s: saved.append(s.shape) or s, lambda s: s):
        y1, y2 = m.ReversibleSequence_0(torch.cat([x, x], -1)).chunk(2, -1)
    fn_saved = [s for s in saved if s == (2, 6, 8, 8)]
    assert len(fn_saved) >= 2 and len(saved) <= 8
    ((y1 + y2) / 2).square().sum().backward()
    rev = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    blocks = m.ReversibleSequence_0.blocks()
    a, b = x.detach(), x.detach()
    for f, g in blocks:
        a = a + f(b)
        b = b + g(a)
    ((a + b) / 2).square().sum().backward()
    for n, p in m.named_parameters():
        assert torch.allclose(rev[n], p.grad, rtol=1e-4, atol=1e-5), n


# ---------------------------------------------------------------------------
# The flax conv helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 6])
@pytest.mark.parametrize("k,s,padding", [
    (3, 2, "SAME"), (3, 2, "VALID"), (1, 2, "SAME"), (4, 2, "SAME"),
    (2, 2, "SAME")])
def test_conv_transpose_matches_flax(n, k, s, padding):
    """flax's ``ConvTranspose`` padding at an odd and an even size; for
    (3, 2, 'SAME') torch's ``padding=1, output_padding=1`` is not it."""
    x = _rand((2, n, n + 1, 3), 15)
    jmod = fnn.ConvTranspose(4, (k, k), strides=(s, s), padding=padding)
    pmod = ConvTranspose(3, 4, (k, k), strides=(s, s), padding=padding,
                         **CPU)
    randomize_(pmod)
    check_module(jmod, pmod, [x])
    if (k, s, padding) == (3, 2, "SAME"):
        with torch.no_grad():
            w = pmod.weight
            wrong = torch.nn.functional.conv_transpose2d(
                t(x).movedim(-1, 1), w, pmod.bias, stride=2, padding=1,
                output_padding=1).movedim(1, -1)
            right = conv_transpose_cl(t(x), w, pmod.bias, (2, 2))
        assert wrong.shape == right.shape
        assert not torch.allclose(wrong, right, atol=1e-3)


@pytest.mark.parametrize("n_in,n_out", [(3, 7), (4, 8), (7, 3), (5, 5)])
def test_resize_nearest_matches_jax(n_in, n_out):
    """``jax.image.resize(method='nearest')`` (half-pixel centres) is
    torch's 'nearest-exact', not its 'nearest'."""
    x = _rand((2, n_in, n_in + 1, 3), 16)
    size = (n_out, n_out + 2)
    ref = jax.image.resize(x, (2,) + size + (3,), method="nearest")
    out = resize_nearest_to(t(x), size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if n_in == 3 and n_out == 7:
        plain = torch.nn.functional.interpolate(
            t(x).movedim(-1, 1), size=size, mode="nearest").movedim(1, -1)
        assert not torch.equal(plain, out)
