"""The port's ResUNet (elektronn3_tpu_torch.models.ResUNet) against the
JAX package's, on the CPU in float32.

For each configuration the same seeded parameters (converted with
``state_dict_from_flax``; batch norms with random statistics and affine
parameters) and the same numpy input go through JAX's ``ResUNet`` at
``pallas_flat=False`` (XLA) and the port's: the eval forward within
1e-5 of the output's scale, one training step (CE + Dice): the loss
within 1e-5 (relative), every parameter gradient and the new running
statistics each within 1e-3 of the leaf's scale plus 1e-6 (the floors of
``test_torch_train.py``), and the converter back (``flax_from_state_dict``
of the loaded model gives the variables it was loaded from, exactly).
The configurations: no residual blocks (3D on the kernel plan, 2D at
start_filts 8), which is also the port's ``UNet`` bit for bit; residual
stacks in 3D at ``n_blocks=3`` and in 2D at ``n_blocks=2``, under
'concat' and 'add'; ``full_norm=False`` without residual blocks (the
ConvBlock path, which norms anyway); ``conv_mode='valid'`` with
residual blocks (the shortcut center-cropped); ``attention`` with a
resizeconv ``up_mode``. Then the port alone: the level plan, the
parameter layout, checkpointing's step the same bits as the plain one,
the import of reference-layout checkpoints (``convs.{j}`` stacks with
``proj``, and ``convs.0`` collapsed into a model without stacks), and
``save_model``/``load_model`` (and the ``Predictor`` from a model file)
rebuilding a ``ResUNet``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.models import resunet as jresunet
from elektronn3_tpu.modules import loss as jloss
from elektronn3_tpu_torch.models import (
    ResUNet, UNet, flax_from_state_dict, load_torch_state_dict,
    state_dict_from_flax)
from elektronn3_tpu_torch.models.resunet import DownBlock, UpBlock
from elektronn3_tpu_torch.modules import loss as ploss
from elektronn3_tpu_torch.training import load_model, save_model

FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-3
LEAF_ATOL = 1e-6
BASE = dict(in_channels=1, out_channels=2, normalization="batch")
RES1 = dict(enc_res_blocks=1, dec_res_blocks=1)

# name: (model options, input shape, the port's pallas_flat)
CONFIGS = {
    # L0 and L1 on the kernels (their plain versions here).
    "res0_3d": (dict(n_blocks=3, start_filts=32, planar_blocks=(0,)),
                (2, 4, 8, 8, 1), True),
    "res0_2d": (dict(n_blocks=3, start_filts=8, dim=2), (2, 16, 16, 1),
                "auto"),
    "res1_3d_concat": (dict(n_blocks=3, start_filts=8, planar_blocks=(0,),
                            **RES1), (2, 4, 8, 8, 1), "auto"),
    "res1_3d_add": (dict(n_blocks=3, start_filts=8, planar_blocks=(0,),
                         merge_mode="add", **RES1), (2, 4, 8, 8, 1),
                    "auto"),
    "res2_2d_concat": (dict(n_blocks=2, start_filts=8, dim=2,
                            enc_res_blocks=2, dec_res_blocks=1),
                       (2, 16, 16, 1), "auto"),
    "res1_2d_add": (dict(n_blocks=2, start_filts=8, dim=2,
                         merge_mode="add", **RES1), (2, 16, 16, 1),
                    "auto"),
    "res0_full_norm_false": (dict(n_blocks=2, start_filts=8,
                                  planar_blocks=(0,), full_norm=False),
                             (2, 2, 8, 8, 1), "auto"),
    # L0 (1,3,3) convs, L1 3x3x3: (6, 20, 20) -> (2, 4, 4).
    "res1_valid": (dict(n_blocks=2, start_filts=8, planar_blocks=(0,),
                        conv_mode="valid", **RES1), (2, 6, 20, 20, 1),
                   "auto"),
    "res1_attention_resize": (dict(n_blocks=2, start_filts=8,
                                   planar_blocks=(0,), attention=True,
                                   up_mode="resizeconv_linear", **RES1),
                              (2, 4, 8, 8, 1), "auto"),
}


def _randomize(variables, rng):
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
            out[k] = np.asarray(v, np.float32)
        return out
    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


def _assert_trees(port, ref):
    port, ref = _leaves(port), _leaves(ref)
    assert port.keys() == ref.keys()
    for k in ref:
        scale = float(np.max(np.abs(ref[k])))
        err = float(np.max(np.abs(port[k] - ref[k])))
        assert err <= LEAF_TOL * scale + LEAF_ATOL, (k, err, scale)


def _inputs(shape, seed=5):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=shape).astype(np.float32)


def _jax_step(jm, v, x, y):
    crit = jloss.CEDiceLoss(1.0, 1.0)

    def loss_fn(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return crit(out, jnp.asarray(y)).astype(jnp.float32), \
            mut["batch_stats"]
    (loss, bs), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return float(loss), jax.device_get(g), jax.device_get(bs)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(variables, x, y, eval forward, step) of JAX's ResUNet."""
    kw, shape, _ = CONFIGS[name]
    rng, x = _inputs(shape)
    jm = jresunet.ResUNet(pallas_flat=False, **BASE, **kw)
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda a: jm.init({"params": key}, a, train=False))(
        jnp.zeros(shape, jnp.float32))
    v = _randomize(jax.device_get(v), rng)
    fwd = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        v, x))
    # A valid-conv model's target has its output's (smaller) shape.
    y = rng.integers(0, 2, size=fwd.shape[:-1]).astype(np.int32)
    return v, x, y, fwd, _jax_step(jm, v, x, y)


def _port_model(name, v, cls=ResUNet, **extra):
    kw, _, pf = CONFIGS[name]
    m = cls(device="cpu", pallas_flat=pf, **BASE, **kw, **extra)
    m.load_state_dict(state_dict_from_flax(v, m))
    return m


def _port_step(m, v, x, y):
    m.train()
    m.zero_grad()
    loss = ploss.CEDiceLoss(1.0, 1.0)(m(torch.from_numpy(x)),
                                      torch.from_numpy(y).long())
    loss.backward()
    grads = flax_from_state_dict(
        {n: p.grad for n, p in m.named_parameters()}, v, ("params",))
    bs = flax_from_state_dict(m.state_dict(), v, ("batch_stats",))
    return float(loss.detach()), grads["params"], bs["batch_stats"]


@functools.lru_cache(maxsize=None)
def _run(name):
    v, x, y, fwd_ref, ref = _jax_run(name)
    m = _port_model(name, v)
    back = flax_from_state_dict(
        {k: t.clone() for k, t in m.state_dict().items()}, v)
    fwd = m.eval()(torch.from_numpy(x)).numpy()
    return dict(kinds=m.level_kinds(x.shape), fwd=(fwd, fwd_ref),
                port=_port_step(m, v, x, y), ref=ref, back=(back, v))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    fwd, ref = _run(name)["fwd"]
    assert fwd.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(fwd - ref).max()) <= FWD_TOL * max(scale, 1.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_step_matches_jax(name):
    r = _run(name)
    (lp, gp, bp), (lr, gr, br) = r["port"], r["ref"]
    assert abs(lp - lr) <= LOSS_RTOL * abs(lr)
    _assert_trees(gp, gr)
    _assert_trees(bp, br)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_round_trip(name):
    back, v = _run(name)["back"]
    back, v = _leaves(back), _leaves(v)
    assert back.keys() == v.keys()
    for k in v:
        assert np.array_equal(back[k], v[k]), k


def test_plans():
    """No residual blocks: the UNet's plan (L0 and L1 on the kernels);
    every other form all 'library'."""
    assert _run("res0_3d")["kinds"] == ["kernels", "kernels", "library"]
    for name in CONFIGS:
        if name != "res0_3d":
            assert set(_run(name)["kinds"]) == {"library"}, name


@pytest.mark.parametrize("kw, shape", [
    (dict(n_blocks=3, start_filts=32, planar_blocks=(0,)),
     (2, 4, 8, 8, 1)),
    (dict(n_blocks=3, start_filts=8, dim=2), (2, 16, 16, 1))])
def test_res0_is_the_unet_bit_for_bit(kw, shape):
    """Same seeded weights, parameter names, forward and gradients."""
    u = UNet(device="cpu", pallas_flat=True, **BASE, **kw)
    r = ResUNet(device="cpu", pallas_flat=True, **BASE, **kw)
    assert list(u.state_dict()) == list(r.state_dict())
    for a, b in zip(u.state_dict().values(), r.state_dict().values()):
        assert torch.equal(a, b)
    x = torch.from_numpy(_inputs(shape)[1])
    y = (x[..., 0] > 0).long()
    assert torch.equal(u.eval()(x), r.eval()(x))
    for m in (u, r):
        m.train()
        ploss.CEDiceLoss(1.0, 1.0)(m(x), y).backward()
    for (n, p), q in zip(u.named_parameters(), r.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_block_layout():
    """The reference's ConvBlock stacks: ``convs.{j}``, ``proj`` in each
    later encoder level's first block and in a decoder's first block
    under 'concat' only, none in ``down_0``'s first block (no shortcut),
    an UpBlock's own ``norm0``."""
    def keys(**kw):
        m = ResUNet(device="meta", n_blocks=3, start_filts=8, **BASE,
                    **kw)
        return {k for k in m.state_dict() if k.endswith("weight")}
    k = keys(enc_res_blocks=2, dec_res_blocks=2)
    assert "down_convs.0.convs.1.conv1.weight" in k
    assert not any(n.startswith("down_convs.0.convs.0.proj") for n in k)
    assert "down_convs.1.convs.0.proj.weight" in k
    assert "down_convs.1.convs.1.proj.weight" not in k
    assert "up_convs.0.convs.0.proj.weight" in k
    assert "up_convs.0.convs.1.proj.weight" not in k
    assert "up_convs.0.norm0.weight" in k
    assert "up_convs.0.convs.1.norm1.weight" in k
    add = keys(enc_res_blocks=1, dec_res_blocks=1, merge_mode="add")
    assert not any(n.startswith("up_convs.") and ".proj." in n for n in add)
    m = ResUNet(device="meta", n_blocks=2, full_norm=False, **BASE)
    assert isinstance(m.down_convs[0], DownBlock)
    assert isinstance(m.up_convs[0], UpBlock)
    assert not m.is_unet and ResUNet(device="meta", **BASE).is_unet


def test_checkpointing_is_the_plain_step():
    """checkpointing True and 'policy' (a full recompute, as JAX's
    ResUNet remats without a policy) give the plain step's loss and
    gradients bit for bit and update the running statistics once."""
    kw = dict(n_blocks=2, start_filts=8, planar_blocks=(0,), **RES1)
    x = torch.from_numpy(_inputs((2, 2, 8, 8, 1))[1])
    y = (x[..., 0] > 0).long()
    out = []
    for ck in (False, True, "policy"):
        m = ResUNet(device="cpu", checkpointing=ck, **BASE, **kw).train()
        loss = ploss.CEDiceLoss(1.0, 1.0)(m(x), y)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    m.named_parameters()},
                    {n: b.clone() for n, b in m.named_buffers()}))
    for loss, g, b in out[1:]:
        assert torch.equal(loss, out[0][0])
        for n in g:
            assert torch.equal(g[n], out[0][1][n]), n
        for n in b:
            assert torch.equal(b[n], out[0][2][n]), n


def _reference_layout(state):
    """A reference ResUNet checkpoint from a port ResUNet's state dict:
    the same names (the port keeps the reference's), with the
    ``module.`` prefix of a DataParallel save."""
    return {f"module.{k}": v.clone() for k, v in state.items()}


def test_torch_import_residual_matches_jax():
    """A residual reference-layout checkpoint (``convs.{j}``, ``proj``)
    through the port's importer and through JAX's: the same model."""
    from elektronn3_tpu.models.torch_import import \
        load_torch_state_dict as jax_import
    name = "res1_3d_concat"
    v, x, _, _, _ = _jax_run(name)
    src = _port_model(name, v)
    ckpt = _reference_layout(src.state_dict())
    dst = ResUNet(device="cpu", generator=torch.Generator().manual_seed(3),
                  **BASE, **CONFIGS[name][0])
    dst.load_state_dict(load_torch_state_dict(ckpt, dst))
    kw = CONFIGS[name][0]
    jm = jresunet.ResUNet(pallas_flat=False, **BASE, **kw)
    jv = jax_import({k: v_.numpy() for k, v_ in ckpt.items()}, jm,
                    example_input_shape=x.shape)
    ref = np.asarray(jm.apply(jv, x, train=False))
    out = dst.eval()(torch.from_numpy(x)).numpy()
    assert float(np.abs(out - ref).max()) <= FWD_TOL * max(
        float(np.abs(ref).max()), 1.0)


def test_torch_import_collapses_convs0():
    """A checkpoint of one plain ConvBlock a level (``convs.0``; the
    port's ResUNet with ``full_norm=False`` and no residual blocks has
    that layout and, as the reference's ConvBlock norms every conv, the
    UNet's function) into the UNet-layout ResUNet: ``convs.0`` collapsed,
    each UpBlock's ``norm0`` before its block's norms; the same forward
    as the source, and as JAX's ResUNet on the source's variables."""
    name = "res0_full_norm_false"
    v, x, _, fwd_ref, _ = _jax_run(name)
    src = _port_model(name, v)
    assert "up_convs.0.convs.0.norm1.weight" in src.state_dict()
    ckpt = _reference_layout(src.state_dict())
    kw = dict(CONFIGS[name][0], full_norm=True)
    dst = ResUNet(device="cpu", **BASE, **kw)
    assert dst.is_unet
    dst.load_state_dict(load_torch_state_dict(ckpt, dst))
    sd = dst.state_dict()
    for a, b in (("up_convs.0.norm0", "up_convs.0.norm0"),
                 ("up_convs.0.convs.0.norm0", "up_convs.0.norm1"),
                 ("up_convs.0.convs.0.norm1", "up_convs.0.norm2"),
                 ("down_convs.1.convs.0.norm1", "down_convs.1.norm1"),
                 ("up_convs.0.convs.0.conv1", "up_convs.0.conv1")):
        assert torch.equal(sd[b + ".weight"],
                           src.state_dict()[a + ".weight"]), (a, b)
    xt = torch.from_numpy(x)
    out = dst.eval()(xt).numpy()
    assert np.array_equal(out, src.eval()(xt).numpy())
    assert float(np.abs(out - fwd_ref).max()) <= FWD_TOL * max(
        float(np.abs(fwd_ref).max()), 1.0)
    # A stray entry still raises under strict.
    with pytest.raises(ValueError):
        load_torch_state_dict(dict(ckpt, **{
            "module.up_convs.0.convs.1.conv1.weight": torch.zeros(1)}), dst)


@pytest.mark.parametrize("kw", [
    dict(enc_res_blocks=1, dec_res_blocks=2, merge_mode="add"),
    dict()])
def test_save_model_load_model(tmp_path, kw):
    """``load_model`` rebuilds a ``ResUNet`` with its residual blocks."""
    m = ResUNet(device="cpu", n_blocks=2, start_filts=8, **BASE, **kw)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.01)
    path = str(tmp_path / "model.pt")
    save_model(m, path, info={"k": 1})
    back, info = load_model(path, device="cpu")
    assert type(back) is ResUNet and info == {"k": 1}
    assert (back.enc_res_blocks, back.dec_res_blocks) == (
        m.enc_res_blocks, m.dec_res_blocks)
    x = torch.from_numpy(_inputs((1, 2, 8, 8, 1))[1])
    assert torch.equal(back.eval()(x), m.eval()(x))
    # The Predictor's model from a file is the ResUNet too.
    from elektronn3_tpu_torch.inference import Predictor
    pred = Predictor(path, device="cpu", apply_softmax=False)
    assert type(pred.model) is ResUNet
    vol = np.moveaxis(x.numpy(), -1, 1)
    assert np.allclose(pred.predict(vol), np.moveaxis(
        m(x).numpy(), -1, 1), atol=1e-6)
