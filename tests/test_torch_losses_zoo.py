"""The port's loss zoo (elektronn3_tpu_torch.modules.loss and .lovasz)
against the JAX package's, on the CPU in float32.

Each loss gets the same numpy inputs (seeded) on both sides: its value
within 1e-5 (relative, plus 1e-7), and its gradient with respect to the
network output (torch autograd against ``jax.grad``) within 1e-5 of the
gradient's largest entry plus 1e-8, with class weights and
``ignore_index`` where the loss takes them. Lovász is also held on
probabilities with many tied errors (the sort's tie order decides the
gradient: both sort stably). ``FixMatchSegLoss`` is held for fixed
draws (flips and quarter turns; 2D and 3D, square and non-square, where
no turn is drawn), fed to JAX's by replacing its ``jax.random`` draws,
through a small position-dependent model whose parameters' gradients
are compared too (JAX's raises on a non-square input, so there the port
is held to JAX's body without the turn); then the Trainer's hook passes
its seeded generator as ``rng``, each step a new draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elektronn3_tpu.modules import loss as jl
from elektronn3_tpu.modules import lovasz as jlov
from elektronn3_tpu_torch.modules import loss as pl
from elektronn3_tpu_torch.modules import lovasz as plov

VAL_RTOL = 1e-5
VAL_ATOL = 1e-7
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-8


def _check(port_fn, jax_fn, *arrays, grad_arg=0):
    """Value and gradient in ``arrays[grad_arg]`` of both losses."""
    xs = [np.asarray(a) for a in arrays]
    jv, jg = jax.jit(jax.value_and_grad(
        lambda g: jax_fn(*[jnp.asarray(a) if i != grad_arg else g
                           for i, a in enumerate(xs)])))(
        jnp.asarray(xs[grad_arg]))
    t = [torch.from_numpy(a.copy()) for a in xs]
    t[grad_arg].requires_grad_(True)
    pv = port_fn(*t)
    pv.backward()
    pv = pv.detach()
    jv, jg = float(jv), np.asarray(jg)
    assert abs(float(pv) - jv) <= VAL_RTOL * abs(jv) + VAL_ATOL, (
        float(pv), jv)
    pg = t[grad_arg].grad.numpy()
    err = float(np.abs(pg - jg).max())
    assert err <= GRAD_RTOL * float(np.abs(jg).max()) + GRAD_ATOL, err
    return float(pv)


def _logits(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=shape).astype(np.float32) * 2


SHAPES = [(2, 6, 7, 3), (2, 3, 4, 5, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weighted, ignore", [(False, None), (True, 2)])
def test_focal_loss(shape, weighted, ignore):
    rng, x = _logits(shape)
    y = rng.integers(0, 3, size=shape[:-1])
    w = np.array([0.2, 1.0, 3.0], np.float32) if weighted else None
    _check(lambda o, t: pl.FocalLoss(w, 2.0, ignore)(o, t),
           lambda o, t: jl.FocalLoss(w, 2.0, ignore)(o, t), x, y)


@pytest.mark.parametrize("onehot", [False, True])
def test_softmax_bce_loss(onehot):
    rng, x = _logits((2, 6, 7, 3), 1)
    y = rng.integers(0, 3, size=x.shape[:-1])
    if onehot:
        y = np.eye(3, dtype=np.float32)[y]
    _check(lambda o, t: pl.SoftmaxBCELoss()(o, t),
           lambda o, t: jl.SoftmaxBCELoss()(o, t), x, y)


@pytest.mark.parametrize("mix", [[True, False, False], [False] * 3])
def test_mixed_combined_loss(mix):
    rng, x = _logits((3, 6, 7, 2), 2)
    y = rng.integers(0, 2, size=x.shape[:-1])
    m = np.asarray(mix)
    _check(lambda o, t: pl.MixedCombinedLoss(pl.CrossEntropyLoss(),
                                             pl.DiceLoss())(o, t, m),
           lambda o, t: jl.MixedCombinedLoss(jl.CrossEntropyLoss(),
                                             jl.DiceLoss())(o, t, m), x, y)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_mse_loss(masked):
    rng, x = _logits((2, 6, 7, 1), 3)
    y = rng.normal(size=x.shape).astype(np.float32)
    mask = (rng.uniform(size=x.shape) < 0.3).astype(np.float32) \
        if masked else None
    _check(lambda o, t: pl.MaskedMSELoss()(o, t, None if mask is None
                                           else torch.from_numpy(mask)),
           lambda o, t: jl.MaskedMSELoss()(o, t, mask), x, y)


@pytest.mark.parametrize("shape", [(2, 9, 10, 1), (1, 5, 9, 10, 2)])
@pytest.mark.parametrize("border", [None, 2])
def test_distance_weighted_mse_loss(shape, border):
    rng, x = _logits(shape, 4)
    y = rng.normal(size=shape).astype(np.float32)
    _check(lambda o, t: pl.DistanceWeightedMSELoss(50.0, border)(o, t),
           lambda o, t: jl.DistanceWeightedMSELoss(50.0, border)(o, t), x, y)


@pytest.mark.parametrize("grad_arg", [0, 1, 2])
@pytest.mark.parametrize("p", [1, 2])
def test_gap_triplet_margin_loss(grad_arg, p):
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=(4, 3, 5, 6)).astype(np.float32)
               for _ in range(3))
    _check(lambda *t: pl.GAPTripletMarginLoss(0.5, p)(*t),
           lambda *t: jl.GAPTripletMarginLoss(0.5, p)(*t), a, b, c,
           grad_arg=grad_arg)
    assert np.allclose(pl.global_average_pooling(torch.from_numpy(a)),
                       np.asarray(jl.global_average_pooling(a)), 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ignore", [None, 1])
def test_lovasz_loss(shape, ignore):
    rng, x = _logits(shape, 6)
    y = rng.integers(0, 3, size=shape[:-1])
    _check(lambda o, t: pl.LovaszLoss(ignore_index=ignore)(o, t),
           lambda o, t: jl.LovaszLoss(ignore_index=ignore)(o, t), x, y)


@pytest.mark.parametrize("only_present, per_image, ignore", [
    (False, False, None), (True, False, 0), (False, True, 2),
    (True, True, None)])
def test_lovasz_softmax_on_ties(only_present, per_image, ignore):
    """Probabilities from a few levels: most errors tie."""
    rng = np.random.default_rng(7)
    p = rng.choice([0.0, 0.25, 0.5, 1.0], size=(2, 5, 6, 4))
    p = (p / np.maximum(p.sum(-1, keepdims=True), 1e-6)).astype(np.float32)
    y = rng.integers(0, 4, size=p.shape[:-1])
    y[0] = 3   # an absent class in the second image's labels
    _check(lambda o, t: plov.lovasz_softmax(o, t, only_present, per_image,
                                            ignore),
           lambda o, t: jlov.lovasz_softmax(o, t, only_present, per_image,
                                            ignore), p, y)


@pytest.mark.parametrize("per_image, ignore, ties", [
    (True, None, False), (False, 255, False), (True, 255, True)])
def test_lovasz_hinge_and_binary_xloss(per_image, ignore, ties):
    rng = np.random.default_rng(8)
    x = (rng.choice([-1.0, 0.0, 0.5], size=(3, 6, 7)) if ties
         else rng.normal(size=(3, 6, 7))).astype(np.float32)
    y = rng.integers(0, 2, size=x.shape)
    if ignore is not None:
        y[rng.uniform(size=y.shape) < 0.2] = ignore
    _check(lambda o, t: plov.lovasz_hinge(o, t, per_image, ignore),
           lambda o, t: jlov.lovasz_hinge(o, t, per_image, ignore), x, y)
    _check(lambda o, t: plov.binary_xloss(o, t, ignore),
           lambda o, t: jlov.binary_xloss(o, t, ignore), x, y)


@pytest.mark.parametrize("per_image", [True, False])
def test_iou_binary(per_image):
    rng = np.random.default_rng(9)
    p = rng.integers(0, 2, size=(3, 5, 6))
    y = rng.integers(0, 3, size=p.shape)
    p[2] = 0
    y[2] = 0   # an empty union: `empty`
    got = float(plov.iou_binary(torch.from_numpy(p), torch.from_numpy(y),
                                0.5, 2, per_image))
    ref = float(jlov.iou_binary(p, y, 0.5, 2, per_image))
    assert abs(got - ref) <= VAL_RTOL * abs(ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("softmax", [True, False])
def test_ac_loss(shape, softmax):
    rng, x = _logits(shape[:-1] + (2,), 10)
    if not softmax:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    y = rng.integers(0, 2, size=x.shape[:-1])
    _check(lambda o, t: pl.ACLoss(softmax, 0.7)(o, t),
           lambda o, t: jl.ACLoss(softmax, 0.7)(o, t), x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_norpf_dice_loss(weighted):
    rng, x = _logits((2, 5, 6, 4), 11)
    y = rng.integers(0, 4, size=x.shape[:-1])
    w = np.array([1.0, 0.5, 2.0, 1.0, 0.3], np.float32) if weighted \
        else None
    _check(lambda o, t: pl.NorpfDiceLoss(weight=w)(o, t),
           lambda o, t: jl.NorpfDiceLoss(weight=w)(o, t), x, y)


def test_norpf_dice_max_ties():
    """Tied foreground probabilities: the union's gradient is shared."""
    p = np.full((2, 4, 4, 3), 0.25, np.float32)
    p[..., 0] = 0.5
    y = np.random.default_rng(12).integers(0, 3, size=p.shape[:-1])
    _check(lambda o, t: pl.norpf_dice_loss(o, t),
           lambda o, t: jl.norpf_dice_loss(o, t), p, y)


# --- FixMatchSegLoss ---------------------------------------------------------

def _toy(params, x, xp):
    """A position-dependent per-voxel model: x * w + P (x one channel),
    so a flip or a turn changes its output."""
    w, P = params
    return x * w + P


def _jax_flips_only(fm, inp, flips, apply_fn):
    """JAX's FixMatchSegLoss body (elektronn3_tpu/modules/loss.py:
    504-531) without the quarter turn, which a non-square input never
    draws: JAX's own raises there (its switch traces every turn)."""
    def flip(t):
        for i, f in enumerate(flips):
            t = jnp.flip(t, axis=1 + i) if f else t
        return t
    out_plain = apply_fn(inp)
    out_aug_de = flip(apply_fn(flip(inp)))
    target_probs = jax.lax.stop_gradient(jax.nn.softmax(out_plain, -1))
    if fm.consistency == "mse":
        loss = jnp.mean((jax.nn.softmax(out_aug_de, -1) - target_probs) ** 2)
    else:
        loss = jnp.mean(-target_probs * jax.nn.log_softmax(out_aug_de, -1))
    if fm.enable_pseudo_label:
        mask = (jnp.max(target_probs, -1) >= fm.confidence_threshold
                ).astype(out_aug_de.dtype)
        nll = -jnp.take_along_axis(
            jax.nn.log_softmax(out_aug_de, -1),
            jnp.argmax(target_probs, -1)[..., None], -1)[..., 0]
        loss = loss + jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1e-12)
    return loss


@pytest.mark.parametrize("spatial, flips, k_rot", [
    ((6, 6), (True, False), 1),
    ((6, 6), (False, True), 3),
    ((5, 7), (True, True), 0),
    ((3, 6, 6), (True, False, True), 2),
    ((3, 4, 6), (False, True, False), 0)])
@pytest.mark.parametrize("consistency, pseudo", [("mse", True),
                                                 ("ce", False)])
def test_fixmatch_for_fixed_draws(monkeypatch, spatial, flips, k_rot,
                                  consistency, pseudo):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, *spatial, 1)).astype(np.float32)
    w = rng.normal(size=(3,)).astype(np.float32) * 3
    P = rng.normal(size=(*spatial, 3)).astype(np.float32) * 3
    kw = dict(enable_pseudo_label=pseudo, confidence_threshold=0.8,
              consistency=consistency)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(flips))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(k_rot))
    jfm = jl.FixMatchSegLoss(**kw)
    square = spatial[-1] == spatial[-2]

    def jloss(params):
        apply_fn = lambda t: _toy(params, t, jnp)  # noqa: E731
        if square:
            return jfm(jnp.asarray(x), rng=jax.random.PRNGKey(0),
                       apply_fn=apply_fn)
        return _jax_flips_only(jfm, jnp.asarray(x), flips, apply_fn)
    if not square:
        # JAX's lax.switch traces every turn, whose shapes differ here.
        with pytest.raises(TypeError):
            jfm(jnp.asarray(x), rng=jax.random.PRNGKey(0),
                apply_fn=lambda t: _toy((w, P), t, jnp))
    jv, (jgw, jgP) = jax.jit(jax.value_and_grad(jloss))(
        (jnp.asarray(w), jnp.asarray(P)))
    tw, tP = (torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (w, P))
    pfm = pl.FixMatchSegLoss(**kw)
    pv = pfm.loss(torch.from_numpy(x), list(flips), k_rot,
                  lambda t: _toy((tw, tP), t, torch))
    pv.backward()
    pv = pv.detach()
    assert abs(float(pv) - float(jv)) <= VAL_RTOL * abs(float(jv)) \
        + VAL_ATOL
    for g, r in ((tw.grad, jgw), (tP.grad, jgP)):
        r = np.asarray(r)
        assert float(np.abs(g.numpy() - r).max()) <= GRAD_RTOL * float(
            np.abs(r).max()) + GRAD_ATOL
    # augment then deaugment is the identity; the augmented input is
    # JAX's.
    xt = torch.from_numpy(x)
    aug = pfm.augment(xt, flips, k_rot)
    if square:
        assert np.array_equal(aug.numpy(), np.asarray(jfm._augment(
            jnp.asarray(x), jnp.asarray(flips), jnp.asarray(k_rot))))
    assert torch.equal(pfm.deaugment(aug, flips, k_rot), xt)


def test_fixmatch_draws():
    """No turn off the square; the draws follow the generator."""
    fm = pl.FixMatchSegLoss()
    seen = {fm.draw(torch.zeros(1, 4, 6, 6, 1),
                    torch.Generator().manual_seed(s))[1] for s in range(40)}
    assert seen == {0, 1, 2, 3}
    assert all(fm.draw(torch.zeros(1, 4, 5, 6, 1),
                       torch.Generator().manual_seed(s))[1] == 0
               for s in range(10))
    a = fm.draw(torch.zeros(1, 6, 6, 1), torch.Generator().manual_seed(3))
    b = fm.draw(torch.zeros(1, 6, 6, 1), torch.Generator().manual_seed(3))
    assert a == b
    with pytest.raises(ValueError):
        fm(torch.zeros(1, 6, 6, 1))


def test_trainer_passes_its_generator(tmp_path):
    """``Trainer.run`` with an unlabeled set calls FixMatch with
    ``rng=`` its generator seeded ``seed`` and the model as
    ``apply_fn``; a second run with the same seed draws the same."""
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.training import Trainer

    class Data:
        def __init__(self, n, seed):
            r = np.random.default_rng(seed)
            self.x = r.normal(size=(n, 1, 8, 8)).astype(np.float32)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return {"inp": self.x[i],
                    "target": (self.x[i, 0] > 0).astype(np.int64)}

    class Recording(pl.FixMatchSegLoss):
        def __call__(self, inp, rng=None, apply_fn=None):
            self.seen.append((rng, apply_fn, self.draw(inp, rng)))
            return self.loss(inp, *self.seen[-1][2], apply_fn)

    draws = []
    for run in range(2):
        model = UNet(device="cpu", dim=2, n_blocks=2, start_filts=8)
        fm = Recording()
        fm.seen = []
        tr = Trainer(model, pl.CEDiceLoss(), train_dataset=Data(4, 0),
                     unlabeled_dataset=Data(4, 1), ss_criterion=fm,
                     batch_size=2, save_root=str(tmp_path),
                     exp_name=f"fm{run}", enable_tensorboard=False, seed=3)
        tr.run(max_steps=3)
        assert len(fm.seen) == 3
        assert all(r is tr._ss_rng and f is model for r, f, _ in fm.seen)
        draws.append([d for _, _, d in fm.seen])
    assert draws[0] == draws[1]
