#!/usr/bin/env python3
"""Which decision flips between the port's and JAX's training steps in
``tests/test_torch_trainer_run.py``'s setup (CPU, float32).

    JAX_PLATFORMS=cpu python seeded_order_probe.py

The setup of ``test_swa_average_matches_jax``: JAX's ``Trainer`` on the
small UNet (``pallas_flat=False``, SGD under the test's ``CyclicLR``, a
train set of one batch), six steps, each step's parameters recorded.
Then, from JAX's parameters before each step and on that step's batch
(JAX's order: the same each epoch), the port's gradient (its kernel
plan, the kernels' plain versions) against ``jax.grad`` of the same
loss, beside the port's own change on an input moved by one ulp. At the
step where the two part by most against that noise, every leaf's
distance, the smallest pre-activation of the decoder's merge-conv norm
in JAX's forward, and
the port's library plan with that one relu forced inactive and active.
A report on stdout.
"""

import functools
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import test_torch_trainer_run as T  # noqa: E402

from elektronn3_tpu.models import unet as junet  # noqa: E402
from elektronn3_tpu.modules import loss as jloss  # noqa: E402
from elektronn3_tpu.training import Trainer as JTrainer  # noqa: E402
from elektronn3_tpu.training import schedulers as jsched  # noqa: E402
from elektronn3_tpu_torch.models import (  # noqa: E402
    UNet, flax_from_state_dict, state_dict_from_flax)
from elektronn3_tpu_torch.models import unet as punet  # noqa: E402
from elektronn3_tpu_torch.modules import loss as ploss  # noqa: E402


def leaves(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def exact_zero_grad(name):
    """A conv bias before a batch norm: its gradient is exactly 0."""
    return name.endswith("bias") and "Norm" not in name \
        and "conv_final" not in name


def worst(a, b, names):
    """The worst leaf of |a - b| / |b| (L2 norms)."""
    return max((float(np.linalg.norm(a[n] - b[n]))
                / float(np.linalg.norm(b[n])), n) for n in names)


def main():
    train = T.Patches(T.BATCH, 0)
    jmodel = junet.UNet(pallas_flat=False, **T.KW)
    jtr = JTrainer(
        jmodel, jloss.CEDiceLoss(1.0, 1.0),
        optimizer=optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3),
        train_dataset=train, batch_size=T.BATCH,
        schedulers={"lr": T._cyclic(jsched)}, save_root=tempfile.mkdtemp(),
        exp_name="jax", sample_plotting_handler=T._no_images,
        tb_hist_interval=0, enable_tensorboard=False)
    variables = jax.device_get({"params": jtr.state.params,
                                "batch_stats": jtr.state.batch_stats})
    before, orders = [variables["params"]], []
    jstep = jtr._train_step_jit
    first = train.inp[:, 0, 0, 0, 0]

    def recording(state, inp, target, rng, lr, unlabeled=None):
        orders.append([int(np.argmin(np.abs(first - v)))
                       for v in np.asarray(inp)[:, 0, 0, 0, 0]])
        out = jstep(state, inp, target, rng, lr, unlabeled)
        before.append(jax.device_get(out[0].params))
        return out
    jtr._train_step_jit = recording
    jtr.run(max_steps=T.STEPS)
    print(f"JAX's sample order at each step: {orders}")

    bs = variables["batch_stats"]
    x_np = np.moveaxis(train.inp, 1, -1)
    x, y = torch.from_numpy(x_np.copy()), torch.from_numpy(
        train.target.astype(np.int64))

    def port_grad(params, pallas_flat="auto", inp=x, norm_hook=None):
        m = UNet(device="cpu", pallas_flat=pallas_flat, **T.KW)
        m.load_state_dict(state_dict_from_flax(
            {"params": params, "batch_stats": bs}, m))
        real = punet.apply_norm
        if norm_hook is not None:
            punet.apply_norm = functools.partial(norm_hook, real)
        try:
            m.train()
            ploss.CEDiceLoss(1.0, 1.0)(m(inp), y).backward()
        finally:
            punet.apply_norm = real
        return leaves(flax_from_state_dict(
            {n: p.grad for n, p in m.named_parameters()}, variables,
            ("params",))["params"])

    def jax_loss(params, inp):
        out, _ = jmodel.apply({"params": params, "batch_stats": bs}, inp,
                              train=True, mutable=["batch_stats"])
        return jloss.CEDiceLoss(1.0, 1.0)(out, jnp.asarray(train.target))
    jax_grad = jax.jit(jax.grad(jax_loss))

    names = [n for n in leaves(variables["params"]) if not exact_zero_grad(n)]
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    print("From JAX's parameters before each step: worst leaf of |port - "
          "JAX| / |JAX|, and of the port's own move on an input moved by "
          "one ulp:")
    ratio = []
    for k in range(1, T.STEPS + 1):
        p = before[k - 1]
        g, jg = port_grad(p), leaves(jax.device_get(jax_grad(p, x_np)))
        gn = port_grad(p, inp=x * (1 + 2.0 ** -23 * noise))
        d, n = worst(g, jg, names)
        u = worst(gn, g, names)[0]
        ratio.append(d / u)
        print(f"  step {k}: {d:.3e} ({n}); one ulp {u:.3e}")
    # The step where the two part by most against the port's own noise.
    k = int(np.argmax(ratio)) + 1
    p = before[k - 1]
    g, jg = port_grad(p), leaves(jax.device_get(jax_grad(p, x_np)))
    print(f"Step {k}, every leaf (|port - JAX| / |JAX|):")
    for n in sorted(jg):
        d = float(np.linalg.norm(g[n] - jg[n]))
        print(f"  {n:28s} {d / (float(np.linalg.norm(jg[n])) + 1e-30):.3e}")

    _, st = jmodel.apply({"params": p, "batch_stats": bs}, x_np, train=True,
                         mutable=["batch_stats", "intermediates"],
                         capture_intermediates=True)
    pre = np.asarray(st["intermediates"]["up_0"]["BatchNorm_1"]["__call__"][0])
    at = np.unravel_index(np.argmin(np.abs(pre)), pre.shape)
    print(f"Step {k}: up_0/BatchNorm_1 (the decoder's merge-conv norm) in "
          f"JAX's forward: smallest |pre-activation| {float(pre[at]):.6e} at "
          f"{tuple(int(t) for t in at)}")

    # The port's library plan, whose norms apply_norm computes (the 6th
    # call is up_0's norm1), with that one relu forced either way.
    for mode in ("as computed", "inactive", "active"):
        seen = {}

        def hook(real, layer, t, reference=False, _n=[0]):
            out = real(layer, t, reference)
            _n[0] += 1
            if _n[0] == 6:
                seen["y"] = float(out.detach()[at])
                if mode != "as computed":
                    v = abs(float(pre[at])) * (-1 if mode == "inactive" else 1)
                    mask = torch.zeros_like(out)
                    mask[at] = 1
                    out = out + mask * (v - out.detach())
            return out
        gl = port_grad(p, pallas_flat=False, norm_hook=hook)
        d, n = worst(gl, jg, names)
        print(f"  port library plan, that relu {mode} (the port's own value "
              f"{seen['y']:.6e}): worst |port - JAX| / |JAX| {d:.3e} ({n})")


if __name__ == "__main__":
    main()
