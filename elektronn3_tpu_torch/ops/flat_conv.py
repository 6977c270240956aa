"""The semi-fused flat executor's ops on NDHWC tensors.

Counterpart of the JAX package's ``ops/flat_conv.py``. There a level's
full-resolution activations live in a 128-lane flat layout (rows of
four w-positions by 32 channels, zero width and row pads, channel lists
of 32-lane chunks) so that the TPU's matrix unit runs full; the layout,
its width masks and its row pads are TPU artefacts, and the port keeps
plain contiguous NDHWC tensors. What carries over is each function:

- :func:`flat_conv3`: the 'same' stride-1 (kd, 3, 3) conv plus bias
  over one or two inputs (a merge conv's list in concat order), with no
  prologue and no statistics of its own (``flat_conv3``, rows 26 and 27
  of the kernel table in PERF.md). On the port it is K1 with the
  identity prologue; its backward is K4 (the dgrad: JAX runs the same
  ``pallas_call`` with flipped, transposed weights, ``_flip_transpose``)
  and K5 (``_wgrad``: dW and db in float32);
- :func:`pool_flat`: the (1, 2, 2) max pool, as two reductions (w pairs,
  then h pairs) whose gradient splits a tie evenly among the tied
  elements at each stage, as JAX's ``reduce_max`` gradient does. XLA in
  JAX, plain torch here (``torch.amax`` splits ties the same way;
  ``F.max_pool3d`` routes a tie's gradient to one element and K6 to
  every tied element in full).

The other XLA companions (``conv3_into_flat``,
``upconv2_transpose_to_flat``, ``conv1x1_from_flat``) are library ops in
the port, as they are XLA in JAX: ``models/unet.py`` calls the library
conv, transposed conv and 1x1 conv with the weight and bias rounded to
the model dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from elektronn3_tpu_torch.ops import fused


def flat_conv3(xs: Sequence[torch.Tensor], weight: torch.Tensor,
               bias: torch.Tensor, *, want_stats: bool = False,
               reference: bool = False):
    """'same' stride-1 (kd, 3, 3) conv plus bias over NDHWC inputs
    (JAX's ``flat_conv3``, ``_FlatConv``).

    Args:
        xs: one or two (N, D, H, W, C_i) tensors of one dtype, each C_i
            a multiple of 32 (a merge conv's inputs in concat order).
        weight: (C_out, sum C_i, kd, 3, 3), kd in {1, 3}.
        bias: (C_out,).
        want_stats: also return the per-channel float32 (sum, sumsq) of
            the stored output, which the following batch norm reads (in
            JAX ``FlatBatchNorm`` reduces the same stored values itself).
        reference: run K1/K4/K5's plain versions whatever the device.
    Returns:
        (N, D, H, W, C_out) in the inputs' dtype, or (y, s, q).

    The weight and bias are rounded to the inputs' dtype at every width,
    as ``_FlatConv`` rounds them (elektronn3_tpu/models/unet.py:260), so
    their gradients come back through that cast (dW and db rounded to
    the dtype, as ``_flat_conv3_bwd`` returns them); accumulation and
    the bias add are float32 and the output is rounded once.
    """
    dtype = xs[0].dtype
    return fused.conv_bnact([x.contiguous() for x in xs], None, None,
                            weight.to(dtype), bias.to(dtype), "linear",
                            want_stats=want_stats, reference=reference)


def pool_flat(x: torch.Tensor) -> torch.Tensor:
    """(1, 2, 2) max pool of an NDHWC tensor with even H and W, written
    as JAX's ``pool_flat`` writes it: the max over w pairs, then over h
    pairs, each a reduction whose gradient splits a tie evenly."""
    n, d, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"pool_flat: H and W must be even, got "
                         f"{tuple(x.shape)}")
    u = torch.amax(x.reshape(n, d, h, w // 2, 2, c), dim=4)
    return torch.amax(u.reshape(n, d, h // 2, 2, w // 2, c), dim=3)
