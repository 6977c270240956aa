"""The direct 'same' convolution of the JAX package's
``ops/pallas_conv.py`` (``conv_direct``, row 28 of the kernel table in
PERF.md).

There it is a tap-packed Pallas kernel that packs the in-plane taps
into both matrix dimensions of the TPU's matrix unit; its one caller is
``benchmark/conv_microbench.py``. The function is a (kd, 3, 3) 'same'
stride-1 conv with no bias, kd = 1 if ``planar`` else 3, its output in
the input's dtype: K1 (``csrc/conv_bnact.cu``) with the identity
prologue, a zero bias and no statistics. No model path calls it, and it
has no gradient, as in JAX.
"""

from __future__ import annotations

import torch

from elektronn3_tpu_torch.ops import fused


def _check(x: torch.Tensor, weight: torch.Tensor, planar: bool) -> None:
    kd = 1 if planar else 3
    if weight.dim() != 5 or weight.shape[2:] != (kd, 3, 3):
        raise ValueError(f"conv_direct: weight {tuple(weight.shape)} is "
                         f"not (C_out, C_in, {kd}, 3, 3) (planar={planar})")
    fused._conv_contract([x], weight, False)


def _zero_bias(weight: torch.Tensor) -> torch.Tensor:
    return torch.zeros(weight.shape[0], dtype=torch.float32,
                       device=weight.device)


def conv_direct_kernel(x: torch.Tensor, weight: torch.Tensor
                       ) -> torch.Tensor:
    """K1 on a CUDA tensor, as :func:`conv_direct_plain`."""
    return fused.conv_bnact_fwd_kernel([x], None, None, weight,
                                       _zero_bias(weight), "linear",
                                       False)[0]


def conv_direct_plain(x: torch.Tensor, weight: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: the weight rounded to ``x``'s dtype, float32
    accumulation, the output rounded once."""
    return fused.conv_bnact_fwd_plain([x], None, None, weight,
                                      _zero_bias(weight), "linear")[0]


def conv_direct(x: torch.Tensor, weight: torch.Tensor, planar: bool = False,
                *, reference: bool = False) -> torch.Tensor:
    """'same' stride-1 conv without bias (JAX's ``conv_direct``).

    Args:
        x: (N, D, H, W, C_in) NDHWC input, float32 or bfloat16.
        weight: (C_out, C_in, kd, 3, 3) torch conv weight, kd = 1 if
            ``planar`` else 3, C_out % 32 == 0.
        planar: the (1, 3, 3) kernel.
        reference: the plain version whatever the device.
    Returns:
        (N, D, H, W, C_out) in ``x``'s dtype. A CPU tensor takes the
        plain version, a CUDA tensor K1.
    """
    _check(x, weight, planar)
    with torch.no_grad():
        if reference or x.device.type == "cpu":
            return conv_direct_plain(x, weight)
        return conv_direct_kernel(x.contiguous(), weight)
