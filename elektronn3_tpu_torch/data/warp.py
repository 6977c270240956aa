"""Warp interpolation and augmentation on the card.

Counterpart of the JAX package's ``ops/warp.py``: the host picks the
random 4x4 matrix, checks the patch's corners and reads a bounding
window; the per-voxel transform and the trilinear or nearest
interpolation run here, on tensors on the caller's device, for a whole
batch at once. In JAX this is an XLA gather, not a Pallas kernel; here
it is plain PyTorch: ``torch.take`` on the flat windows.

- ``warp_interpolate`` / ``warp_interpolate_batch``: one window / a
  batch of windows of one shape. JAX's lane-row gather
  (``_gather_lanes``, ``_lane_rows``, ``E3TPU_ROWGATHER``) answers the
  TPU's slow scalar gathers and has no counterpart here.
- ``elastic_displacement`` and ``warp_interpolate_elastic``: a smoothed
  random displacement added to the source coordinates, so elastic
  deformation needs no second interpolation.
- The photometric augmentations and ``normalize``, per sample on
  (N, *spatial, C) batches.

Each random function is a draw (``*_draw``, from an explicit
``torch.Generator`` on the tensors' device) and a pure apply
(``*_apply``), so that the tests can feed JAX's draws to the port.

Nearest rounds halves to even (``torch.round``, as ``jnp.round``); the
host's C++ nearest rounds them away from zero (``std::lround``), so the
two differ at exact .5 ties. Coordinates are clamped to the window:
the host's corner check makes every accepted sample's reads fall
inside it, and the clamp only guards rounding at its edges.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def dest_coords(patch_shape: Sequence[int], device=None) -> torch.Tensor:
    """Homogeneous (z, y, x, 1) coordinate grid, shape patch + (4,)."""
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in patch_shape]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([zz, yy, xx, torch.ones_like(zz)], dim=-1)


def _source_coords(M_invs: torch.Tensor, los: torch.Tensor,
                   patch_shape: Sequence[int]) -> torch.Tensor:
    """(N, *patch, 3) coordinates relative to each window: M_inv applied
    to the patch grid, divided by the homogeneous coordinate, minus
    ``lo``."""
    g = dest_coords(patch_shape, M_invs.device).unbind(-1)
    m = M_invs.float().view(-1, 1, 1, 1, 4, 4)
    # sum_j g_j * M_ij in pairs, (0 + 1) + (2 + 3): the order of the JAX
    # package's einsum on the CPU, so the two agree bit for bit
    src = [(g[0] * m[..., i, 0] + g[1] * m[..., i, 1])
           + (g[2] * m[..., i, 2] + g[3] * m[..., i, 3]) for i in range(4)]
    rel = torch.stack(src[:3], dim=-1) / src[3][..., None]
    return rel - los.float().view(-1, 1, 1, 1, 3)


def _interpolate(windows: torch.Tensor, rel: torch.Tensor, discrete: bool,
                 clamp_weights: bool = False) -> torch.Tensor:
    """Sample (N, D, H, W) float32 ``windows`` at (N, *patch, 3)
    window-relative coordinates. The bounds are Python numbers: a bounds
    tensor made from a list would be a blocking copy to the card, which
    waits for the work queued before it."""
    N, D, H, W = windows.shape
    flat = windows.reshape(-1)
    top = (D - 1, H - 1, W - 1)
    base = (torch.arange(N, device=windows.device) * (D * H * W)
            ).view(-1, 1, 1, 1)
    if discrete:
        r = torch.round(rel)
        iz, iy, ix = (r[..., k].clamp(0, top[k]).long() for k in range(3))
        return torch.take(flat, base + (iz * H + iy) * W + ix)
    c0 = [torch.floor(rel[..., k]).clamp(0, top[k] - 1) for k in range(3)]
    dz, dy, dx = ((rel[..., k].clamp(0, top[k]) if clamp_weights
                   else rel[..., k]) - c0[k] for k in range(3))
    iz, iy, ix = (c.long() for c in c0)
    e = base + (iz * H + iy) * W + ix

    def g(oz, oy, ox):
        return torch.take(flat, e + ((oz * H + oy) * W + ox))

    return (g(0, 0, 0) * (1 - dz) * (1 - dy) * (1 - dx)
            + g(1, 0, 0) * dz * (1 - dy) * (1 - dx)
            + g(0, 1, 0) * (1 - dz) * dy * (1 - dx)
            + g(0, 0, 1) * (1 - dz) * (1 - dy) * dx
            + g(1, 0, 1) * dz * (1 - dy) * dx
            + g(0, 1, 1) * (1 - dz) * dy * dx
            + g(1, 1, 0) * dz * dy * (1 - dx)
            + g(1, 1, 1) * dz * dy * dx)


def warp_interpolate_batch(windows: torch.Tensor, M_invs: torch.Tensor,
                           los: torch.Tensor,
                           patch_shape: Tuple[int, int, int],
                           discrete: bool = False) -> torch.Tensor:
    """Warp-sample a patch from each of ``windows`` (N, D, H, W; any real
    dtype, sampled in float32) by ``M_invs`` (N, 4, 4: patch coordinates
    to source coordinates) and window origins ``los`` (N, 3). Returns
    (N,) + patch_shape float32: trilinear, or nearest with
    ``discrete``."""
    rel = _source_coords(M_invs, los, patch_shape)
    return _interpolate(windows.float(), rel, discrete)


def out_of_window(M_invs: torch.Tensor, los: torch.Tensor,
                  patch_shape: Tuple[int, int, int],
                  window_shape: Sequence[int]) -> int:
    """How many voxels of the patches that ``M_invs`` and ``los`` sample
    lie outside windows of ``window_shape``: the voxels that the warp
    would clamp to a window's edge."""
    rel = _source_coords(M_invs, los, patch_shape)
    out = [(rel[..., k] < 0) | (rel[..., k] > window_shape[k] - 1)
           for k in range(3)]
    return int((out[0] | out[1] | out[2]).sum())


def warp_interpolate(window: torch.Tensor, M_inv: torch.Tensor,
                     lo: torch.Tensor, patch_shape: Tuple[int, int, int],
                     discrete: bool = False) -> torch.Tensor:
    """``warp_interpolate_batch`` of one (D, H, W) window."""
    return warp_interpolate_batch(window[None], M_inv[None], lo[None],
                                  patch_shape, discrete)[0]


# ---------------------------------------------------------------------------
# Elastic deformation (reference WIP inline elastic,
# coord_transforms.py:395-418)
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(sigma: float, device=None) -> torch.Tensor:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _smooth3d(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian smoothing of a (D, H, W) field, zero-padded at
    the borders (scipy's mode='constant')."""
    k = _gaussian_kernel1d(sigma, field.device)
    r = (k.shape[0] - 1) // 2
    x = field[None, None]
    for axis in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = k.shape[0]
        pad = [0, 0, 0]
        pad[axis] = r
        x = F.conv3d(x, k.view(shape), padding=tuple(pad))
    return x[0, 0]


def elastic_displacement_draw(patch_shape: Tuple[int, int, int],
                              generator: torch.Generator,
                              device=None) -> torch.Tensor:
    """The (3, *patch) U(-1, 1) noise of one displacement field."""
    u = torch.rand((3,) + tuple(patch_shape), generator=generator,
                   device=device)
    return u * 2 - 1


def elastic_displacement_apply(noise: torch.Tensor, sigma: float = 4.0,
                               alpha: float = 40.0,
                               aniso_factor: float = 1.0) -> torch.Tensor:
    """Displacement (*patch, 3) from (3, *patch) noise: per dimension
    gaussian_filter(noise, sigma) * alpha, the z part divided by
    ``aniso_factor`` (reference coord_transforms.py:400-414)."""
    comps = []
    for i in range(3):
        d = _smooth3d(noise[i], sigma) * alpha
        if i == 0 and aniso_factor != 1.0:
            d = d / aniso_factor
        comps.append(d)
    return torch.stack(comps, dim=-1)


def elastic_displacement(generator: torch.Generator,
                         patch_shape: Tuple[int, int, int],
                         sigma: float = 4.0, alpha: float = 40.0,
                         aniso_factor: float = 1.0,
                         device=None) -> torch.Tensor:
    """A random smoothed displacement field, shape patch + (3,)."""
    return elastic_displacement_apply(
        elastic_displacement_draw(patch_shape, generator, device),
        sigma, alpha, aniso_factor)


def warp_interpolate_elastic(window: torch.Tensor, M_inv: torch.Tensor,
                             lo: torch.Tensor, displacement: torch.Tensor,
                             patch_shape: Tuple[int, int, int],
                             discrete: bool = False) -> torch.Tensor:
    """``warp_interpolate`` with ``displacement`` (*patch, 3) added to
    the source coordinates; the displaced coordinates are clamped to
    the window (the reference clips to the read bounds,
    coord_transforms.py:415-418)."""
    rel = _source_coords(M_inv[None], lo[None], patch_shape) \
        + displacement[None]
    return _interpolate(window[None].float(), rel, discrete,
                        clamp_weights=True)[0]


# ---------------------------------------------------------------------------
# Photometric augmentations on (N, *spatial, C) batches
# ---------------------------------------------------------------------------

def _per_sample(n: int, ndim: int) -> Tuple[int, ...]:
    return (n,) + (1,) * (ndim - 1)


def _bernoulli(n: int, prob: float, generator, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) < prob


def brightness_contrast_draw(n: int, generator: torch.Generator,
                             brightness_std: float = 0.5,
                             contrast_std: float = 0.5, prob: float = 1.0,
                             device=None):
    """(a, b, apply), each (n,): contrast, brightness, whether to
    apply."""
    a = 1 + torch.randn(n, generator=generator, device=device) * contrast_std
    b = torch.randn(n, generator=generator, device=device) * brightness_std
    return a, b, _bernoulli(n, prob, generator, device)


def brightness_contrast_apply(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor,
                              apply: torch.Tensor) -> torch.Tensor:
    """``a * (x - mean) + mean + b`` per sample where ``apply``."""
    shape = _per_sample(x.shape[0], x.ndim)
    m = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    aug = a.view(shape) * (x - m) + m + b.view(shape)
    return torch.where(apply.view(shape), aug, x)


def random_brightness_contrast(x: torch.Tensor, generator: torch.Generator,
                               brightness_std: float = 0.5,
                               contrast_std: float = 0.5,
                               prob: float = 1.0) -> torch.Tensor:
    """Per-sample brightness/contrast jitter; the card's counterpart of
    ``transforms.RandomBrightnessContrast``."""
    return brightness_contrast_apply(x, *brightness_contrast_draw(
        x.shape[0], generator, brightness_std, contrast_std, prob,
        x.device))


def gaussian_noise_draw(shape: Sequence[int], generator: torch.Generator,
                        sigma: float = 0.1, prob: float = 1.0, device=None):
    """(noise of ``shape``, apply (N,))."""
    noise = torch.randn(tuple(shape), generator=generator,
                        device=device) * sigma
    return noise, _bernoulli(shape[0], prob, generator, device)


def gaussian_noise_apply(x: torch.Tensor, noise: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    shape = _per_sample(x.shape[0], x.ndim)
    return x + torch.where(apply.view(shape), noise.to(x.dtype),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def additive_gaussian_noise(x: torch.Tensor, generator: torch.Generator,
                            sigma: float = 0.1,
                            prob: float = 1.0) -> torch.Tensor:
    """The card's counterpart of ``transforms.AdditiveGaussianNoise``."""
    return gaussian_noise_apply(x, *gaussian_noise_draw(
        x.shape, generator, sigma, prob, x.device))


def gamma_draw(n: int, generator: torch.Generator, gamma_std: float = 0.5,
               prob: float = 1.0, device=None):
    """(gamma, apply), each (n,): gamma = exp(N(0, gamma_std))."""
    gamma = torch.exp(torch.randn(n, generator=generator, device=device)
                      * gamma_std)
    return gamma, _bernoulli(n, prob, generator, device)


def gamma_apply(x: torch.Tensor, gamma: torch.Tensor,
                apply: torch.Tensor) -> torch.Tensor:
    """Per sample: min-max normalize, raise to ``gamma``, scale back."""
    shape = _per_sample(x.shape[0], x.ndim)
    axes = tuple(range(1, x.ndim))
    lo = x.amin(dim=axes, keepdim=True)
    hi = x.amax(dim=axes, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-8)
    aug = torch.pow((x - lo) / span, gamma.view(shape)) * span + lo
    return torch.where(apply.view(shape), aug, x)


def random_gamma(x: torch.Tensor, generator: torch.Generator,
                 gamma_std: float = 0.5, prob: float = 1.0) -> torch.Tensor:
    """The card's counterpart of ``transforms.RandomGammaCorrection``
    (per-sample gamma on min-max normalized values, scaled back)."""
    return gamma_apply(x, *gamma_draw(x.shape[0], generator, gamma_std,
                                      prob, x.device))


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel (last axis) normalization."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std
