"""Coordinate-space warping augmentation.

Counterpart of the JAX package's ``data/coord_transforms.py``
(reference elektronn3/data/coord_transforms.py): random affine and
perspective augmentation applied in coordinate space. The output
patch's voxel coordinates are mapped back into the source volume and
the source is sampled there, so the cost follows the patch size, not
the volume's.

- 4x4 homogeneous matrix builders          (reference :138-255)
- make_dest_coords/corners                 (:259-278)
- WarpingOOBError / WarpingSanityError     (:282-298)
- warp_slice                               (:301-521)
- get_warped_coord_transform               (:524-646)

The interpolation runs in the C++ kernels of ``data/native.py``; the
numpy ``map_coordinates_*`` below are their plain versions, used by
``warp_slice(debug=True)`` and the tests. Out-of-bounds samples are
caught from the matrix's corners before any data is read.

Randomness: every builder draws from the ``rng`` it is given or, with
none, from a ``numpy.random.Generator`` seeded from the process's
numpy random state (``np.random.randint``). So a loader that seeds that
state per sample gets the same matrices again, and each worker its own.
(The JAX package draws from a fresh, unseeded generator there.)
"""

from __future__ import annotations

import itertools
from functools import lru_cache, reduce
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from elektronn3_tpu_torch.data import native as _native
from elektronn3_tpu_torch.data.sources import DataSource, slice_3d

floatX = np.float32


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    """``rng``, or a generator seeded from numpy's global random state."""
    if rng is not None:
        return rng
    return np.random.default_rng(np.random.randint(2 ** 32))


# ---------------------------------------------------------------------------
# Interpolation: the plain numpy versions of the native gathers
# ---------------------------------------------------------------------------

def map_coordinates_nearest(src: np.ndarray, coords: np.ndarray,
                            lo: np.ndarray) -> np.ndarray:
    """Nearest-neighbor gather of ``src`` at ``coords - lo``.

    ``src``: (D, H, W); ``coords``: (..., 3) float; ``lo``: (3,).
    No bounds checking (parity with reference :27-48) — callers must
    guarantee in-bounds coordinates; indices are produced by rounding.
    """
    c = np.rint(coords - lo).astype(np.int64)
    return src[c[..., 0], c[..., 1], c[..., 2]]


def map_coordinates_linear(src: np.ndarray, coords: np.ndarray,
                           lo: np.ndarray) -> np.ndarray:
    """Trilinear gather of ``src`` at ``coords - lo``.

    Vectorized equivalent of the reference gufunc (:63-100): floor
    corner + 8-neighbor weighted sum. No bounds checking; every
    ``coords - lo + 1`` must be within ``src``'s bounds.
    """
    c = coords - lo
    c0 = c.astype(np.int64)  # truncation == floor for non-negative coords
    d = (c - c0).astype(src.dtype, copy=False)
    u0, v0, w0 = c0[..., 0], c0[..., 1], c0[..., 2]
    du, dv, dw = d[..., 0], d[..., 1], d[..., 2]
    u1, v1, w1 = u0 + 1, v0 + 1, w0 + 1
    return (src[u0, v0, w0] * (1 - du) * (1 - dv) * (1 - dw)
            + src[u1, v0, w0] * du * (1 - dv) * (1 - dw)
            + src[u0, v1, w0] * (1 - du) * dv * (1 - dw)
            + src[u0, v0, w1] * (1 - du) * (1 - dv) * dw
            + src[u1, v0, w1] * du * (1 - dv) * dw
            + src[u0, v1, w1] * (1 - du) * dv * dw
            + src[u1, v1, w0] * du * dv * (1 - dw)
            + src[u1, v1, w1] * du * dv * dw)


# ---------------------------------------------------------------------------
# Homogeneous 4x4 matrix builders (reference :133-255)
# ---------------------------------------------------------------------------

def identity() -> np.ndarray:
    return np.eye(4, dtype=floatX)


def translate(dz, dy, dx) -> np.ndarray:
    M = np.eye(4, dtype=floatX)
    M[0, 3], M[1, 3], M[2, 3] = dz, dy, dx
    return M


def rotate_z(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0],
                     [0, c, -s, 0],
                     [0, s, c, 0],
                     [0, 0, 0, 1]], dtype=floatX)


def rotate_y(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0],
                     [s, c, 0, 0],
                     [0, 0, 1, 0],
                     [0, 0, 0, 1]], dtype=floatX)


def rotate_x(a) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0],
                     [0, 1, 0, 0],
                     [-s, 0, c, 0],
                     [0, 0, 0, 1]], dtype=floatX)


def scale(mz, my, mx) -> np.ndarray:
    return np.diag(np.array([mz, my, mx, 1.0], dtype=floatX))


def scale_inv(mz, my, mx) -> np.ndarray:
    return scale(1 / mz, 1 / my, 1 / mx)


def chain_matrices(mat_list: Sequence[np.ndarray]) -> np.ndarray:
    return reduce(np.dot, mat_list, identity())


def get_random_rotmat(lock_z: bool = False, amount: float = 1.0,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _rng(rng)
    gamma = rng.random() * 2 * np.pi * amount
    if lock_z:
        return rotate_z(gamma)
    phi = rng.random() * 2 * np.pi * amount
    theta = np.arcsin(rng.random()) * amount
    return chain_matrices([rotate_z(gamma), rotate_y(-theta), rotate_z(-phi)])


def get_random_flipmat(no_x_flip: bool = False,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _rng(rng)
    F = np.eye(4, dtype=floatX)
    flips = rng.binomial(1, 0.5, 4) * 2 - 1
    flips[3] = 1
    if no_x_flip:
        flips[2] = 1
    np.fill_diagonal(F, flips)
    return F


def get_random_swapmat(lock_z: bool = False,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _rng(rng)
    S = np.eye(4, dtype=floatX)
    if lock_z:
        swaps = [[0, 1, 2, 3], [0, 2, 1, 3]]
    else:
        swaps = [[0, 1, 2, 3], [0, 2, 1, 3], [1, 0, 2, 3],
                 [1, 2, 0, 3], [2, 0, 1, 3], [2, 1, 0, 3]]
    return S[swaps[rng.integers(0, len(swaps))]]


def get_random_warpmat(lock_z: bool = False, perspective: bool = False,
                       amount: float = 1.0,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = _rng(rng)
    W = np.eye(4, dtype=floatX)
    amount = amount * 0.1
    perturb = rng.uniform(-amount, amount, (4, 4))
    perturb[3, 3] = 0
    if lock_z:
        perturb[0] = 0
        perturb[:, 0] = 0
    if not perspective:
        perturb[3] = 0
    perturb[3, :3] *= 0.05  # perspective params must be tiny
    np.clip(perturb[3, :3], -3e-3, 3e-3, out=perturb[3, :3])
    return (W + perturb).astype(floatX)


@lru_cache()
def make_dest_coords(sh: Tuple[int, int, int]) -> np.ndarray:
    """Homogeneous (z, y, x, 1) coordinate grid of shape ``sh + (4,)``.
    Reference :259-269."""
    zz, yy, xx = np.mgrid[0:sh[0], 0:sh[1], 0:sh[2]]
    hh = np.ones(sh, dtype=np.int64)
    coords = np.stack([zz, yy, xx, hh], axis=-1)
    return coords.astype(floatX)


@lru_cache()
def make_dest_corners(sh: Tuple[int, int, int]) -> np.ndarray:
    """Homogeneous coordinates of the 8 patch corners. Reference :272-278."""
    corners = np.array(list(itertools.product(*([0, 1],) * 3)))
    corners = corners * (np.subtract(sh, 1))
    return np.hstack([corners, np.ones((8, 1))])


class WarpingOOBError(ValueError):
    """Transformed coordinates refer to out-of-bounds areas — expected
    frequently with random warping; caught before any data is read and
    handled by retrying with a new random transform (reference :282-291)."""


class WarpingSanityError(Exception):
    """A numeric sanity check of coordinate warping failed (reference
    :293-298)."""


def warp_slice(
        inp_src: DataSource,
        patch_shape: Union[Tuple[int, ...], np.ndarray],
        M: np.ndarray,
        target_src: Optional[DataSource] = None,
        target_patch_shape: Optional[Union[Tuple[int, ...], np.ndarray]] = None,
        target_discrete_ix: Optional[Sequence[int]] = None,
        input_discrete_ix: Optional[Sequence[int]] = None,
        debug: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Cut a warped patch out of ``inp_src`` (and optionally
    ``target_src``) by inverse-mapping output coordinates through ``M``.

    Full semantics parity with reference warp_slice (:301-521):
    corner-based OOB pre-check → raise WarpingOOBError before reading;
    bounding-window HDF5 read; per-channel nearest (discrete) or
    trilinear (continuous) interpolation; target centering offsets.

    Returns ``(inp, target)`` with shapes ``(C,) + patch_shape`` /
    ``(C_t,) + target_patch_shape`` (channels-first host layout like the
    source files; the dataset layer transposes to channels-last before
    feeding the device).
    """
    patch_shape = tuple(int(s) for s in patch_shape)
    if len(inp_src.shape) == 3:
        n_f = 1
    elif len(inp_src.shape) == 4:
        n_f = inp_src.shape[0]
    else:
        raise ValueError(f"Can't handle inp_src shape {inp_src.shape}")
    inp_src_shape = np.array(inp_src.shape[-3:])

    M_inv = np.linalg.inv(M.astype(np.float64)).astype(floatX)
    perspective = bool(np.any(M[3, :3] != 0))
    dest_corners = make_dest_corners(patch_shape)
    src_corners = np.dot(M_inv, dest_corners.T).T
    if perspective:  # homogeneous divide
        src_corners /= src_corners[:, 3][:, None]
    src_corners = src_corners[:, :3]
    lo = np.min(np.floor(src_corners), 0).astype(np.int64)
    hi = np.max(np.ceil(src_corners + 1), 0).astype(np.int64)

    # Fast path: affine transforms (the overwhelmingly common case) use
    # the fused native C++ transform+interpolate kernels — the dense
    # (P, 3) source-coordinate array is never materialized. Corner-based
    # bounds are exact for affine maps (extrema at box vertices). The
    # dense-coordinate path (the native gathers; numpy under debug)
    # remains for perspective transforms and debug mode.
    fused = not debug and not perspective
    if fused:
        src_coords = None
    else:
        dest_coords = make_dest_coords(patch_shape)
        src_coords = np.tensordot(dest_coords, M_inv, axes=[[-1], [1]])
        if perspective:
            src_coords /= src_coords[..., 3][..., None]
        src_coords = src_coords[..., :3]

    if target_src is not None:
        target_src_shape = np.array(target_src.shape[-3:])
        target_patch_shape = tuple(int(s) for s in target_patch_shape)
        n_f_t = target_src.shape[0] if target_src.ndim == 4 else 1

        target_src_offset = np.subtract(inp_src_shape, target_src.shape[-3:])
        if np.any(np.mod(target_src_offset, 2)):
            raise ValueError("targets must be centered w.r.t. images")
        target_src_offset //= 2
        target_offset = np.subtract(patch_shape, target_patch_shape)
        if np.any(np.mod(target_offset, 2)):
            raise ValueError("targets must be centered w.r.t. images")
        target_offset //= 2

        if fused:
            # Bounds from the target subregion's corners.
            t_corners = make_dest_corners(target_patch_shape).copy()
            t_corners[:, :3] += target_offset
            src_t_corners = (M_inv @ t_corners.T).T[:, :3]
            lo_targ = np.floor(src_t_corners.min(0)
                               - target_src_offset).astype(np.int64)
            hi_targ = np.ceil(src_t_corners.max(0)
                              + 1 - target_src_offset).astype(np.int64)
        else:
            src_coords_target = src_coords[
                target_offset[0]:target_offset[0] + target_patch_shape[0],
                target_offset[1]:target_offset[1] + target_patch_shape[1],
                target_offset[2]:target_offset[2] + target_patch_shape[2]]
            lo_targ = np.floor(src_coords_target.reshape(-1, 3).min(0)
                               - target_src_offset).astype(np.int64)
            hi_targ = np.ceil(src_coords_target.reshape(-1, 3).max(0)
                              + 1 - target_src_offset).astype(np.int64)
        if np.any(lo_targ < 0) or np.any(hi_targ >= target_src_shape - 1):
            raise WarpingOOBError("Out of bounds for target_src")

    if np.any(lo < 0) or np.any(hi >= inp_src_shape - 1):
        raise WarpingOOBError("Out of bounds for inp_src")

    # Read the input bounding window (hi + 1: interpolation needs it).
    img_cut = slice_3d(inp_src, lo, hi + 1, dtype=floatX)
    if img_cut.ndim == 3:
        img_cut = img_cut[None]
    lo_f = lo.astype(floatX)

    if debug:
        rel = src_coords - lo_f
        if np.any(rel.reshape(-1, 3).max(0) >= img_cut.shape[-3:]):
            raise WarpingSanityError("src_coords check failed (too high)")
        if np.any(rel.reshape(-1, 3).min(0) < 0):
            raise WarpingSanityError("src_coords check failed (negative)")

    if input_discrete_ix is None:
        in_discrete = [False] * img_cut.shape[0]
    else:
        in_discrete = [i in input_discrete_ix for i in range(img_cut.shape[0])]
    inp = np.empty((n_f,) + patch_shape, dtype=floatX)
    use_native = not debug
    for k, discr in enumerate(in_discrete):
        if fused:
            inp[k] = _native.warp_interp(
                img_cut[k], M_inv, patch_shape, lo_f, False, discr)
        elif use_native:
            inp[k] = _native.map_coordinates_linear(
                img_cut[k], src_coords, lo_f) if not discr else \
                _native.map_coordinates_nearest(img_cut[k], src_coords, lo_f)
        else:
            fn = map_coordinates_nearest if discr else map_coordinates_linear
            inp[k] = fn(img_cut[k], src_coords, lo_f)

    if target_src is None:
        return inp, None

    target_cut = slice_3d(target_src, lo_targ, hi_targ + 1, dtype=floatX)
    if target_cut.ndim == 3:
        target_cut = target_cut[None]
    target = np.empty((n_f_t,) + target_patch_shape, dtype=floatX)
    lo_targ_f = (lo_targ + target_src_offset).astype(floatX)
    if target_discrete_ix is None:
        t_discrete = [True] * n_f_t
    else:
        t_discrete = [i in target_discrete_ix for i in range(n_f_t)]
    if fused:
        # Compose the target-subregion offset into the matrix:
        # dest' in [0, tps) maps to dest = dest' + target_offset.
        M_inv_target = M_inv @ translate(*target_offset)
    for k, discr in enumerate(t_discrete):
        if fused:
            target[k] = _native.warp_interp(
                target_cut[k], M_inv_target, target_patch_shape,
                lo_targ_f, False, discr)
        elif use_native:
            target[k] = _native.map_coordinates_nearest(
                target_cut[k], src_coords_target, lo_targ_f) if discr else \
                _native.map_coordinates_linear(
                    target_cut[k], src_coords_target, lo_targ_f)
        else:
            fn = map_coordinates_nearest if discr else map_coordinates_linear
            target[k] = fn(target_cut[k], src_coords_target, lo_targ_f)
        if discr and debug:
            unique_cut = set(np.unique(target_cut[k]).tolist())
            unique_warp = set(np.unique(target[k]).tolist())
            if not unique_warp.issubset(unique_cut):
                raise WarpingSanityError(
                    f"Invalid discrete target: warp introduced new values "
                    f"{unique_warp - unique_cut}")

    if debug and np.any(np.isnan(inp)):
        raise RuntimeError("Warping is broken: inp contains NaN.")
    if debug and target is not None and np.any(np.isnan(target)):
        raise RuntimeError("Warping is broken: target contains NaN.")
    return inp, target


def get_warped_coord_transform(
        inp_src_shape: Union[Tuple, np.ndarray],
        patch_shape: Union[Tuple, np.ndarray],
        aniso_factor: int = 2,
        sample_aniso: bool = True,
        warp_amount: float = 1.0,
        lock_z: bool = True,
        no_x_flip: bool = False,
        perspective: bool = False,
        target_src_shape: Optional[Union[Tuple, np.ndarray]] = None,
        target_patch_shape: Optional[Union[Tuple, np.ndarray]] = None,
        rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Compose random warping parameters into a single homogeneous 4x4
    transformation matrix M. Full parity with reference :524-646
    (random patch position, flip/swap/rotate/warp matrices, anisotropic
    source/dest scaling, M = T_dest·S_dest·R·W·F·S·S_src·T_src).
    """
    rng = _rng(rng)
    patch_shape = np.array(patch_shape)
    if target_patch_shape is not None:
        target_patch_shape = np.array(target_patch_shape)
    spatial_inp_src_shape = np.array(inp_src_shape[-3:])

    dest_center = patch_shape / 2
    src_remainder = (patch_shape % 2) / 2
    if target_patch_shape is not None:
        spatial_target_src_shape = np.array(target_src_shape[-3:])
        target_center = target_patch_shape / 2
        offset = (spatial_inp_src_shape - spatial_target_src_shape) // 2
        lo_pos = np.maximum(dest_center, target_center + offset)
        hi_pos = np.minimum(
            spatial_inp_src_shape - dest_center,
            spatial_target_src_shape - target_center + offset)
    else:
        lo_pos = dest_center
        hi_pos = spatial_inp_src_shape - dest_center
    if not np.all(lo_pos < hi_pos):
        raise RuntimeError(
            f"lo_pos: {lo_pos}, hi_pos: {hi_pos}\n"
            "lo_pos has to be smaller than hi_pos in all dimensions. Make "
            "sure your patch_shape is significantly smaller than the shape "
            "of the smallest labelled region of your data set.")
    z = rng.integers(lo_pos[0], hi_pos[0]) + src_remainder[0]
    y = rng.integers(lo_pos[1], hi_pos[1]) + src_remainder[1]
    x = rng.integers(lo_pos[2], hi_pos[2]) + src_remainder[2]

    F = get_random_flipmat(no_x_flip, rng)
    if no_x_flip:
        S = np.eye(4, dtype=floatX)
    else:
        S = get_random_swapmat(lock_z, rng)
    if np.isclose(warp_amount, 0):
        R = np.eye(4, dtype=floatX)
        W = np.eye(4, dtype=floatX)
    else:
        R = get_random_rotmat(lock_z, warp_amount, rng)
        W = get_random_warpmat(lock_z, perspective, warp_amount, rng)

    T_src = translate(-z, -y, -x)
    S_src = scale(aniso_factor, 1, 1)
    S_dest = scale(1.0 / aniso_factor, 1, 1) if sample_aniso else identity()
    T_dest = translate(dest_center[0], dest_center[1], dest_center[2])

    return chain_matrices([T_dest, S_dest, R, W, F, S, S_src, T_src])
