"""ctypes bindings for the host's C++ warp-interpolation kernels.

Counterpart of the JAX package's ``ops/native.py``: the kernels of
``native/warp_kernels.cpp`` (the reference's Numba gufuncs,
coord_transforms.py:27-130, in C++), built unchanged at first use with
g++ and JAX's flags (``-O3 -march=native``, so the two builds give the
same bits) into ``elektronn3_tpu_torch/_build/``, under a name that
carries a hash of the source, the flags and the host's CPU flags.
Concurrent builders (loader workers) write to a temporary name and
rename it into place.

Unlike the JAX loader, nothing here falls back: a missing source or
compiler, a failed build or a failed load raises. The numpy
``map_coordinates_*`` of ``coord_transforms`` are the plain versions of
these kernels, for the tests and for the dense-coordinate path.

The kernels check no bounds: callers guarantee that every coordinate
(+1 for linear) lies in ``src``. Nearest rounds with ``std::lround``,
halves away from zero (``warp_kernels.cpp:37``, ``:165``), where numpy's
``rint`` and the card's warp round halves to even.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR.parent / "native" / "warp_kernels.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu() -> bytes:
    """This host's CPU flags: ``-march=native`` builds for them, so a
    library built on another host is not loaded here."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return platform.processor().encode()


def build() -> Path:
    """Compile ``native/warp_kernels.cpp`` into ``_build/`` unless a
    library of the same source, flags and CPU is there; returns its
    path."""
    if not SRC.is_file():
        raise FileNotFoundError(f"the warp kernels' source {SRC} is missing")
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cpu()).hexdigest()[:16]
    out = BUILD_DIR / f"libwarp_kernels-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC}:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernels, built first where needed."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            for name in ("map_coordinates_nearest_f32",
                         "map_coordinates_linear_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [fp, i64, i64, i64, fp, i64, fp, fp]
                fn.restype = None
            for name in ("warp_interp_linear_f32", "warp_interp_nearest_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [fp, i64, i64, i64, fp, i64, i64, i64, fp,
                               ctypes.c_int, fp]
                fn.restype = None
            _LIB = lib
    return _LIB


def _map_coordinates(name, src, coords, lo):
    src = np.ascontiguousarray(src, np.float32)
    cshape = coords.shape[:-1]
    coords = np.ascontiguousarray(coords, np.float32).reshape(-1, 3)
    lo = np.ascontiguousarray(lo, np.float32)
    dest = np.empty(coords.shape[0], np.float32)
    getattr(library(), name)(src, *src.shape, coords, coords.shape[0], lo,
                             dest)
    return dest.reshape(cshape)


def map_coordinates_nearest(src: np.ndarray, coords: np.ndarray,
                            lo: np.ndarray) -> np.ndarray:
    """Nearest-neighbour gather of (D, H, W) ``src`` at ``coords - lo``
    ((..., 3) coordinates); the contract of
    ``coord_transforms.map_coordinates_nearest``."""
    return _map_coordinates("map_coordinates_nearest_f32", src, coords, lo)


def map_coordinates_linear(src: np.ndarray, coords: np.ndarray,
                           lo: np.ndarray) -> np.ndarray:
    """Trilinear gather; the contract of
    ``coord_transforms.map_coordinates_linear``."""
    return _map_coordinates("map_coordinates_linear_f32", src, coords, lo)


def warp_interp(src: np.ndarray, M_inv: np.ndarray, patch_shape,
                lo: np.ndarray, perspective: bool,
                discrete: bool) -> np.ndarray:
    """Transform and interpolate one (D, H, W) channel into a patch in
    one pass: ``M_inv`` (4, 4) maps patch coordinates to the source's,
    ``lo`` (3,) is the window's origin in the source."""
    lib = library()
    src = np.ascontiguousarray(src, np.float32)
    M_inv = np.ascontiguousarray(M_inv, np.float32).reshape(16)
    lo = np.ascontiguousarray(lo, np.float32)
    pd, ph, pw = (int(s) for s in patch_shape)
    dest = np.empty(pd * ph * pw, np.float32)
    fn = (lib.warp_interp_nearest_f32 if discrete
          else lib.warp_interp_linear_f32)
    fn(src, *src.shape, M_inv, pd, ph, pw, lo, int(perspective), dest)
    return dest.reshape((pd, ph, pw))
