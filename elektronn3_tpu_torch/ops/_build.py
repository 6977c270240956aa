"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a``
(Hopper), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, which is
loaded with ``ctypes``. Nothing links against PyTorch's headers, so a
build takes seconds, not minutes. The library lands in
``elektronn3_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Concurrent builders write to a temporary name and rename
it into place.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("conv_bnact.cu", "conv_bnact_bwd.cu", "pool_bnact.cu",
           "upconv_bnact.cu", "batch_norm.cu", "conv_vup.cu", "conv_tc.cu",
           "upconv_tc.cu", "wgrad_tc.cu", "upconv_bwd_tc.cu",
           "upconv_stats_bwd_tc.cu", "dgrad_tc.cu", "conv1_bwd.cu",
           "conv_vup_tc.cu", "conv1_fwd.cu")
HEADERS = ("common.cuh", "conv_bnact.cuh", "upconv_vup.cuh", "tc.cuh",
           "conv_tc.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# argtypes of each C entry point (csrc/*.cu, extern "C").
_SIGNATURES = {
    "e3_conv_bnact": (_I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_conv_bnact_tc": (_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _P),
    "e3_upconv_bnact_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P),
    "e3_conv_bnact_dgrad": (_I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I,
                            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P),
    "e3_conv_bnact_dgrad_tc": (_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                               _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _P),
    "e3_conv1_bwd": (_I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "e3_conv_bnact_wgrad_tc": (_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                               _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "e3_upconv_bnact_bwd_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    "e3_conv_bnact_wgrad": (_I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                            _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "e3_pool_bnact": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_pool_bnact_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _P),
    "e3_conv1_fwd": (_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _P),
    "e3_upconv_bnact": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P),
    "e3_upconv_bnact_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_bn_stats": (_I, _P, _P, _P, _F, _P, _P, _F, _F, _P, _P, _L, _I, _I,
                    _I, _I, _P),
    "e3_bn_normalize": (_I, _P, _P, _P, _P, _L, _I, _P),
    "e3_bn_bwd_reduce": (_I, _P, _P, _P, _P, _P, _F, _P, _P, _L, _I, _I,
                         _I, _I, _P),
    "e3_bn_bwd_dx": (_I, _P, _P, _P, _P, _P, _P, _L, _I, _P),
    "e3_conv_vup": (_I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P,
                    _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "e3_conv_vup_dgrad": (_I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                          _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _P),
    "e3_conv_vup_wgrad": (_I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P,
                          _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                          _I, _P),
    "e3_conv_vup_chain": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _P),
    "e3_upconv_stats": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    "e3_upconv_stats_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_upconv_stats_bwd_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_conv_vup_wgrad_tc": (_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                             _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                             _I, _P),
    "e3_conv_vup_tc": (_P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P,
                       _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "e3_conv_vup_dgrad_tc": (_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                             _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _I, _P),
    "e3_upconv_stats_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # time of this process's build
build_log: str = ""                      # nvcc's output of that build


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from elektronn3_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the build directory unless a library
    of the same sources and flags is already there: one ``nvcc -c`` per
    source, run in parallel, then one link. ``verbose`` adds
    ``-Xptxas=-v`` (registers, shared memory and spills per kernel; the
    code is the same) and keeps nvcc's output in :data:`build_log`."""
    global build_seconds, build_log
    extra = ("-Xptxas=-v",) if verbose else ()
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"libe3kernels-{_digest()}.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp, Path(s).stem + ".o")) for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", "-o", o,
                 str(CSRC / s)] for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        for cmd, p in zip(cmds, procs):
            log = p.communicate()[0]
            logs.append(log)
            if p.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        lib = str(Path(tmp, "lib.so"))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
