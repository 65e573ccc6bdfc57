"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

The pattern of pomfret_tpu/io/native/__init__.py: sources under csrc/
compile into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), written to kernels/_build/ and named by
a hash of the sources and flags, so an edited source rebuilds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# IEEE division (-prec-div=true is nvcc's default; no --use_fast_math) and
# no contraction into FMAs, so the kernel's float math is the plain
# version's, operation for operation
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-prec-div=true",
              "-fmad=false"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME, or put it on "
                       "PATH); the CUDA kernels are built from source")


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpomfret_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the hashed library exists; returns its path.
    Raises with nvcc's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.pomfret_loop_launch.restype = ci
            lib.pomfret_loop_launch.argtypes = [ci] + [vp] * 8 + [ci] * 5 \
                + [vp]
            lib.pomfret_error_string.restype = ctypes.c_char_p
            lib.pomfret_error_string.argtypes = [ci]
            _LIB = lib
        return _LIB
