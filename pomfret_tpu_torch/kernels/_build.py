"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

The pattern of pomfret_tpu/io/native/__init__.py: the sources under csrc/
compile into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), written to kernels/_build/ and named by
a hash of every file under csrc/ and of the flags, so an edited source or
header rebuilds. Each .cu compiles in its own nvcc process, all started
together, and one more nvcc links the objects.
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
              "-O3", "-Xcompiler", "-fPIC", "-prec-div=true", "-fmad=false"]
_TIMEOUT_S = 600

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
    for path in sorted(glob.glob(os.path.join(_SRC_DIR, "*"))):
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpomfret_kernels_{h.hexdigest()[:16]}.so")


def _run(procs):
    """Wait for every (cmd, Popen); raise with the output of the first
    that failed."""
    failed = None
    for cmd, p in procs:
        try:
            out, _ = p.communicate(timeout=_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile csrc/*.cu unless the hashed library exists; returns its path.
    Raises with nvcc's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    tmp = f"{out}.tmp{tag}"
    try:
        _run(procs)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Every pointer and
    the stream are c_void_p, so ctypes passes them whole."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name, argtypes in (
                    ("pomfret_loop_launch", [ci] + [vp] * 12 + [ci] * 7),
                    ("pomfret_score_launch", [ci] + [vp] * 7 + [ci] * 5),
                    ("pomfret_score_commit_launch",
                     [ci] + [vp] * 8 + [ci] * 6),
                    ("pomfret_probe_row_copy_launch",
                     [ci] + [vp] * 6 + [ci] * 10),
                    ("pomfret_probe_lane_vec_launch", [vp] * 2 + [ci] * 7),
                    ("pomfret_probe_v3_loop_launch", [vp] * 3 + [ci] * 7),
                    ("pomfret_probe_stile_launch", [vp] * 4 + [ci] * 8),
                    ("pomfret_probe_stile_ratio_launch", [vp] * 2 + [ci] * 3),
                    ("pomfret_probe_empty_launch", [ci] * 4)):
                fn = getattr(lib, name)
                fn.restype = ci
                fn.argtypes = argtypes + [vp]  # the stream last
            for name, n_in in (("pomfret_loop_plan", 5),
                               ("pomfret_step_plan", 4)):
                fn = getattr(lib, name)
                fn.restype = ci
                fn.argtypes = [ci] * n_in + [ctypes.POINTER(ci)] * 3
            lib.pomfret_error_string.restype = ctypes.c_char_p
            lib.pomfret_error_string.argtypes = [ci]
            _LIB = lib
        return _LIB
