"""Logging / timing helpers.

Mirrors the reference's stderr conventions ([M::fn] / [W::..] / [E::..] /
[dbg::..] / [T::..], cli.c:16-25, main.c:22) and the wall-clock + peak-RSS
reporting (Get_T/Get_U at cli.c:16-25).
"""
import resource
import sys
import time

_VERBOSE = 0
_HAS_IMPLICIT = False  # global_data_has_implicit (cli.c:14)


def set_data_has_implicit() -> None:
    global _HAS_IMPLICIT
    _HAS_IMPLICIT = True


def data_has_implicit() -> bool:
    return _HAS_IMPLICIT


def set_verbose(v: int) -> None:
    global _VERBOSE
    _VERBOSE = v


def get_verbose() -> int:
    return _VERBOSE


def Get_T() -> float:
    return time.time()


def Get_U() -> float:
    # peak RSS in GiB (ru_maxrss is KiB on Linux)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1048576.0


def _emit(prefix: str, func: str, msg: str) -> None:
    sys.stderr.write(f"[{prefix}::{func}] {msg}\n")


def log_info(func: str, msg: str) -> None:
    _emit("M", func, msg)


def log_warn(func: str, msg: str) -> None:
    _emit("W", func, msg)


def log_err(func: str, msg: str) -> None:
    _emit("E", func, msg)


def log_dbg(func: str, msg: str) -> None:
    if _VERBOSE > 0:
        _emit("dbg", func, msg)
