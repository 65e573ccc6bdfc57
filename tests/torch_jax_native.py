"""The JAX package's native IO library, built and loaded once before the
port's tests that hold the port against that package.

The JAX package builds its library on first use, `g++ -o` straight onto
the .so, with no lock across processes: a test worker that loads the .so
while another worker's link has it open and empty gets None from that
package's get_lib() and keeps it for the rest of the process. Each test
module that drives the library calls ready() as it is imported, and
pytest-xdist's workers import every module before any test runs, so each
worker finds the library built and whole: the first process builds it
under an fcntl lock in the port's native build directory, the others wait
on the lock and then find it up to date. The library is loaded with
ctypes to prove it whole, not through get_lib(), whose allocator settings
stay for the package's first use."""
import ctypes
import fcntl
import os

from pomfret_tpu_torch.io.native import BUILD_DIR

_READY = False


def ready() -> None:
    global _READY
    if _READY:
        return
    from pomfret_tpu.io import native

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "jax_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        fresh = (os.path.exists(native._SO)
                 and os.path.getmtime(native._SO)
                 >= os.path.getmtime(native._SRC))
        for _ in range(2):  # a .so left broken is built again, once
            if not fresh and not native._build():
                break
            try:
                ctypes.CDLL(native._SO)
                break
            except OSError:
                fresh = False
    _READY = True
