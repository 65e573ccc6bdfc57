"""Keep large heap buffers guest-resident across alloc/free cycles.

On the virtualized benchmark hosts, first touch of memory the guest has
never used (or has returned to the hypervisor) costs ~7-25 ms/MB — ~100x
the warm page-fault rate. glibc munmaps any freed chunk above
M_MMAP_THRESHOLD (128 KB default), so every whole-chromosome plain-BAM
span (~400 MB) and every large packing buffer is handed back to the host
and re-paid on the next allocation; measured e2e this was the single
largest window-load cost (3-8 s per chromosome of pure fault service).

Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps those buffers in the
main arena, where free() retains the pages for the next allocation:
repeat 400 MB alloc+touch cycles drop from ~3 s to ~5 ms. Peak RSS grows
to the high-water mark of concurrently live buffers (hundreds of MB for
WGS-scale runs on a 128 GB host) — the classic memory-for-latency trade
the reference makes globally by running a long-lived multi-GB process.

The reference counterpart is htslib's block-cache + thread-pool buffer
reuse (bgzf.c keeps per-thread compression buffers alive for the file's
lifetime); this is the allocator-level equivalent for a numpy pipeline.

POMFRET_NO_MALLOC_TUNE=1 disables (e.g. for RSS-constrained runs).
"""
import ctypes
import os

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def keep_memory_resident(threshold_bytes: int = 1 << 30) -> bool:
    """Idempotent; returns True when the thresholds were applied."""
    global _done
    if _done:
        return True
    if os.environ.get("POMFRET_NO_MALLOC_TUNE"):
        return False
    try:
        libc = ctypes.CDLL(None)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)) and ok
    except Exception:
        return False
    _done = ok
    return ok
