"""ctypes loader for the C++ IO fast paths (builds on first use).

Every entry point has a pure-Python fallback; `native_available()` gates use.

The library is built into BUILD_DIR, named by a hash of the source and the
compiler flags, so an edited source or another flag set builds anew. The
build holds an exclusive lock on BUILD_DIR/lock, compiles to a temporary
file and renames it into place: concurrent processes (test workers) build
once and never load a half-written library. A rung of the link ladder that
fails to build leaves `<library>.failed` beside it, so later processes go
straight to the next rung (remove BUILD_DIR to try again, for example
after installing libdeflate).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ...utils.malloc_tune import keep_memory_resident

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pomfret_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
# prefer libdeflate for BGZF payload decode (htslib does the same, ~2-3x
# zlib inflate); fall back to plain zlib when it is absent
_LINK_LADDER = (["-DUSE_LIBDEFLATE", "-ldeflate"], [])
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _flags():
    # POMFRET_NATIVE_SANITIZE=1 builds with ASan+UBSan (the reference's
    # `make dbg` analog, Makefile:17-18)
    if os.environ.get("POMFRET_NATIVE_SANITIZE"):
        return ["-O1", "-g", "-fsanitize=address,undefined",
                "-fno-omit-frame-pointer"]
    return ["-O3"]


def library_path(extra) -> str:
    """Where the library built with `extra` link flags lives."""
    h = hashlib.sha256(" ".join(_flags() + list(extra)).encode() + b"\0")
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpomfret_native_{h.hexdigest()[:16]}.so")


def _compile(out: str, extra) -> bool:
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *_flags(), "-shared", "-fPIC", "-o", tmp, _SRC,
                        *extra, "-lz", "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The first rung of the link ladder that builds (or was built) and
    loads, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        for extra in _LINK_LADDER:
            out = library_path(extra)
            if not os.path.exists(out):
                if os.path.exists(out + ".failed"):
                    continue
                if not _compile(out, extra):
                    open(out + ".failed", "w").close()
                    continue
            try:
                return ctypes.CDLL(out)
            except OSError:
                continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        # Large scratch buffers cycle through every native hot path; keeping
        # them guest-resident across alloc/free is worth seconds per
        # chromosome on the virtualized hosts (utils/malloc_tune.py).
        # Invoked here (first native use) rather than at module import so
        # embedding consumers that never call the native paths keep the
        # default allocator behavior (POMFRET_NO_MALLOC_TUNE=1 disables).
        keep_memory_resident()
        lib = _load()
        if lib is None:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bgzf_scan_blocks.restype = ctypes.c_int64
        lib.bgzf_scan_blocks.argtypes = [u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
        lib.bgzf_inflate_blocks.restype = ctypes.c_int32
        lib.bgzf_inflate_blocks.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p,
                                            ctypes.c_int64, u8p, ctypes.c_int]
        lib.bgzf_deflate_blocks.restype = ctypes.c_int32
        lib.bgzf_deflate_blocks.argtypes = [u8p, i64p, i64p, ctypes.c_int64,
                                            ctypes.c_int, u8p, i64p, i64p,
                                            ctypes.c_int]
        lib.bam_scan_records.restype = ctypes.c_int64
        lib.bam_scan_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint16), u8p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.bam_scan_bgzf.restype = ctypes.c_int64
        lib.bam_scan_bgzf.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i64p,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.bam_scan_bgzf_take.restype = None
        lib.bam_scan_bgzf_take.argtypes = [
            ctypes.c_void_p, *lib.bam_scan_records.argtypes[4:]]
        lib.rans4x8_uncompress.restype = ctypes.c_int32
        lib.rans4x8_uncompress.argtypes = [u8p, ctypes.c_int64,
                                           u8p, ctypes.c_int64]
        i32 = ctypes.c_int32
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.bam_window_load.restype = ctypes.c_int64
        lib.bam_window_load.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
            i32, ctypes.c_int64, ctypes.c_int64,
            i32, i32, ctypes.c_double, i32, i32, ctypes.c_int64, i32,
            i64p, i32p, i32p, i8p, i32p, i32p, i8p,
            i64p, u8p, ctypes.c_int64,
            i64p, i32p, u32p, u8p, ctypes.c_int64,
            i32p, i64p]
        lib.varhaptag_reads.restype = ctypes.c_int64
        lib.varhaptag_reads.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
            i32, ctypes.c_int64, ctypes.c_int64,
            i64p, u8p, i32p, u8p, i64p, u8p, ctypes.c_int64,
            i32, ctypes.c_int64,
            i64p, u8p, i8p, i64p, u8p, ctypes.c_int64]
        lib.mmr_extract_reads.restype = ctypes.c_int64
        lib.mmr_extract_reads.argtypes = [
            u32p, u8p, ctypes.c_int64,
            u32p, u8p, i64p, i32p, ctypes.c_int64, i32,
            u32p, ctypes.c_int64, i64p, i32p, u32p]
        lib.mmr_extract_multi.restype = None
        lib.mmr_extract_multi.argtypes = [
            u32p, u8p, i64p,
            i64p, i64p, i64p, i64p,
            i64p, ctypes.c_int64, i32,
            u32p, i64p, i64p,
            i64p, i32p, u32p,
            i64p, i64p]
        lib.mer_runs_multi.restype = None
        lib.mer_runs_multi.argtypes = [
            i64p, i64p, i64p, i64p, i64p,
            i64p, i64p, i64p, i64p,
            ctypes.c_int64, i32,
            u8p, i32p, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p]
        lib.meth_decode_read.restype = i32
        lib.meth_decode_read.argtypes = [
            u8p, i32, i32, ctypes.c_char_p, u8p, i32,
            ctypes.POINTER(ctypes.c_uint32), i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_uint32), u8p, i32,
            ctypes.POINTER(i32)]
        lib.bam_retag_hp.restype = ctypes.c_int64
        lib.bam_retag_hp.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            u8p, i64p, i32p, ctypes.c_int64,
            u8p, i64p, i32p, ctypes.c_int64, i32, i32,
            i64p, i64p, i64p, i64p, i32p, i32,
            i32p, i64p, ctypes.c_int64, i64p, i64p]
        lib.mer_grid_fill.restype = ctypes.c_int64
        lib.mer_grid_fill.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64,
            u32p, ctypes.c_int64,
            i64p, ctypes.c_int64,
            i8p, ctypes.c_int64, ctypes.c_int64, u8p]
        lib.mer_runs_fill.restype = ctypes.c_int64
        lib.mer_runs_fill.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64,
            u32p, ctypes.c_int64,
            i64p, ctypes.c_int64,
            u8p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p]
        lib.site_select.restype = ctypes.c_int64
        lib.site_select.argtypes = [
            u32p, u8p, ctypes.c_int64, ctypes.c_int64,
            u32p, ctypes.c_int64]
        lib.gzip_decompress_buf.restype = ctypes.c_int64
        lib.gzip_decompress_buf.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.cram_decode_slice.restype = ctypes.c_int64
        lib.cram_decode_slice.argtypes = [
            u8p, i32p, i64p, i64p, i32,               # ext blocks
            u8p, ctypes.c_int64,                      # core
            i32, ctypes.c_int64, i32,                 # slice ref/start/n_rec
            i32, i32, u8p,                            # rn/ap-delta/sub matrix
            i32p, i64p, u8p,                          # series encodings
            i32p, i32, i32p,                          # tag dict
            i32p, i32p, i64p, u8p, i32,               # tag encodings
            u8p, ctypes.c_int64, ctypes.c_int64,      # ref slice
            u8p, i64p, i32,                           # rg ids
            u8p, ctypes.c_int64, i64p]                # out + metas
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def _p(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def bgzf_inflate_all(comp: bytes, n_threads: int = 4) -> Optional[bytes]:
    """Decompress an entire BGZF byte buffer with the native thread pool."""
    lib = get_lib()
    if lib is None:
        return None
    comp_a = np.frombuffer(comp, dtype=np.uint8)
    max_blocks = len(comp) // 28 + 2
    offs = np.zeros(max_blocks, dtype=np.int64)
    isize = np.zeros(max_blocks, dtype=np.int64)
    n = lib.bgzf_scan_blocks(_p(comp_a, ctypes.c_uint8), len(comp),
                             _p(offs, ctypes.c_int64), _p(isize, ctypes.c_int64),
                             max_blocks)
    if n < 0:
        return None
    out_offs = np.zeros(n, dtype=np.int64)
    np.cumsum(isize[: n - 1], out=out_offs[1:]) if n > 1 else None
    total = int(isize[:n].sum())
    out = np.empty(total, dtype=np.uint8)
    r = lib.bgzf_inflate_blocks(_p(comp_a, ctypes.c_uint8), len(comp),
                                _p(offs, ctypes.c_int64), _p(out_offs, ctypes.c_int64),
                                _p(isize, ctypes.c_int64), n,
                                _p(out, ctypes.c_uint8), n_threads)
    if r != 0:
        return None
    return out.tobytes()


def bgzf_block_table(comp) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(byte offset in `comp`, uncompressed size) of every BGZF block."""
    lib = get_lib()
    if lib is None:
        return None
    comp_a = np.frombuffer(comp, dtype=np.uint8)
    max_blocks = len(comp) // 28 + 2
    offs = np.zeros(max_blocks, dtype=np.int64)
    isize = np.zeros(max_blocks, dtype=np.int64)
    n = lib.bgzf_scan_blocks(_p(comp_a, ctypes.c_uint8), len(comp),
                             _p(offs, ctypes.c_int64), _p(isize, ctypes.c_int64),
                             max_blocks)
    if n < 0:
        return None
    return offs[:n].copy(), isize[:n].copy()


def bgzf_deflate_all(payload: bytes, level: int = 6, n_threads: int = 4,
                     chunk: int = 0xFF00) -> Optional[bytes]:
    """Compress a payload into BGZF blocks (no EOF marker appended)."""
    lib = get_lib()
    if lib is None:
        return None
    pay = np.frombuffer(payload, dtype=np.uint8)
    n_chunks = max(1, (len(payload) + chunk - 1) // chunk)
    in_offs = np.arange(n_chunks, dtype=np.int64) * chunk
    in_lens = np.full(n_chunks, chunk, dtype=np.int64)
    if len(payload) % chunk:
        in_lens[-1] = len(payload) % chunk
    if len(payload) == 0:
        in_lens[0] = 0
    worst = chunk + chunk // 2 + 64 + 26
    out_offs = np.arange(n_chunks, dtype=np.int64) * worst
    out_lens = np.zeros(n_chunks, dtype=np.int64)
    out = np.empty(n_chunks * worst, dtype=np.uint8)
    r = lib.bgzf_deflate_blocks(_p(pay, ctypes.c_uint8),
                                _p(in_offs, ctypes.c_int64), _p(in_lens, ctypes.c_int64),
                                n_chunks, level, _p(out, ctypes.c_uint8),
                                _p(out_offs, ctypes.c_int64), _p(out_lens, ctypes.c_int64),
                                n_threads)
    if r != 0:
        return None
    parts = [out[out_offs[i]: out_offs[i] + out_lens[i]].tobytes()
             for i in range(n_chunks)]
    return b"".join(parts)


def bgzf_deflate_all_chunks(payload: bytes, lens, level: int = 6,
                            n_threads: int = 4):
    """Compress explicit payload chunks into BGZF blocks.
    Returns (concatenated blocks bytes, [block sizes]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    pay = np.frombuffer(payload, dtype=np.uint8)
    n_chunks = len(lens)
    if n_chunks == 0:
        return b"", []
    in_lens = np.asarray(lens, dtype=np.int64)
    in_offs = np.zeros(n_chunks, dtype=np.int64)
    np.cumsum(in_lens[:-1], out=in_offs[1:])
    worst = int(in_lens.max()) + int(in_lens.max()) // 2 + 64 + 26
    out_offs = np.arange(n_chunks, dtype=np.int64) * worst
    out_lens = np.zeros(n_chunks, dtype=np.int64)
    out = np.empty(n_chunks * worst, dtype=np.uint8)
    r = lib.bgzf_deflate_blocks(_p(pay, ctypes.c_uint8),
                                _p(in_offs, ctypes.c_int64), _p(in_lens, ctypes.c_int64),
                                n_chunks, level, _p(out, ctypes.c_uint8),
                                _p(out_offs, ctypes.c_int64), _p(out_lens, ctypes.c_int64),
                                max(1, n_threads))
    if r != 0:
        return None
    parts = [out[out_offs[i]: out_offs[i] + out_lens[i]].tobytes()
             for i in range(n_chunks)]
    return b"".join(parts), [int(x) for x in out_lens]


# the columns of a record scan, in the order of bam_scan_records' arrays
_SCAN_COLUMNS = (
    ("rec_off", np.int64), ("refID", np.int32), ("pos", np.int32),
    ("flag", np.uint16), ("mapq", np.uint8), ("l_seq", np.int32),
    ("endpos", np.int32), ("hp", np.int32), ("de", np.float32))


def _scan_arrays(n: int):
    """Empty scan columns of n records, and their pointers in argument
    order."""
    cols = {k: np.empty(n, dtype=dt) for k, dt in _SCAN_COLUMNS}
    return cols, [_p(cols[k], np.ctypeslib.as_ctypes_type(dt))
                  for k, dt in _SCAN_COLUMNS]


def bam_scan(buf: bytes, start: int) -> Optional[dict]:
    """Columnar scan of all records from `start`; returns dict of arrays,
    or None past one record per 40 bytes."""
    lib = get_lib()
    if lib is None:
        return None
    b = np.frombuffer(buf, dtype=np.uint8)
    max_rec = max(16, len(buf) // 40)
    cols, ptrs = _scan_arrays(max_rec)
    n = lib.bam_scan_records(_p(b, ctypes.c_uint8), len(buf), start, max_rec,
                             *ptrs)
    if n < 0:
        return None
    return {k: v[:n].copy() for k, v in cols.items()}


def bam_scan_bgzf(comp, offs: np.ndarray, isize: np.ndarray, skip: int,
                  plain_base: int, slot_bytes: int, n_workers: int,
                  max_rec: int):
    """bam_scan over the plain bytes of consecutive BGZF blocks of `comp`
    (rows of bgzf_block_table, the first at plain_base in the file's plain
    stream), from `skip` bytes into the first, inflated and walked as one
    pipeline (pomfret_native.cpp bam_scan_bgzf): n_workers threads inflate
    slots of at most slot_bytes into reused buffers while this thread's
    call walks them. Returns (columns, (plain bytes of the slots walked,
    slots walked, the walk's waits for a slot)), or None where a slot the
    walk reaches does not inflate or a record starts past max_rec."""
    lib = get_lib()
    if lib is None:
        return None
    comp_a = np.frombuffer(comp, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    isize = np.ascontiguousarray(isize, dtype=np.int64)
    info = np.zeros(3, dtype=np.int64)
    rows = ctypes.c_void_p()
    n = lib.bam_scan_bgzf(_p(comp_a, ctypes.c_uint8), _p(offs, ctypes.c_int64),
                          _p(isize, ctypes.c_int64), len(offs), skip,
                          plain_base, slot_bytes, n_workers, max_rec,
                          _p(info, ctypes.c_int64), ctypes.byref(rows))
    if n < 0:
        return None
    cols, ptrs = _scan_arrays(n)
    lib.bam_scan_bgzf_take(rows, *ptrs)
    return cols, tuple(int(x) for x in info)


def rans4x8_uncompress(stream: bytes, raw_size: int) -> Optional[bytes]:
    """Native rANS4x8 decode of a full stream (9-byte header + payload)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty(raw_size, dtype=np.uint8)
    r = lib.rans4x8_uncompress(_p(src, ctypes.c_uint8), len(src),
                               _p(out, ctypes.c_uint8), raw_size)
    if r != 0:
        return None
    return out.tobytes()


def bgzf_inflate_index(comp, arena: Optional[str] = None
                       ) -> Optional[Tuple[bytes, np.ndarray, np.ndarray]]:
    """Decompress a BGZF byte span and return (plain bytes, block byte
    offsets within `comp`, per-block uncompressed sizes) — the index needed
    to map virtual offsets into the plain buffer.

    arena: name of a thread-local grow-only output buffer to decompress
    into (the returned plain array is a VIEW of it, valid until this
    thread's next call with the same name). Sequential chrom-source
    segments pass alternating generation names so each segment's plain
    buffer reuses already-touched pages — fresh np.empty per segment meant
    the allocator handing multi-GB back and forth with the hypervisor
    (fresh-page inflate ~177 MB/s vs ~1 GB/s warm on these hosts)."""
    lib = get_lib()
    if lib is None:
        return None
    comp_a = np.frombuffer(comp, dtype=np.uint8)
    max_blocks = len(comp) // 28 + 2
    offs = np.zeros(max_blocks, dtype=np.int64)
    isize = np.zeros(max_blocks, dtype=np.int64)
    n = lib.bgzf_scan_blocks(_p(comp_a, ctypes.c_uint8), len(comp),
                             _p(offs, ctypes.c_int64), _p(isize, ctypes.c_int64),
                             max_blocks)
    if n < 0:
        return None
    offs = offs[:n]
    isize = isize[:n]
    out_offs = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(isize[:-1], out=out_offs[1:])
    total = int(isize.sum())
    if arena is not None:
        out = _arena(arena, total, np.uint8)[:total]
    else:
        out = np.empty(total, dtype=np.uint8)
    r = lib.bgzf_inflate_blocks(_p(comp_a, ctypes.c_uint8), len(comp),
                                _p(offs, ctypes.c_int64), _p(out_offs, ctypes.c_int64),
                                _p(isize, ctypes.c_int64), n,
                                _p(out, ctypes.c_uint8), max(2, min(8, _N_CPU)))
    if r != 0:
        return None
    return out, offs, isize  # out stays a uint8 array: no copy on this path


_N_CPU = os.cpu_count() or 2

_TLS = threading.local()


def _arena(name: str, size: int, dtype) -> np.ndarray:
    """Thread-local grow-only scratch buffer. The window loader's output
    capacities scale with the decompressed span (tens of MB); fresh
    np.empty per call meant first-touch page faults dominating the native
    decode on the virtualized hosts. Buffers persist per thread and per
    name; returned arrays are valid until the SAME thread's next call
    using the same name."""
    store = getattr(_TLS, "bufs", None)
    if store is None:
        store = _TLS.bufs = {}
    a = store.get(name)
    if a is None or len(a) < size or a.dtype != np.dtype(dtype):
        a = store[name] = np.empty(size, dtype=dtype)
    return a


def bam_window_load(buf, chunk_ranges, tid: int, beg: int, end: int,
                    min_mapq: int, readlen_threshold: int, de_max: float,
                    lo: int, hi: int, n_threads: int = 0) -> Optional[dict]:
    """One-call window fetch+filter+meth-decode over a decompressed BAI
    chunk span (see bam_window_load in pomfret_native.cpp). Returns a dict
    of columnar arrays of the n records kept, with n_parsed, the records it
    parsed, kept or not; or None when the native lib is unavailable.

    The ctypes call releases the GIL, so concurrent window loads from a
    thread pool scale (the htslib-bgzf-worker role for region fetches)."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = max(2, min(8, _N_CPU + 1))
    b = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
    n_chunks = len(chunk_ranges)
    c_starts = np.asarray([c[0] for c in chunk_ranges], dtype=np.int64)
    c_stops = np.asarray([c[1] for c in chunk_ranges], dtype=np.int64)
    n_cap = max(256, len(buf) // 512)
    qn_cap = n_cap * 64
    # pass 2 stores only ACTUAL lifted calls (per-thread arenas in C++), so
    # calls_cap needs ~#CpG-calls, not the lseq-proportional worst case a
    # buf_len-sized buffer covered (that 4x-buf_len allocation per call was
    # the window-load bottleneck: fresh multi-GB mmaps + scattered
    # first-touch faults). len(buf)//64 is ~2.5x the observed density, with
    # doubling retries below.
    calls_cap = max(65536, len(buf) // 64)
    # two arena generations alternate per call, so a caller may hold one
    # call's calls/quals slabs while the NEXT call (the segment-pipelined
    # ChromReadSource prefetches fwc for segment k+1 while assembling k)
    # runs on the same thread; slabs stay valid until the next-but-one
    # call on this thread
    g = getattr(_TLS, "wl_gen", 0)
    _TLS.wl_gen = g ^ 1
    for _ in range(8):  # retry with doubled caps on overflow
        # thread-local reusable scratch: see _arena. The small per-record
        # outputs are COPIED into the return dict; calls/quals (the big
        # slabs) are returned as the arena itself (lifetime above).
        rec_off = _arena(f"wl_rec_off{g}", n_cap, np.int64)
        pos = _arena(f"wl_pos{g}", n_cap, np.int32)
        endpos = _arena(f"wl_endpos{g}", n_cap, np.int32)
        strand = _arena(f"wl_strand{g}", n_cap, np.int8)
        hp = _arena(f"wl_hp{g}", n_cap, np.int32)
        lseq = _arena(f"wl_lseq{g}", n_cap, np.int32)
        fallback = _arena(f"wl_fallback{g}", n_cap, np.int8)
        qname_off = _arena(f"wl_qname_off{g}", n_cap + 1, np.int64)
        qname_buf = _arena(f"wl_qname_buf{g}", qn_cap, np.uint8)
        call_off = _arena(f"wl_call_off{g}", n_cap + 1, np.int64)
        call_n = _arena(f"wl_call_n{g}", n_cap, np.int32)
        calls = _arena(f"wl_calls{g}", calls_cap, np.uint32)
        quals = _arena(f"wl_quals{g}", calls_cap, np.uint8)
        has_implicit = ctypes.c_int32(0)
        n_parsed = ctypes.c_int64(0)
        n = lib.bam_window_load(
            _p(b, ctypes.c_uint8), len(buf),
            _p(c_starts, ctypes.c_int64), _p(c_stops, ctypes.c_int64), n_chunks,
            tid, beg, end, min_mapq, readlen_threshold, de_max, lo, hi,
            n_cap, n_threads,
            _p(rec_off, ctypes.c_int64), _p(pos, ctypes.c_int32),
            _p(endpos, ctypes.c_int32), _p(strand, ctypes.c_int8),
            _p(hp, ctypes.c_int32), _p(lseq, ctypes.c_int32),
            _p(fallback, ctypes.c_int8),
            _p(qname_off, ctypes.c_int64), _p(qname_buf, ctypes.c_uint8), qn_cap,
            _p(call_off, ctypes.c_int64), _p(call_n, ctypes.c_int32),
            _p(calls, ctypes.c_uint32), _p(quals, ctypes.c_uint8), calls_cap,
            ctypes.byref(has_implicit), ctypes.byref(n_parsed))
        if n == -3:
            n_cap *= 2
            qn_cap *= 2
            continue
        if n == -4:
            qn_cap *= 2
            continue
        if n == -5:
            calls_cap *= 2
            continue
        if n < 0:
            return None
        n = int(n)
        # slice to the used qname bytes (qn_cap scales with the window
        # buffer; copying the whole capacity cost ~1s/200 windows)
        qb = qname_buf[: int(qname_off[n])].tobytes() if n else b""
        return {
            "n": n, "n_parsed": int(n_parsed.value),
            # per-record columns are copied out of the arenas (tiny);
            # calls/quals stay arena-backed (see note above)
            "rec_off": rec_off[:n].copy(), "pos": pos[:n].copy(),
            "endpos": endpos[:n].copy(), "strand": strand[:n].copy(),
            "hp": hp[:n].copy(), "l_seq": lseq[:n].copy(),
            "fallback": fallback[:n].copy(),
            "qnames": [qb[qname_off[i]: qname_off[i + 1]].decode()
                       for i in range(n)],
            "call_off": call_off[: n + 1].copy(), "call_n": call_n[:n].copy(),
            "calls": calls, "quals": quals,
            "has_implicit": bool(has_implicit.value),
        }
    return None


def site_select(calls: np.ndarray, quals: np.ndarray,
                cov_sel: int) -> Optional[np.ndarray]:
    """Methmer site selection over a window's concatenated calls (see
    site_select in pomfret_native.cpp): ascending positions with >=
    cov_sel meth AND unmeth calls, or None (native lib unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(calls)
    calls = np.ascontiguousarray(calls, dtype=np.uint32)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    cap = max(256, n)
    out = _arena("site_sel_out", cap, np.uint32)
    m = lib.site_select(_p(calls, ctypes.c_uint32),
                        _p(quals, ctypes.c_uint8), n, cov_sel,
                        _p(out, ctypes.c_uint32), cap)
    if m < 0:
        return None
    return out[: int(m)].copy()


def gzip_decompress(data: bytes, raw_size: int) -> Optional[bytes]:
    """Decompress one gzip member of known size via libdeflate (CRAM block
    payloads); None -> caller uses Python's gzip."""
    lib = get_lib()
    if lib is None or raw_size < 0:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(raw_size, 1), dtype=np.uint8)
    n = lib.gzip_decompress_buf(_p(src, ctypes.c_uint8), len(src),
                                _p(out, ctypes.c_uint8), raw_size)
    if n != raw_size:
        return None
    return out[:raw_size].tobytes()


def varhaptag_reads(buf, chunk_ranges, tid: int, beg: int, end: int,
                    kv_pos: np.ndarray, kv_op: np.ndarray, kv_len: np.ndarray,
                    kv_hap: np.ndarray, kv_chars_off: np.ndarray,
                    kv_chars: np.ndarray,
                    n_threads: int = 0) -> Optional[dict]:
    """Whole-chromosome varhaptag in one threaded C++ call (see
    varhaptag_reads in pomfret_native.cpp). kv_chars_off must have
    n_known+1 entries. Returns columnar {qnames, hap, fallback, rec_off}."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = max(2, min(8, _N_CPU + 1))
    b = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
    n_chunks = len(chunk_ranges)
    c_starts = np.asarray([c[0] for c in chunk_ranges], dtype=np.int64)
    c_stops = np.asarray([c[1] for c in chunk_ranges], dtype=np.int64)
    n_cap = max(256, len(buf) // 512)
    qn_cap = n_cap * 64
    for _ in range(8):
        rec_off = np.empty(n_cap, dtype=np.int64)
        hap = np.empty(n_cap, dtype=np.uint8)
        fallback = np.empty(n_cap, dtype=np.int8)
        qname_off = np.empty(n_cap + 1, dtype=np.int64)
        qname_buf = np.empty(qn_cap, dtype=np.uint8)
        n = lib.varhaptag_reads(
            _p(b, ctypes.c_uint8), len(buf),
            _p(c_starts, ctypes.c_int64), _p(c_stops, ctypes.c_int64), n_chunks,
            tid, beg, end,
            _p(kv_pos, ctypes.c_int64), _p(kv_op, ctypes.c_uint8),
            _p(kv_len, ctypes.c_int32), _p(kv_hap, ctypes.c_uint8),
            _p(kv_chars_off, ctypes.c_int64), _p(kv_chars, ctypes.c_uint8),
            len(kv_pos), n_threads, n_cap,
            _p(rec_off, ctypes.c_int64), _p(hap, ctypes.c_uint8),
            _p(fallback, ctypes.c_int8),
            _p(qname_off, ctypes.c_int64), _p(qname_buf, ctypes.c_uint8), qn_cap)
        if n == -3:
            n_cap *= 2
            qn_cap *= 2
            continue
        if n == -4:
            qn_cap *= 2
            continue
        if n < 0:
            return None
        n = int(n)
        qb = qname_buf[: int(qname_off[n])].tobytes() if n else b""
        return {
            "n": n, "rec_off": rec_off[:n], "hap": hap[:n],
            "fallback": fallback[:n],
            "qnames": [qb[qname_off[i]: qname_off[i + 1]].decode()
                       for i in range(n)],
        }
    return None


def mmr_extract_reads(sites: np.ndarray, mmr_lens: np.ndarray,
                      calls: np.ndarray, quals: np.ndarray,
                      call_off: np.ndarray, call_n: np.ndarray,
                      n_threads: int = 0) -> Optional[dict]:
    """Batch methmer extraction for all reads of a window (the reference buf
    walk, blockjoin.c:3357-3451, threaded over reads). Returns dict with
    concatenated `mers` + per-read `off`/`n`/`start_i`, or None when the
    native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = max(2, min(8, _N_CPU + 1))
    n_reads = len(call_n)
    sites = np.ascontiguousarray(sites, dtype=np.uint32)
    mmr_lens = np.ascontiguousarray(mmr_lens, dtype=np.uint8)
    out_off = np.empty(n_reads, dtype=np.int64)
    out_n = np.empty(n_reads, dtype=np.int32)
    out_start = np.empty(n_reads, dtype=np.uint32)
    cap = max(4096, int(len(calls)) + 64 * max(1, n_reads))
    for _ in range(8):
        out_mers = np.empty(cap, dtype=np.uint32)
        total = lib.mmr_extract_reads(
            _p(sites, ctypes.c_uint32), _p(mmr_lens, ctypes.c_uint8),
            len(sites),
            _p(calls, ctypes.c_uint32), _p(quals, ctypes.c_uint8),
            _p(call_off, ctypes.c_int64), _p(call_n, ctypes.c_int32),
            n_reads, n_threads,
            _p(out_mers, ctypes.c_uint32), cap,
            _p(out_off, ctypes.c_int64), _p(out_n, ctypes.c_int32),
            _p(out_start, ctypes.c_uint32))
        if total == -1:
            cap *= 2
            continue
        return {"mers": out_mers, "off": out_off, "n": out_n,
                "start_i": out_start}
    return None


def mer_runs_multi(tasks, R: int, SP: int, CB: int, n_threads: int = 0):
    """Batched runs-layout fill: one native call builds every lane's
    (R, CB) blk/b0 of a pack group (see mer_runs_multi in
    pomfret_native.cpp). tasks: list of (rows, lens, starts, offs, mers,
    inv_perm) per lane; shapes (R, SP, CB) are group-uniform. Returns
    (blk (T,R,CB) u8, b0 (T,R) i32, has (T,R) bool, maxd (T) i64 — a
    negative maxd means that lane needs the dense path) or None."""
    lib = get_lib()
    if lib is None or not tasks:
        return None
    if n_threads <= 0:
        n_threads = max(2, min(8, _N_CPU + 1))
    T = len(tasks)
    ptrs = np.zeros((6, T), dtype=np.int64)   # rows/lens/starts/offs/mers/ip
    n_runs = np.zeros(T, dtype=np.int64)
    n_mers = np.zeros(T, dtype=np.int64)
    n_reads = np.zeros(T, dtype=np.int64)
    keep = []
    for t, (rows, lens, starts, offs, mers, inv_perm) in enumerate(tasks):
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        mers = np.ascontiguousarray(mers, dtype=np.uint32)
        inv_perm = np.ascontiguousarray(inv_perm, dtype=np.int64)
        keep.append((rows, lens, starts, offs, mers, inv_perm))
        for a, arr in enumerate((rows, lens, starts, offs, mers, inv_perm)):
            ptrs[a, t] = arr.ctypes.data if len(arr) else 0
        n_runs[t] = len(rows)
        n_mers[t] = len(mers)
        n_reads[t] = max(len(inv_perm), 1)
    # grow-only arena (~0.3 GB per dense group; consumed by pack_gap_batch
    # within the same pack_group call). mer_fill_common only writes present
    # entries, so zero in place — warm-page memset vs fresh calloc pages.
    blk = _arena("runs_multi_blk", T * R * CB,
                 np.uint8)[: T * R * CB].reshape(T, R, CB)
    blk.fill(0)
    b0 = np.zeros((T, R), dtype=np.int32)
    has = np.zeros((T, R), dtype=np.uint8)
    maxd = np.zeros(T, dtype=np.int64)
    lib.mer_runs_multi(
        _p(ptrs[0], ctypes.c_int64), _p(ptrs[1], ctypes.c_int64),
        _p(ptrs[2], ctypes.c_int64), _p(ptrs[3], ctypes.c_int64),
        _p(n_runs, ctypes.c_int64),
        _p(ptrs[4], ctypes.c_int64), _p(n_mers, ctypes.c_int64),
        _p(ptrs[5], ctypes.c_int64), _p(n_reads, ctypes.c_int64),
        T, n_threads,
        _p(blk, ctypes.c_uint8), _p(b0, ctypes.c_int32),
        _p(has, ctypes.c_uint8),
        R, SP, CB, _p(maxd, ctypes.c_int64))
    return blk, b0, has.astype(bool), maxd


def mmr_extract_multi(tasks, n_threads: int = 0):
    """Batched methmer extraction: one native call for MANY (site grid,
    read-call table) tasks — the whole pack group's (gap, direction)
    extractions at once (see mmr_extract_multi in pomfret_native.cpp).

    tasks: list of (sites u32, mmr_lens u8, calls u32, quals u8,
    call_off i64, call_n i32). Returns a list of {mers, off, n, start_i}
    dicts (mers is a view into one shared buffer) or None when the lib is
    unavailable. Tasks whose conservative output capacity still overflows
    re-run through the single-call path (handles its own growth)."""
    lib = get_lib()
    if lib is None or not tasks:
        return None
    if n_threads <= 0:
        n_threads = max(2, min(8, _N_CPU + 1))
    T = len(tasks)
    keep = []  # contiguous arrays kept alive across the call
    site_off = np.zeros(T + 1, dtype=np.int64)
    read_base = np.zeros(T + 1, dtype=np.int64)
    out_base = np.zeros(T, dtype=np.int64)
    out_cap = np.zeros(T, dtype=np.int64)
    calls_ptrs = np.zeros(T, dtype=np.int64)
    quals_ptrs = np.zeros(T, dtype=np.int64)
    calloff_ptrs = np.zeros(T, dtype=np.int64)
    calln_ptrs = np.zeros(T, dtype=np.int64)
    n_reads_per = np.zeros(T, dtype=np.int64)
    sites_parts, lens_parts = [], []
    base = 0
    for t, (sites, lens, calls, quals, call_off, call_n) in enumerate(tasks):
        sites = np.ascontiguousarray(sites, dtype=np.uint32)
        lens = np.ascontiguousarray(lens, dtype=np.uint8)
        calls = np.ascontiguousarray(calls, dtype=np.uint32)
        quals = np.ascontiguousarray(quals, dtype=np.uint8)
        call_off = np.ascontiguousarray(call_off, dtype=np.int64)
        call_n = np.ascontiguousarray(call_n, dtype=np.int32)
        keep.append((calls, quals, call_off, call_n))
        sites_parts.append(sites)
        lens_parts.append(lens)
        site_off[t + 1] = site_off[t] + len(sites)
        read_base[t + 1] = read_base[t] + len(call_n)
        n_reads_per[t] = len(call_n)
        calls_ptrs[t] = calls.ctypes.data if len(calls) else 0
        quals_ptrs[t] = quals.ctypes.data if len(quals) else 0
        calloff_ptrs[t] = call_off.ctypes.data if len(call_off) else 0
        calln_ptrs[t] = call_n.ctypes.data if len(call_n) else 0
        cap = max(4096, int(len(calls)) + 64 * max(1, len(call_n)))
        out_base[t] = base
        out_cap[t] = cap
        base += cap
    sites_all = np.concatenate(sites_parts) if sites_parts \
        else np.zeros(0, dtype=np.uint32)
    lens_all = np.concatenate(lens_parts) if lens_parts \
        else np.zeros(0, dtype=np.uint8)
    n_reads_tot = int(read_base[-1])
    # grow-only arena: ~0.5 GB per dense group, fully consumed within the
    # same pack_group call — a fresh allocation per group was a dominant
    # source of the fault-storm the virtualized hosts inflict on new pages
    out_mers = _arena("mmr_multi_mers", base, np.uint32)[:base]
    out_off = np.empty(max(n_reads_tot, 1), dtype=np.int64)
    out_n = np.empty(max(n_reads_tot, 1), dtype=np.int32)
    out_start = np.empty(max(n_reads_tot, 1), dtype=np.uint32)
    out_totals = np.empty(T, dtype=np.int64)
    lib.mmr_extract_multi(
        _p(sites_all, ctypes.c_uint32), _p(lens_all, ctypes.c_uint8),
        _p(site_off, ctypes.c_int64),
        _p(calls_ptrs, ctypes.c_int64), _p(quals_ptrs, ctypes.c_int64),
        _p(calloff_ptrs, ctypes.c_int64), _p(calln_ptrs, ctypes.c_int64),
        _p(n_reads_per, ctypes.c_int64), T, n_threads,
        _p(out_mers, ctypes.c_uint32), _p(out_base, ctypes.c_int64),
        _p(out_cap, ctypes.c_int64),
        _p(out_off, ctypes.c_int64), _p(out_n, ctypes.c_int32),
        _p(out_start, ctypes.c_uint32),
        _p(read_base, ctypes.c_int64), _p(out_totals, ctypes.c_int64))
    results = []
    for t in range(T):
        r0, r1 = int(read_base[t]), int(read_base[t + 1])
        if out_totals[t] < 0:
            # capacity overflow (i>1 dup double-emission blowups):
            # single-call path grows its buffer until it fits
            sites, lens, calls, quals, call_off, call_n = tasks[t]
            results.append(mmr_extract_reads(sites, lens, calls, quals,
                                             call_off, call_n))
        else:
            b = int(out_base[t])
            results.append({
                "mers": out_mers[b : b + int(out_totals[t])],
                "off": out_off[r0:r1], "n": out_n[r0:r1],
                "start_i": out_start[r0:r1],
            })
    return results


_meth_tl = threading.local()


def meth_decode_read(seq_packed: bytes, l_seq: int, strand: int,
                     mm: str, ml, cigar, pos: int, lo: int, hi: int):
    """Native per-read 5mC extraction + CIGAR ref-lift for the dominant
    single-'C+m' MM shape. Returns (ref_pos uint32 array, qual-class uint8
    array, has_implicit) or None when the read needs the Python path.

    Hot path (called once per read per window load): output buffers and the
    has_implicit cell are thread-local and reused across calls."""
    lib = _LIB if _LIB is not None else get_lib()
    if lib is None:
        return None
    sp = np.frombuffer(seq_packed, dtype=np.uint8)
    ml_arr = np.asarray(ml, dtype=np.uint8) if ml is not None else None
    cig = np.asarray(cigar, dtype=np.uint32)
    cap = l_seq + 16
    bufs = getattr(_meth_tl, "bufs", None)
    if bufs is None or len(bufs[0]) < cap:
        bufs = _meth_tl.bufs = (np.empty(max(cap, 65536), dtype=np.uint32),
                                np.empty(max(cap, 65536), dtype=np.uint8),
                                ctypes.c_int32(0))
    out_pos, out_qual, has_implicit = bufs
    has_implicit.value = 0
    n = lib.meth_decode_read(
        _p(sp, ctypes.c_uint8), l_seq, strand, mm.encode(),
        _p(ml_arr, ctypes.c_uint8) if ml_arr is not None else None,
        len(ml_arr) if ml_arr is not None else 0,
        _p(cig, ctypes.c_uint32) if len(cig) else None, len(cig), pos,
        lo, hi, _p(out_pos, ctypes.c_uint32), _p(out_qual, ctypes.c_uint8),
        len(out_pos), ctypes.byref(has_implicit))
    if n < 0:
        return None
    return out_pos[:n].copy(), out_qual[:n].copy(), bool(has_implicit.value)


def qmap_arrays(d: dict):
    """Sorted concatenated-key arrays for the native qname->int lookups."""
    items = sorted((k.encode(), v) for k, v in d.items())
    if not items:
        return (np.zeros(1, np.uint8), np.zeros(1, np.int64),
                np.zeros(0, np.int32), 0)
    blob = np.frombuffer(b"".join(k for k, _ in items), dtype=np.uint8)
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(k) for k, _ in items], out=off[1:])
    vals = np.asarray([v for _, v in items], dtype=np.int32)
    return blob, off, vals, len(items)


def bam_retag_hp(buf: bytes, maps, intervals, state: np.ndarray,
                 mode: int = 0):
    """Patch the HP tag of every complete BAM record in `buf` (see
    bam_retag_hp in pomfret_native.cpp). maps = (qmap_arrays(meth),
    qmap_arrays(raw), use_raw_map); intervals = (iv_off, fl_off, starts,
    ends, flips, n_bamrefs); state = int32[3] [prev_tid, need_flip,
    prev_idx], mutated in place. mode 0 = methphase rewrite, 1 = varhaptag.

    Returns (out_bytes, rec_meta int64[n,8] rows [refID, pos, endpos,
    out_off, out_len, unmapped, hp_raw, hp_new], consumed) or None when the
    native lib is unavailable; raises on malformed records."""
    lib = get_lib()
    if lib is None:
        return None
    (k1, o1, v1, n1), (k2, o2, v2, n2), use_raw = maps
    iv_off, fl_off, starts, ends, flips, n_refs = intervals
    b = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(len(buf) + len(buf) // 4 + 64, dtype=np.uint8)
    meta_cap = len(buf) // 36 + 8
    meta = np.empty(meta_cap * 8, dtype=np.int64)
    n_meta = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    n_out = lib.bam_retag_hp(
        _p(b, ctypes.c_uint8), len(buf),
        _p(out, ctypes.c_uint8), len(out),
        _p(k1, ctypes.c_uint8), _p(o1, ctypes.c_int64),
        _p(v1, ctypes.c_int32), n1,
        _p(k2, ctypes.c_uint8), _p(o2, ctypes.c_int64),
        _p(v2, ctypes.c_int32), n2,
        1 if use_raw else 0, mode,
        _p(iv_off, ctypes.c_int64), _p(fl_off, ctypes.c_int64),
        _p(starts, ctypes.c_int64), _p(ends, ctypes.c_int64),
        _p(flips, ctypes.c_int32), n_refs,
        _p(state, ctypes.c_int32),
        _p(meta, ctypes.c_int64), meta_cap,
        ctypes.byref(n_meta), ctypes.byref(consumed))
    if n_out < 0:
        raise ValueError(f"bam_retag_hp failed: {n_out}")
    nm = int(n_meta.value)
    return (out[:n_out].tobytes(), meta[: nm * 8].reshape(nm, 8),
            int(consumed.value))


# fixed series order shared with cram_decode_slice in pomfret_native.cpp
_CRAM_SERIES = ("BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP",
                "TS", "NF", "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS",
                "IN", "SC", "BA", "QS", "MQ", "RS", "PD", "HC")


def cram_decode_slice(ch, sl, core_data: bytes, ext_blocks: dict,
                      ref_seq, ref_offset: int, rg_ids,
                      skip_qs: bool = False) -> Optional[tuple]:
    """Native decode of one CRAM slice into a raw BAM record stream.

    ch: io.cram.CompressionHeader; sl: io.cram.SliceHeader.
    Returns (bam_bytes, metas int64 (n,6) [refID,pos,endpos,off,len,unmapped])
    or None when the native lib is unavailable or the slice uses an encoding
    the C++ decoder does not cover (callers fall back to the Python loop).

    skip_qs: the caller dropped the QS series' dedicated external block
    (window/scan consumers never read per-base quals) — the decoder emits
    0xFF quals without touching the stream (E_SKIP sentinel)."""
    lib = get_lib()
    if lib is None:
        return None
    n_rec = sl.n_records
    if n_rec == 0:
        return b"", np.zeros((0, 6), dtype=np.int64)

    ids = sorted(ext_blocks)
    ext_ids = np.asarray(ids, dtype=np.int32)
    ext_len = np.asarray([len(ext_blocks[i]) for i in ids], dtype=np.int64)
    ext_off = np.zeros(len(ids), dtype=np.int64)
    if len(ids) > 1:
        np.cumsum(ext_len[:-1], out=ext_off[1:])
    ext_buf = np.frombuffer(b"".join(ext_blocks[i] for i in ids) or b"\0",
                            dtype=np.uint8)

    se_codec = np.zeros(len(_CRAM_SERIES), dtype=np.int32)
    se_off = np.zeros(len(_CRAM_SERIES) + 1, dtype=np.int64)
    prm_parts = []
    for k, key in enumerate(_CRAM_SERIES):
        enc = ch.series.get(key)
        if enc is not None:
            se_codec[k] = enc.codec
            prm_parts.append(enc.params)
        se_off[k + 1] = se_off[k] + (len(enc.params) if enc is not None else 0)
    se_prm = np.frombuffer(b"".join(prm_parts) or b"\0", dtype=np.uint8)
    if skip_qs:
        se_codec[_CRAM_SERIES.index("QS")] = 100  # E_SKIP sentinel

    td_off = np.zeros(len(ch.tag_dict) + 1, dtype=np.int32)
    td_keys_l = []
    for li, line in enumerate(ch.tag_dict):
        for tag, typ in line:
            td_keys_l.append((ord(tag[0]) << 16) | (ord(tag[1]) << 8) | typ)
        td_off[li + 1] = len(td_keys_l)
    td_keys = np.asarray(td_keys_l or [0], dtype=np.int32)

    tag_keys = np.asarray(sorted(ch.tags) or [0], dtype=np.int32)
    n_tag = len(ch.tags)
    tag_codec = np.zeros(max(n_tag, 1), dtype=np.int32)
    tag_off = np.zeros(n_tag + 1, dtype=np.int64)
    tprm_parts = []
    for i, key in enumerate(sorted(ch.tags)):
        enc = ch.tags[key]
        tag_codec[i] = enc.codec
        tprm_parts.append(enc.params)
        tag_off[i + 1] = tag_off[i] + len(enc.params)
    tag_prm = np.frombuffer(b"".join(tprm_parts) or b"\0", dtype=np.uint8)

    if isinstance(ref_seq, str):
        ref_seq = ref_seq.encode()
    ref_arr = np.frombuffer(ref_seq, dtype=np.uint8) if ref_seq else None
    rg_off = np.zeros(len(rg_ids) + 1, dtype=np.int64)
    rg_parts = []
    for i, rid in enumerate(rg_ids):
        rg_parts.append(rid.encode())
        rg_off[i + 1] = rg_off[i] + len(rg_parts[-1])
    rg_buf = np.frombuffer(b"".join(rg_parts) or b"\0", dtype=np.uint8)

    core_arr = np.frombuffer(core_data or b"\0", dtype=np.uint8)
    sub = np.frombuffer(ch.sub_matrix, dtype=np.uint8)
    metas = np.empty(n_rec * 6, dtype=np.int64)
    # generous first guess: records expand vs their compressed size
    cap = max(1 << 16, int(ext_len.sum()) * 3 + n_rec * 64)
    for _ in range(8):
        out = np.empty(cap, dtype=np.uint8)
        r = lib.cram_decode_slice(
            _p(ext_buf, ctypes.c_uint8), _p(ext_ids, ctypes.c_int32),
            _p(ext_off, ctypes.c_int64), _p(ext_len, ctypes.c_int64),
            len(ids),
            _p(core_arr, ctypes.c_uint8), len(core_data or b""),
            sl.ref_id, sl.start, n_rec,
            1 if ch.rn_preserved else 0, 1 if ch.ap_delta else 0,
            _p(sub, ctypes.c_uint8),
            _p(se_codec, ctypes.c_int32), _p(se_off, ctypes.c_int64),
            _p(se_prm, ctypes.c_uint8),
            _p(td_off, ctypes.c_int32), len(ch.tag_dict),
            _p(td_keys, ctypes.c_int32),
            _p(tag_keys, ctypes.c_int32), _p(tag_codec, ctypes.c_int32),
            _p(tag_off, ctypes.c_int64), _p(tag_prm, ctypes.c_uint8), n_tag,
            _p(ref_arr, ctypes.c_uint8) if ref_arr is not None else None,
            len(ref_arr) if ref_arr is not None else 0, ref_offset,
            _p(rg_buf, ctypes.c_uint8), _p(rg_off, ctypes.c_int64),
            len(rg_ids),
            _p(out, ctypes.c_uint8), cap, _p(metas, ctypes.c_int64))
        if r == -1:
            cap *= 2
            continue
        if r < 0:
            return None  # unsupported/corrupt -> Python fallback
        return out[:r].tobytes(), metas.reshape(n_rec, 6)
    return None


def mer_grid_fill(rows: np.ndarray, lens: np.ndarray, starts: np.ndarray,
                  offs: np.ndarray, mers: np.ndarray, inv_perm: np.ndarray,
                  R: int, SP: int) -> Optional[tuple]:
    """Native dense per-site mer-id grid (see mer_grid_fill in
    pomfret_native.cpp). Returns (ids int8 (R,SP), has_mmr bool (R,), max_d)
    or None when the lib is absent / a site needs >127 ids (the numpy int32
    path handles that case)."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    mers = np.ascontiguousarray(mers, dtype=np.uint32)
    inv_perm = np.ascontiguousarray(inv_perm, dtype=np.int64)
    grid = np.full((R, SP), -1, dtype=np.int8)
    has = np.zeros(R, dtype=np.uint8)
    r = lib.mer_grid_fill(
        _p(rows, ctypes.c_int64), _p(lens, ctypes.c_int64),
        _p(starts, ctypes.c_int64), _p(offs, ctypes.c_int64), len(rows),
        _p(mers, ctypes.c_uint32), len(mers),
        _p(inv_perm, ctypes.c_int64), max(len(inv_perm), 1),
        _p(grid, ctypes.c_int8), R, SP, _p(has, ctypes.c_uint8))
    if r < 0:
        return None
    return grid, has.astype(bool), int(r)


def mer_runs_fill(rows: np.ndarray, lens: np.ndarray, starts: np.ndarray,
                  offs: np.ndarray, mers: np.ndarray, inv_perm: np.ndarray,
                  R: int, SP: int, CB: int) -> Optional[tuple]:
    """Compact runs layout of the mer-id grid (see mer_runs_fill in
    pomfret_native.cpp): blk (R, CB) uint8 of id+1 (0 = absent) at offset
    (start&127)+k, b0 (R,) int32 first 128-site block (-1 = no mers).
    Returns (blk, b0, has_mmr, max_d) or None when the lib is absent, a
    site needs >127 ids, or CB is too small (callers size CB as
    round_up(max(start%128 + len), 128))."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    mers = np.ascontiguousarray(mers, dtype=np.uint32)
    inv_perm = np.ascontiguousarray(inv_perm, dtype=np.int64)
    blk = np.zeros((R, CB), dtype=np.uint8)
    b0 = np.empty(R, dtype=np.int32)
    has = np.zeros(R, dtype=np.uint8)
    r = lib.mer_runs_fill(
        _p(rows, ctypes.c_int64), _p(lens, ctypes.c_int64),
        _p(starts, ctypes.c_int64), _p(offs, ctypes.c_int64), len(rows),
        _p(mers, ctypes.c_uint32), len(mers),
        _p(inv_perm, ctypes.c_int64), max(len(inv_perm), 1),
        _p(blk, ctypes.c_uint8), _p(b0, ctypes.c_int32), R, SP, CB,
        _p(has, ctypes.c_uint8))
    if r < 0:
        return None
    return blk, b0, has.astype(bool), int(r)
