"""BGZF (blocked gzip) reader/writer.

Replaces the htslib bgzf layer used by the reference (bgzf_mt at
blockjoin.c:576-578, 3046). BGZF is a series of gzip members, each with an
FEXTRA 'BC' subfield carrying the compressed block size; random access uses
virtual offsets voffset = (compressed_offset << 16) | within_block_offset.

The decompression/compression hot loops release the GIL inside zlib, so a
thread pool gives real parallelism (the TPU-era analog of htslib's bgzf
worker pool); a C++ fast path can replace this later without API change.
"""
from __future__ import annotations

import concurrent.futures as _fut
import os
import struct
import threading
import zlib

# 28-byte empty BGZF block used as EOF marker (fixed by the SAM spec).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")  # magic(4) mtime xfl os xlen


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18:
        return False
    if head[0] != 0x1F or head[1] != 0x8B or head[3] & 4 == 0:
        return False
    # look for BC subfield
    xlen = struct.unpack_from("<H", head, 10)[0]
    return xlen >= 6 and head[12:14] == b"BC"


def _parse_block_header(buf: bytes, off: int):
    """Return (data_start, bsize_total) for block at byte offset `off`."""
    if buf[off] != 0x1F or buf[off + 1] != 0x8B:
        raise ValueError("not a gzip block")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    xoff = off + 12
    xend = xoff + xlen
    bsize = None
    while xoff + 4 <= xend:
        si1, si2, slen = buf[xoff], buf[xoff + 1], struct.unpack_from("<H", buf, xoff + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", buf, xoff + 4)[0] + 1
        xoff += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC subfield")
    return xend, bsize


def _inflate_block(buf: bytes, off: int):
    """Inflate one BGZF block at `off`; return (payload_bytes, next_off)."""
    data_start, bsize = _parse_block_header(buf, off)
    # deflate payload sits between the header and the trailing CRC32+ISIZE
    comp = buf[data_start : off + bsize - 8]
    payload = zlib.decompress(comp, wbits=-15)
    return payload, off + bsize


# shared raw-byte cache: many BamReader instances (per-thread, per-phase)
# open the same file; the compressed bytes are immutable, so all readers can
# share one copy instead of slurping a whole-genome BAM per instance
_RAW_CACHE: dict = {}
_RAW_LOCK = threading.Lock()


def _read_raw_shared(path: str) -> bytes:
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    with _RAW_LOCK:
        hit = _RAW_CACHE.get(key)
    if hit is not None:
        return hit
    with open(path, "rb") as f:
        raw = f.read()
    with _RAW_LOCK:
        # keep at most a few distinct files resident
        if len(_RAW_CACHE) >= 4:
            _RAW_CACHE.pop(next(iter(_RAW_CACHE)))
        _RAW_CACHE[key] = raw
    return raw


class BgzfReader:
    """Random-access BGZF reader over an in-memory byte buffer.

    The compressed bytes are read once per file and SHARED across all reader
    instances (see _read_raw_shared); per-block decompression is lazy and
    cached per instance."""

    def __init__(self, path: str, threads: int = 1):
        self.path = path
        self._raw = _read_raw_shared(path)
        self._threads = max(1, threads)
        self._cache_off = -1
        self._cache_data = b""
        # current logical position
        self._block_off = 0
        self._within = 0

    # ---- virtual offset API ----
    def seek_virtual(self, voffset: int) -> None:
        self._block_off = voffset >> 16
        self._within = voffset & 0xFFFF

    def tell_virtual(self) -> int:
        return (self._block_off << 16) | self._within

    def _block(self, off: int) -> bytes:
        if off == self._cache_off:
            return self._cache_data
        payload, _ = _inflate_block(self._raw, off)
        self._cache_off = off
        self._cache_data = payload
        return payload

    def read(self, n: int) -> bytes:
        out = []
        need = n
        while need > 0:
            if self._block_off >= len(self._raw):
                break
            data = self._block(self._block_off)
            if self._within >= len(data):
                # advance to next block (empty block or exhausted)
                _, bsize = _parse_block_header(self._raw, self._block_off)
                self._block_off += bsize
                self._within = 0
                if len(data) == 0 and self._block_off >= len(self._raw):
                    break
                continue
            take = data[self._within : self._within + need]
            out.append(take)
            self._within += len(take)
            need -= len(take)
        return b"".join(out)

    def at_eof(self) -> bool:
        while True:
            if self._block_off >= len(self._raw):
                return True
            data = self._block(self._block_off)
            if self._within < len(data):
                return False
            _, bsize = _parse_block_header(self._raw, self._block_off)
            self._block_off += bsize
            self._within = 0

    # ---- bulk decompression ----
    def read_all(self) -> bytes:
        """Decompress the entire file (C++ thread pool when available,
        else Python threads — zlib releases the GIL)."""
        try:
            from . import native
            if native.native_available():
                out = native.bgzf_inflate_all(self._raw, n_threads=max(self._threads, 4))
                if out is not None:
                    return out
        except ImportError:
            pass
        offs = []
        off = 0
        raw = self._raw
        n = len(raw)
        while off < n:
            _, bsize = _parse_block_header(raw, off)
            offs.append(off)
            off += bsize
        if self._threads > 1 and len(offs) > 8:
            with _fut.ThreadPoolExecutor(self._threads) as ex:
                parts = list(ex.map(lambda o: _inflate_block(raw, o)[0], offs))
        else:
            parts = [_inflate_block(raw, o)[0] for o in offs]
        return b"".join(parts)

    def block_offsets(self):
        """Byte offsets of every block plus per-block uncompressed sizes."""
        offs = []
        sizes = []
        off = 0
        raw = self._raw
        n = len(raw)
        while off < n:
            _, bsize = _parse_block_header(raw, off)
            isize = struct.unpack_from("<I", raw, off + bsize - 4)[0]
            offs.append(off)
            sizes.append(isize)
            off += bsize
        return offs, sizes


def _deflate_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 26  # 18 header + comp + 8 trailer
    if bsize > 0x10000:
        raise ValueError("BGZF block too large after compression")
    hdr = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload) & 0xFFFFFFFF)


class BgzfWriter:
    """BGZF writer with multithreaded block compression (C++ batch deflate
    when available, Python thread pool otherwise).

    Supports deferred virtual offsets: `mark()` returns a (block_seq,
    within) handle without forcing compression; after `close()`,
    `resolve_mark()` turns handles into final virtual offsets. This lets the
    BAM writer index records while compression proceeds in large parallel
    batches (the htslib bgzf_mt role)."""

    BLOCK = 0xFF00  # uncompressed payload per block (htslib default)

    def __init__(self, path: str, level: int = 6, threads: int = 1):
        self._f = open(path, "wb")
        self._level = level
        self._buf = bytearray()
        self._threads = max(1, threads)
        self._pool = _fut.ThreadPoolExecutor(self._threads) if self._threads > 1 else None
        self._pending = []          # python-pool futures, FIFO
        self._queue = []            # chunks awaiting native batch deflate
        self._sizes = []            # compressed size per completed chunk
        self._n_submitted = 0
        self._closed = False
        try:
            from . import native
            self._native = native if native.native_available() else None
        except ImportError:
            self._native = None

    def write(self, data: bytes) -> None:
        # bulk-friendly: submit BLOCK-sized views of `data` directly instead
        # of accumulating into the bytearray (front-deletion is O(n) per
        # block — quadratic for multi-MB writes from the native retag path)
        B = self.BLOCK
        if self._buf:
            need = B - len(self._buf)
            if len(data) < need:
                self._buf += data
                return
            self._buf += data[:need]
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit(chunk)
            data = memoryview(data)[need:]
        mv = memoryview(data)
        n_full = len(mv) // B
        for i in range(n_full):
            self._submit(bytes(mv[i * B : (i + 1) * B]))
        self._buf += mv[n_full * B :]

    # ---- deferred offsets ----
    def mark(self):
        """Cheap position handle: (block_seq, offset_within_block)."""
        return (self._n_submitted, len(self._buf))

    def resolve_mark(self, mark) -> int:
        """mark -> virtual offset; valid after close()."""
        seq, within = mark
        if not hasattr(self, "_offsets"):
            offs = [0]
            for s in self._sizes:
                offs.append(offs[-1] + s)
            self._offsets = offs
        return (self._offsets[seq] << 16) | within

    def tell_virtual(self) -> int:
        # forces compression of everything submitted so far
        self._drain_all()
        return (self._f.tell() << 16) | len(self._buf)

    def flush_block(self) -> None:
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit(chunk)

    def _submit(self, chunk: bytes) -> None:
        self._n_submitted += 1
        if self._native is not None:
            self._queue.append(chunk)
            if len(self._queue) >= 256:
                self._flush_native()
        elif self._pool is not None:
            self._pending.append(self._pool.submit(_deflate_block, chunk, self._level))
            if len(self._pending) >= self._threads * 8:
                self._drain_python(keep=self._threads * 2)
        else:
            out = _deflate_block(chunk, self._level)
            self._sizes.append(len(out))
            self._f.write(out)

    def _flush_native(self) -> None:
        if not self._queue:
            return
        payload = b"".join(self._queue)
        lens = [len(c) for c in self._queue]
        comp = self._native.bgzf_deflate_all_chunks(payload, lens, self._level,
                                                    n_threads=self._threads)
        if comp is None:  # native failure: fall back per chunk
            for c in self._queue:
                out = _deflate_block(c, self._level)
                self._sizes.append(len(out))
                self._f.write(out)
        else:
            blocks, sizes = comp
            self._sizes.extend(sizes)
            self._f.write(blocks)
        self._queue = []

    def _drain_python(self, keep: int = 0) -> None:
        while len(self._pending) > keep:
            out = self._pending.pop(0).result()
            self._sizes.append(len(out))
            self._f.write(out)

    def _drain_all(self) -> None:
        self._flush_native()
        self._drain_python()

    def close(self) -> None:
        if self._closed:
            return
        self.flush_block()
        self._drain_all()
        if self._pool is not None:
            self._pool.shutdown()
        self._f.write(BGZF_EOF)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
